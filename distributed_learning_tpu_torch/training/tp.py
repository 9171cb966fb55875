"""Tensor parallelism for the transformer (port of
``distributed_learning_tpu/training/tp.py``).

The reference only annotates: megatron-style shardings on the weight
matrices over a ``model`` mesh axis, and XLA's SPMD partitioner inserts
every collective.  PyTorch on ``torch.distributed`` has no partitioner,
so the port writes the collectives itself, with the same layout: a rank
of a :class:`~distributed_learning_tpu_torch.parallel.multihost.GridMesh`
holds the block of each parameter that the reference's spec places on the
device of its index, and computes head-local and column/row-local
(``TransformerLM(tp_axis="model", mesh=grid)``: Megatron's f at each
region's entry, one ``all_reduce`` at its exit).

Rules (the Megatron-LM split, arXiv:1909.08053), as the reference's:

* QKV kernel ``(d, 3, H, Dh)`` and GQA's ``q_proj`` / ``kv_proj``: the
  head axis;
* attention out-projection ``(H, Dh, d)``: the head rows (one
  ``all_reduce``);
* MLP up kernel ``(d, 4d)``: columns; down kernel ``(4d, d)``: rows (one
  ``all_reduce``);
* embeddings, LayerNorms, biases, the vocabulary head and MoE expert
  kernels: whole on every rank.  A dimension that does not divide by the
  axis leaves its leaf whole (:func:`divisible_or_replicated`: MQA's
  ``kv_proj`` on a 2-way axis).

:func:`make_tp_train_step` is the data x tensor parallel step on a
``(data, model)`` grid; :func:`make_tp_generate` serves the same layout
(prefill, then decode steps against a head-sharded KV cache).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch
import torch.nn.functional as F

from distributed_learning_tpu_torch.models.moe import collect_load_balance_loss
from distributed_learning_tpu_torch.parallel.multihost import (
    PartitionSpec as P,
    local_shard,
    path_names,
    tree_map_with_path,
)
from distributed_learning_tpu_torch.training.fsdp import reject_dropout_model

__all__ = ["transformer_tp_rules", "shard_transformer_params", "make_tp_train_step",
           "make_tp_generate", "constrain_decode_cache", "divisible_or_replicated"]


def transformer_tp_rules(path, leaf, model_axis: str) -> P:
    """The placement of one TransformerLM parameter (``tp.py:57``):
    ``path`` is its flax path (keys or a dotted name), ``leaf`` anything
    with ``shape`` and ``ndim`` (one agent's shape)."""
    names = path_names(path)
    if len(names) < 2:
        return P()
    if any(n.startswith("_Attention") for n in names):
        # GQA's projections carry their own names; the head axis is dim 1
        # of q_proj (d, H, Dh) and dim 2 of kv_proj (d, 2, Hkv, Dh).
        if names[-2] == "q_proj":
            return P(None, model_axis, None)
        if names[-2] == "kv_proj":
            return P(None, None, model_axis, None)
        if leaf.ndim == 4:  # QKV (d, 3, H, Dh)
            return P(None, None, model_axis, None)
        if leaf.ndim == 3:  # out-projection (H, Dh, d)
            return P(model_axis, None, None)
        return P()
    if leaf.ndim != 2:
        return P()  # biases, LayerNorm scales: whole
    dense = names[-2]
    if any(n.startswith("_Block") for n in names):
        # The block's own Dense pair is the MLP: up = columns, down = rows.
        if dense == "Dense_0":
            return P(None, model_axis)
        if dense == "Dense_1":
            return P(model_axis, None)
    return P()


def divisible_or_replicated(spec: P, leaf, mesh, model_axis: str) -> P:
    """Whole when the split dimension does not divide by the axis size
    (``tp.py:100``): MQA's ``kv_proj`` with one K/V head on a 2-way axis
    is kept whole on every rank rather than refused."""
    n = mesh.shape[model_axis]
    for d, name in enumerate(spec):
        if name == model_axis and leaf.shape[d] % n:
            return P()
    return spec


def shard_transformer_params(params: Any, mesh, model_axis: str = "model") -> Any:
    """This rank's block of every leaf of a full TransformerLM parameter
    tree (the flax tree as nested mappings of arrays) under the megatron
    rules on ``mesh``."""
    def place(path, leaf):
        spec = divisible_or_replicated(transformer_tp_rules(path, leaf, model_axis),
                                       leaf, mesh, model_axis)
        return local_shard(leaf, spec, mesh)

    return tree_map_with_path(place, params)


def _axis(mesh, name: Optional[str]):
    """``mesh[name]``, or None when the grid has no such axis."""
    return mesh[name] if name is not None and name in mesh else None


def _rows(t: torch.Tensor, data) -> torch.Tensor:
    """This rank's rows of a global batch split over ``data``."""
    if data is None:
        return t
    B = t.shape[0]
    if B % data.size:
        raise ValueError(f"batch {B} does not split over the {data.size}-way "
                         f"{data.axis_name!r} axis")
    b = B // data.size
    return t[data.agent * b:(data.agent + 1) * b]


def bind_optimizer(model, tx):
    """``tx(model.flat_params)`` with the gradient buffer bound (``tx`` a
    factory as ``make_optimizer`` returns)."""
    model.flat_grads.zero_()
    model.flat_params.grad = model.flat_grads
    return tx(model.flat_params)


def lm_loss(model, x: torch.Tensor, y: torch.Tensor, moe_aux_coef: float) -> torch.Tensor:
    """The mean cross entropy of ``model`` on (B, T) tokens ``x`` against
    ``y``, plus ``moe_aux_coef`` times the blocks' mean load-balance loss
    (MoE models only)."""
    logits = model(x[None])[0]
    loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), y.reshape(-1).long())
    aux = collect_load_balance_loss(model)
    if aux is not None:
        loss = loss + moe_aux_coef * aux[0]
    return loss


def build_tp_step(mesh, model, tx, *, data_axis: Optional[str] = "data",
                  model_axis: str = "model", moe_aux_coef: float = 0.01) -> Callable:
    """The uninstrumented step of :func:`make_tp_train_step` (the gossip
    x TP step runs it on each agent row)."""
    reject_dropout_model(model)
    mp = mesh[model_axis]
    if model.parallel.get(model_axis) is not mp:
        raise ValueError(f"model must be built on the mesh's {model_axis!r} axis "
                         f"(TransformerLM(tp_axis={model_axis!r}, mesh=mesh))")
    data = _axis(mesh, data_axis)
    model.set_batch_mesh(data)
    optimizer = bind_optimizer(model, tx)
    grads = model.flat_grads
    partial = [model.param_slices[name] for name in model.tp_partial_grads]
    # Seconds of the last call's collectives (the model axis's exits and
    # entries, the data axis's gradient all_reduce), read by profiling.
    step_clock = {"model_s": 0.0, "data_s": 0.0}

    def step(x_tok: torch.Tensor, y_tok: torch.Tensor) -> torch.Tensor:
        dev = model.flat_params.device
        x, y = _rows(x_tok, data).to(dev), _rows(y_tok, data).to(dev)
        mp.clock.reset()
        if data is not None:
            data.clock.reset()
        grads.zero_()
        loss = lm_loss(model, x, y, moe_aux_coef)
        loss.backward()
        if partial:
            # Leaves kept whole but read in blocks (Dense_0's bias, a
            # replicated kv_proj): each rank holds its blocks' gradient.
            buf = torch.cat([grads[0, o:o + n] for o, n in partial])
            mp.all_reduce(buf, "sum")
            i = 0
            for o, n in partial:
                grads[0, o:o + n].copy_(buf[i:i + n])
                i += n
        loss = loss.detach().reshape(1).clone()
        if data is not None:
            data.all_reduce(grads, "sum")
            grads.div_(data.size)
            data.all_reduce(loss, "sum")
            loss.div_(data.size)
        optimizer.step()
        for key, m in (("model_s", mp), ("data_s", data)):
            c = m.clock if m is not None else None
            step_clock[key] = 0.0 if c is None else c.d2h_s + c.exchange_s + c.h2d_s
        return loss[0]

    step.optimizer, step.model, step.clock = optimizer, model, step_clock
    return step


def make_tp_train_step(mesh, model, tx, *, data_axis: Optional[str] = "data",
                       model_axis: str = "model", moe_aux_coef: float = 0.01) -> Callable:
    """The data x tensor parallel step on ``mesh`` (a ``GridMesh`` with
    ``data_axis`` and ``model_axis``; without a ``data_axis`` every rank
    of the model line takes the whole batch) for this rank's ``model``, a
    ``TransformerLM(tp_axis=model_axis, mesh=mesh)`` (or one built with
    ``moe_expert_axis=model_axis``: the expert-parallel step), and ``tx``,
    an optimizer factory as ``make_optimizer`` returns (its moments sit
    beside this rank's blocks).

    ``step(x_tok, y_tok) -> loss``: the global (B, T) batch (B divisible
    by the data axis), of which this rank takes its rows; ``loss`` is the
    global mean, the same on every rank.  The gradient is averaged over
    ``data`` with one ``all_reduce`` of the flat buffer; the gradients of
    :attr:`~distributed_learning_tpu_torch.models.transformer.
    TransformerLM.tp_partial_grads` are summed over ``model`` first, so
    the whole leaves stay equal along the model line.  An MoE model's
    load-balance term joins at ``moe_aux_coef``."""
    from distributed_learning_tpu_torch.obs import instrument_step

    return instrument_step(build_tp_step(mesh, model, tx, data_axis=data_axis,
                                         model_axis=model_axis, moe_aux_coef=moe_aux_coef),
                           "tp.train_step")


def _decode_cache_spec(shape, mesh, data_axis: str = "data", model_axis: str = "model") -> P:
    """The placement of one (B, L, Hkv, Dh) cache leaf (``tp.py:231``):
    batch over ``data`` and heads over ``model``, each kept whole when it
    does not divide."""
    n_model = mesh.shape.get(model_axis, 1)
    n_data = mesh.shape.get(data_axis, 1)
    return P(data_axis if data_axis in mesh.shape and shape[0] % n_data == 0 else None, None,
             model_axis if model_axis in mesh.shape and shape[2] % n_model == 0 else None,
             None)


def constrain_decode_cache(cache, mesh, *, data_axis: str = "data", model_axis: str = "model"):
    """This rank's block of a whole KV cache (a ``KVCache`` of (B, L, Hkv,
    Dh) leaves) under the reference's cache placement: what ``make_tp_generate``'s
    model allocates on the rank."""
    from distributed_learning_tpu_torch.models.transformer import KVCache

    def block(t):
        return local_shard(t, _decode_cache_spec(t.shape, mesh, data_axis, model_axis), mesh)

    return KVCache(keys=[block(k) for k in cache.keys], values=[block(v) for v in cache.values],
                   index=cache.index, fresh=cache.fresh)


def make_tp_generate(mesh, model, *, data_axis: Optional[str] = "data",
                     model_axis: str = "model") -> Callable:
    """Tensor-parallel generation on ``mesh``: this rank's ``model`` (as
    for :func:`make_tp_train_step`) holds its query heads, its K/V heads
    of the cache (all of them under the replicated-K/V fallback) and, when
    B divides, the ``data`` rank's ``B/n`` rows.

    Returns ``gen(prompt, steps, *, key=None, temperature=0.0, top_k=None,
    top_p=None) -> (B, steps)`` tokens: ``prompt`` the global (B, Tp)
    prompt, the result gathered over ``data`` on every rank, equal to the
    one-process :func:`~distributed_learning_tpu_torch.models.transformer.
    generate`.  Sampling: ``key`` is a ``torch.Generator`` the caller
    seeds alike on every rank; each rank draws the whole batch's uniforms
    and keeps its rows, so the ranks of a model line (whose logits are
    equal, after the last all_reduce) pick the same token and the draws
    are the one-process ``generate``'s for the same seed."""
    from distributed_learning_tpu_torch.models.transformer import sample_fn, validate_sampling
    from distributed_learning_tpu_torch.obs import instrument_step

    mesh[model_axis]  # the model axis must exist
    data = _axis(mesh, data_axis)

    @torch.no_grad()
    def gen(prompt, steps, *, key=None, temperature=0.0, top_k=None, top_p=None):
        prompt = torch.as_tensor(prompt)
        B, Tp = prompt.shape
        steps = int(steps)
        validate_sampling(model, Tp, steps, key, float(temperature), top_k, top_p)
        split = data is not None and B % data.size == 0
        b = B // data.size if split else B
        rows = slice(data.agent * b, (data.agent + 1) * b) if split else slice(0, B)
        pick = sample_fn(float(temperature), top_k, top_p)
        dev = model.flat_params.device
        tokens = prompt.to(dev, torch.long)[rows][None]
        was_training = model.training
        model.eval()
        try:
            cache = model.init_cache(b)
            tok = pick(model(tokens, cache)[:, :, -1], key, torch.long, rows=rows, batch=B)
            out = torch.empty((1, b, steps), dtype=torch.long, device=dev)
            for t in range(steps):
                out[:, :, t] = tok
                tok = pick(model(tok[..., None], cache)[:, :, -1], key, torch.long,
                           rows=rows, batch=B)
        finally:
            model.train(was_training)
        out = out[0]
        if split and data.size > 1:
            out = torch.cat(data.all_gather(out).unbind(0), 0)
        return out.to(prompt.dtype)

    return instrument_step(gen, "tp.generate")
