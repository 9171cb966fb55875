"""Pipeline-parallel training of the TransformerLM (port of
``distributed_learning_tpu/training/pp_lm.py``).

``training/pp.py`` pipelines any uniform stage function; this module binds
it to the port's model: the block stack is cut into ``S`` stages (or ``S
x V`` chunks for the interleaved schedule), each stage rank keeping its
blocks, while the thin ends — token / position embeddings in front, the
final LayerNorm and vocabulary head behind — are held on every rank, as
the reference replicates them.

Three schedules, the same gradients:

* :func:`make_lm_pipeline_train_step` — GPipe (``remat_stage`` keeps only
  each stage's input between forward and backward);
* :func:`make_lm_1f1b_train_step` — 1F1B: the head seeds each microbatch's
  backward at the last stage, the embeddings take stage 0's input
  cotangents (the chained embed-vjp step, :func:`_lm_chained_step`);
* :func:`make_lm_interleaved_train_step` — interleaved 1F1B over ``V``
  chunks a stage.

A step is built from this rank's ``TransformerLM`` (``n_agents=1``, on the
mesh's axes: ``tp_axis=`` / ``moe_expert_axis=`` / a sequence-parallel
``attn_impl`` with ``mesh=``), drawn whole from its seed, so the pipeline
of seed ``s`` is the one-process model of seed ``s``.  The step takes the
model over: it keeps the embeddings, the head and this rank's blocks in
one flat buffer of its own (the optimizer's) and drops the other blocks.
``step(tok_mb, y_mb) -> loss`` takes the global ``(M, mb, T)`` tokens and
pre-shifted targets; a rank takes its rows over the data axes and its
tokens over ``seq``.

Inside a stage the blocks run the model's own modes: Megatron tensor
parallelism over ``tp_axis`` (the QKV / out-projection / MLP exits'
``all_reduce`` on the rank's model line), ring / ring-flash / Ulysses
attention over ``seq`` at global positions, experts over
``expert_axis``.  Every axis that is none of these nor the stage axis is
data parallelism.  Layouts: :func:`split_lm_params` / :func:`merge_lm_params`
and :func:`stage_layout` / :func:`interleaved_stage_layout` convert a
flax-structured tree (numpy or torch leaves) as the reference's do.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from distributed_learning_tpu_torch.models._stacked import _rebind
from distributed_learning_tpu_torch.parallel.multihost import PartitionSpec as P
from distributed_learning_tpu_torch.training.fsdp import reject_dropout_model
from distributed_learning_tpu_torch.training.pp import (
    _aux_seed_value,
    _GPipe,
    _leaves,
    _Pipe,
    _Plan,
    _run_1f1b,
    _StageRunner,
    _unflatten,
    head_seed,
)

__all__ = [
    "split_lm_params",
    "merge_lm_params",
    "stage_layout",
    "interleaved_stage_layout",
    "make_lm_pipeline_train_step",
    "make_lm_1f1b_train_step",
    "make_lm_interleaved_train_step",
]

_SEQ_PARALLEL = ("ring", "ring_flash", "ulysses")


# ---------------------------------------------------------------------- #
# Layouts (flax-structured trees of numpy arrays or tensors)              #
# ---------------------------------------------------------------------- #
def _tree_map(fn, tree):
    paths, leaves = zip(*_leaves(tree)) if tree else ((), ())
    return _unflatten(list(paths), [fn(x) for x in leaves]) if paths else {}


def _stack(leaves):
    return torch.stack(list(leaves)) if isinstance(leaves[0], torch.Tensor) else np.stack(leaves)


def stage_layout(stacked, n_stages: int):
    """(L, ...) block stack -> (S, L/S, ...) per-stage groups."""
    def fold(leaf):
        L = leaf.shape[0]
        if L % n_stages:
            raise ValueError(f"{L} blocks do not divide into {n_stages} stages")
        return leaf.reshape((n_stages, L // n_stages) + tuple(leaf.shape[1:]))

    return _tree_map(fold, stacked)


def interleaved_stage_layout(stacked, n_stages: int, n_chunks: int):
    """(L, ...) block stack -> (S, V, L/(S*V), ...) chunk groups for the
    interleaved schedule: chunk ``c`` of stage ``d`` holds the blocks of
    virtual stage ``v = c*S + d``, i.e. leaf[d, c, l] = block ``(c*S +
    d)*Lc + l``."""
    S, V = n_stages, n_chunks

    def fold(leaf):
        L = leaf.shape[0]
        if L % (S * V):
            raise ValueError(f"{L} blocks do not divide into {S} stages x {V} chunks")
        Lc = L // (S * V)
        return leaf.reshape((V, S, Lc) + tuple(leaf.shape[1:])).swapaxes(0, 1)

    return _tree_map(fold, stacked)


def _outer_keys(params) -> list:
    return [k for k in params if not k.startswith("_Block_")]


def split_lm_params(model, params) -> Tuple[Any, Any]:
    """Flax param tree -> ``(outer, stacked)``: ``outer`` the embeddings
    and the final LayerNorm + head, ``stacked`` the block subtrees
    restacked on a leading ``num_layers`` axis."""
    blocks = [params[f"_Block_{i}"] for i in range(model.num_layers)]
    paths = [p for p, _ in _leaves(blocks[0])]
    cols = [[leaf for _, leaf in _leaves(b)] for b in blocks]
    stacked = _unflatten(paths, [_stack([c[j] for c in cols]) for j in range(len(paths))])
    outer = {k: params[k] for k in _outer_keys(params)}
    return outer, stacked


def merge_lm_params(model, outer, stacked, *, n_stages: Optional[int] = None,
                    n_chunks: Optional[int] = None) -> Any:
    """Inverse of :func:`split_lm_params`: rebuild the flax tree.  Pass
    ``n_stages`` when ``stacked`` is in :func:`stage_layout`'s (S, L/S,
    ...) form, and ``n_chunks`` too for :func:`interleaved_stage_layout`'s
    (S, V, Lc, ...); omit both for the (L, ...) form (the layouts are
    indistinguishable from shapes alone whenever S == L)."""
    L = model.num_layers

    def unstack(leaf):
        if n_chunks is not None:
            # (S, V, Lc, ...) -> (V, S, Lc, ...) -> (L, ...): C-order
            # flattening of [c, d, l] is block (c*S + d)*Lc + l.
            return leaf.swapaxes(0, 1).reshape((L,) + tuple(leaf.shape[3:]))
        if n_stages is not None:
            return leaf.reshape((L,) + tuple(leaf.shape[2:]))
        return leaf

    flat = _tree_map(unstack, stacked)
    params = dict(outer)
    for i in range(L):
        params[f"_Block_{i}"] = _tree_map(lambda a: a[i], flat)
    return params


def stage_layers(n_layers: int, n_stages: int, stage: int,
                 n_chunks: Optional[int] = None) -> List[List[int]]:
    """The global block indices of stage ``stage``, a list per chunk: one
    chunk of ``L/S`` consecutive blocks, or (interleaved) chunk ``c``
    holding the ``L/(S*V)`` blocks of virtual stage ``c*S + stage``."""
    if n_chunks is None:
        k = n_layers // n_stages
        return [list(range(stage * k, (stage + 1) * k))]
    k = n_layers // (n_stages * n_chunks)
    return [list(range((c * n_stages + stage) * k, (c * n_stages + stage + 1) * k))
            for c in range(n_chunks)]


# ---------------------------------------------------------------------- #
# The model's parts                                                      #
# ---------------------------------------------------------------------- #
class _LMParts:
    """Validation, the stage function over a chunk of the model's blocks,
    and the embed / head closures — what every step builder shares.

    A sequence-parallel ``attn_impl`` makes ``sp`` true (tokens split over
    ``model.seq_axis``, global positions); ``mlp="moe"`` makes each chunk
    report the mean of its blocks' load-balance aux, which the schedules
    fold into the objective at ``moe_aux_coef``."""

    def __init__(self, mesh, model, stage_axis: str, expert_axis: Optional[str] = None,
                 tp_axis: Optional[str] = None):
        reject_dropout_model(model)
        if model.attn_impl not in ("full", "flash") + _SEQ_PARALLEL:
            raise ValueError(f"unknown attn_impl {model.attn_impl!r} (want full|flash|"
                             "ring|ring_flash|ulysses)")
        axes = tuple(mesh.shape)
        self.sp = model.attn_impl in _SEQ_PARALLEL
        self.seq_axis = model.seq_axis if self.sp else None
        if self.sp and model.seq_axis not in axes:
            raise ValueError(f"attn_impl {model.attn_impl!r} needs mesh axis "
                             f"{model.seq_axis!r}; the mesh has {axes}")
        self.moe = model.mlp == "moe"
        if expert_axis is not None:
            if not self.moe:
                raise ValueError("expert_axis needs mlp='moe' — a dense LM has no expert "
                                 "kernels to shard")
            if expert_axis not in axes:
                raise ValueError(f"expert_axis {expert_axis!r} is not on the mesh {axes}")
            n_ep = mesh.shape[expert_axis]
            E = model.blocks[0].moe.num_experts
            if E % n_ep:
                raise ValueError(f"num_experts {E} must be divisible by the "
                                 f"{expert_axis!r} axis size {n_ep}")
        if tp_axis is not None:
            if self.moe:
                raise ValueError("tp_axis with mlp='moe' is not supported; shard the "
                                 "experts instead (expert_axis)")
            if tp_axis not in axes:
                raise ValueError(f"tp_axis {tp_axis!r} is not on the mesh {axes}")
            n_tp = mesh.shape[tp_axis]
            for what, val in (("num_heads", model.num_heads),
                              ("num_kv_heads", model.num_kv_heads),
                              ("mlp width", model.mlp_ratio * model.num_heads * model.head_dim)):
                if val % n_tp:
                    raise ValueError(f"{what} {val} must be divisible by the {tp_axis!r} "
                                     f"axis size {n_tp}")
        if stage_axis not in axes:
            raise ValueError(f"stage axis {stage_axis!r} is not on the mesh {axes}")
        self.S = mesh.shape[stage_axis]
        L = model.num_layers
        if L % self.S:
            raise ValueError(f"num_layers {L} must divide into {self.S} stages")
        # The port's model holds its mode's blocks: it must be built on
        # the mesh's axes the step names (and no others).
        for what, axis, built in (("tp_axis", tp_axis, model.tp_axis),
                                  ("moe_expert_axis", expert_axis, model.moe_expert_axis)):
            if axis != built or (axis is not None and model.parallel.get(axis) is not mesh[axis]):
                raise ValueError(f"the step's {what} is {axis!r} but the model was built with "
                                 f"{built!r}: build TransformerLM({what}={axis!r}, mesh=mesh) "
                                 "on this mesh")
        if self.sp and model.seq_mesh is not mesh[model.seq_axis]:
            raise ValueError(f"model's sequence-parallel attention must run on the mesh's "
                             f"{model.seq_axis!r} axis (TransformerLM(attn_impl=..., mesh=mesh))")
        self.model, self.stage_axis = model, stage_axis
        self.tp_axis, self.expert_axis = tp_axis, expert_axis
        self.use_rope = model.pos_emb == "rope"
        self.n_seq = mesh.shape[self.seq_axis] if self.sp else 1
        self.seq_agent = mesh[self.seq_axis].agent if self.sp else 0

    @property
    def extra_axes(self) -> tuple:
        return (self.seq_axis,) if self.sp else ()

    @property
    def spec_axes(self) -> tuple:
        return tuple(a for a in (self.tp_axis, self.expert_axis) if a is not None)

    @property
    def mb_spec(self) -> P:
        # (M, mb, T): dim 2 is the token dim.
        return P(None, None, self.seq_axis) if self.sp else P()

    def positions(self, T_local: int, device) -> torch.Tensor:
        """Global positions of this rank's tokens (each seq shard offset by
        its index, the ``models/transformer.py`` convention)."""
        return self.seq_agent * T_local + torch.arange(T_local, device=device)

    def stage_fn(self, chunks: List[List[nn.Module]]) -> Callable:
        """``run(c, act) -> act`` (or ``(act, aux)`` for MoE) over chunk
        ``c``'s blocks; ``act`` is ``(1, mb, T, d)``."""
        moe = self.moe

        def run(c, act):
            positions = self.positions(act.shape[-2], act.device)
            auxes = []
            for blk in chunks[c]:
                act = blk(act, positions)
                if moe:
                    auxes.append(blk.moe.aux)
                    blk.moe.aux = None
            if not moe:
                return act
            aux = auxes[0]
            for a in auxes[1:]:
                aux = aux + a
            return act, (aux / len(auxes))[0]

        return run

    def embed(self, tok: torch.Tensor) -> torch.Tensor:
        """(M, mb, T) tokens -> (M, 1, mb, T, d) embedded activations."""
        m = self.model
        M, B, T = tok.shape
        if not self.use_rope and T * self.n_seq > m.max_len:
            raise ValueError(f"sequence length {T * self.n_seq} exceeds max_len {m.max_len}")
        x = m.embed_tokens(m.embed, getattr(m, "pos_embed", None), tok.reshape(1, M * B, T),
                           self.positions(T, tok.device))
        return x[0].reshape(M, B, T, -1)[:, None]

    def head_loss(self, out: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        m = self.model
        logits = m.head(m.ln_f(out)).to(torch.float32)
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), y.reshape(-1).long())

    def head_loss_sharded(self, out: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """This seq shard's share of the microbatch loss: its token mean
        over the number of shards (the shares sum to the global mean, the
        port's form of the reference's seq-``pmean`` exit)."""
        return self.head_loss(out, y) / self.n_seq

    def build_param_specs(self, *, n_chunks: Optional[int] = None) -> Optional[dict]:
        """Per-leaf placements of the stacked stage parameters (one block's
        flax tree, each spec leading with the stage axis, then the chunk
        axis for the interleaved layout), or ``None`` for the uniform
        ``P(stage)`` default.  The block's own dims follow the model's
        layout: the Megatron split over ``tp_axis`` (the port keeps the
        MLP up bias whole, reading its columns' slice) and the experts over
        ``expert_axis``."""
        if self.expert_axis is None and self.tp_axis is None:
            return None
        from distributed_learning_tpu_torch.convert import lm_flax_path

        m = self.model
        lead = (self.stage_axis, None) if n_chunks is None else (self.stage_axis, None, None)
        block0 = [n for n in m.layout if n.startswith("blocks.0.")]
        paths = [lm_flax_path(n)[1:] for n in block0]
        specs = []
        for n in block0:
            own = tuple(m.layout[n]) + (None,) * (len(m.full_shapes[n]) - len(m.layout[n]))
            specs.append(P(*lead, *own))
        return _unflatten(paths, specs)


# ---------------------------------------------------------------------- #
# The step                                                               #
# ---------------------------------------------------------------------- #
class PipelineLMStep:
    """A pipelined LM training step on this rank (see the module
    docstring).  ``schedule`` is ``"gpipe"``, ``"1f1b"`` or
    ``"interleaved"``.  Attributes: ``model`` (taken over), ``optimizer``,
    ``layers`` (the global block indices held, a list per chunk),
    ``timing`` (the last call's seconds: ``stage_s``, ``hops_s``,
    ``broadcast_s``, ``reduce_s``), ``stats`` (stash depth and peak, or
    GPipe's graphs held)."""

    def __init__(self, schedule: str, mesh, model, tx, *, stage_axis: str = "stage",
                 remat_stage: bool = False, moe_aux_coef: float = 0.01,
                 expert_axis: Optional[str] = None, tp_axis: Optional[str] = None,
                 n_chunks: Optional[int] = None, n_microbatches: Optional[int] = None):
        from distributed_learning_tpu_torch.training.tp import bind_optimizer

        parts = _LMParts(mesh, model, stage_axis, expert_axis, tp_axis)
        if n_chunks is not None and model.num_layers % (parts.S * n_chunks):
            raise ValueError(f"num_layers {model.num_layers} must divide into {parts.S} "
                             f"stages x {n_chunks} chunks")
        self.schedule, self.parts, self.model = schedule, parts, model
        self.remat_stage, self.moe_aux_coef = bool(remat_stage), float(moe_aux_coef)
        self.n_chunks, self.n_microbatches = n_chunks, n_microbatches
        plan = _Plan(mesh, stage_axis, parts.extra_axes, parts.spec_axes)
        self.plan = plan
        self.sched = None
        if schedule == "interleaved":
            from distributed_learning_tpu_torch.training.pp_interleaved import build_schedule

            self.sched = build_schedule(plan.S, n_chunks, n_microbatches)
        if parts.moe and len(plan.data) > 1:
            raise ValueError(f"an MoE pipeline routes the batch of one data axis; the mesh has "
                             f"{plan.data_axes}")
        model.set_batch_mesh(plan.data[0] if plan.data else None)
        self.layers = stage_layers(model.num_layers, plan.S, plan.s, n_chunks)
        kept = {i for chunk in self.layers for i in chunk}
        # This rank's parameters, in the model's order, move into a buffer
        # of the step's own; the other blocks go.
        named = [(n, p) for n, p in model.named_parameters()
                 if not n.startswith("blocks.") or int(n.split(".")[1]) in kept]
        total = sum(p[0].numel() for _, p in named)
        dev = model.flat_params.device
        self.flat = torch.empty(1, total, dtype=torch.float32, device=dev)
        self.grads = torch.zeros_like(self.flat)
        slices = _rebind(model, named, self.flat, self.grads)
        for i in range(model.num_layers):
            if i not in kept:
                model.blocks[i] = nn.Module()
        model.flat_params, model.flat_grads, model.param_slices = self.flat, self.grads, slices
        heads = [slices[n] for n in slices if n.startswith(("ln_f.", "head."))]
        self.head_range = (min(o for o, _ in heads), max(o + n for o, n in heads))
        self.partial = [slices[n] for n in model.tp_partial_grads if n in slices]
        self.chunks = [[model.blocks[i] for i in chunk] for chunk in self.layers]
        self.runner = _StageRunner(parts.stage_fn(self.chunks), parts.moe)
        self.optimizer = bind_optimizer(model, tx)
        self.timing: Dict[str, float] = {}
        self.stats: Dict[str, int] = {}

    # -- state --------------------------------------------------------- #
    def local_params(self) -> Dict[str, torch.Tensor]:
        """``{port name: (1, ...) view}`` of what this rank holds: the
        embeddings, the head and its blocks (global names)."""
        return self.model.stacked_parameters()

    # -- the step ------------------------------------------------------ #
    def __call__(self, tok_mb, y_mb) -> torch.Tensor:
        parts, plan, model = self.parts, self.plan, self.model
        dev = self.flat.device
        tok = plan.block(torch.as_tensor(tok_mb), parts.mb_spec).to(dev).long()
        y = plan.block(torch.as_tensor(y_mb), parts.mb_spec).to(dev).long()
        M = tok.shape[0]
        if self.n_microbatches is not None and M != self.n_microbatches:
            raise ValueError(f"schedule was built for {self.n_microbatches} microbatches, "
                             f"got {M}")
        plan.clock.reset()
        self.grads.zero_()
        x = parts.embed(tok)
        share = 1.0 / (parts.n_seq * plan.n_data)  # this rank's share of the global mean
        coef = self.moe_aux_coef if parts.moe else None
        if self.schedule == "gpipe":
            loss = self._gpipe(x, y, share, coef)
        else:
            loss = _lm_chained_step(self, x, y, M, coef)
        self._finish(loss)
        self.optimizer.step()
        self.timing = plan.clock.read()
        return loss[0]

    def _gpipe(self, x, y, share, coef):
        """GPipe: the interior is one ``_GPipe`` call whose outputs stay on
        the last stage, which runs the head; every other rank drives the
        interior's backward with a zero output cotangent."""
        plan, parts = self.plan, self.parts
        pipe = _Pipe(plan, lambda aliases: self.runner, self.remat_stage, parts.moe)
        pipe.replicate_outputs = False
        res = _GPipe.apply(pipe, x)
        out, aux = res if parts.moe else (res, None)
        self.stats = dict(pipe.stats)
        last = plan.s == plan.S - 1
        if last:
            # (M, 1, mb, T, d) -> the one agent's (1, M*mb, T, d).
            obj = parts.head_loss(out[:, 0].reshape(1, -1, *out.shape[-2:]), y) * share
            if aux is not None:
                obj = obj + coef * aux * share
            obj.backward()
            return obj.detach().reshape(1).to(torch.float32).clone()
        outs, cots = [out], [torch.zeros_like(out)]
        if aux is not None:
            outs.append(aux)
            cots.append(torch.full_like(aux, coef * share))
        torch.autograd.backward(outs, cots)
        return torch.zeros(1, dtype=torch.float32, device=x.device)

    def _finish(self, loss: torch.Tensor) -> None:
        """The last stage's loss and head gradient broadcast over the stage
        line (written back on every rank), then the loss and the whole
        gradient summed over the extra and data axes (the shares make that
        the global mean), and the tensor-parallel partial gradients over
        the model axis."""
        plan = self.plan
        h0, h1 = self.head_range
        head = torch.cat([loss.reshape(1), self.grads[0, h0:h1]])
        plan.broadcast(head, plan.S - 1)
        loss.copy_(head[:1])
        self.grads[0, h0:h1].copy_(head[1:])
        if plan.extras or plan.data:
            plan.reduce(self.grads)
            plan.reduce(loss)
        if self.partial:
            mp = plan.mesh[self.parts.tp_axis]
            buf = torch.cat([self.grads[0, o:o + n] for o, n in self.partial])
            with plan.clock.host("reduce_s"):
                mp.all_reduce(buf, "sum")
            i = 0
            for o, n in self.partial:
                self.grads[0, o:o + n].copy_(buf[i:i + n])
                i += n


def make_lm_pipeline_train_step(mesh, model, tx, *, stage_axis: str = "stage",
                                remat_stage: bool = False, moe_aux_coef: float = 0.01,
                                expert_axis: Optional[str] = None,
                                tp_axis: Optional[str] = None) -> PipelineLMStep:
    """The GPipe LM step on ``mesh`` (a ``GridMesh`` with ``stage_axis``)
    for this rank's ``model`` and ``tx``, an optimizer factory as
    ``make_optimizer`` returns (its state beside this rank's parameters).

    ``step(tok_mb, y_mb) -> loss``: (M, mb, T) int tokens and pre-shifted
    targets, the global arrays; ``loss`` the mean microbatch loss (plus
    ``moe_aux_coef`` times the per-layer mean load-balance aux for an MoE
    model), the same on every rank.  A sequence-parallel ``attn_impl``
    needs ``model.seq_axis`` on the mesh; ``dropout_rate`` must be 0."""
    return PipelineLMStep("gpipe", mesh, model, tx, stage_axis=stage_axis,
                          remat_stage=remat_stage, moe_aux_coef=moe_aux_coef,
                          expert_axis=expert_axis, tp_axis=tp_axis)


def _lm_chained_step(step, x, y, M, coef):
    """The embed-vjp -> inner schedule sequence that the head-seeded LM
    steps (1F1B, interleaved) share: the executor runs on the embedded
    microbatches ``x`` (their graph kept), the head seeding at the last
    (virtual) stage; stage 0's input cotangents, broadcast over the
    stage line, feed the embeddings' backward on every rank.  Returns
    this rank's loss (the last stage's is broadcast by the caller's
    :meth:`PipelineLMStep._finish`)."""
    from distributed_learning_tpu_torch.training.pp_interleaved import _run_interleaved

    plan, parts = step.plan, step.parts
    V = step.n_chunks or 1
    scale = 1.0 / (M * plan.n_data)
    aux_seed = 0.0
    if coef is not None:
        aux_seed = _aux_seed_value(coef, M, plan.S * V, [parts.n_seq]) / plan.n_data
    hfn = lambda hp, o, yy: parts.head_loss_sharded(o, yy)  # noqa: E731
    head = lambda o, yy: head_seed(hfn, {}, o, yy, scale)  # noqa: E731
    xd = x.detach()
    if step.schedule == "1f1b":
        res = _run_1f1b(plan, step.runner, xd, y, M, head, scale, aux_seed, True)
    else:
        res = _run_interleaved(plan, step.sched, V, step.runner, xd, y, head, scale, aux_seed,
                               True)
    step.stats = {"stash_depth": res["stash"].depth, "stash_peak": res["stash"].peak}
    loss = res["loss"].reshape(1).clone()
    if coef is not None:
        aux = plan.stage_sum(res["aux"].reshape(1).clone())
        loss = loss + aux * coef / (plan.S * V * M * parts.n_seq * plan.n_data)
    d_x = torch.stack(res["d_in"]) if plan.s == 0 else torch.empty_like(xd)
    plan.broadcast(d_x, 0)
    torch.autograd.backward(x, d_x)
    return loss


def make_lm_1f1b_train_step(mesh, model, tx, *, stage_axis: str = "stage",
                            moe_aux_coef: float = 0.01, expert_axis: Optional[str] = None,
                            tp_axis: Optional[str] = None) -> PipelineLMStep:
    """The contract of :func:`make_lm_pipeline_train_step` under 1F1B
    (stash depth ``min(M, 2S-1)``): the head seeds each microbatch's
    backward at the last stage (its gradient accumulated there and
    broadcast), the embeddings train through stage 0's input cotangents."""
    return PipelineLMStep("1f1b", mesh, model, tx, stage_axis=stage_axis,
                          moe_aux_coef=moe_aux_coef, expert_axis=expert_axis, tp_axis=tp_axis)


def make_lm_interleaved_train_step(mesh, model, tx, n_chunks: int, n_microbatches: int, *,
                                   stage_axis: str = "stage", moe_aux_coef: float = 0.01,
                                   expert_axis: Optional[str] = None,
                                   tp_axis: Optional[str] = None) -> PipelineLMStep:
    """The LM under the interleaved 1F1B schedule: the contract of
    :func:`make_lm_1f1b_train_step` with ``n_chunks`` chunks a stage
    (chunk ``c`` of stage ``d`` the blocks of virtual stage ``c*S + d``)
    and exactly ``n_microbatches`` microbatches a call."""
    return PipelineLMStep("interleaved", mesh, model, tx, stage_axis=stage_axis,
                          moe_aux_coef=moe_aux_coef, expert_axis=expert_axis, tp_axis=tp_axis,
                          n_chunks=n_chunks, n_microbatches=n_microbatches)
