"""Carry weights (and BatchNorm statistics) across from the JAX package's
models, both ways, per agent or stacked with a leading agent axis.  This
module works on numpy arrays only and imports nothing of the JAX
package.

**Vision zoo, MLP** (``models/vision.py``, ``models/mlp.py``): the port's
names ARE flax's paths joined with dots (``_WideBasic_0.Conv_1.kernel``),
because the port's modules take flax's automatic names as they are built
(``models/_stacked.add_child``), so the map needs no table.  The one
change of layout: conv kernels are HWIO in flax and OIHW in the port,
transposed here and nowhere else (a kernel of 4 axes per agent is a conv
kernel; dense kernels keep flax's ``(in, out)``).  A ``batch_stats`` tree
(``.../BatchNorm_0/{mean, var}``) maps the same way, with nothing to
transpose.

**TransformerLM**: the flax tree, as nested dicts of numpy arrays:

* top level: ``Embed_0/embedding (V, d)``, ``Embed_1/embedding
  (max_len, d)`` (learned positions only; none under rope),
  ``_Block_i/...``, ``LayerNorm_0/{scale, bias}``, ``Dense_0/{kernel
  (d, V), bias}``;
* inside a block: ``LayerNorm_0``, ``LayerNorm_1``,
  ``_Attention_0/DenseGeneral_0/kernel (d, 3, H, Dh)`` or, with grouped
  queries, ``_Attention_0/q_proj/kernel (d, H, Dh)`` and
  ``_Attention_0/kv_proj/kernel (d, 2, Hkv, Dh)``,
  ``_Attention_0/DenseGeneral_1/kernel (H, Dh, d)``, then ``Dense_0 (d,
  4d)`` and ``Dense_1 (4d, d)`` with biases, or with ``mlp="moe"``
  ``MoEMLP_0/{gate/kernel (d, E), w_up (E, d, h), b_up (E, h), w_dn
  (E, h, d), b_dn (E, d)}``.

The port keeps flax's per-agent shapes (kernels ``(in, out)``), so the
mapping is a renaming by the tables below; nothing is transposed.

**Model-parallel layouts** (:func:`flax_to_torch_shards`): a rank of a
tensor-, expert- or data-parallel grid holds blocks of the leaves, the
blocks the reference's ``PartitionSpec`` puts on the device of its index
(``"tp"``: ``training/tp.py``'s rules; ``"ep"``: ``models/moe.py``'s
``moe_param_spec``; ``"fsdp"``: ``training/fsdp.py``'s ``fsdp_spec``),
so a test loads one full init on both sides.

**Pipeline layouts** (:func:`flax_stage_block`, :func:`pipeline_to_flax`):
a JAX ``pp_lm`` tree (``outer`` and the stacked stage layout) to what one
rank of the port's pipeline holds, and the ranks' parameters back to one
flax tree through ``pp_lm.merge_lm_params``.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional

import numpy as np

__all__ = ["flax_stage_block", "flax_to_torch", "flax_to_torch_shards", "lm_flax_path",
           "pipeline_to_flax", "torch_to_flax"]

_TOP = {
    ("Embed_0", "embedding"): "embed",
    ("Embed_1", "embedding"): "pos_embed",
    ("LayerNorm_0", "scale"): "ln_f.scale",
    ("LayerNorm_0", "bias"): "ln_f.bias",
    ("Dense_0", "kernel"): "head.kernel",
    ("Dense_0", "bias"): "head.bias",
}
_BLOCK = {
    ("LayerNorm_0", "scale"): "ln1.scale",
    ("LayerNorm_0", "bias"): "ln1.bias",
    ("LayerNorm_1", "scale"): "ln2.scale",
    ("LayerNorm_1", "bias"): "ln2.bias",
    ("_Attention_0", "DenseGeneral_0", "kernel"): "attn.qkv",
    ("_Attention_0", "q_proj", "kernel"): "attn.q_proj",
    ("_Attention_0", "kv_proj", "kernel"): "attn.kv_proj",
    ("_Attention_0", "DenseGeneral_1", "kernel"): "attn.out",
    ("Dense_0", "kernel"): "fc1.kernel",
    ("Dense_0", "bias"): "fc1.bias",
    ("Dense_1", "kernel"): "fc2.kernel",
    ("Dense_1", "bias"): "fc2.bias",
    ("MoEMLP_0", "gate", "kernel"): "moe.gate",
    ("MoEMLP_0", "w_up"): "moe.w_up",
    ("MoEMLP_0", "b_up"): "moe.b_up",
    ("MoEMLP_0", "w_dn"): "moe.w_dn",
    ("MoEMLP_0", "b_dn"): "moe.b_dn",
}
_BLOCK_RE = re.compile(r"_Block_(\d+)")


def _walk(tree: Mapping[str, Any], prefix=()):
    for key, val in tree.items():
        path = prefix + (str(key),)
        if isinstance(val, Mapping):
            yield from _walk(val, path)
        else:
            yield path, val


def _is_lm(tree: Mapping[str, Any]) -> bool:
    return "Embed_0" in tree or any(_BLOCK_RE.fullmatch(str(k)) for k in tree)


def _lm_name(path) -> Optional[str]:
    m = _BLOCK_RE.fullmatch(path[0])
    if m:
        name = _BLOCK.get(path[1:])
        return None if name is None else f"blocks.{m.group(1)}.{name}"
    return _TOP.get(path)


def _conv_axes(arr: np.ndarray, stacked: bool, to_torch: bool):
    """The transpose between flax's HWIO and the port's OIHW conv kernel,
    or None for any other leaf."""
    if arr.ndim not in (2 + stacked, 4 + stacked):
        raise ValueError(
            f"a kernel of shape {arr.shape} is neither a dense nor a conv kernel "
            f"{'with' if stacked else 'without'} a leading agent axis (n_agents)")
    if arr.ndim != 4 + stacked:
        return None
    axes = (3, 2, 0, 1) if to_torch else (2, 3, 1, 0)
    return (0,) + tuple(a + 1 for a in axes) if stacked else axes


def flax_to_torch(params: Mapping[str, Any], n_agents: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Map a flax params tree, or a ``batch_stats`` tree, of a model of
    the zoo (a ``{"params": ...}`` or ``{"batch_stats": ...}`` wrapper is
    accepted) to the port's ``{name: array}``.

    With ``n_agents``, every leaf is taken as stacked ``(n_agents, ...)``
    and must carry that leading axis; without it the leaves are one
    agent's and the caller's model broadcasts them."""
    if len(params) == 1 and next(iter(params)) in ("params", "batch_stats"):
        params = next(iter(params.values()))
    lm = _is_lm(params)
    out: Dict[str, np.ndarray] = {}
    for path, leaf in _walk(params):
        arr = np.asarray(leaf)
        if arr.dtype != np.float64:  # float64 stays (a float64 oracle's grads)
            arr = arr.astype(np.float32)
        if lm:
            name = _lm_name(path)
        else:
            name = ".".join(path)
            if path[-1] == "kernel":
                axes = _conv_axes(arr, n_agents is not None, to_torch=True)
                if axes is not None:
                    arr = np.ascontiguousarray(arr.transpose(axes))
        if name is None:
            raise KeyError(f"no port parameter for flax path {'/'.join(path)}")
        if n_agents is not None and (arr.ndim == 0 or arr.shape[0] != n_agents):
            raise ValueError(
                f"{'/'.join(path)} has shape {arr.shape}; expected a leading "
                f"agent axis of {n_agents}"
            )
        out[name] = arr
    return out


def torch_to_flax(params: Mapping[str, Any], n_agents: Optional[int] = None) -> Dict[str, Any]:
    """Inverse of :func:`flax_to_torch`: ``{name: array}`` back to the
    nested flax tree, stacked when ``n_agents`` is given (the leaves must
    then carry that leading axis) and per agent otherwise."""
    inv_top = {v: k for k, v in _TOP.items()}
    inv_block = {v: k for k, v in _BLOCK.items()}
    lm = "embed" in params
    tree: Dict[str, Any] = {}
    for name, arr in params.items():
        arr = np.asarray(arr)
        if not lm:
            path = tuple(name.split("."))
            if path[-1] == "kernel":
                axes = _conv_axes(arr, n_agents is not None, to_torch=False)
                if axes is not None:
                    arr = np.ascontiguousarray(arr.transpose(axes))
        elif name.startswith("blocks."):
            _, idx, rest = name.split(".", 2)
            path = (f"_Block_{idx}",) + inv_block[rest]
        else:
            path = inv_top[name]
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = arr
    return tree


def lm_flax_path(name: str) -> tuple:
    """The flax path of a TransformerLM parameter of the port
    (``blocks.0.fc1.kernel`` -> ``("_Block_0", "Dense_0", "kernel")``)."""
    if name.startswith("blocks."):
        _, idx, rest = name.split(".", 2)
        return (f"_Block_{idx}",) + {v: k for k, v in _BLOCK.items()}[rest]
    return {v: k for k, v in _TOP.items()}[name]


def flax_to_torch_shards(params: Mapping[str, Any], mesh, layout: str, *,
                         n_agents: Optional[int] = None, agents_axis: str = "agents",
                         model_axis: str = "model", data_axis: str = "data",
                         expert_axis: str = "expert") -> Dict[str, np.ndarray]:
    """A full TransformerLM flax tree to this rank's blocks under
    ``layout`` (``"tp"``, ``"ep"`` or ``"fsdp"``) on ``mesh`` (a
    ``GridMesh`` or a ``multihost.MeshPosition``), as port names.  With
    ``n_agents`` the leaves are stacked and the rank keeps its agent's row
    along ``agents_axis`` too (a (1, ...) block)."""
    import torch

    from distributed_learning_tpu_torch.models.moe import moe_param_spec
    from distributed_learning_tpu_torch.parallel.multihost import local_shard
    from distributed_learning_tpu_torch.training.fsdp import fsdp_spec
    from distributed_learning_tpu_torch.training.tp import (
        divisible_or_replicated,
        transformer_tp_rules,
    )

    out: Dict[str, np.ndarray] = {}
    for name, arr in flax_to_torch(params, n_agents=n_agents).items():
        path = lm_flax_path(name)
        leaf = torch.empty(arr.shape[1:] if n_agents is not None else arr.shape, device="meta")
        if layout == "tp":
            spec = divisible_or_replicated(transformer_tp_rules(path, leaf, model_axis), leaf,
                                           mesh, model_axis)
        elif layout == "ep":
            spec = moe_param_spec(path, leaf, expert_axis)
        elif layout == "fsdp":
            spec = fsdp_spec(leaf, mesh.shape[data_axis], data_axis)
        else:
            raise ValueError(f"unknown layout {layout!r} (want tp|ep|fsdp)")
        if n_agents is not None:
            spec = (agents_axis,) + tuple(spec)
        out[name] = np.ascontiguousarray(local_shard(arr, spec, mesh))
    return out


def flax_stage_block(model, outer: Mapping[str, Any], stages: Mapping[str, Any], mesh, *,
                     n_chunks: Optional[int] = None, stage_axis: str = "stage",
                     layout: Optional[str] = None, **axes) -> Dict[str, np.ndarray]:
    """A JAX pipeline's parameters — ``outer`` and the stacked ``stages``
    in ``pp_lm.stage_layout``'s (S, L/S, ...) or, with ``n_chunks``,
    ``interleaved_stage_layout``'s (S, V, Lc, ...) form (numpy leaves) —
    to what this rank of ``mesh`` (a ``GridMesh`` or a
    ``multihost.MeshPosition``) holds in the port's pipeline, as port
    names: the embeddings and the head whole, and the blocks of its stage
    (global indices), each cut by :func:`flax_to_torch_shards`'s
    ``layout`` (``"tp"`` or ``"ep"``) where the stage is also split over
    the model or expert axis.  ``model`` gives the layer count."""
    from distributed_learning_tpu_torch.training.pp_lm import merge_lm_params, stage_layers

    S = mesh.shape[stage_axis]
    whole = merge_lm_params(model, outer, stages, n_stages=S, n_chunks=n_chunks)
    conv = (flax_to_torch_shards(whole, mesh, layout, **axes) if layout is not None
            else flax_to_torch(whole))
    kept = {i for chunk in stage_layers(model.num_layers, S, mesh.coords[stage_axis], n_chunks)
            for i in chunk}
    return {k: v for k, v in conv.items()
            if not k.startswith("blocks.") or int(k.split(".")[1]) in kept}


def pipeline_to_flax(model, rank_params, shape: Mapping[str, int], *,
                     stage_axis: str = "stage",
                     split_axes=("model", "expert")) -> Dict[str, Any]:
    """The ranks' pipeline parameters back to one flax tree:
    ``rank_params[r]`` is rank ``r``'s ``{port name: (1, ...) array}``
    (its ``PipelineLMStep.local_params()``, ranks row-major over
    ``shape``); ``model`` is a one-process ``TransformerLM`` of the same
    configuration, whose parameters give the whole shapes.  A block held
    in parts along a model or expert axis (``split_axes``) is joined along
    the dimension its part is short in; every stage's blocks are stacked
    into ``pp_lm.stage_layout``'s form and merged by ``merge_lm_params``."""
    from distributed_learning_tpu_torch.parallel.multihost import MeshPosition
    from distributed_learning_tpu_torch.training.pp_lm import (
        merge_lm_params,
        split_lm_params,
        stage_layout,
    )

    split = next((a for a in split_axes if a in shape), None)
    whole: Dict[str, np.ndarray] = {}
    for name, p in model.stacked_parameters().items():
        full = tuple(p.shape[1:])
        holders = [r for r, params in enumerate(rank_params) if name in params]
        if not holders:
            raise KeyError(f"no rank holds {name}")
        arr = np.asarray(rank_params[holders[0]][name])[0]
        if arr.shape == full:
            whole[name] = arr
            continue
        dim = next(d for d in range(len(full)) if arr.shape[d] != full[d])
        first = MeshPosition.of_rank(shape, holders[0]).coords
        parts = {}
        for r in holders:
            c = MeshPosition.of_rank(shape, r).coords
            if all(c[a] == first[a] for a in shape if a != split):
                parts[c[split]] = np.asarray(rank_params[r][name])[0]
        whole[name] = np.concatenate([parts[i] for i in sorted(parts)], dim)
    outer, stacked = split_lm_params(model, torch_to_flax(whole))
    S = shape[stage_axis]
    return merge_lm_params(model, outer, stage_layout(stacked, S), n_stages=S)
