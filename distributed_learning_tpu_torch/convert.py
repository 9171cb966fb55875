"""Carry weights across from the JAX package's ``TransformerLM``.

The flax tree, as nested dicts of numpy arrays (per agent, or stacked
with a leading agent axis):

* top level: ``Embed_0/embedding (V, d)``, ``Embed_1/embedding
  (max_len, d)``, ``_Block_i/...``, ``LayerNorm_0/{scale, bias}``,
  ``Dense_0/{kernel (d, V), bias}``;
* inside a block: ``LayerNorm_0``, ``LayerNorm_1``,
  ``_Attention_0/DenseGeneral_0/kernel (d, 3, H, Dh)``,
  ``_Attention_0/DenseGeneral_1/kernel (H, Dh, d)``, ``Dense_0 (d, 4d)``
  and ``Dense_1 (4d, d)`` with biases.

The port keeps flax's per-agent shapes (kernels ``(in, out)``), so the
mapping is a renaming; nothing is transposed.  This module works on numpy
arrays only and imports nothing of the JAX package.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional

import numpy as np

__all__ = ["flax_to_torch", "torch_to_flax"]

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
    ("_Attention_0", "DenseGeneral_1", "kernel"): "attn.out",
    ("Dense_0", "kernel"): "fc1.kernel",
    ("Dense_0", "bias"): "fc1.bias",
    ("Dense_1", "kernel"): "fc2.kernel",
    ("Dense_1", "bias"): "fc2.bias",
}
_BLOCK_RE = re.compile(r"_Block_(\d+)")


def _walk(tree: Mapping[str, Any], prefix=()):
    for key, val in tree.items():
        path = prefix + (str(key),)
        if isinstance(val, Mapping):
            yield from _walk(val, path)
        else:
            yield path, val


def flax_to_torch(params: Mapping[str, Any], n_agents: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Map a flax ``TransformerLM`` params tree (a ``{"params": ...}``
    wrapper is accepted) to the port's ``{name: array}``.

    With ``n_agents``, every leaf is taken as stacked ``(n_agents, ...)``
    and must carry that leading axis; without it the leaves are one
    agent's and the caller's model broadcasts them."""
    if "params" in params and len(params) == 1:
        params = params["params"]
    out: Dict[str, np.ndarray] = {}
    for path, leaf in _walk(params):
        arr = np.asarray(leaf, dtype=np.float32)
        m = _BLOCK_RE.fullmatch(path[0])
        if m:
            name = _BLOCK.get(path[1:])
            if name is not None:
                name = f"blocks.{m.group(1)}.{name}"
        else:
            name = _TOP.get(path)
        if name is None:
            raise KeyError(f"no port parameter for flax path {'/'.join(path)}")
        if n_agents is not None and (arr.ndim == 0 or arr.shape[0] != n_agents):
            raise ValueError(
                f"{'/'.join(path)} has shape {arr.shape}; expected a leading "
                f"agent axis of {n_agents}"
            )
        out[name] = arr
    return out


def torch_to_flax(params: Mapping[str, Any]) -> Dict[str, Any]:
    """Inverse of :func:`flax_to_torch`: ``{name: array}`` back to the
    nested flax tree (arrays as given, stacked or not)."""
    inv_top = {v: k for k, v in _TOP.items()}
    inv_block = {v: k for k, v in _BLOCK.items()}
    tree: Dict[str, Any] = {}
    for name, arr in params.items():
        if name.startswith("blocks."):
            _, idx, rest = name.split(".", 2)
            path = (f"_Block_{idx}",) + inv_block[rest]
        else:
            path = inv_top[name]
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.asarray(arr)
    return tree
