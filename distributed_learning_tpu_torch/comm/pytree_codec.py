"""Model tree <-> flat wire vector adapter for the comm backend (port of
``distributed_learning_tpu/comm/pytree_codec.py``).

A model crosses the wire as ``(flat float32 vector, TreeSpec)``: the spec
(the tree's structure and each leaf's shape and dtype) is static and equal
on every agent, and only the vector touches the network.  The tree here
is a nested mapping (lists and tuples too) of torch tensors, such as one
agent's parameters under flax's names (``convert.py``).

The ravel is the JAX package's, to the bit: leaves in ``jax.tree.flatten``
order, which sorts every mapping's keys (``torch.utils._pytree`` keeps
insertion order, so it is not used), each leaf cast to float32 and
raveled in C order.  :meth:`TreeSpec.dtype_buckets` names dtypes as numpy
does (``"bfloat16"``, ``"float32"``), so the fused sparse frame's
sections come in the reference's order.

:func:`tree_to_flat` of tensors on the card makes one device-to-host copy
of the whole ravel, into a pinned float32 buffer, and returns it as a
numpy array over that buffer; :func:`flat_to_tree` makes one host-to-device
copy (fast from a pinned array) and cuts the leaves out of it on the
device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from distributed_learning_tpu_torch.device import resolve_device
from distributed_learning_tpu_torch.ops.mixing import _bucket_name as dtype_name

__all__ = ["TreeSpec", "tree_to_flat", "flat_to_tree"]

Tree = Any

_FLOAT_DTYPES = (torch.float16, torch.bfloat16, torch.float32, torch.float64,
                 torch.float8_e4m3fn, torch.float8_e5m2)


def _flatten(tree: Tree, leaves: List[torch.Tensor]):
    """Append ``tree``'s leaves to ``leaves`` in ``jax.tree.flatten``
    order and return its structure."""
    if isinstance(tree, Mapping):
        keys = sorted(tree)
        return ("dict", tuple((k, _flatten(tree[k], leaves)) for k in keys))
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__, tuple(_flatten(t, leaves) for t in tree))
    leaves.append(tree if isinstance(tree, torch.Tensor) else torch.as_tensor(tree))
    return None


def _unflatten(structure, leaves) -> Tree:
    if structure is None:
        return next(leaves)
    kind, children = structure
    if kind == "dict":
        return {k: _unflatten(c, leaves) for k, c in children}
    seq = [_unflatten(c, leaves) for c in children]
    return seq if kind == "list" else tuple(seq)


@dataclasses.dataclass(frozen=True)
class TreeSpec:
    """Static description of a flattened tree: enough to rebuild it from
    the wire vector.  Equal specs on every agent are the deployment
    invariant (same model class and configuration, same spec)."""

    treedef: Any
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[torch.dtype, ...]

    @property
    def sizes(self) -> Tuple[int, ...]:
        return tuple(int(np.prod(s, dtype=np.int64)) for s in self.shapes)

    @property
    def total(self) -> int:
        return int(sum(self.sizes))

    def dtype_buckets(self) -> Tuple[Tuple[str, Tuple[Tuple[int, int], ...]], ...]:
        """Leaf spans of the wire ravel grouped by original storage dtype:
        ``((dtype_name, ((offset, size), ...)), ...)``, names sorted,
        offsets ascending flat positions into the float32 wire vector.
        The fused sparse frame (``tensor_codec.encode_fused_sparse``)
        ships one ``indices|values`` section per bucket, bf16-origin
        leaves on a bf16 value section."""
        by_dtype: dict = {}
        off = 0
        for dt, size in zip(self.dtypes, self.sizes):
            by_dtype.setdefault(dtype_name(dt), []).append((off, size))
            off += size
        return tuple((name, tuple(spans)) for name, spans in sorted(by_dtype.items()))


def tree_to_flat(tree: Tree) -> Tuple[np.ndarray, TreeSpec]:
    """Flatten a tree of floating tensors (all on one device) into one
    float32 wire vector plus its spec.  On the card the leaves are
    raveled into one device buffer and copied to the host once, into
    pinned memory; the numpy array returned keeps that buffer alive.

    Non-float leaves are rejected: gossip averages values, which means
    nothing for integer state (step counters); mix the parameters and
    keep such state local."""
    leaves: List[torch.Tensor] = []
    treedef = _flatten(tree, leaves)
    for leaf in leaves:
        if leaf.dtype not in _FLOAT_DTYPES:
            raise TypeError(f"cannot gossip non-float leaf of dtype {dtype_name(leaf.dtype)}; "
                            "flatten only the model parameters")
    spec = TreeSpec(treedef=treedef, shapes=tuple(tuple(t.shape) for t in leaves),
                    dtypes=tuple(t.dtype for t in leaves))
    if not leaves:
        return np.zeros(0, np.float32), spec
    devices = {t.device for t in leaves}
    if len(devices) != 1:
        raise ValueError(f"tree leaves lie on several devices: {sorted(map(str, devices))}")
    with torch.no_grad():
        ravel = torch.cat([t.detach().reshape(-1).to(torch.float32) for t in leaves])
        if ravel.device.type == "cuda":
            host = torch.empty(ravel.numel(), dtype=torch.float32, pin_memory=True)
            host.copy_(ravel)
            ravel = host
    return ravel.numpy(), spec


def flat_to_tree(flat: np.ndarray, spec: TreeSpec,
                 device: Optional[Union[str, torch.device]] = None) -> Tree:
    """Rebuild the tree from a wire vector on ``device`` (the card unless
    ``device="cpu"``; see :func:`~distributed_learning_tpu_torch.device.resolve_device`),
    each leaf in its original shape and dtype.  One host-to-device copy;
    float32 leaves are views of the copied vector."""
    dev = resolve_device(device)
    flat = np.ascontiguousarray(flat, dtype=np.float32).ravel()
    if flat.size != spec.total:
        raise ValueError(f"wire vector has {flat.size} elements, spec expects {spec.total}")
    with torch.no_grad():
        src = torch.from_numpy(flat)
        buf = src.to(dev) if dev.type == "cuda" else src.clone()
        leaves, off = [], 0
        for shape, dtype, size in zip(spec.shapes, spec.dtypes, spec.sizes):
            leaves.append(buf[off:off + size].view(shape).to(dtype))
            off += size
    return _unflatten(spec.treedef, iter(leaves))
