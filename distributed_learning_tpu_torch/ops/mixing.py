"""Mixing and disagreement primitives on agent-stacked state
(port of ``distributed_learning_tpu/ops/mixing.py``, dense route).

State convention: per-agent values live in a ``{name: tensor}`` dict
whose every tensor has a leading *agent* axis of size N ("stacked").  On
one device that axis is a batch dimension and one gossip round is one
``W @ X`` GEMM per dtype bucket of the fused ``{dtype: (N, P)}`` layout.

The trainer keeps its parameters as views into one contiguous ``(N, P)``
float32 buffer (``models/transformer.py``), so its gossip rounds run on
the fused buffer in place, with no flatten/unflatten per epoch.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

__all__ = [
    "FusedLayout",
    "fused_layout",
    "flatten_stacked",
    "unflatten_stacked",
    "dense_mix",
    "global_average",
    "agent_deviations",
    "max_deviation",
]

Stacked = Dict[str, torch.Tensor]


class _LeafSlot(NamedTuple):
    """Where one stacked tensor lives inside its dtype bucket."""

    name: str
    bucket: str            # dtype name, e.g. "float32"
    offset: int            # column offset inside the (N, P_bucket) buffer
    shape: Tuple[int, ...]  # trailing (per-agent) shape; () for (N,) leaves
    size: int              # prod(shape)


class FusedLayout(NamedTuple):
    """Static metadata of a fused flat-buffer state: every stacked tensor
    raveled into ONE contiguous ``(N, P)`` buffer per storage dtype, so a
    gossip round is O(buckets) GEMMs instead of O(leaves)."""

    slots: Tuple[_LeafSlot, ...]
    buckets: Tuple[Tuple[str, int], ...]  # (dtype name, width P), sorted

    def bytes_per_round(self, n: int) -> int:
        """Bytes of state one gossip round touches for ``n`` agents."""
        return sum(n * width * itemsize(name) for name, width in self.buckets)

    def bucket_spans(self, bucket: str) -> Tuple[Tuple[int, int], ...]:
        """``(offset, size)`` leaf spans of one dtype bucket, ascending:
        they tile the bucket's ``[0, P)`` columns, one span per leaf (the
        segments a per-leaf compression budget selects against)."""
        spans = tuple((s.offset, s.size) for s in self.slots if s.bucket == bucket)
        if not spans:
            raise KeyError(bucket)
        return spans


def itemsize(bucket: str) -> int:
    """Bytes per element of a bucket's storage dtype (``"bfloat16"`` -> 2)."""
    return torch.empty((), dtype=getattr(torch, bucket)).element_size()


def _bucket_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def fused_layout(stacked: Stacked) -> FusedLayout:
    """Fused layout of a stacked dict: tensors grouped by storage dtype,
    laid out consecutively in dict order."""
    lead = None
    widths: Dict[str, int] = {}
    slots: List[_LeafSlot] = []
    for name, t in stacked.items():
        if t.dim() == 0:
            raise ValueError(
                f"fused_layout: {name!r} is a scalar — every tensor of a "
                "stacked state needs a leading agent axis"
            )
        if lead is None:
            lead = t.shape[0]
        elif t.shape[0] != lead:
            raise ValueError(
                f"fused_layout: {name!r} has leading axis {t.shape[0]}, "
                f"expected {lead} (inconsistent agent axis)"
            )
        bucket = _bucket_name(t.dtype)
        size = int(np.prod(t.shape[1:], dtype=np.int64))
        slots.append(
            _LeafSlot(name, bucket, widths.get(bucket, 0), tuple(t.shape[1:]), size)
        )
        widths[bucket] = widths.get(bucket, 0) + size
    return FusedLayout(tuple(slots), tuple(sorted(widths.items())))


def flatten_stacked(
    stacked: Stacked, layout: FusedLayout | None = None
) -> Tuple[Dict[str, torch.Tensor], FusedLayout]:
    """Ravel a stacked dict into its fused ``{dtype: (N, P)}`` buffers,
    always new memory (the input is never aliased)."""
    if layout is None:
        layout = fused_layout(stacked)
    parts: Dict[str, List[torch.Tensor]] = {}
    for slot in layout.slots:
        t = stacked[slot.name]
        parts.setdefault(slot.bucket, []).append(t.reshape(t.shape[0], slot.size))
    buffers = {name: torch.cat(p, dim=1) for name, p in parts.items()}
    return buffers, layout


def unflatten_stacked(
    buffers: Dict[str, torch.Tensor], layout: FusedLayout
) -> Stacked:
    """Inverse of :func:`flatten_stacked`: views of each tensor's columns."""
    out: Stacked = {}
    for slot in layout.slots:
        buf = buffers[slot.bucket]
        piece = buf[:, slot.offset: slot.offset + slot.size]
        out[slot.name] = piece.reshape((buf.shape[0],) + slot.shape)
    return out


@contextlib.contextmanager
def _highest_precision():
    """float32 GEMMs without TF32 inside the block, the caller's setting
    restored after it: the counterpart of the reference's
    ``Precision.HIGHEST``.  Consensus residuals are driven to ~1e-4 and
    below, which TF32's 10-bit mantissa would floor."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def dense_mix(stacked: Stacked, W: torch.Tensor, out: Stacked) -> Stacked:
    """One gossip round on the whole stacked state, ``x_a <- sum_b W[a,b]
    x_b``, written into ``out`` (the same keys, shapes and dtypes,
    contiguous), which it returns.

    Mixes in float32 whatever the storage dtype; a float32 tensor's round
    is one GEMM straight into ``out``, with no allocation.  Works on
    per-leaf stacked dicts and on fused buffers alike (both are ``{key:
    (N, ...)}``).
    """
    Wf = W.to(torch.float32)
    with _highest_precision():
        for key, x in stacked.items():
            dst = out[key]
            xf = x.reshape(x.shape[0], -1)
            if x.dtype == dst.dtype == torch.float32:
                torch.matmul(Wf, xf, out=dst.view(dst.shape[0], -1))
            else:
                dst.copy_(torch.matmul(Wf, xf.to(torch.float32)).reshape(dst.shape))
    return out


def global_average(stacked: Stacked, out: Stacked) -> Stacked:
    """Exact averaging, the ``gamma = 0`` case of a gossip round: each
    tensor's float32 mean over the agent axis, written back to every
    agent of ``out`` (which may be ``stacked`` itself), which it returns."""
    for key, x in stacked.items():
        mean = x.to(torch.float32).mean(dim=0, keepdim=True)
        out[key].copy_(mean.expand(x.shape))
    return out


def _sq_dev_from_mean(stacked: Stacked) -> torch.Tensor:
    """Per-agent squared L2 distance from the across-agent mean, summed over
    every tensor (the agent's whole flattened parameter vector)."""
    total = None
    for x in stacked.values():
        mean = x.mean(dim=0, keepdim=True)
        d = (x - mean).to(torch.float32)
        sq = (d * d).reshape(d.shape[0], -1).sum(dim=1)
        total = sq if total is None else total + sq
    return total


def agent_deviations(stacked: Stacked) -> torch.Tensor:
    """(N,) tensor: each agent's L2 distance from the mean parameter vector."""
    return torch.sqrt(_sq_dev_from_mean(stacked))


def max_deviation(stacked: Stacked) -> torch.Tensor:
    """Scalar: max over agents of :func:`agent_deviations` — the residual the
    eps-stopping rule compares against."""
    return agent_deviations(stacked).max()
