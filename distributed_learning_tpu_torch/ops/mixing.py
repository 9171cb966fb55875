"""Mixing and disagreement primitives on agent-stacked state
(port of ``distributed_learning_tpu/ops/mixing.py``, dense route).

State convention: per-agent values live in a ``{name: tensor}`` dict
whose every tensor has a leading *agent* axis of size N ("stacked").  On
one device that axis is a batch dimension and one gossip round is one
``W @ X`` GEMM per dtype bucket of the fused ``{dtype: (N, P)}`` layout.

The trainer keeps its parameters as views into one contiguous ``(N, P)``
float32 buffer (``models/transformer.py``), so its gossip rounds run on
the fused buffer in place, with no flatten/unflatten per epoch.

The async and Byzantine-robust rounds follow the reference's
effective-matrix discipline: staleness (:func:`stale_weight_matrix`) and
clipping (:func:`clip_weight_matrix`) reweight W's off-diagonal with the
lost mass placed on the diagonal, and trimming (:func:`trimmed_mix`) adds
a correction that is exactly 0.0 at ``trim=0``, so at the neutral knobs
each round runs the plain round's GEMM and equals it bitwise.  Nothing
here reads a device value back to the host, indexes with a boolean mask
or calls a median op, so a CUDA graph can capture every round.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

__all__ = [
    "stack_trees",
    "unstack_tree",
    "FusedLayout",
    "fused_layout",
    "flatten_stacked",
    "unflatten_stacked",
    "dense_mix",
    "fused_dense_mix",
    "fused_max_deviation",
    "global_average",
    "agent_deviations",
    "max_deviation",
    "max_std",
    "weighted_lift",
    "weighted_readout",
    "stale_weight_matrix",
    "presence_weight_matrix",
    "stale_weighted_mix",
    "pairwise_sq_dists",
    "clip_weight_matrix",
    "adaptive_clip_radius",
    "clipped_mix",
    "trim_counts",
    "trimmed_mix",
]

Stacked = Dict[str, torch.Tensor]
Tree = Union[torch.Tensor, Dict[str, torch.Tensor]]


def _leaf(v) -> torch.Tensor:
    return v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))


def stack_trees(trees: Sequence[Tree]) -> Tree:
    """Stack N per-agent values (each a tensor, an array or a ``{name:
    tensor}`` dict of one structure) into one with a leading agent axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: torch.stack([_leaf(t[k]) for t in trees], dim=0) for k in first}
    return torch.stack([_leaf(t) for t in trees], dim=0)


def unstack_tree(stacked: Tree, n: int) -> List[Tree]:
    """Split the leading agent axis back into N per-agent values (views).

    Every tensor must carry the leading agent axis of size ``n`` (the
    :func:`stack_trees` invariant); one without it is rejected rather
    than handed to every agent, which would alias one state n ways.
    """
    leaves = stacked.items() if isinstance(stacked, dict) else [("", stacked)]
    for name, x in leaves:
        shape = tuple(getattr(x, "shape", ()))
        if len(shape) == 0 or shape[0] != n:
            raise ValueError(
                f"unstack_tree: {name!r} has shape {shape} — every tensor of a "
                f"stacked state must have a leading agent axis of size {n} "
                "(stack scalars with stack_trees first)"
            )
    if isinstance(stacked, dict):
        return [{k: x[i] for k, x in stacked.items()} for i in range(n)]
    return [stacked[i] for i in range(n)]


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

    @property
    def leaf_count(self) -> int:
        return len(self.slots)

    @property
    def bucket_count(self) -> int:
        return len(self.buckets)

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


def fused_dense_mix(stacked: Stacked, W: torch.Tensor, *, times: int = 1) -> Stacked:
    """``times`` dense rounds on the fused buffers of ``stacked``: flatten
    once into ``{dtype: (N, P)}`` buffers, mix them (ping-pong with one
    spare set), and return a new stacked dict of views of the result
    (``ops/mixing.py:236`` of the JAX package, for a caller's own loop)."""
    buffers, layout = flatten_stacked(stacked)
    spare = {k: torch.empty_like(b) for k, b in buffers.items()}
    for _ in range(int(times)):
        buffers, spare = dense_mix(buffers, W, spare), buffers
    return unflatten_stacked(buffers, layout)


def fused_max_deviation(stacked: Stacked, *, fused: bool = True) -> torch.Tensor:
    """:func:`max_deviation` on the fused buffers (one reduction per dtype
    bucket instead of one per tensor); ``fused=False`` reduces per
    tensor.  The statistic does not depend on the layout, so both agree
    to summation order."""
    return max_deviation(flatten_stacked(stacked)[0] if fused else stacked)


def global_average(stacked: Stacked, out: Stacked) -> Stacked:
    """Exact averaging, the ``gamma = 0`` case of a gossip round: each
    tensor's float32 mean over the agent axis, written back to every
    agent of ``out`` (which may be ``stacked`` itself), which it returns."""
    for key, x in stacked.items():
        mean = x.to(torch.float32).mean(dim=0, keepdim=True)
        out[key].copy_(mean.expand(x.shape))
    return out


def _rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` as float32 ``(N, P)`` rows (a view when it is float32 already)."""
    return x.reshape(x.shape[0], -1).to(torch.float32)


def _eye(n: int, device) -> torch.Tensor:
    return torch.eye(n, dtype=torch.bool, device=device)


def _place_off_diagonal(W: torch.Tensor, off_eff: torch.Tensor, eye: torch.Tensor) -> torch.Tensor:
    """``off_eff`` off the diagonal and ``W``'s diagonal plus each row's
    lost off-diagonal mass on it.  Where-placement, not addition, keeps
    the surviving off-diagonal entries bitwise untouched."""
    off = torch.where(eye, 0.0, W)
    dropped = (off - off_eff).sum(dim=1)
    return torch.where(eye, (torch.diagonal(W) + dropped)[:, None], off_eff)


def _round_rows(Wf: torch.Tensor, x: torch.Tensor, pub: Optional[torch.Tensor],
                dst: torch.Tensor) -> torch.Tensor:
    """One key's plain round in float32 ``(N, P)`` rows: ``Wf @ x``, or
    with a published buffer ``Wf @ pub + diag(Wf) * (x - pub)``; written
    into ``dst``'s rows when ``dst`` is float32 (no allocation for the
    GEMM), else into new rows for :func:`_store`."""
    src = _rows(x if pub is None else pub)
    if dst.dtype == torch.float32:
        acc = torch.matmul(Wf, src, out=dst.view(dst.shape[0], -1))
    else:
        acc = torch.matmul(Wf, src)
    if pub is not None:
        acc.add_((_rows(x) - src).mul_(torch.diagonal(Wf)[:, None]))
    return acc


def _store(dst: torch.Tensor, acc: torch.Tensor) -> None:
    """Cast float32 rows from :func:`_round_rows` into ``dst`` unless they
    are already its storage."""
    if dst.dtype != torch.float32:
        dst.copy_(acc.reshape(dst.shape))


# -- stale-weighted mixing (the async gossip runtime's device program) -- #
def stale_weight_matrix(W: torch.Tensor, age: torch.Tensor, *, tau) -> torch.Tensor:
    """Effective mixing matrix under per-agent publication staleness.

    ``age[j]`` counts rounds since agent ``j`` last published.  A stale
    contribution is down-weighted by ``1/(1+age)`` and dropped beyond the
    bound ``tau`` (an int, or a 0-dim device tensor so one captured graph
    serves every bound); the lost mass of each row moves onto its self
    edge, so the row sums are kept.  Self edges never decay.  With ``age
    == 0`` everywhere the result is bitwise ``W``.
    """
    W = W.to(torch.float32)
    agef = age.to(torch.float32)
    scale = torch.where(agef <= tau, 1.0 / (1.0 + agef), 0.0)
    eye = _eye(W.shape[0], W.device)
    return _place_off_diagonal(W, torch.where(eye, 0.0, W * scale[None, :]), eye)


def presence_weight_matrix(W: torch.Tensor, present: torch.Tensor) -> torch.Tensor:
    """Effective mixing matrix when some agents sit a round out:
    ``present[j]`` is 1/True for participants.  Edges to absent agents get
    zero weight with the mass moved to the self edge, and an absent
    agent's own row becomes the identity.  With everyone present the
    result is bitwise ``W``."""
    W = W.to(torch.float32)
    n = W.shape[0]
    p = present.to(torch.float32)
    eye = _eye(n, W.device)
    W_eff = _place_off_diagonal(W, torch.where(eye, 0.0, W * p[None, :]), eye)
    return torch.where(p[:, None] > 0.0, W_eff, eye.to(torch.float32))


def stale_weighted_mix(stacked: Stacked, published: Stacked, W_eff: torch.Tensor,
                       out: Stacked) -> Stacked:
    """One stale-weighted round on double-buffered state,
    ``x_i <- W_eff[i, i] x_i + sum_{j != i} W_eff[i, j] pub_j``, written
    into ``out`` (not aliasing ``stacked`` or ``published``), which it
    returns.

    Neighbours' contributions come from the published buffer, the self
    term from the live one: one GEMM per key plus the correction
    ``diag(W_eff) * (x - pub)``, which is exactly zero where ``pub``
    holds ``x``'s bits; the round is then bitwise :func:`dense_mix`
    under ``W_eff``.
    """
    Wf = W_eff.to(torch.float32)
    with _highest_precision():
        for key, x in stacked.items():
            dst = out[key]
            _store(dst, _round_rows(Wf, x, published[key], dst))
    return out


# -- Byzantine-robust aggregation (clipped / trimmed / median) ---------- #
def pairwise_sq_dists(stacked: Stacked, neighbors: Optional[Stacked] = None) -> torch.Tensor:
    """(N, N) squared L2 distances between agents' whole parameter
    vectors, ``sq[i, j] = ||row_i(stacked) - row_j(neighbors)||^2`` summed
    over every key, in the reference's Gram form ``sx + sy - 2 X Y^T``
    (one GEMM per key), clamped at 0.  The cancellation error of that
    form is the reference's too: a clip decision sees its numbers.
    ``neighbors`` defaults to ``stacked``; the async rounds pass the
    published buffer."""
    total = None
    with _highest_precision():
        for key, x in stacked.items():
            xf = _rows(x)
            yf = xf if neighbors is None else _rows(neighbors[key])
            g = torch.matmul(xf, yf.T)
            sx = (xf * xf).sum(dim=1)
            sy = sx if neighbors is None else (yf * yf).sum(dim=1)
            sq = sx[:, None] + sy[None, :] - 2.0 * g
            total = sq if total is None else total + sq
    return total.clamp_min(0.0)


def _per_receiver(value, n: int, device) -> torch.Tensor:
    """A scalar or ``(n,)`` knob as an ``(n,)`` float32 device tensor,
    made by a fill, not a host copy, when it is a Python number."""
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=torch.float32).expand(n)
    return torch.full((n,), float(np.float32(value)), dtype=torch.float32, device=device)


def clip_weight_matrix(W: torch.Tensor, sq_dists: torch.Tensor,
                       radius) -> Tuple[torch.Tensor, torch.Tensor]:
    """Effective mixing matrix with neighbour deltas clipped at
    ``radius``: ``W_ij <- W_ij * min(1, r_i / ||x_j - x_i||)`` with the
    lost mass on the self edge, so a clipped round is :func:`dense_mix`
    under it.  ``radius`` is a scalar or a per-receiver ``(N,)`` tensor.
    NaN distances clip to zero weight, and a NaN or negative radius row
    holds its own value.  With ``radius=inf`` the result is bitwise
    ``W``.  Returns ``(W_eff, clipped_mass)``, the total absolute edge
    weight moved onto self edges (0.0 when nothing clipped)."""
    W = W.to(torch.float32)
    n = W.shape[0]
    r = _per_receiver(radius, n, W.device)[:, None]
    norm = torch.sqrt(sq_dists)
    norm = torch.where(torch.isnan(norm), math.inf, norm)
    s = torch.where(norm <= r, 1.0, r / norm.clamp_min(1e-30))
    s = torch.where(torch.isnan(s) | (s < 0.0), 0.0, s)
    eye = _eye(n, W.device)
    off_eff = torch.where(eye, 0.0, W * s)
    W_eff = _place_off_diagonal(W, off_eff, eye)
    clipped_mass = (torch.where(eye, 0.0, W).abs() - off_eff.abs()).sum()
    return W_eff, clipped_mass


def adaptive_clip_radius(W: torch.Tensor, sq_dists: torch.Tensor, multiplier) -> torch.Tensor:
    """Per-receiver clipping radius: ``multiplier`` times the median norm
    of the receiver's neighbour deltas (NaN distances count as inf), as
    ``jnp.nanmedian`` computes it: an even count averages the two middle
    values, in its ``lo * (1 - w) + hi * w`` form.  The masked median is
    sorted and gathered here (``torch.nanmedian`` takes the lower middle
    value).  ``multiplier=inf`` gives inf rows; an isolated agent's
    radius is 0."""
    W = W.to(torch.float32)
    n = W.shape[0]
    support = (W != 0.0) & ~_eye(n, W.device)
    norm = torch.sqrt(sq_dists.clamp_min(0.0))
    norm = torch.where(torch.isnan(norm), math.inf, norm)
    ranked = torch.where(support, norm, math.nan).sort(dim=1).values  # NaN last
    k = support.sum(dim=1).to(torch.float32)
    q = 0.5 * (k - 1.0)
    lo, hi = torch.floor(q), torch.ceil(q)
    w_hi = q - lo
    w_lo = 1.0 - w_hi
    last = k - 1.0
    lo = torch.minimum(lo, last).clamp_min(0.0).long()[:, None]
    hi = torch.minimum(hi, last).clamp_min(0.0).long()[:, None]
    med = ranked.gather(1, lo)[:, 0] * w_lo + ranked.gather(1, hi)[:, 0] * w_hi
    med = torch.where(torch.isnan(med), 0.0, med)
    mult = float(np.float32(multiplier))
    if math.isinf(mult):
        return torch.full((n,), math.inf, dtype=torch.float32, device=W.device)
    return mult * med


def clipped_mix(stacked: Stacked, W: torch.Tensor, radius, out: Stacked, *,
                adaptive: bool = False,
                published: Optional[Stacked] = None) -> Tuple[Stacked, torch.Tensor]:
    """One clipped-gossip round into ``out``; returns ``(out,
    clipped_mass)``.  ``published=None`` is the synchronous round
    (:func:`dense_mix` under the clipped matrix); with the async double
    buffer, pass the stale-decayed matrix as ``W`` and the clip measures
    each delta from the receiver's live value to the neighbour's
    publication (:func:`stale_weighted_mix` under the clipped matrix).
    ``adaptive`` reads ``radius`` as the :func:`adaptive_clip_radius`
    multiplier.  With ``radius=inf`` the round is bitwise the plain
    one."""
    sq = pairwise_sq_dists(stacked, published)
    r = adaptive_clip_radius(W, sq, radius) if adaptive else radius
    W_eff, mass = clip_weight_matrix(W, sq, r)
    if published is None:
        return dense_mix(stacked, W_eff, out), mass
    return stale_weighted_mix(stacked, published, W_eff, out), mass


def trim_counts(W: torch.Tensor, trim) -> torch.Tensor:
    """Per-receiver ``(N,)`` int32 trim depth for :func:`trimmed_mix`: an
    int applies to every receiver; ``"median"`` takes the deepest trim
    ``(deg_i - 1) // 2`` that keeps the central one (odd degree) or two
    (even degree) neighbour contributions."""
    W = W.to(torch.float32)
    n = W.shape[0]
    deg = ((W != 0.0) & ~_eye(n, W.device)).sum(dim=1).to(torch.int32)
    if isinstance(trim, str):
        if trim != "median":
            raise ValueError(f"trim must be an int or 'median', got {trim!r}")
        return torch.div(deg - 1, 2, rounding_mode="floor").clamp_min(0)
    return torch.full((n,), int(trim), dtype=torch.int32, device=W.device)


# Entries of one (N, N, chunk) temporary of trimmed_mix: the coordinates
# run in chunks of 2**25 // N**2, so each temporary stays at 128 MiB in
# float32 whatever the width.  The result per coordinate does not depend
# on the chunking.
_TRIM_CHUNK_ENTRIES = 1 << 25


def trimmed_mix(stacked: Stacked, W: torch.Tensor, trim: torch.Tensor, out: Stacked, *,
                published: Optional[Stacked] = None) -> Tuple[Stacked, torch.Tensor]:
    """One coordinate-wise trimmed-mean round into ``out``; returns
    ``(out, trimmed_mass)``.

    For each receiver i and coordinate p the ``trim[i]`` highest and
    lowest neighbour contributions (ranked among i's neighbours, ties by
    index) move onto the self edge: the plain GEMM (sync) or
    :func:`stale_weighted_mix` (async, ``published``) plus the correction
    ``sum_j W_ij m_ijp (x_i[p] - nb_j[p])``, which is exactly 0.0 at
    ``trim=0``.  ``trimmed_mass`` is the mean per-coordinate edge weight
    redirected, summed over keys.  The ranks cost O(N^2 P) comparisons.
    """
    W = W.to(torch.float32)
    n = W.shape[0]
    eye = _eye(n, W.device)
    support = (W != 0.0) & ~eye
    supf = support.to(torch.float32)
    deg = supf.sum(dim=1)
    tf = trim.to(torch.int32).to(torch.float32)
    lo_cut, hi_cut = tf[:, None, None], (deg - tf)[:, None, None]
    W_off = torch.where(support, W, 0.0)
    idx = torch.arange(n, device=W.device)
    tie_lo = (idx[:, None] < idx[None, :])[:, :, None]
    mass = torch.zeros((), dtype=torch.float32, device=W.device)
    chunk = max(1, _TRIM_CHUNK_ENTRIES // (n * n))
    with _highest_precision():
        for key, x in stacked.items():
            dst = out[key]
            pub = None if published is None else published[key]
            acc = _round_rows(W, x, pub, dst)
            xf = _rows(x)
            pf = xf if pub is None else _rows(pub)
            count = torch.zeros((n, n), dtype=torch.int64, device=W.device)
            for c0 in range(0, pf.shape[1], chunk):
                p = pf[:, c0: c0 + chunk]
                # rank[i, j, c]: how many of receiver i's neighbours sort
                # strictly below contribution j at coordinate c (ties by
                # index keep the ranking a permutation).
                lt = p[:, None, :] < p[None, :, :]
                tie = (p[:, None, :] == p[None, :, :]) & tie_lo
                cmp = (lt | tie).to(torch.float32)
                rank = torch.matmul(supf, cmp.view(n, -1)).view(n, n, -1)
                m = support[:, :, None] & ((rank < lo_cut) | (rank >= hi_cut))
                delta = xf[:, None, c0: c0 + chunk] - p[None, :, :]
                corr = torch.matmul(W_off[:, None, :], torch.where(m, delta, 0.0))
                acc[:, c0: c0 + chunk].add_(corr[:, 0, :])
                count += m.sum(dim=2)
            mass = mass + ((W_off.double() * count.double()).sum() / pf.shape[1]).float()
            _store(dst, acc)
    return out, mass


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


def max_std(stacked: Stacked) -> torch.Tensor:
    """Max over parameters of the across-agent standard deviation: the
    population std (``jnp.std``'s ddof 0, so ``correction=0``; torch's
    default unbiased estimator would read sqrt(n/(n-1)) too high)."""
    return torch.stack([
        torch.std(x.to(torch.float32), dim=0, correction=0).max()
        for x in stacked.values()
    ]).max()


def _agent_axis(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return w.reshape((-1,) + (1,) * (x.dim() - 1))


def weighted_lift(stacked: Stacked, weights: torch.Tensor) -> Stacked:
    """Rescale each agent's value by ``w_i / mean(w)``, so that plain
    average consensus computes the *weighted* average:
    ``(1/n) sum y_i = (sum w_i x_i) / (sum w_i)``.  The scale is cast to
    each tensor's dtype before the product, as in the reference."""
    w = weights / weights.mean()
    return {k: x * _agent_axis(w, x).to(x.dtype) for k, x in stacked.items()}


def weighted_readout(stacked_num: Stacked, stacked_den: torch.Tensor) -> Stacked:
    """Finish a push-sum style weighted consensus: the mixed numerator
    divided by the mixed scalar weight channel (cast to each tensor's
    dtype)."""
    return {k: x / _agent_axis(stacked_den, x).to(x.dtype)
            for k, x in stacked_num.items()}
