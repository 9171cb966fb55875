"""Compressed gossip with error feedback, CHOCO-GOSSIP (port of
``distributed_learning_tpu/parallel/compression.py``, dense route).

Each agent keeps a *public* estimate ``xhat_i`` that its neighbours also
track; only the compressed correction ``q_i = C(x_i - xhat_i)`` would
cross a wire:

    q_i     = C(x_i - xhat_i)
    xhat_j <- xhat_j + q_j
    x_i    <- x_i + gamma * sum_j W_ij (xhat_j - xhat_i)

With a delta-contractive compressor (top-k, random-k, scaled sign) the
iterates converge linearly to exact consensus.  On one device the mixing
product on the estimates is the port's ``dense_mix`` GEMM
(``ops/mixing.py``); the compression math is exact.

A compressor is a callable ``(value, generator) -> value`` on ONE agent's
leaf, the counterpart of the reference's ``(value, jax key)``; it
returns a value of the same shape and dtype.  ``random_k`` draws its keys
with ``torch.rand`` from the ``torch.Generator`` it is handed and keeps
the top k of them: uniform choice without replacement that a CUDA graph
can capture.  Its bits cannot follow ``jax.random``.

Selection order: the k kept entries are those ``lax.top_k`` keeps.  The
magnitude is widened to float32, NaN ranks above every number, and on a
tie the lowest index wins: a stable descending sort, whose order
``torch.topk`` does not promise.

:class:`FusedCompressor` runs the same math on the fused ``{dtype: (N,
P)}`` buffers, per leaf span (``budget="per-leaf"``) or per bucket
(``"global"``); :class:`ChocoGossipEngine` runs CHOCO rounds on them in
place (:meth:`ChocoGossipEngine.round_`, what the trainer's graphs
capture) or on a copy (:meth:`ChocoGossipEngine.run`).  Nothing here
reads a device value back to the host or indexes with a boolean mask.
The mesh-sharded route of the reference is not ported (ROADMAP.md).

Each round counts the reference's compressed-gossip accounting on the
default registry, host-side only: ``consensus.compressed_bytes`` (the
nominal sparse-wire bytes, :meth:`FusedCompressor.wire_bytes_per_round`)
and the ``consensus.compression_ratio`` gauge against the dense round's
bytes (:meth:`FusedLayout.bytes_per_round`); custom compressors, whose
k is unknowable, are skipped.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from distributed_learning_tpu_torch.obs.registry import get_registry
from distributed_learning_tpu_torch.ops import mixing as ops
from distributed_learning_tpu_torch.parallel.consensus import ConsensusEngine

__all__ = [
    "Compressor",
    "FusedCompressor",
    "top_k",
    "approx_top_k",
    "random_k",
    "scaled_sign",
    "identity",
    "compressor_delta",
    "int8_quant",
    "compressor_from_spec",
    "ChocoState",
    "ChocoGossipEngine",
]

Stacked = Dict[str, torch.Tensor]


def _k_of(fraction: float, size: int) -> int:
    """The keep count of a top-k/random-k fraction, ``max(1,
    round(fraction * size))``: one source for per-leaf, per-bucket and
    wire-byte accounting."""
    return max(1, int(round(fraction * size)))


def _sel_mag(v: torch.Tensor) -> torch.Tensor:
    """``|v|`` as a selection key, sub-float32 floats widened to float32
    (exact and order-preserving); the values themselves are never
    touched."""
    mag = v.abs()
    if mag.dtype in (torch.bfloat16, torch.float16):
        mag = mag.to(torch.float32)
    return mag


def _top_indices(keys: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest keys along the last axis, in
    ``lax.top_k``'s order: NaN above every number, ties to the lowest
    index (a stable descending sort)."""
    return torch.sort(keys, dim=-1, descending=True, stable=True).indices[..., :k]


def _keep(flat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``flat`` where ``idx`` (along the last axis) selects, exact zero
    elsewhere: the selected values are exact copies."""
    mask = torch.zeros(flat.shape, dtype=torch.bool, device=flat.device)
    mask.scatter_(-1, idx, True)
    return torch.where(mask, flat, torch.zeros((), dtype=flat.dtype, device=flat.device))


class Compressor:
    """A delta-contractive compressor: callable ``(value, generator) ->
    compressed value`` of the same shape and dtype, on one agent's leaf.

    ``kind`` and its parameters let :class:`FusedCompressor` run the same
    math on whole fused buffers; any plain callable is ``kind="custom"``
    and is applied leaf by leaf, agent by agent."""

    def __init__(self, fn: Callable[[torch.Tensor, Optional[torch.Generator]], torch.Tensor],
                 kind: str = "custom", *, fraction: Optional[float] = None,
                 recall_target: Optional[float] = None):
        self._fn = fn
        self.kind = str(kind)
        self.fraction = fraction
        self.recall_target = recall_target

    def __call__(self, v: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self._fn(v, generator)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        arg = "" if self.fraction is None else f":{self.fraction}"
        return f"Compressor({self.kind}{arg})"


def compressor_from_spec(spec: str) -> Compressor:
    """Parse a compressor spec: ``"topk:0.1"``, ``"atopk:0.1"``,
    ``"randk:0.25"``, ``"sign"``, ``"int8"``, or ``"none"`` (identity)."""
    name, _, arg = str(spec).partition(":")
    name = name.strip().lower()
    if name in ("none", "identity"):
        return identity()
    if name in ("sign", "scaled_sign"):
        return scaled_sign()
    if name in ("int8", "q8"):
        return int8_quant()
    if name in ("topk", "top_k", "randk", "random_k", "atopk", "approx_top_k"):
        try:
            fraction = float(arg) if arg else 0.1
        except ValueError:
            raise ValueError(
                f"bad fraction in compressor spec {spec!r} (want e.g. '{name}:0.1')"
            ) from None
        if name in ("topk", "top_k"):
            return top_k(fraction)
        if name in ("atopk", "approx_top_k"):
            return approx_top_k(fraction)
        return random_k(fraction)
    raise ValueError(
        f"unknown compressor spec {spec!r} (want topk:F, atopk:F, randk:F, sign, int8, none)"
    )


# --------------------------------------------------------------------- #
# delta-contractive compressors                                         #
# --------------------------------------------------------------------- #
def _check_fraction(fraction: float) -> None:
    if not 0.0 < fraction <= 1.0:
        raise ValueError(f"fraction must be in (0, 1], got {fraction}")


def _top_k_fn(fraction: float):
    def compress(v, generator=None):
        flat = v.reshape(-1)
        idx = _top_indices(_sel_mag(flat), _k_of(fraction, flat.numel()))
        return _keep(flat, idx).reshape(v.shape)

    return compress


def top_k(fraction: float) -> Compressor:
    """Keep the top ``fraction`` of entries by magnitude."""
    _check_fraction(fraction)
    return Compressor(_top_k_fn(fraction), "top_k", fraction=fraction)


def approx_top_k(fraction: float, recall_target: float = 0.95) -> Compressor:
    """The reference's hardware-aware top-k (``jax.lax.approx_max_k``).
    ``approx_max_k`` is exact on the CPU, the oracle's platform, and so is
    this port: it keeps exactly :func:`top_k`'s entries on every device,
    and ``recall_target`` is only validated and carried."""
    _check_fraction(fraction)
    if not 0.0 < recall_target <= 1.0:
        raise ValueError(f"recall_target must be in (0, 1], got {recall_target}")
    return Compressor(_top_k_fn(fraction), "approx_top_k", fraction=fraction,
                      recall_target=recall_target)


def _random_indices(shape: Tuple[int, ...], k: int, generator, device) -> torch.Tensor:
    """``k`` distinct indices along the last axis of ``shape``, uniform
    without replacement: the top k of uniform keys from ``generator``."""
    keys = torch.rand(shape, generator=generator, device=device)
    return _top_indices(keys, k)


def random_k(fraction: float) -> Compressor:
    """Keep a uniformly random ``fraction`` of entries, drawn from the
    generator passed with the value."""
    _check_fraction(fraction)

    def compress(v, generator=None):
        flat = v.reshape(-1)
        idx = _random_indices(flat.shape, _k_of(fraction, flat.numel()), generator, flat.device)
        return _keep(flat, idx).reshape(v.shape)

    return Compressor(compress, "random_k", fraction=fraction)


def scaled_sign() -> Compressor:
    """``(||v||_1 / d) * sign(v)``: 1 bit an entry plus one scale."""

    def compress(v, generator=None):
        flat = v.reshape(-1)
        scale = flat.abs().sum() / flat.numel()
        return (scale * torch.sign(flat)).reshape(v.shape)

    return Compressor(compress, "scaled_sign")


def _int8(v: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``round(v / s) * s`` clipped to +-127 quanta, 0 where the scale is 0."""
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(v / safe), -127, 127)
    return torch.where(scale > 0, q * safe, torch.zeros((), dtype=v.dtype, device=v.device))


def int8_quant() -> Compressor:
    """Symmetric int8 quantization, ``round(v/s)*s`` with ``s =
    max|v|/127``: 1 byte an entry plus one scale.  Its contraction rests
    on ``||v||^2`` being well above ``max|v|^2``, as in the reference."""

    def compress(v, generator=None):
        flat = v.reshape(-1)
        return _int8(flat, flat.abs().max() / 127.0).reshape(v.shape)

    return Compressor(compress, "int8_quant")


def identity() -> Compressor:
    """No compression (delta = 1): CHOCO is then plain gossip on the
    estimates, damped by gamma."""
    return Compressor(lambda v, generator=None: v, "identity")


def compressor_delta(compress: Compressor, dim: int = 256, trials: int = 50,
                     seed: int = 0) -> float:
    """Empirical contraction factor ``min_v 1 - ||C(v)-v||^2 / ||v||^2``
    over ``trials`` Gaussian vectors from a CPU generator seeded with
    ``seed`` (its draws differ from the reference's ``jax.random``)."""
    g = torch.Generator().manual_seed(int(seed))
    worst = 0.0
    for _ in range(trials):
        v = torch.randn(dim, generator=g)
        err = v - compress(v, g)
        worst = max(worst, float((err * err).sum() / (v * v).sum()))
    return 1.0 - worst


# --------------------------------------------------------------------- #
# Fused whole-buffer compression                                        #
# --------------------------------------------------------------------- #
class _SizeClass(NamedTuple):
    """The static index map of one power-of-two class of leaf spans."""

    gidx: torch.Tensor    # (L * maxd,) bucket columns, P for padding
    offsets: torch.Tensor  # (L, 1) start of each leaf's row in gidx
    keep: torch.Tensor    # (L, kmax) whether rank r is within leaf l's k
    L: int
    maxd: int
    kmax: int


class FusedCompressor:
    """Compression run directly on the fused ``{dtype: (rows, P)}``
    buffers (:func:`~distributed_learning_tpu_torch.ops.mixing.flatten_stacked`).

    ``budget="per-leaf"`` keeps every leaf's own k or scale, the per-leaf
    compressor's values exactly.  The top-k family is one segment-aware
    selection per bucket (:meth:`_segment_top_k`); ``scaled_sign`` and
    ``int8_quant`` reduce one scale per leaf span and apply one
    elementwise pass; ``random_k`` and custom callables run per leaf view
    and per agent, drawing in layout order.

    ``budget="global"`` spends one budget over each whole bucket row: one
    top-k (or one random index set per agent and round) and one scale per
    bucket; it needs a named compressor kind.
    """

    _KINDS = ("top_k", "approx_top_k", "random_k", "scaled_sign", "int8_quant", "identity")

    def __init__(self, base: Compressor, budget: str = "per-leaf"):
        if budget not in ("per-leaf", "global"):
            raise ValueError(
                f"unknown compression budget {budget!r} (want 'per-leaf' or 'global')"
            )
        self.base = base
        self.budget = budget
        self.kind = getattr(base, "kind", "custom")
        if self.kind not in self._KINDS:
            self.kind = "custom"
        if budget == "global" and self.kind == "custom":
            raise ValueError(
                "budget='global' needs a named compressor kind "
                f"({'/'.join(self._KINDS)}); got a custom callable whose "
                "whole-buffer form is unknowable"
            )
        self._classes: Dict[tuple, List[_SizeClass]] = {}

    # ------------------------------------------------------------------ #
    def compress(self, buffers: Stacked, layout: ops.FusedLayout,
                 generator: Optional[torch.Generator], *, n: int) -> Stacked:
        """Compress the fused correction buffers (new ``{dtype: (rows,
        P)}`` tensors back)."""
        if self.kind == "identity":
            return dict(buffers)
        if self.kind == "custom" or (self.kind == "random_k" and self.budget == "per-leaf"):
            return self.per_leaf_views(buffers, layout, generator, n=n)
        return {name: self._bucket(buffers[name], layout.bucket_spans(name), generator)
                for name, _w in layout.buckets}

    def per_leaf_views(self, buffers: Stacked, layout: ops.FusedLayout,
                       generator: Optional[torch.Generator], *, n: int) -> Stacked:
        """The base compressor on every leaf view of every agent, in
        layout order then agent order (the generator's draws follow that
        order): exact per-leaf semantics for any kind."""
        out = {name: torch.empty_like(buf) for name, buf in buffers.items()}
        for slot in layout.slots:
            cols = slice(slot.offset, slot.offset + slot.size)
            src, dst = buffers[slot.bucket][:, cols], out[slot.bucket][:, cols]
            for a in range(n):
                dst[a].copy_(self.base(src[a].reshape(slot.shape), generator).reshape(-1))
        return out

    # ------------------------------------------------------------------ #
    def _bucket(self, buf: torch.Tensor, spans, generator) -> torch.Tensor:
        P_ = buf.shape[1]
        fraction = self.base.fraction
        if self.kind in ("top_k", "approx_top_k"):
            if self.budget == "per-leaf":
                return self._segment_top_k(buf, spans)
            return _keep(buf, _top_indices(_sel_mag(buf), _k_of(fraction, P_)))
        if self.kind == "random_k":  # global budget (per-leaf runs the views)
            idx = _random_indices(tuple(buf.shape), _k_of(fraction, P_), generator, buf.device)
            return _keep(buf, idx)
        if self.kind == "scaled_sign":
            scale = self._scale_cols(buf, spans, lambda sl: sl.abs().sum(dim=1, keepdim=True)
                                     / sl.shape[1])
            return scale * torch.sign(buf)
        if self.kind == "int8_quant":
            scale = self._scale_cols(buf, spans,
                                     lambda sl: sl.abs().amax(dim=1, keepdim=True) / 127.0)
            return _int8(buf, scale)
        raise AssertionError(self.kind)  # pragma: no cover

    def _scale_cols(self, buf: torch.Tensor, spans, red) -> torch.Tensor:
        """Per-column scales: the bucket row's (global budget), or each
        leaf span's broadcast over its columns (per-leaf budget)."""
        if self.budget == "global":
            return red(buf)
        parts = [red(buf[:, off: off + size]).expand(buf.shape[0], size) for off, size in spans]
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)

    def prepare(self, layout: ops.FusedLayout, device) -> None:
        """Build the per-leaf selection's static index maps for ``layout``
        on ``device`` now: their host-to-device copies then happen here,
        not inside the first round."""
        if self.kind in ("top_k", "approx_top_k") and self.budget == "per-leaf":
            for name, width in layout.buckets:
                self._size_classes(layout.bucket_spans(name), width, torch.device(device))

    def _size_classes(self, spans, P_: int, device: torch.device) -> List[_SizeClass]:
        """The spans grouped by ``size.bit_length()`` (padding wastes
        under 2x), each with its static index map on ``device``; built
        once per layout and device."""
        key = (tuple(spans), P_, str(device))
        if key in self._classes:
            return self._classes[key]
        classes: Dict[int, list] = {}
        for j, (_off, size) in enumerate(spans):
            classes.setdefault(max(int(size).bit_length(), 1), []).append(j)
        out = []
        for _cls, members in sorted(classes.items()):
            sizes = [spans[j][1] for j in members]
            ks = [_k_of(self.base.fraction, s) for s in sizes]
            L, maxd, kmax = len(members), max(sizes), max(ks)
            gidx = np.full((L, maxd), P_, np.int64)
            for i, j in enumerate(members):
                off, size = spans[j]
                gidx[i, :size] = np.arange(off, off + size, dtype=np.int64)
            keep = np.arange(kmax)[None, :] < np.asarray(ks)[:, None]
            out.append(_SizeClass(
                gidx=torch.as_tensor(gidx.ravel(), device=device),
                offsets=torch.arange(L, device=device)[:, None] * maxd,
                keep=torch.as_tensor(keep, device=device), L=L, maxd=maxd, kmax=kmax))
        self._classes[key] = out
        return out

    def _segment_top_k(self, buf: torch.Tensor, spans) -> torch.Tensor:
        """Every leaf span keeps its top ``max(1, round(fraction *
        size))`` columns by magnitude, exactly per-leaf :func:`top_k`, in
        a number of ops independent of the leaf count: per size class, a
        gather of the magnitudes into a padded ``(rows, L, maxd)`` layout
        (padding reads a -inf sentinel column, never selected), ONE
        batched selection at the class's largest k, surplus ranks sent to
        the sentinel; then one boolean scatter and one select for the
        whole bucket."""
        rows, P_ = buf.shape
        mag = _sel_mag(buf)
        mag_ext = torch.cat([mag, torch.full((rows, 1), float("-inf"), device=buf.device)], dim=1)
        cols = []
        for c in self._size_classes(spans, P_, buf.device):
            padded = mag_ext.index_select(1, c.gidx).view(rows, c.L, c.maxd)
            idx = _top_indices(padded, c.kmax)                       # (rows, L, kmax)
            col = c.gidx[idx + c.offsets]
            cols.append(torch.where(c.keep, col, P_).reshape(rows, c.L * c.kmax))
        cols = cols[0] if len(cols) == 1 else torch.cat(cols, dim=1)
        mask = torch.zeros((rows, P_ + 1), dtype=torch.bool, device=buf.device)
        mask.scatter_(1, cols, True)
        return torch.where(mask[:, :P_], buf, torch.zeros((), dtype=buf.dtype, device=buf.device))

    # ------------------------------------------------------------------ #
    def wire_bytes_per_round(self, layout: ops.FusedLayout, n: int) -> Optional[int]:
        """Nominal sparse-wire bytes one compressed round ships for ``n``
        agents: a u32 index plus one stored-dtype value per kept entry for
        the k-sparse kinds, 1 bit an entry plus one scale for
        ``scaled_sign``, 1 byte an entry plus a float32 scale for int8,
        the dense buffer for identity; ``None`` for custom callables."""
        if self.kind == "custom":
            return None
        total = 0
        for name, width in layout.buckets:
            item = ops.itemsize(name)
            if self.kind in ("top_k", "approx_top_k", "random_k"):
                if self.budget == "global":
                    k = _k_of(self.base.fraction, width)
                else:
                    k = sum(_k_of(self.base.fraction, size) for _o, size in layout.bucket_spans(name))
                total += k * (4 + item)
            elif self.kind == "scaled_sign":
                total += (width + 7) // 8 + item
            elif self.kind == "int8_quant":
                total += width + 4
            else:  # identity
                total += width * item
        return total * n


# --------------------------------------------------------------------- #
class ChocoState(NamedTuple):
    """Stacked CHOCO state: iterates, public estimates, the generator the
    random kinds draw from (it advances in place), and the error-feedback
    bank when the engine has ``error_feedback=True`` (else ``None``)."""

    x: Stacked
    xhat: Stacked
    generator: torch.Generator
    ef: Optional[Stacked] = None


class ChocoGossipEngine:
    """CHOCO-GOSSIP over a mixing matrix, dense route.

    ``W``: (n, n) symmetric row-stochastic mixing matrix; ``compressor``:
    a :class:`Compressor`; ``gamma``: the consensus step size (``gamma ~
    delta`` is the reference's heuristic); ``fused``: compress with a
    :class:`FusedCompressor` and mix the fused buffers (``False``: the
    per-leaf oracle, base compressor per leaf view and one GEMM per
    leaf); ``budget``: ``"per-leaf"`` or ``"global"`` (fused only);
    ``error_feedback``: bank the mass the compressor drops, ``delta - q``,
    and offer it again next round (fused only); ``device``: the card
    unless ``"cpu"`` is asked for.
    """

    def __init__(self, W: np.ndarray, compressor: Compressor, *, gamma: float = 0.3,
                 fused: bool = True, budget: str = "per-leaf", error_feedback: bool = False,
                 device=None):
        self.engine = ConsensusEngine(W, device=device)
        self.n = self.engine.n
        self.device = self.engine.device
        self.compressor = compressor
        self.gamma = float(gamma)
        self.fused = bool(fused)
        if not fused and budget != "per-leaf":
            raise ValueError(
                "budget='global' requires fused=True (the per-leaf oracle is, by "
                "definition, per-leaf budgeted)"
            )
        self.budget = budget
        self.error_feedback = bool(error_feedback)
        if self.error_feedback and not fused:
            raise ValueError(
                "error_feedback=True is the fused global-budget rescue; it requires "
                "fused=True (the per-leaf oracle keeps each leaf's exact compressor "
                "contract instead)"
            )
        self.fused_compressor = FusedCompressor(compressor, budget=budget)

    # ------------------------------------------------------------------ #
    def init(self, x0: Stacked, *, seed: int = 0) -> ChocoState:
        """Estimates (and the error-feedback bank) start at zero; the
        generator is seeded with ``seed``."""
        x = {k: v.to(self.device).clone() for k, v in x0.items()}
        zeros = lambda: {k: torch.zeros_like(v) for k, v in x.items()}  # noqa: E731
        gen = torch.Generator(self.device).manual_seed(int(seed))
        return ChocoState(x=x, xhat=zeros(), generator=gen,
                          ef=zeros() if self.error_feedback else None)

    def _note_compression(self, layout: ops.FusedLayout, rounds: int) -> None:
        """Compressed-gossip accounting for ``rounds`` rounds on
        ``layout`` (the reference's ``_note_compression``)."""
        wire = self.fused_compressor.wire_bytes_per_round(layout, self.n)
        if wire is None:
            return
        reg = get_registry()
        reg.inc("consensus.compressed_bytes", wire * int(rounds))
        dense = layout.bytes_per_round(self.n)
        if dense:
            reg.gauge("consensus.compression_ratio", wire / dense)

    @torch.no_grad()
    def round_(self, x: Stacked, xhat: Stacked, ef: Optional[Stacked], layout: ops.FusedLayout,
               generator: Optional[torch.Generator]) -> None:
        """One CHOCO round in place on the fused ``{dtype: (N, P)}``
        buffers ``x``, ``xhat`` and (with error feedback) ``ef``, whose
        addresses stay fixed; the temporaries are freed at the end, so a
        CUDA graph can capture the round."""
        self._note_compression(layout, 1)
        delta = {k: x[k] - xhat[k] for k in x}
        if ef is not None:
            for k in delta:
                delta[k].add_(ef[k])
        if self.fused:
            q = self.fused_compressor.compress(delta, layout, generator, n=self.n)
        else:
            q = self.fused_compressor.per_leaf_views(delta, layout, generator, n=self.n)
        if ef is not None:
            for k in ef:
                torch.sub(delta[k], q[k], out=ef[k])
        del delta
        for k in xhat:
            xhat[k].add_(q[k])
        del q
        W = self.engine._W_dev
        if self.fused:
            mixed = ops.dense_mix(xhat, W, out={k: torch.empty_like(v) for k, v in xhat.items()})
        else:
            hats = ops.unflatten_stacked(xhat, layout)
            per_leaf = ops.dense_mix(hats, W, out={k: torch.empty_like(v) for k, v in hats.items()})
            mixed, _ = ops.flatten_stacked(per_leaf, layout)
        for k in x:
            # x + gamma (mixed - xhat) with one rounding, as the reference's
            # fused update rounds it.
            x[k].add_(mixed[k].sub_(xhat[k]), alpha=self.gamma)

    def run(self, state: ChocoState, rounds: int) -> Tuple[ChocoState, torch.Tensor]:
        """``rounds`` CHOCO iterations on a copy of the state; returns the
        new state and the ``(rounds,)`` per-round residual trace (max
        agent deviation of the iterates after each round).  The state's
        generator advances in place."""
        layout = ops.fused_layout(state.x)
        bx, _ = ops.flatten_stacked(state.x, layout)
        bh, _ = ops.flatten_stacked(state.xhat, layout)
        bef = None if state.ef is None else ops.flatten_stacked(state.ef, layout)[0]
        trace = torch.empty(int(rounds), device=self.device)
        for r in range(int(rounds)):
            self.round_(bx, bh, bef, layout, state.generator)
            trace[r] = ops.max_deviation(bx)
        return ChocoState(
            x=ops.unflatten_stacked(bx, layout), xhat=ops.unflatten_stacked(bh, layout),
            generator=state.generator,
            ef=None if bef is None else ops.unflatten_stacked(bef, layout)), trace

    def max_deviation(self, state: ChocoState) -> float:
        return float(self.engine.max_deviation(state.x))
