"""Byzantine-robust gossip programs on the :class:`ConsensusEngine`, dense
route (port of ``distributed_learning_tpu/parallel/robust.py``).

Weighted averaging has breakdown point zero: one peer that publishes
poisoned values pulls every agent toward them.  These programs swap the
round's aggregation for three classical robust estimators on the
engine's fused ``{dtype: (N, P)}`` buffers:

* **clipped gossip**: each neighbour delta is clipped at an (optionally
  adaptive) radius, an effective mixing matrix
  (:func:`~distributed_learning_tpu_torch.ops.mixing.clip_weight_matrix`),
  so the round stays one GEMM per dtype bucket;
* **trimmed mean**: per coordinate, the ``t`` highest and lowest
  neighbour contributions move onto the self edge
  (:func:`~distributed_learning_tpu_torch.ops.mixing.trimmed_mix`);
* **coordinate median**: the deepest trim of the same family
  (``kind="median"``).

At the neutral knobs (``radius=inf`` / ``trim=0``) every program is
bitwise the plain :meth:`ConsensusEngine.mix_` /
:meth:`ConsensusEngine.mix_async_`.  A program runs in place on fused
buffers and adds the edge weight its defense redirected to a 0-dim
device tensor ``mass`` that the caller passes in (the reference returns
it); it reads nothing back to the host, so the trainer's CUDA graphs
capture it.  A round count is a Python int: a captured graph exists per
count, so the ``*_times_program`` forms differ from the static ones only
in taking the count per call.

Sharded halves (an engine with ``mesh=``, one agent a rank, the
reference's ``_local_clipped_once``, ``_local_trimmed_once`` and
``_local_async_robust_round``):

* clip: each matching's partner arrives through the engine's exchange
  and its delta norm is taken on this rank (an edge decision, no extra
  collective); the adaptive radius is the median over this rank's
  partners; a scale of exactly 1 takes the plain partner term verbatim,
  so at ``radius=inf`` the round is the plain round bit for bit.  The
  terms accumulate in the bucket's dtype, as the reference's mesh route
  does: against the dense route (one float32 GEMM) a bfloat16 bucket
  then differs by up to one bfloat16 ulp;
* trimmed mean: the plain matching round plus a rank-mask correction
  from one ``all_gather`` a bucket (exactly 0.0 at ``trim=0``), the
  ``(n, n, chunk)`` comparisons chunked as the dense route's;
* async clip and trim: one ``all_gather`` of the published bucket,
  shared by the distance and the contraction passes.

Each round adds this rank's share of the redirected mass; the engine
sums the shares across the ranks.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from distributed_learning_tpu_torch.ops import mixing as ops
from distributed_learning_tpu_torch.parallel.consensus import AsyncGossipState, _scaled

__all__ = [
    "RobustConfig",
    "as_robust_config",
    "robust_mix_program",
    "robust_mix_times_program",
    "robust_async_gossip_program",
    "robust_async_gossip_times_program",
]

_KINDS = ("clip", "trim", "median")
Stacked = dict
Spare = Optional[Sequence[Stacked]]


class RobustConfig(NamedTuple):
    """Static (hashable) knobs of one robust aggregation rule.

    ``kind="clip"``: ``radius`` is the L2 clipping radius of a neighbour
    delta (over the agent's whole parameter vector); ``adaptive=True``
    reads it as a multiplier of the receiver's median neighbour-delta
    norm.  ``kind="trim"``: ``trim`` contributions are discarded per
    coordinate from each end.  ``kind="median"``: coordinate-wise median
    (``radius``/``trim`` ignored).  ``radius=inf`` / ``trim=0`` make the
    program bitwise the plain mix.
    """

    kind: str = "clip"
    radius: float = float("inf")
    adaptive: bool = False
    trim: int = 0

    @property
    def neutral(self) -> bool:
        if self.kind == "clip":
            return np.isinf(self.radius)
        if self.kind == "trim":
            return self.trim == 0
        return False


def as_robust_config(spec: Union[RobustConfig, Mapping, str]) -> RobustConfig:
    """Validate a ``robust_mixing=`` spec into a :class:`RobustConfig`: a
    config, a kind string, or a mapping with keys from ``{"kind",
    "radius", "adaptive", "trim"}`` (unknown keys are rejected: a typo'd
    knob must not run the undefended mix)."""
    if isinstance(spec, RobustConfig):
        cfg = spec
    elif isinstance(spec, str):
        cfg = RobustConfig(kind=spec)
    elif isinstance(spec, Mapping):
        unknown = set(spec) - {"kind", "radius", "adaptive", "trim"}
        if unknown:
            raise ValueError(
                f"unknown robust_mixing key(s) {sorted(unknown)}; "
                "valid keys: kind, radius, adaptive, trim"
            )
        cfg = RobustConfig(
            kind=str(spec.get("kind", "clip")),
            radius=float(spec.get("radius", float("inf"))),
            adaptive=bool(spec.get("adaptive", False)),
            trim=int(spec.get("trim", 0)),
        )
    else:
        raise TypeError(
            f"robust_mixing must be a RobustConfig, mapping, or kind "
            f"string, got {type(spec).__name__}"
        )
    if cfg.kind not in _KINDS:
        raise ValueError(f"robust_mixing kind must be one of {_KINDS}, got {cfg.kind!r}")
    if cfg.kind == "trim" and cfg.trim < 0:
        raise ValueError(f"trim must be >= 0, got {cfg.trim}")
    return cfg


def _trim_depths(engine, cfg: RobustConfig) -> torch.Tensor:
    """Per-receiver (n,) trim depths for the trim/median kinds, from the
    engine's own matrix."""
    return ops.trim_counts(engine._W_dev, "median" if cfg.kind == "median" else cfg.trim)


def _robust_mix(cfg: RobustConfig, t_dev: Optional[torch.Tensor], x: Stacked, W: torch.Tensor,
                out: Stacked, published: Optional[Stacked]):
    """One robust round of ``cfg`` into ``out`` under ``W``: ``(out, mass)``."""
    if cfg.kind == "clip":
        return ops.clipped_mix(x, W, cfg.radius, out, adaptive=cfg.adaptive,
                               published=published)
    return ops.trimmed_mix(x, W, t_dev, out, published=published)


def _clip_scale(norm: torch.Tensor, r_eff) -> torch.Tensor:
    """The clip factor of a delta of norm ``norm`` at radius ``r_eff``:
    1 inside the radius, ``r / norm`` outside, 0 where that is NaN or
    negative (the reference's guards)."""
    s = torch.where(norm <= r_eff, 1.0, r_eff / norm.clamp_min(1e-30))
    return torch.where(torch.isnan(s) | (s < 0.0), 0.0, s)


def _effective_radius(radius: float, norms: torch.Tensor, support: torch.Tensor,
                      adaptive: bool):
    """The radius a receiver clips at: ``radius``, or with ``adaptive``
    ``radius`` times the median of its neighbours' delta norms (inf stays
    inf)."""
    r = float(np.float32(radius))
    if not adaptive:
        return r
    med = ops.masked_median(norms, support)
    if np.isinf(r):
        return torch.full_like(med, np.inf)
    return r * med


def _local_clipped_round(engine, cfg: RobustConfig):
    """``(x, out, mass) -> out``: one clipped round on this rank's
    buckets (the reference's ``_local_clipped_once``).  Pass 1 moves each
    matching's partner and measures the full-row delta norm; pass 2
    accumulates the self term and each partner's clipped term, scaled in
    float32 and summed in the bucket's dtype."""
    mesh = engine.mesh
    matched = [(p, w) for p, w in zip(engine._partners, engine._mw) if p is not None]

    def round_once(x: Stacked, out: Stacked, mass: torch.Tensor) -> Stacked:
        partners, norms = [], []
        for p, w in matched:
            nb = {k: torch.empty_like(v, memory_format=torch.contiguous_format)
                  for k, v in x.items()}
            mesh.exchange([(p, v) for v in x.values()], [(p, t) for t in nb.values()])
            sq = torch.zeros((), dtype=torch.float32, device=engine.device)
            for k, v in x.items():
                d = nb[k].float() - v.float()
                sq = sq + (d * d).sum()
            partners.append((nb, w))
            norms.append(torch.sqrt(sq))
        for k, v in x.items():
            out[k].copy_(_scaled(v, engine._sw))
        if not matched:  # an agent no matching reaches keeps its value
            return out
        norm = torch.stack(norms)
        norm = torch.where(torch.isnan(norm), np.inf, norm)
        support = torch.tensor([w != 0.0 for _, w in matched], device=engine.device)
        scales = _clip_scale(norm, _effective_radius(cfg.radius, norm, support, cfg.adaptive))
        for (nb, w), s in zip(partners, scales):
            for k, v in x.items():
                b = nb[k]
                clipped = (v.float() + s * (b.float() - v.float())).to(b.dtype)
                out[k].add_(_scaled(torch.where(s == 1.0, b, clipped), w))
            mass.add_(abs(w) * (1.0 - s))
        return out

    return round_once


def _trim_correction(W_row: torch.Tensor, t: torch.Tensor, a: int, xf: torch.Tensor,
                     pf: torch.Tensor):
    """Receiver ``a``'s trimmed-mean correction for one bucket:
    ``(corr (P,), count (n,))``, ``corr[p] = sum_j W_off[j] m[j, p] (x[p]
    - pf[j, p])`` over the contributions ``m`` ranks among the ``t``
    highest or lowest of ``a``'s neighbours at coordinate ``p`` (ties by
    index), and ``count[j]`` the coordinates trimmed from ``j``.  The
    ``(n, n, chunk)`` comparisons run in chunks of
    ``ops._TRIM_CHUNK_ENTRIES``, as the dense route's."""
    n, P_ = pf.shape
    idx = torch.arange(n, device=pf.device)
    support = (W_row != 0.0) & (idx != a)
    supf = support.to(torch.float32)
    deg = supf.sum()
    tf = t.to(torch.int32).to(torch.float32)
    W_off = torch.where(support, W_row, 0.0)
    tie_lo = (idx[:, None] < idx[None, :])[:, :, None]
    corr = torch.empty(P_, dtype=torch.float32, device=pf.device)
    count = torch.zeros(n, dtype=torch.int64, device=pf.device)
    chunk = max(1, ops._TRIM_CHUNK_ENTRIES // (n * n))
    for c0 in range(0, P_, chunk):
        p = pf[:, c0: c0 + chunk]
        lt = p[:, None, :] < p[None, :, :]
        tie = (p[:, None, :] == p[None, :, :]) & tie_lo
        cmp = (lt | tie).to(torch.float32)
        rank = torch.matmul(supf[None], cmp.view(n, -1)).view(n, -1)
        m = support[:, None] & ((rank < tf) | (rank >= deg - tf))
        delta = xf[c0: c0 + chunk][None] - p
        corr[c0: c0 + chunk] = torch.matmul(W_off[None], torch.where(m, delta, 0.0))[0]
        count += m.sum(dim=1)
    return corr, count, W_off


def _local_trimmed_round(engine, cfg: RobustConfig):
    """``(x, out, mass) -> out``: one trimmed-mean round on this rank's
    buckets (the reference's ``_local_trimmed_once``): the plain
    matching round, then the correction from every agent's bucket
    (one ``all_gather`` each)."""
    mesh, a = engine.mesh, engine.mesh.agent
    W_row = engine._W_dev[a]
    t = _trim_depths(engine, cfg)[a]

    def round_once(x: Stacked, out: Stacked, mass: torch.Tensor) -> Stacked:
        engine._local_mix_once(x, out)
        with ops._highest_precision():
            for k, v in x.items():
                pf = mesh.all_gather(v[0].contiguous()).float().reshape(engine.n, -1)
                corr, count, W_off = _trim_correction(W_row, t, a, v.reshape(-1).float(), pf)
                mass.add_(((W_off.double() * count.double()).sum() / pf.shape[1]).float())
                out[k].copy_((out[k].reshape(-1).float() + corr).reshape(v.shape))
        return out

    return round_once


# -- synchronous robust mixing ------------------------------------------- #
def _dense_robust_round(engine, cfg: RobustConfig):
    """``(x, out, mass) -> out``: one dense robust round under the
    engine's matrix, its redirected mass added to ``mass``."""
    W = engine._W_dev
    t_dev = None if cfg.kind == "clip" else _trim_depths(engine, cfg)

    def round_once(x: Stacked, out: Stacked, mass: torch.Tensor) -> Stacked:
        out, m = _robust_mix(cfg, t_dev, x, W, out, None)
        mass.add_(m)
        return out

    return round_once


def robust_mix_times_program(engine, spec):
    """``run(buffers, times, mass, spare=None)``: ``times`` robust rounds
    in place on fused buffers, the redirected mass (round by round, as
    the reference sums it) added to the 0-dim device tensor ``mass`` (on
    a mesh this rank's share)."""
    cfg = as_robust_config(spec)
    if engine.mesh is None:
        round_once = _dense_robust_round(engine, cfg)
    elif cfg.kind == "clip":
        round_once = _local_clipped_round(engine, cfg)
    else:
        round_once = _local_trimmed_round(engine, cfg)

    def run(buffers: Stacked, times: int, mass: torch.Tensor, spare: Spare = None) -> None:
        engine._rounds(buffers, lambda t, _: t < times,
                       lambda x, out: round_once(x, out, mass), spare)

    return run


def robust_mix_program(engine, spec, times: int = 1):
    """:func:`robust_mix_times_program` at a fixed round count:
    ``run(buffers, mass, spare=None)``."""
    run = robust_mix_times_program(engine, spec)
    return lambda buffers, mass, spare=None: run(buffers, int(times), mass, spare)


# -- asynchronous (stale-weighted, double-buffered) robust mixing -------- #
def _dense_async_robust_round(engine, cfg: RobustConfig, periods: torch.Tensor):
    """``(x, out, state, tau, mass) -> out``: one async round (publish ->
    age -> the robust estimator on the stale-decayed matrix), deltas from
    the receiver's live value to each neighbour's publication, the only
    buffer a lying peer controls."""
    W = engine._W_dev
    t_dev = None if cfg.kind == "clip" else _trim_depths(engine, cfg)

    def round_once(x: Stacked, out: Stacked, state: AsyncGossipState, tau,
                   mass: torch.Tensor) -> Stacked:
        engine._publish_(x, state, periods)
        W_eff = ops.stale_weight_matrix(W, state.age, tau=tau)
        out, m = _robust_mix(cfg, t_dev, x, W_eff, out, state.pub)
        state.rnd.add_(1)
        mass.add_(m)
        return out

    return round_once


def _local_async_robust_round(engine, cfg: RobustConfig, periods: torch.Tensor):
    """Sharded counterpart of :func:`_dense_async_robust_round` (the
    reference's ``_local_async_robust_round``): this rank publishes,
    every age advances, then one ``all_gather`` of each published bucket
    serves both the distance pass and the contraction, against this
    rank's row of the stale-decayed matrix."""
    mesh, a, n = engine.mesh, engine.mesh.agent, engine.n
    W = engine._W_dev
    t = None if cfg.kind == "clip" else _trim_depths(engine, cfg)[a]
    idx = torch.arange(n, device=engine.device)
    own = idx == a

    def round_once(x: Stacked, out: Stacked, state: AsyncGossipState, tau,
                   mass: torch.Tensor) -> Stacked:
        engine._publish_local_(x, state, periods)
        W_row = ops.stale_weight_matrix(W, state.age, tau=tau)[a]
        state.rnd.add_(1)
        with ops._highest_precision():
            gathered = {k: mesh.all_gather(state.pub[k][0].contiguous()).float().reshape(n, -1)
                        for k in x}
            if cfg.kind == "clip":
                sq = torch.zeros(n, dtype=torch.float32, device=engine.device)
                for k, v in x.items():
                    dd = gathered[k] - v.reshape(1, -1).float()
                    sq = sq + (dd * dd).sum(dim=1)
                norm = torch.sqrt(sq.clamp_min(0.0))
                norm = torch.where(torch.isnan(norm), np.inf, norm)
                r_eff = _effective_radius(cfg.radius, norm, (W_row != 0.0) & ~own, cfg.adaptive)
                s = _clip_scale(norm, r_eff)
                off = torch.where(own, 0.0, W_row)
                off_eff = torch.where(own, 0.0, W_row * s)
                row = torch.where(own, W_row[a] + (off - off_eff).sum(), off_eff)
                mass.add_((off.abs() - off_eff.abs()).sum())
            else:
                row = W_row
            for k, v in x.items():
                pf, xf = gathered[k], v.reshape(1, -1).float()
                acc = torch.matmul(row[None], pf)
                acc = acc + row[a] * (xf - state.pub[k].reshape(1, -1).float())
                if cfg.kind != "clip":
                    corr, count, W_off = _trim_correction(W_row, t, a, xf[0], pf)
                    mass.add_(((W_off.double() * count.double()).sum() / pf.shape[1]).float())
                    acc = acc + corr[None]
                out[k].copy_(acc.reshape(v.shape))
        return out

    return round_once


def robust_async_gossip_times_program(engine, spec, *, periods):
    """``run(buffers, state, times, tau, mass, spare=None)``: ``times``
    robust async rounds in place, the carry ``state`` updated in place and
    the redirected mass added to ``mass``; ``tau`` an int or a 0-dim
    device tensor (on a mesh ``mass`` gets this rank's share)."""
    cfg, periods = as_robust_config(spec), engine._periods_tensor(periods)
    round_once = (_dense_async_robust_round(engine, cfg, periods) if engine.mesh is None
                  else _local_async_robust_round(engine, cfg, periods))

    def run(buffers: Stacked, state: AsyncGossipState, times: int, tau, mass: torch.Tensor,
            spare: Spare = None) -> None:
        engine._rounds(buffers, lambda t, _: t < times,
                       lambda x, out: round_once(x, out, state, tau, mass), spare)

    return run


def robust_async_gossip_program(engine, spec, *, tau: int, periods, times: int = 1):
    """:func:`robust_async_gossip_times_program` at a fixed round count
    and bound: ``run(buffers, state, mass, spare=None)``."""
    run = robust_async_gossip_times_program(engine, spec, periods=periods)
    return lambda buffers, state, mass, spare=None: run(buffers, state, int(times), int(tau),
                                                        mass, spare)
