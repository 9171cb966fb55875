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
in taking the count per call.  The sharded halves of the reference
(``_local_clipped_once``, ``_local_trimmed_once``,
``_local_async_robust_round``) wait for the engine on
``torch.distributed`` (ROADMAP.md).
"""

from __future__ import annotations

from typing import Mapping, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from distributed_learning_tpu_torch.ops import mixing as ops
from distributed_learning_tpu_torch.parallel.consensus import AsyncGossipState

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
    the reference sums it) added to the 0-dim device tensor ``mass``."""
    round_once = _dense_robust_round(engine, as_robust_config(spec))

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


def robust_async_gossip_times_program(engine, spec, *, periods):
    """``run(buffers, state, times, tau, mass, spare=None)``: ``times``
    robust async rounds in place, the carry ``state`` updated in place and
    the redirected mass added to ``mass``; ``tau`` an int or a 0-dim
    device tensor."""
    round_once = _dense_async_robust_round(engine, as_robust_config(spec),
                                           engine._periods_tensor(periods))

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
