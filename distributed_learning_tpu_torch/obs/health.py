"""Online health sentinel: declarative live-run rules over the merged
run registry.

The port's own copy of ``distributed_learning_tpu/obs/health.py``, which
imports no JAX either; only import paths and the names of the JAX
package's files differ.

Everything before this watched a run *post-mortem*: flight dumps are
written when something already died, and ``obs-report`` replays logs
after the fact.  The :class:`HealthSentinel` is the live half — the
master (or any aggregator owner) drives it once per merged telemetry
batch, it evaluates a small set of declarative :class:`HealthRule`\\ s
over the :class:`~distributed_learning_tpu_torch.obs.aggregate.RunAggregator`
registry, and on a breach it

* emits a ``health.breach`` event + ``health.breaches/<rule>`` counter
  + per-rule ``health.breached/<rule>`` gauge into the same registry
  (so breaches ride the aggregate JSONL stream into ``obs-monitor``'s
  live health section), and
* proactively triggers a reason-tagged
  :class:`~distributed_learning_tpu_torch.obs.flight.FlightRecorder` dump
  (``health-<rule>``) — the black box is written while the run is
  still alive, not after it died.

The default rule set covers the failure modes the comm stack already
counts but nothing watched (the JAX package's docs/observability.md §Health sentinel):

===========================  ==========================================
rule                         breaches when
===========================  ==========================================
``consensus-stall``          a ``consensus.residual/<token>`` series
                             stopped improving over its trailing window
``staleness-pressure``       the mean mixed staleness
                             (``comm.agent.staleness/*``) exceeds the
                             configured tau pressure bound
``round-latency-regression`` the recent mean round wall time regressed
                             past ``factor`` x the rolling baseline of
                             earlier rounds
``wire-error-storm``         wire-error counters (frame retries, codec
                             drops, robust-gossip violations/
                             quarantines, injected faults) grew by more
                             than ``threshold`` since the last
                             evaluation
``eviction-pressure``        the obs plane itself is losing data
                             (``obs.deltas_lost`` +
                             ``obs.delta_events_dropped/*`` growth)
===========================  ==========================================

Growth-based rules prime on their first evaluation (no breach on the
first batch — a restarted master must not re-fire on totals it never
saw grow).  Evaluation is host-side, jax-free, and never raises: a rule
that throws is counted (``health.rule_errors``) and skipped, because a
monitoring plane must not be able to kill the run it watches.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

from distributed_learning_tpu_torch.obs.flight import FlightRecorder
from distributed_learning_tpu_torch.obs.registry import MetricsRegistry

__all__ = [
    "HealthBreach",
    "HealthRule",
    "HealthSentinel",
    "default_rules",
]


@dataclasses.dataclass(frozen=True)
class HealthBreach:
    """One rule violation at one evaluation."""

    rule: str
    detail: str
    value: float
    threshold: float


class HealthRule:
    """Base: subclasses set ``name``/``description`` and implement
    :meth:`check` against the sentinel's evaluation context."""

    name = "rule"
    description = ""

    def check(self, ctx: "HealthSentinel") -> Optional[HealthBreach]:
        raise NotImplementedError


def _series_tails(registry: MetricsRegistry, prefix: str,
                  n: int) -> Dict[str, List[float]]:
    """label -> last ``n`` values, for every series under ``prefix``."""
    out: Dict[str, List[float]] = {}
    for name, pts in registry.series.items():
        if name == prefix.rstrip("/") or name.startswith(prefix):
            vals = [v for _s, v in pts]
            if vals:
                out[name] = vals[-n:]
    return out


class ConsensusStallRule(HealthRule):
    """A consensus residual that stopped shrinking: the run burns
    rounds without converging (dead link, diverged weights, a
    Byzantine neighbor past the defense's budget)."""

    name = "consensus-stall"
    description = ("consensus.residual stopped improving over its "
                   "trailing window")

    def __init__(self, *, window: int = 6, min_drop: float = 0.02,
                 floor: float = 1e-6):
        self.window = int(window)
        self.min_drop = float(min_drop)
        self.floor = float(floor)

    def check(self, ctx: "HealthSentinel") -> Optional[HealthBreach]:
        worst: Optional[HealthBreach] = None
        for name, pts in ctx.registry.series.items():
            if not name.startswith("consensus.residual"):
                continue
            vals = [v for _s, v in pts][-self.window:]
            if len(vals) < self.window:
                continue
            first, last = vals[0], vals[-1]
            if first <= self.floor:
                continue  # converged; nothing left to improve
            improvement = (first - last) / abs(first)
            if improvement < self.min_drop:
                br = HealthBreach(
                    rule=self.name,
                    detail=(
                        f"{name}: {first:.3g} -> {last:.3g} over last "
                        f"{self.window} points "
                        f"({improvement * 100:.1f}% < "
                        f"{self.min_drop * 100:.0f}% drop)"
                    ),
                    value=improvement,
                    threshold=self.min_drop,
                )
                if worst is None or br.value < worst.value:
                    worst = br
        return worst


class StalenessPressureRule(HealthRule):
    """Mixed staleness blowing past the tau the schedule was tuned for:
    the async runtime is mixing mostly-old values, convergence quality
    degrades silently (the JAX package's docs/async_runtime.md, tau trade-off)."""

    name = "staleness-pressure"
    description = "mean mixed staleness exceeds the tau pressure bound"

    def __init__(self, *, max_mean: float = 4.0, window: int = 16):
        self.max_mean = float(max_mean)
        self.window = int(window)

    def check(self, ctx: "HealthSentinel") -> Optional[HealthBreach]:
        tails = _series_tails(
            ctx.registry, "comm.agent.staleness/", self.window
        )
        vals = [v for tail in tails.values() for v in tail]
        if not vals:
            return None
        mean = sum(vals) / len(vals)
        if mean <= self.max_mean:
            return None
        return HealthBreach(
            rule=self.name,
            detail=(
                f"mean mixed staleness {mean:.2f} > {self.max_mean:g} "
                f"over {len(vals)} recent mixes "
                f"(max {max(vals):.0f})"
            ),
            value=mean,
            threshold=self.max_mean,
        )


class RoundLatencyRegressionRule(HealthRule):
    """Recent rounds run ``factor``x slower than the rolling healthy
    baseline: a link went bad, a host started swapping, a straggler
    appeared — catch it from the trend, before the deadline logic has
    to amputate anyone."""

    name = "round-latency-regression"
    description = ("recent mean round wall time regressed vs the "
                   "rolling healthy baseline")

    def __init__(self, *, factor: float = 2.0, recent: int = 5,
                 min_history: int = 10):
        self.factor = float(factor)
        self.recent = int(recent)
        self.min_history = int(min_history)

    def _candidates(
        self, registry: MetricsRegistry
    ) -> Sequence[Tuple[str, List[float]]]:
        for prefix in ("comm.master.round_s", "comm.agent.round_s/",
                       "comm.agent.async_round_s/"):
            tails = _series_tails(registry, prefix, 1 << 30)
            if tails:
                return sorted(tails.items())
        return ()

    def check(self, ctx: "HealthSentinel") -> Optional[HealthBreach]:
        worst: Optional[HealthBreach] = None
        for label, vals in self._candidates(ctx.registry):
            if len(vals) < max(self.min_history, self.recent + 1):
                continue
            baseline_vals = vals[:-self.recent]
            baseline = sum(baseline_vals) / len(baseline_vals)
            recent = sum(vals[-self.recent:]) / self.recent
            if baseline <= 0 or recent <= self.factor * baseline:
                continue
            br = HealthBreach(
                rule=self.name,
                detail=(
                    f"{label}: recent mean {recent:.4f}s > "
                    f"{self.factor:g}x baseline {baseline:.4f}s "
                    f"(last {self.recent} of {len(vals)} rounds)"
                ),
                value=recent / baseline,
                threshold=self.factor,
            )
            if worst is None or br.value > worst.value:
                worst = br
        return worst


class WireErrorStormRule(HealthRule):
    """Wire-error counters growing in a burst: frame retries, codec
    drops, robust-gossip violations/quarantines, injected faults.  Any
    one of them trickling is survivable; a storm means an edge (or a
    peer) is actively failing."""

    name = "wire-error-storm"
    description = ("wire error/quarantine counters grew past the "
                   "storm threshold since the last evaluation")

    #: substrings of BARE (unlabeled) counter names that count as wire
    #: errors.  comm.faults.* is matched by prefix: its bare per-kind
    #: counters (comm.faults.drop, ...) have no label dimension.
    MARKERS = ("frame_retries", "crc_drop", "decode_failed",
               "validation", "violation", "quarantin")

    def __init__(self, *, threshold: float = 10.0):
        self.threshold = float(threshold)

    def check(self, ctx: "HealthSentinel") -> Optional[HealthBreach]:
        total = 0.0
        for name, v in ctx.counters.items():
            if "/" in name:
                continue
            if name.startswith("comm.faults.") or any(
                m in name for m in self.MARKERS
            ):
                total += float(v)
        growth = ctx.growth(self.name, total)
        if growth is None or growth < self.threshold:
            return None
        return HealthBreach(
            rule=self.name,
            detail=(
                f"wire errors grew by {growth:g} since the last "
                f"evaluation (total {total:g})"
            ),
            value=growth,
            threshold=self.threshold,
        )


class EvictionPressureRule(HealthRule):
    """The obs plane itself is shedding data: lost telemetry deltas or
    agent-side event-buffer evictions growing means every OTHER signal
    here is becoming partial — surface it before trusting them."""

    name = "eviction-pressure"
    description = ("obs.deltas_lost / delta_events_dropped grew past "
                   "the eviction threshold since the last evaluation")

    def __init__(self, *, threshold: float = 64.0):
        self.threshold = float(threshold)

    def check(self, ctx: "HealthSentinel") -> Optional[HealthBreach]:
        total = float(ctx.counters.get("obs.deltas_lost", 0))
        for name, v in ctx.counters.items():
            if (name.startswith("obs.delta_events_dropped/")
                    and name.count("/") == 1):
                total += float(v)
        growth = ctx.growth(self.name, total)
        if growth is None or growth < self.threshold:
            return None
        return HealthBreach(
            rule=self.name,
            detail=(
                f"obs-plane data loss grew by {growth:g} since the "
                f"last evaluation (total {total:g})"
            ),
            value=growth,
            threshold=self.threshold,
        )


def default_rules() -> Tuple[HealthRule, ...]:
    """The five stock rules with their default thresholds."""
    return (
        ConsensusStallRule(),
        StalenessPressureRule(),
        RoundLatencyRegressionRule(),
        WireErrorStormRule(),
        EvictionPressureRule(),
    )


class HealthSentinel:
    """Evaluates :class:`HealthRule`\\ s over a merged run registry.

    Drive it from whoever owns the :class:`RunAggregator` — the master
    calls :meth:`evaluate` after each merged telemetry batch
    (``ConsensusMaster(sentinel=...)``).  Breaches are emitted into the
    SAME registry the rules read (``health.*`` names are never
    themselves rule inputs), and each breached rule triggers one
    reason-tagged flight dump per ``cooldown_s`` window so a persistent
    breach cannot write an unbounded dump stream.
    """

    def __init__(self, registry: MetricsRegistry, *,
                 flight: Optional[FlightRecorder] = None,
                 rules: Optional[Sequence[HealthRule]] = None,
                 cooldown_s: float = 30.0,
                 counters_source: Optional[
                     Callable[[], Mapping[str, float]]
                 ] = None):
        self.registry = registry
        self.flight = flight
        self.rules: Tuple[HealthRule, ...] = tuple(
            rules if rules is not None else default_rules()
        )
        self.cooldown_s = float(cooldown_s)
        self._counters_source = counters_source
        self._growth_baseline: Dict[str, float] = {}
        self._last_dump: Dict[str, float] = {}
        self.breaches: List[HealthBreach] = []
        #: rule evaluation context, refreshed per evaluate() call.
        self.counters: Mapping[str, float] = {}

    # ------------------------------------------------------------------ #
    def growth(self, key: str, value: float) -> Optional[float]:
        """Delta of ``value`` since the last evaluation that reported
        ``key``; None on the priming observation (a fresh sentinel must
        not breach on totals it never watched grow)."""
        prev = self._growth_baseline.get(key)
        self._growth_baseline[key] = float(value)
        if prev is None:
            return None
        return float(value) - prev

    # ------------------------------------------------------------------ #
    def evaluate(self, *, counters: Optional[Mapping[str, float]] = None
                 ) -> List[HealthBreach]:
        """Run every rule once; record + return this batch's breaches.

        ``counters`` overrides the registry totals for replayed streams
        (the ``obs-monitor`` path), like the profile functions.  Never
        raises: rule exceptions are counted and skipped.
        """
        if counters is not None:
            self.counters = counters
        elif self._counters_source is not None:
            self.counters = self._counters_source()
        else:
            self.counters = self.registry.counters
        breaches: List[HealthBreach] = []
        for rule in self.rules:
            try:
                br = rule.check(self)
            except Exception:
                self.registry.inc("health.rule_errors")
                self.registry.inc(f"health.rule_errors/{rule.name}")
                continue
            self.registry.gauge(
                f"health.breached/{rule.name}",
                1.0 if br is not None else 0.0,
            )
            if br is not None:
                breaches.append(br)
        for br in breaches:
            self.breaches.append(br)
            self.registry.inc("health.breaches")
            self.registry.inc(f"health.breaches/{br.rule}")
            self.registry.event(
                "health.breach", rule=br.rule, detail=br.detail,
                value=br.value, threshold=br.threshold,
            )
            self._maybe_dump(br)
        return breaches

    def _maybe_dump(self, br: HealthBreach) -> None:
        if self.flight is None:
            return
        now = time.monotonic()
        last = self._last_dump.get(br.rule)
        if last is not None and now - last < self.cooldown_s:
            return
        self._last_dump[br.rule] = now
        try:
            self.flight.trigger(
                f"health-{br.rule}", rule=br.rule, detail=br.detail,
                value=br.value, threshold=br.threshold,
            )
            self.registry.inc("health.flight_dumps")
        except Exception:
            # The black box failing to write must not take down the
            # run the sentinel is protecting.
            self.registry.inc("health.flight_dump_failed")

    # ------------------------------------------------------------------ #
    def breached_rules(self) -> List[str]:
        """Distinct rule names breached so far, in first-breach order."""
        seen: List[str] = []
        for br in self.breaches:
            if br.rule not in seen:
                seen.append(br.rule)
        return seen
