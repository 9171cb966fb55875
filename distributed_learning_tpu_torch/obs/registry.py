"""Metrics registry: counters, gauges, time-series, and an event log.

The port's own copy of ``distributed_learning_tpu/obs/registry.py``, which
imports no JAX either; only import paths and the names of the JAX
package's files differ.

The reference has no observability beyond ad-hoc ``_debug`` prints
(``consensus_tcp/master.py:63-68``, ``consensus_tcp/agent.py:46-51``)
and notebook ``%time`` cells; decentralized-training work lives on
exactly the signals those prints threw away — consensus residuals,
communication volume, gossip-round counts (the headline traces of
arXiv 2105.09080 and the local/communication step accounting of
arXiv 1805.09767).  This registry is the one sink for all of them:

* **counters** — monotonically increasing totals (`inc`): gossip rounds
  run/aborted, bytes framed, batches prefetched;
* **gauges** — last-value-wins scalars (`gauge`): queue depth, current
  learning rate;
* **time-series** — `(step, value)` observations (`observe`): per-chunk
  loss, grad norm, consensus residual;
* **events** — series points, spans, and free-form events append to an
  ordered log (counters/gauges stay aggregate-only so per-frame byte
  counts cannot flood it; exports snapshot their totals), each line of
  which is one JSON object (the JSONL event-log exporter) replayable by
  ``MetricsRegistry.from_jsonl`` — a run report builds offline from the
  file alone (``python -m distributed_learning_tpu_torch.cli obs-report
  run.jsonl``).

Everything here is host-side and jax-free: device-side metrics ride the
jitted chunk's existing outputs (see :mod:`~distributed_learning_tpu_torch.obs.carry`)
and reach the registry once per chunk, never per step.

Thread-safe: the trainer's host loop, the prefetch daemon thread, and
the asyncio comm backend all write to one registry.
"""

from __future__ import annotations

import collections
import contextlib
import json
import threading
import time
from typing import Any, Callable, Dict, Hashable, IO, Iterator, List, Mapping, Optional

from distributed_learning_tpu_torch.utils.telemetry import TelemetryProcessor

__all__ = [
    "MetricsRegistry",
    "JsonlSink",
    "JsonlTelemetry",
    "get_registry",
    "set_registry",
    "use_registry",
    "read_jsonl",
    "run_report",
]


class MetricsRegistry:
    """One run's metrics: counters / gauges / series plus the event log.

    ``max_events`` bounds the in-memory log as a ring (the *last* N
    events are retained — the flight-recorder semantics a post-mortem
    needs); ``max_points`` does the same per series.  Aggregates —
    counters, gauges, series summaries, span stats — are exact
    regardless of either cap, evictions are counted (visible in
    :meth:`snapshot` / :meth:`run_report`), and a :class:`JsonlSink`
    streams the *full* log to disk when nothing may be lost.
    ``max_points=None`` keeps the pre-ring unbounded-list behaviour
    (explicit opt-in for short-lived test registries); the process-wide
    default registry — the one the comm layer counts into — is
    constructed bounded.
    """

    def __init__(self, *, clock: Callable[[], float] = time.time,
                 max_events: int = 1 << 20,
                 max_points: Optional[int] = None):
        self._lock = threading.Lock()
        self._clock = clock
        self._max_events = int(max_events)
        self._max_points = None if max_points is None else int(max_points)
        self._dropped_events = 0
        self.points_dropped: Dict[str, int] = {}
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        # name -> sequence of (step, value); step may be None (arrival
        # order).  A deque ring when max_points is set, a plain list
        # otherwise (so unbounded registries keep list semantics).
        self.series: Dict[str, Any] = {}
        # name -> [count, total_s, max_s] span aggregates.
        self.span_stats: Dict[str, List[float]] = {}
        self.events: Any = (
            collections.deque(maxlen=self._max_events)
            if self._max_events else []
        )
        self._sinks: List[Callable[[dict], None]] = []

    # ------------------------------------------------------------------ #
    def add_sink(self, sink: Callable[[dict], None]) -> None:
        """Stream every event dict to ``sink`` as it is recorded (e.g. a
        :class:`JsonlSink`); long runs stream metrics instead of holding
        them until exit."""
        with self._lock:
            self._sinks.append(sink)

    def remove_sink(self, sink: Callable[[dict], None]) -> None:
        """Detach a sink added with :meth:`add_sink` (no-op if absent)."""
        with self._lock:
            try:
                self._sinks.remove(sink)
            except ValueError:
                pass

    def recent_events(self) -> List[dict]:
        """A consistent copy of the retained event log (oldest first) —
        what a late-attached consumer (delta source, flight ring) backfills
        from."""
        with self._lock:
            return list(self.events)

    def _new_series(self):
        if self._max_points is None:
            return []
        return collections.deque(maxlen=self._max_points)

    def _record(self, event: dict) -> None:
        # Caller holds the lock.  The event log is a ring: at capacity
        # the OLDEST event is evicted (and counted), so a post-mortem
        # reads the run's tail, not its first hour.
        if (self._max_events and len(self.events) >= self._max_events):
            self._dropped_events += 1
        self.events.append(event)
        for sink in self._sinks:
            sink(event)

    # ------------------------------------------------------------------ #
    def inc(self, name: str, value: float = 1.0) -> float:
        """Add ``value`` to counter ``name``; returns the new total.

        Counters are hot-path-friendly: an inc is a lock + dict update,
        no per-inc event (per-frame byte counts would otherwise flood
        the log); the export paths snapshot the totals instead."""
        with self._lock:
            total = self.counters.get(name, 0.0) + float(value)
            self.counters[name] = total
            return total

    def gauge(self, name: str, value: float) -> None:
        """Last-value-wins scalar (same aggregate-only discipline as
        counters; use :meth:`observe` when the history matters)."""
        with self._lock:
            self.gauges[name] = float(value)

    def observe(self, name: str, value: float,
                step: Optional[int] = None) -> None:
        """Append one time-series observation (ring-evicting the oldest
        point, counted in ``points_dropped``, when ``max_points`` is
        set)."""
        with self._lock:
            pts = self.series.get(name)
            if pts is None:
                pts = self.series[name] = self._new_series()
            if (self._max_points is not None
                    and len(pts) >= self._max_points):
                self.points_dropped[name] = (
                    self.points_dropped.get(name, 0) + 1
                )
            pts.append(
                (None if step is None else int(step), float(value))
            )
            ev = {
                "ts": self._clock(), "kind": "series", "name": name,
                "value": float(value),
            }
            if step is not None:
                ev["step"] = int(step)
            self._record(ev)

    def record_span(self, name: str, dur_s: float, *, depth: int = 0,
                    t0: Optional[float] = None) -> None:
        """Aggregate + log one completed wall-clock span (the
        :class:`~distributed_learning_tpu_torch.obs.spans.SpanTracer` calls
        this; spans are events too, so the JSONL log replays them).
        ``t0``, when known, is the span's wall-clock (unix-epoch) start
        — the anchor that lets per-agent logs merge onto one
        timeline."""
        with self._lock:
            agg = self.span_stats.setdefault(name, [0, 0.0, 0.0])
            agg[0] += 1
            agg[1] += float(dur_s)
            agg[2] = max(agg[2], float(dur_s))
            ev = {
                "ts": self._clock(), "kind": "span", "name": name,
                "value": float(dur_s), "depth": int(depth),
            }
            if t0 is not None:
                ev["t0"] = float(t0)
            self._record(ev)

    def event(self, name: str, **fields: Any) -> None:
        """Free-form event (e.g. a telemetry payload, a round abort)."""
        with self._lock:
            ev = {"ts": self._clock(), "kind": "event", "name": name}
            ev.update(fields)
            self._record(ev)

    # ------------------------------------------------------------------ #
    def snapshot(self) -> dict:
        """Current aggregate state (counters, gauges, series lengths);
        ``dropped`` makes ring truncation visible."""
        with self._lock:
            return {
                "counters": dict(self.counters),
                "gauges": dict(self.gauges),
                "series": {k: len(v) for k, v in self.series.items()},
                "spans": {k: int(v[0]) for k, v in self.span_stats.items()},
                "dropped": {
                    "events": self._dropped_events,
                    "series_points": sum(self.points_dropped.values()),
                },
            }

    def run_report(self) -> dict:
        """Aggregated run summary: counter totals, last gauges, per-series
        count/mean/min/max/last, per-span count/total/mean/max."""
        with self._lock:
            series = {}
            for name, pts in self.series.items():
                vals = [v for _, v in pts]
                last_step = next(
                    (s for s, _ in reversed(pts) if s is not None), None
                )
                series[name] = {
                    "count": len(vals),
                    "mean": sum(vals) / len(vals),
                    "min": min(vals),
                    "max": max(vals),
                    "last": vals[-1],
                    "last_step": last_step,
                }
                # Ring eviction is visible: stats cover the retained
                # window, "dropped" says how much history it lost.
                if self.points_dropped.get(name):
                    series[name]["dropped"] = self.points_dropped[name]
            spans = {
                name: {
                    "count": int(c),
                    "total_s": total,
                    "mean_s": total / c if c else 0.0,
                    "max_s": mx,
                }
                for name, (c, total, mx) in self.span_stats.items()
            }
            report = {
                "counters": dict(self.counters),
                "gauges": dict(self.gauges),
                "series": series,
                "spans": spans,
                "events": len(self.events) + self._dropped_events,
            }
            if self._dropped_events:
                report["events_dropped"] = self._dropped_events
            if self.events:
                report["wall_s"] = (
                    self.events[-1]["ts"] - self.events[0]["ts"]
                )
            return report

    # -- JSONL event-log exporter -------------------------------------- #
    def dump_jsonl(self, path: str) -> int:
        """Write the event log, one JSON object per line, followed by a
        counter/gauge totals snapshot (counters record no per-inc
        events, so the snapshot is how they reach the file); returns
        the number of lines written."""
        ts = self._clock()
        with self._lock:
            events = list(self.events)
            events += [
                {"ts": ts, "kind": "counter", "name": k, "total": v}
                for k, v in sorted(self.counters.items())
            ]
            events += [
                {"ts": ts, "kind": "gauge", "name": k, "value": v}
                for k, v in sorted(self.gauges.items())
            ]
        with open(path, "w", encoding="utf-8") as fh:
            for ev in events:
                fh.write(json.dumps(ev, sort_keys=True) + "\n")
        return len(events)

    @classmethod
    def from_jsonl(cls, path: str) -> "MetricsRegistry":
        """Rebuild a registry by replaying a JSONL event log (the
        round-trip inverse of :meth:`dump_jsonl`; timestamps are
        preserved from the file, not re-stamped)."""
        return cls.from_events(read_jsonl(path))

    @classmethod
    def from_events(cls, events) -> "MetricsRegistry":
        """Rebuild a registry by replaying an iterable of event dicts
        (what :meth:`from_jsonl` and the tolerant mid-write reader of
        ``obs-monitor`` share)."""
        reg = cls()
        for ev in events:
            kind = ev.get("kind")
            name = ev.get("name", "")
            if kind == "counter":
                # Snapshot lines carry the running total (authoritative);
                # plain increment lines add up.
                if "total" in ev:
                    reg.counters[name] = ev["total"]
                else:
                    reg.counters[name] = (
                        reg.counters.get(name, 0.0) + ev.get("value", 0.0)
                    )
            elif kind == "gauge":
                reg.gauges[name] = ev.get("value", 0.0)
            elif kind == "series":
                reg.series.setdefault(name, []).append(
                    (ev.get("step"), ev.get("value", 0.0))
                )
            elif kind == "span":
                agg = reg.span_stats.setdefault(name, [0, 0.0, 0.0])
                agg[0] += 1
                agg[1] += ev.get("value", 0.0)
                agg[2] = max(agg[2], ev.get("value", 0.0))
            reg.events.append(ev)
        return reg


def read_jsonl(path: str) -> Iterator[dict]:
    """Yield each non-blank line of a JSONL file as a dict."""
    with open(path, "r", encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if line:
                yield json.loads(line)


def run_report(path: str) -> dict:
    """Run-report exporter over an on-disk JSONL event log."""
    return MetricsRegistry.from_jsonl(path).run_report()


class JsonlSink:
    """Streaming JSONL writer: attach with ``registry.add_sink(sink)``
    and every event lands on disk (flushed) the moment it is recorded —
    a crash loses nothing, a long run never buffers unboundedly."""

    def __init__(self, path_or_file: Any):
        self._own = isinstance(path_or_file, (str, bytes))
        self._fh: IO = (
            open(path_or_file, "a", encoding="utf-8")
            if self._own else path_or_file
        )
        self._lock = threading.Lock()

    def __call__(self, event: Mapping[str, Any]) -> None:
        with self._lock:
            self._fh.write(json.dumps(dict(event), sort_keys=True) + "\n")
            self._fh.flush()

    def close(self) -> None:
        if self._own:
            self._fh.close()


class JsonlTelemetry(TelemetryProcessor):
    """:class:`TelemetryProcessor` that streams each per-node payload to
    a JSONL file as it arrives — the trainer flushes telemetry once per
    jitted chunk, so a long run's metrics are on disk while it trains
    instead of only at exit.  The abstract ``process(token, payload)``
    interface is unchanged; existing subclasses are unaffected."""

    def __init__(self, path: str, *,
                 registry: Optional[MetricsRegistry] = None):
        self._sink = JsonlSink(path)
        self._registry = registry
        self._clock = time.time

    def process(self, token: Hashable, payload: Any) -> None:
        self._sink({
            "ts": self._clock(), "kind": "event", "name": "telemetry",
            "token": str(token), "payload": payload,
        })
        if self._registry is not None:
            self._registry.event("telemetry", token=str(token),
                                 payload=payload)

    def close(self) -> None:
        self._sink.close()


# ---------------------------------------------------------------------- #
# Default (process-wide) registry                                        #
# ---------------------------------------------------------------------- #
# Bounded by default: the comm/prefetch layers count into this registry
# for the life of the process, and an unbounded series (one residual
# observation per gossip round, forever) is a slow memory leak on a
# long-lived agent.  The rings keep the last 16Ki points per series /
# 64Ki events; evictions stay visible via ``points_dropped`` /
# ``events_dropped``.
_DEFAULT = MetricsRegistry(max_points=1 << 14, max_events=1 << 16)
_DEFAULT_LOCK = threading.Lock()


def get_registry() -> MetricsRegistry:
    """The process-wide default registry (what the comm/prefetch layers
    count into when no explicit registry is wired through)."""
    return _DEFAULT


def set_registry(registry: MetricsRegistry) -> MetricsRegistry:
    """Replace the default registry; returns the previous one."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        prev, _DEFAULT = _DEFAULT, registry
        return prev


@contextlib.contextmanager
def use_registry(registry: MetricsRegistry) -> Iterator[MetricsRegistry]:
    """Scope the default registry (tests isolate their counters with
    this)."""
    prev = set_registry(registry)
    try:
        yield registry
    finally:
        set_registry(prev)
