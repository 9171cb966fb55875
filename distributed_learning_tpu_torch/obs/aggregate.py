"""Run-wide observability plane: merge per-agent metric streams into one
run registry, straggler profiles, and merged cross-agent traces.

The port's own copy of ``distributed_learning_tpu/obs/aggregate.py``, which
imports no JAX either; only import paths and the names of the JAX
package's files differ.

PR 2 gave every *process* a :class:`MetricsRegistry`; this module gives
the *run* one.  Each agent periodically packs a delta of its registry —
counter totals, gauges, and the events recorded since the last pack
(series points, wall-anchored spans, free-form events) — into the
existing ``Telemetry`` wire message as a structured payload
(:data:`OBS_PAYLOAD_KIND`, versioned; re-exported by
the JAX package's ``comm/protocol.py`` as part of the wire surface).  The master hands
every payload to a :class:`RunAggregator`, which

* merges the streams into ONE registry with per-agent label dimensions
  (``comm.agent.rounds_run/a`` per agent + the run-wide
  ``comm.agent.rounds_run`` sum — the same ``name/label`` convention the
  trainer uses for ``train.loss/node``);
* computes **straggler profiles** (:func:`straggler_profile_from_registry`):
  per-agent round-latency percentiles + histograms, per-round
  slowest-agent attribution from the master's arrival lags, round skew,
  and the staleness picture from the existing
  ``stale_requests_dropped`` / ``requests_deferred`` counters — exactly
  the signals stale-weighted mixing and deadline rounds
  (arxiv.org/pdf/2002.01119) and adaptive synchronization
  (arxiv.org/pdf/1910.13598) need as input;
* feeds every merged event into the
  :class:`~distributed_learning_tpu_torch.obs.flight.FlightRecorder` ring, so
  a fault dump carries each agent's recent history;
* exports a **merged Chrome/Perfetto trace**: one track (pid) per
  agent, span starts wall-clock-anchored (``SpanTracer.wall0``), so N
  processes' spans land on one shared timeline.

Everything is host-side and jax-free (the ``obs-report`` /
``obs-monitor`` CLIs replay these structures offline); nothing here may
touch a jitted program — the plane observes training, it never joins
it.
"""

from __future__ import annotations

import collections
import math
import threading
import time
from typing import Any, Dict, List, Mapping, Optional, Tuple

from distributed_learning_tpu_torch.obs.flight import FlightRecorder
from distributed_learning_tpu_torch.obs.registry import MetricsRegistry
from distributed_learning_tpu_torch.obs.sketch import (
    DEFAULT_ALPHA,
    LabelRollup,
    QuantileSketch,
)
from distributed_learning_tpu_torch.obs.spans import FLOW_EVENT, FLOW_PHASES
from distributed_learning_tpu_torch.utils.telemetry import TelemetryProcessor

__all__ = [
    "OBS_PAYLOAD_KIND",
    "OBS_PAYLOAD_VERSION",
    "OBS_PAYLOAD_SECTIONS",
    "SKETCH_SERIES",
    "is_obs_payload",
    "ObsDeltaSource",
    "RunAggregator",
    "SubAggregator",
    "straggler_profile_from_registry",
    "edge_profile_from_registry",
]

#: ``payload["kind"]`` marking a Telemetry payload as a registry delta
#: (any other payload is opaque user telemetry, recorded as-is).
OBS_PAYLOAD_KIND = "obs.delta"
#: Schema version inside the payload (``payload["v"]``).  Bump on
#: incompatible layout changes; the aggregator records-but-skips
#: payloads from the future instead of crashing a running master.
#: v2 (fleet-scale plane): adds the ``sketches``/``rollups`` sections
#: and the ``agg`` sub-aggregator flag; v1 payloads still merge (the
#: new sections are simply absent, and the aggregator derives sketches
#: from the raw series they carry).
OBS_PAYLOAD_VERSION = 2

#: The payload's section keys, in wire order — part of the declared
#: wire surface (re-exported by the JAX package's ``comm/protocol.py``, cross-checked
#: and pinned by its wire-contract lint): adding/renaming a
#: section is a schema change and must ride a version bump through
#: ``--audit-write``.
OBS_PAYLOAD_SECTIONS = ("counters", "gauges", "events", "sketches", "rollups")

#: Series (by name, or ``name/<label>``) summarized as mergeable
#: quantile sketches in v2 deltas — the straggler/edge/latency paths
#: whose percentiles the profiles render.  Everything else (loss
#: curves, residual trends) keeps raw points: order matters there.
SKETCH_SERIES = (
    "straggler.lag_s",
    "straggler.skew_s",
    "comm.agent.round_s",
    "comm.agent.async_round_s",
    "comm.agent.staleness",
    "comm.edge.latency_s",
    "comm.edge.staleness",
    "comm.master.round_s",
)


def _sketched(name: str) -> bool:
    """Whether series ``name`` belongs to a sketched metric family."""
    for base in SKETCH_SERIES:
        if name == base or name.startswith(base + "/"):
            return True
    return False

#: Round-latency histogram bucket upper bounds (seconds; last is +inf).
LATENCY_BUCKETS_S = (
    0.001, 0.003, 0.01, 0.03, 0.1, 0.3, 1.0, 3.0, 10.0, math.inf,
)


def is_obs_payload(payload: Any) -> bool:
    """Whether a Telemetry payload is a structured registry delta."""
    return (
        isinstance(payload, Mapping)
        and payload.get("kind") == OBS_PAYLOAD_KIND
    )


# ---------------------------------------------------------------------- #
# Agent side: incremental registry deltas                                #
# ---------------------------------------------------------------------- #
class ObsDeltaSource:
    """Packs a registry's growth since the last pack into an
    ``obs.delta`` payload.

    Counters/gauges travel as *absolute totals* (idempotent: a lost or
    repeated delta cannot double-count — the aggregator diffs against
    the last totals it saw); series points, spans, and events travel as
    the buffered event stream (a sink registered on the registry, so
    packing is O(new events), never a rescan).  ``seq`` increments per
    pack; gaps tell the aggregator how many deltas a flaky wire lost.

    v2 (fleet-scale plane): points of the :data:`SKETCH_SERIES`
    families additionally fold into per-pack
    :class:`~distributed_learning_tpu_torch.obs.sketch.QuantileSketch` deltas
    (``payload["sketches"]``, drained each pack — the aggregator merges
    them by pure addition, so seq dedup/gap accounting carries over
    unchanged).  ``raw_series=False`` is the fleet mode: sketched
    series stop travelling as raw points entirely, making the delta's
    byte size O(metrics) instead of O(samples); the substitution is
    disclosed per pack (``series_sketched``), never silent.
    """

    def __init__(self, registry: MetricsRegistry, *,
                 max_buffer: int = 4096, backfill: bool = True,
                 sketch: bool = True, sketch_alpha: float = DEFAULT_ALPHA,
                 raw_series: bool = True):
        self._registry = registry
        self._lock = threading.Lock()
        self._buffer: collections.deque = collections.deque(
            maxlen=int(max_buffer)
        )
        self._dropped = 0
        self._seq = 0
        self._closed = False
        self._sketch = bool(sketch)
        self._sketch_alpha = float(sketch_alpha)
        self._raw_series = bool(raw_series)
        self._pending_sketches: Dict[str, QuantileSketch] = {}
        self._suppressed = 0
        if backfill:
            # A late-attached source still ships the registry's retained
            # history in its first delta (events recorded before the
            # sink existed would otherwise be invisible to the run).
            for ev in registry.recent_events():
                self._ingest(dict(ev))
        registry.add_sink(self._sink)

    def _sink(self, event: Mapping[str, Any]) -> None:
        self._ingest(dict(event))

    def _ingest(self, event: dict) -> None:
        with self._lock:
            if (event.get("kind") == "series"
                    and _sketched(event.get("name", ""))):
                if self._sketch:
                    name = event["name"]
                    sk = self._pending_sketches.get(name)
                    if sk is None:
                        sk = self._pending_sketches[name] = QuantileSketch(
                            self._sketch_alpha
                        )
                    sk.add(float(event.get("value", 0.0)))
                if not self._raw_series:
                    # Fleet mode: the sketch IS the wire form of this
                    # point; count the substitution so it is visible.
                    self._suppressed += 1
                    return
            if (self._buffer.maxlen is not None
                    and len(self._buffer) >= self._buffer.maxlen):
                self._dropped += 1
            self._buffer.append(event)

    def pack(self) -> dict:
        """One delta payload; drains the event buffer and the pending
        sketch deltas."""
        with self._lock:
            events = list(self._buffer)
            self._buffer.clear()
            dropped, self._dropped = self._dropped, 0
            suppressed, self._suppressed = self._suppressed, 0
            sketches = {
                name: sk.to_dict()
                for name, sk in sorted(self._pending_sketches.items())
            }
            self._pending_sketches.clear()
            self._seq += 1
            seq = self._seq
        snap = self._registry.snapshot()
        payload = {
            "kind": OBS_PAYLOAD_KIND,
            "v": OBS_PAYLOAD_VERSION,
            "seq": seq,
            "wall": time.time(),
            "counters": snap["counters"],
            "gauges": snap["gauges"],
            "events": events,
        }
        if sketches:
            payload["sketches"] = sketches
        if dropped:
            payload["events_dropped"] = dropped
        if suppressed:
            payload["series_sketched"] = suppressed
        return payload

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._registry.remove_sink(self._sink)


# ---------------------------------------------------------------------- #
# Master side: the run aggregator                                        #
# ---------------------------------------------------------------------- #
class _AgentView:
    """Per-agent merge state inside the aggregator."""

    __slots__ = ("last_seq", "counters", "spans", "flows", "last_wall")

    def __init__(self, max_spans: int):
        self.last_seq = 0
        self.counters: Dict[str, float] = {}
        # (name, wall_t0, dur_s, depth) for the merged trace.
        self.spans: collections.deque = collections.deque(maxlen=max_spans)
        # trace.flow frame-lifecycle events ({phase, origin, seq, run,
        # edge, ts, ...}) — the arrow-linked causal chains of the
        # merged trace.
        self.flows: collections.deque = collections.deque(maxlen=max_spans)
        self.last_wall: Optional[float] = None


class RunAggregator(TelemetryProcessor):
    """Merge per-agent ``obs.delta`` payloads into one run registry.

    Implements the ``TelemetryProcessor`` interface, so it plugs
    straight into the master's existing telemetry dispatch
    (``ConsensusMaster(aggregator=...)`` wires it; a user telemetry
    processor still runs beside it).  Non-delta payloads are recorded
    as plain ``telemetry`` events with their token — the plane subsumes
    the old path, it does not break it.
    """

    def __init__(self, *, registry: Optional[MetricsRegistry] = None,
                 flight: Optional[FlightRecorder] = None,
                 max_spans_per_agent: int = 4096):
        #: The merged run registry (per-agent labels + run-wide sums).
        self.registry = (
            registry if registry is not None
            else MetricsRegistry(max_points=1 << 14, max_events=1 << 16)
        )
        self.flight = flight
        self._lock = threading.Lock()
        self._max_spans = int(max_spans_per_agent)
        self._views: Dict[str, _AgentView] = {}
        #: Merged quantile sketches, keyed like the merged series
        #: (``name/<token>`` per agent + the bare run-wide ``name``).
        #: Constant-size per metric and eviction-immune — the profile
        #: paths read quantiles from here, the raw rings stay as the
        #: small-run exact oracle.
        self.sketches: Dict[str, QuantileSketch] = {}
        #: Merged bounded label rollups (sub-aggregator exports).
        self.rollups: Dict[str, LabelRollup] = {}

    # ------------------------------------------------------------------ #
    def agents(self) -> List[str]:
        with self._lock:
            return sorted(self._views)

    def _view(self, token: str) -> _AgentView:
        with self._lock:
            view = self._views.get(token)
            if view is None:
                view = self._views[token] = _AgentView(self._max_spans)
            return view

    # ------------------------------------------------------------------ #
    def process(self, token: Any, payload: Any) -> None:
        """TelemetryProcessor entry point: merge one payload."""
        token = str(token)
        if not is_obs_payload(payload):
            self.registry.event("telemetry", token=token, payload=payload)
            if self.flight is not None:
                self.flight.note(token, "telemetry", payload=payload)
            return
        if int(payload.get("v", 0)) > OBS_PAYLOAD_VERSION:
            # A newer agent talking to an older master: visible, not
            # fatal — the rest of the plane keeps running.
            self.registry.inc("obs.unknown_version")
            return
        # Sub-aggregator export (payload["agg"], SubAggregator): names
        # already carry their per-agent labels from the sub's merge, so
        # everything lands as-is — no relabel, no run-wide duplication.
        # That pass-through is exactly what makes aggregate-of-
        # aggregates equal the flat merge.
        agg = bool(payload.get("agg"))
        view = self._view(token)
        seq = int(payload.get("seq", view.last_seq + 1))
        if seq <= view.last_seq:
            self.registry.inc("obs.stale_deltas")
            return
        if seq > view.last_seq + 1:
            self.registry.inc("obs.deltas_lost", seq - view.last_seq - 1)
        view.last_seq = seq
        view.last_wall = payload.get("wall")

        self._merge_counters(
            token, view, payload.get("counters") or {}, relabel=not agg
        )
        for name, value in (payload.get("gauges") or {}).items():
            if not agg:
                self.registry.gauge(f"{name}/{token}", float(value))
            self.registry.gauge(name, float(value))
        for name, d in sorted((payload.get("sketches") or {}).items()):
            self._merge_sketch_dict(token, name, d, relabel=not agg)
        for name, d in sorted((payload.get("rollups") or {}).items()):
            self._merge_rollup_dict(name, d)
        # A payload that carries sketch sections is the authority on its
        # sketched series; one that does not (v1 producers, offline
        # merge_registry replays, sketch-less sources) gets them derived
        # from its raw points here — either way the sketch state covers
        # every point exactly once.
        sketch_series = (not agg) and ("sketches" not in payload)
        for ev in payload.get("events") or ():
            self._merge_event(
                token, view, ev,
                relabel=not agg, sketch_series=sketch_series,
            )
        if payload.get("events_dropped"):
            self.registry.inc(
                f"obs.delta_events_dropped/{token}",
                payload["events_dropped"],
            )
        if payload.get("series_sketched"):
            self.registry.inc(
                "obs.series_sketched", payload["series_sketched"]
            )
        # Self-contained stream marker: carries this agent's absolute
        # counter totals, so a JsonlSink'd aggregate file replays into
        # a live dashboard (obs-monitor) with counters intact.
        self.registry.event(
            "obs.delta", token=token, seq=seq,
            wall=view.last_wall, counters=dict(view.counters),
        )
        self.registry.inc("obs.deltas_merged")

    def _merge_counters(self, token: str, view: _AgentView,
                        counters: Mapping[str, Any], *,
                        relabel: bool = True) -> None:
        for name, total in counters.items():
            total = float(total)
            prev = view.counters.get(name, 0.0)
            diff = total - prev
            if diff < 0:
                # The token restarted with fresh counters (elastic
                # rejoin): its new life counts from zero.
                self.registry.inc("obs.counter_resets")
                diff = total
            if diff:
                if relabel:
                    self.registry.inc(f"{name}/{token}", diff)
                self.registry.inc(name, diff)
            view.counters[name] = total

    # ------------------------------------------------------------------ #
    # Sketch / rollup state.  These two hooks are the ONE write path    #
    # into the merged sketch maps — SubAggregator overrides them to    #
    # also accumulate its pending upstream delta.                       #
    # ------------------------------------------------------------------ #
    def _sketch_point(self, key: str, value: float) -> None:
        with self._lock:
            sk = self.sketches.get(key)
            if sk is None:
                sk = self.sketches[key] = QuantileSketch()
            sk.add(value)

    def sketch(self, key: str) -> Optional[QuantileSketch]:
        """A copy of the merged sketch under ``key`` (``name/<token>``
        or the bare run-wide ``name``), or None."""
        with self._lock:
            sk = self.sketches.get(key)
            return None if sk is None else sk.copy()

    def _sketch_merge(self, key: str, sk: QuantileSketch) -> None:
        mismatch = False
        with self._lock:
            cur = self.sketches.get(key)
            if cur is None:
                self.sketches[key] = sk.copy()
            else:
                try:
                    cur.merge(sk)
                except ValueError:
                    # Geometry mismatch (foreign α): visible, not fatal.
                    mismatch = True
        if mismatch:
            self.registry.inc("obs.sketch_errors")

    def _rollup_merge(self, name: str, ru: LabelRollup) -> None:
        with self._lock:
            cur = self.rollups.get(name)
            if cur is None:
                self.rollups[name] = ru.copy()
            else:
                cur.merge(ru)

    def rollup(self, name: str) -> Optional[LabelRollup]:
        """A copy of the merged label rollup for counter family
        ``name``, or None."""
        with self._lock:
            ru = self.rollups.get(name)
            return None if ru is None else ru.copy()

    def _merge_sketch_dict(self, token: str, name: str, d: Any, *,
                           relabel: bool) -> None:
        try:
            sk = QuantileSketch.from_dict(d)
        except (TypeError, ValueError, AttributeError):
            self.registry.inc("obs.sketch_errors")
            return
        if relabel:
            self._sketch_merge(f"{name}/{token}", sk)
        self._sketch_merge(name, sk)

    def _merge_rollup_dict(self, name: str, d: Any) -> None:
        try:
            ru = LabelRollup.from_dict(d)
        except (TypeError, ValueError, AttributeError):
            self.registry.inc("obs.sketch_errors")
            return
        self._rollup_merge(name, ru)

    def _merge_event(self, token: str, view: _AgentView,
                     ev: Mapping[str, Any], *, relabel: bool = True,
                     sketch_series: bool = False) -> None:
        kind = ev.get("kind")
        name = ev.get("name", "")
        flight_token = token
        if kind == "series":
            value = float(ev.get("value", 0.0))
            self.registry.observe(
                f"{name}/{token}" if relabel else name, value,
                step=ev.get("step"),
            )
            if sketch_series and _sketched(name):
                self._sketch_point(f"{name}/{token}", value)
                self._sketch_point(name, value)
        elif kind == "span":
            dur = float(ev.get("value", 0.0))
            t0 = ev.get("t0")
            self.registry.record_span(
                f"{name}/{token}" if relabel else name, dur,
                depth=int(ev.get("depth", 0)), t0=t0,
            )
            if t0 is not None:
                view.spans.append(
                    (name, float(t0), dur, int(ev.get("depth", 0)))
                )
        elif kind == "event":
            fields = {
                k: v for k, v in ev.items()
                if k not in ("kind", "name", "ts")
            }
            if relabel:
                # A replayed *aggregated* dump (``obs-report --merge``
                # over pod registries) already carries the original
                # agent attribution in the fields — keep it rather
                # than relabeling every event with the pod's token.
                inner = fields.pop("token", None)
                inner_ts = fields.pop("agent_ts", None)
                if inner is not None:
                    flight_token = str(inner)
                self.registry.event(
                    name, token=flight_token,
                    agent_ts=(inner_ts if inner_ts is not None
                              else ev.get("ts")),
                    **fields)
            else:
                # Sub-aggregator pass-through: token/agent_ts already
                # ride inside the fields from the sub's own merge.
                self.registry.event(name, **fields)
                flight_token = str(fields.get("token", token))
            if name == FLOW_EVENT:
                # Frame-lifecycle hop: keep it (with the emitting
                # agent's wall stamp) for the merged trace's arrows.
                flow = dict(fields)
                if relabel:
                    flow["agent"] = flight_token
                    flow["ts"] = (inner_ts if inner_ts is not None
                                  else ev.get("ts"))
                else:
                    flow.setdefault("agent", flight_token)
                    flow["ts"] = fields.get("agent_ts", ev.get("ts"))
                view.flows.append(flow)
        elif kind in ("counter", "gauge"):
            # Snapshot lines from a replayed dump file: totals already
            # merged through the counters/gauges maps — skip, or the
            # offline merge would double-count.
            return
        if self.flight is not None:
            self.flight.record(flight_token, ev)

    # ------------------------------------------------------------------ #
    def merge_registry(self, token: str,
                       registry: MetricsRegistry) -> None:
        """Offline merge of a whole per-agent registry (the
        ``obs-report --merge`` path over per-agent JSONL files): one
        synthetic delta carrying the registry's totals and full event
        log."""
        self.process(str(token), {
            "kind": OBS_PAYLOAD_KIND,
            "v": OBS_PAYLOAD_VERSION,
            "seq": self._view(str(token)).last_seq + 1,
            "counters": dict(registry.counters),
            "gauges": dict(registry.gauges),
            "events": list(registry.events),
        })

    # ------------------------------------------------------------------ #
    # Master-side round accounting (control-plane signals the agents    #
    # cannot see about themselves).                                      #
    # ------------------------------------------------------------------ #
    def note_round_arrivals(self, round_id: int,
                            arrivals: Mapping[str, float]) -> None:
        """Per-round straggler attribution from the master's view: the
        wall-clock arrival time of each agent's round request.  The
        LAST arrival is the straggler — it set the round's start time
        for everyone (lock-step rounds run at the pace of the slowest
        agent, which is exactly what the async runtime will relax)."""
        if not arrivals:
            return
        t_first = min(arrivals.values())
        t_last = max(arrivals.values())
        for token, t in arrivals.items():
            self.registry.observe(
                f"straggler.lag_s/{token}", t - t_first, step=round_id
            )
            self._sketch_point(f"straggler.lag_s/{token}", t - t_first)
        self.registry.observe(
            "straggler.skew_s", t_last - t_first, step=round_id
        )
        self._sketch_point("straggler.skew_s", t_last - t_first)
        slowest = max(arrivals, key=lambda t: arrivals[t])
        self.registry.inc(f"straggler.slowest/{slowest}")
        if self.flight is not None:
            self.flight.note(
                "<master>", "round_arrivals", round_id=int(round_id),
                skew_s=t_last - t_first, slowest=slowest,
            )

    def note_round_done(self, round_id: int, dur_s: float,
                        wall_t0: Optional[float] = None) -> None:
        """Master-side whole-round wall time (request-complete to
        all-converged)."""
        self.registry.inc("comm.master.rounds_done")
        self.registry.observe(
            "comm.master.round_s", float(dur_s), step=round_id
        )
        self._sketch_point("comm.master.round_s", float(dur_s))
        self.registry.record_span(
            "comm.master.round", float(dur_s), t0=wall_t0
        )
        if wall_t0 is not None:
            self._view("<master>").spans.append(
                ("comm.master.round", float(wall_t0), float(dur_s), 0)
            )

    # ------------------------------------------------------------------ #
    def _sketch_snapshot(self) -> Dict[str, QuantileSketch]:
        with self._lock:
            return {k: sk.copy() for k, sk in self.sketches.items()}

    def straggler_profile(self) -> dict:
        """See :func:`straggler_profile_from_registry` (the aggregator
        hands over its merged sketches, so quantiles stay
        constant-memory and eviction-immune at fleet scale)."""
        return straggler_profile_from_registry(
            self.registry, sketches=self._sketch_snapshot()
        )

    def edge_profile(self) -> dict:
        """See :func:`edge_profile_from_registry`."""
        return edge_profile_from_registry(
            self.registry, sketches=self._sketch_snapshot()
        )

    # ------------------------------------------------------------------ #
    def to_chrome_trace(self) -> dict:
        """Merged Chrome/Perfetto trace: one track (pid) per agent,
        wall-clock-anchored span starts normalized to the earliest span
        (the shared timeline), ``process_name`` metadata naming each
        track after its agent.

        ``trace.flow`` frame-lifecycle events additionally render as
        per-frame causal chains: each hop becomes a small anchor slice
        (``frame.<phase>``, tid 2 — the "wire" lane of its agent's
        track) and the hops sharing one wire-carried
        ``(run, origin, seq)`` identity are linked with Chrome flow
        arrows (``ph`` s/t/f, one id per frame), so
        encode→send→recv→decode→mix reads as ONE arrow-linked path
        across process tracks in Perfetto."""
        with self._lock:
            per_agent = {
                token: (list(view.spans), list(view.flows))
                for token, view in sorted(self._views.items())
                if view.spans or view.flows
            }
        events: List[dict] = []
        all_t0 = [t0 for spans, _flows in per_agent.values()
                  for (_n, t0, _d, _dep) in spans]
        all_t0 += [
            float(f["ts"]) for _spans, flows in per_agent.values()
            for f in flows if f.get("ts") is not None
        ]
        base = min(all_t0) if all_t0 else 0.0
        pids: Dict[str, int] = {}
        for pid, (token, (spans, _flows)) in enumerate(
            per_agent.items(), start=1
        ):
            pids[token] = pid
            events.append({
                "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                "args": {"name": f"agent {token}"},
            })
            for name, t0, dur, depth in spans:
                events.append({
                    "name": name,
                    "ph": "X",
                    "ts": round((t0 - base) * 1e6, 3),
                    "dur": round(dur * 1e6, 3),
                    "pid": pid,
                    "tid": 1,
                    "args": {"agent": token, "depth": depth},
                })
        # Frame chains: group hops by wire identity, order each chain
        # by lifecycle phase (the wall stamps of two processes are only
        # ~ms-aligned; the phase order is the causal truth).
        chains: Dict[str, List[Tuple[int, float, int, dict]]] = {}
        for token, (_spans, flows) in per_agent.items():
            for f in flows:
                ts, phase = f.get("ts"), f.get("phase")
                if ts is None or phase not in FLOW_PHASES:
                    continue
                key = (
                    f"{f.get('run', 0)}:{f.get('origin', '')}:"
                    f"{f.get('seq', 0)}"
                )
                chains.setdefault(key, []).append(
                    (FLOW_PHASES.index(phase), float(ts), pids[token], f)
                )
        flow_id = 0
        for key in sorted(chains):
            hops = sorted(chains[key], key=lambda h: (h[0], h[1]))
            flow_id += 1
            for _order, ts, pid, f in hops:
                events.append({
                    "name": f"frame.{f['phase']}",
                    "ph": "X",
                    "ts": round((ts - base) * 1e6, 3),
                    "dur": 20.0,
                    "pid": pid,
                    "tid": 2,
                    "args": {
                        k: f[k]
                        for k in ("origin", "seq", "run", "edge", "agent")
                        if k in f
                    },
                })
            if len(hops) < 2:
                continue
            for i, (_order, ts, pid, _f) in enumerate(hops):
                ph = "s" if i == 0 else (
                    "f" if i == len(hops) - 1 else "t"
                )
                arrow = {
                    "name": "frame",
                    "cat": FLOW_EVENT,
                    "ph": ph,
                    "id": flow_id,
                    # +1us: strictly inside the anchor slice, so the
                    # arrow binds to it on every Perfetto version.
                    "ts": round((ts - base) * 1e6 + 1.0, 3),
                    "pid": pid,
                    "tid": 2,
                }
                if ph == "f":
                    arrow["bp"] = "e"
                events.append(arrow)
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "metadata": {"wall0": base},
        }

    def export_chrome_trace(self, path: str) -> int:
        """Write :meth:`to_chrome_trace` to ``path``; returns the span
        event count (metadata rows excluded)."""
        import json

        trace = self.to_chrome_trace()
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(trace, fh)
        return sum(1 for e in trace["traceEvents"] if e["ph"] == "X")


# ---------------------------------------------------------------------- #
# Hierarchical tier: the per-pod sub-aggregator                          #
# ---------------------------------------------------------------------- #
class SubAggregator(RunAggregator):
    """A mid-tier aggregator that re-exports its merged state upstream.

    A per-pod sub-master merges its own agents' ``obs.delta`` payloads
    exactly like :class:`RunAggregator` (same dedup, same labels, same
    local profiles), and periodically :meth:`export_delta`\\ s ONE
    bounded payload for a root aggregator — the aggregate-of-aggregates
    shape the sharded-master control plane needs.  The export is itself
    a v2 ``obs.delta``:

    * ``agg: True`` tells the root to merge it as-is (names already
      carry their ``/token`` labels from this tier's merge — no
      relabel, no run-wide duplication), which is what makes the
      two-tier merge equal the flat one;
    * counters/gauges travel as absolute totals (idempotent at the
      root, same as an agent delta); ``obs.*`` plane bookkeeping is
      filtered — each tier keeps its own merge-health counters;
    * sketch state travels as per-export DELTAS mirrored at merge time
      (:meth:`_sketch_point` / :meth:`_sketch_merge` overrides), so the
      root's merge is pure addition and seq gap/dedup accounting
      carries over unchanged;
    * ``forward_raw_series=False`` is the fleet mode: sketched-series
      points stop riding the event stream upstream (the sketch IS
      their wire form), making export bytes O(metrics);
    * ``rollup_labels=N`` additionally folds per-label counter deltas
      (``name/<label>``, label cardinality unbounded under churn) into
      bounded :class:`LabelRollup` sections, keeping only the bare
      run-wide counters exact.  Edge-shaped labels (``src->dst``) stay
      exact — the per-edge observatory depends on them.
    """

    def __init__(self, *, registry: Optional[MetricsRegistry] = None,
                 flight: Optional[FlightRecorder] = None,
                 max_spans_per_agent: int = 4096,
                 forward_raw_series: bool = True,
                 rollup_labels: int = 0):
        super().__init__(
            registry=registry, flight=flight,
            max_spans_per_agent=max_spans_per_agent,
        )
        #: Sketch/rollup growth since the last export (drained by
        #: :meth:`export_delta`; the merged totals stay in
        #: ``self.sketches`` for this tier's own profiles).
        self._pending_sketches: Dict[str, QuantileSketch] = {}
        self._pending_rollups: Dict[str, LabelRollup] = {}
        self._rollup_labels = int(rollup_labels)
        #: Last-export absolute totals of the labeled counters folded
        #: into rollups (delta accounting with reset handling, same
        #: contract as the root's per-view counter diff).
        self._rollup_base: Dict[str, float] = {}
        # sketch=False: this tier's merge hooks own the sketch state
        # (below); the source still buffers events and, in fleet mode,
        # suppresses raw sketched-series points.
        self._source = ObsDeltaSource(
            self.registry, sketch=False, backfill=True,
            raw_series=bool(forward_raw_series),
        )

    # The ONE write path into the sketch maps, mirrored into the
    # pending upstream delta.
    def _sketch_point(self, key: str, value: float) -> None:
        super()._sketch_point(key, value)
        with self._lock:
            sk = self._pending_sketches.get(key)
            if sk is None:
                sk = self._pending_sketches[key] = QuantileSketch()
            sk.add(value)

    def _sketch_merge(self, key: str, sk: QuantileSketch) -> None:
        super()._sketch_merge(key, sk)
        with self._lock:
            cur = self._pending_sketches.get(key)
            if cur is None:
                self._pending_sketches[key] = sk.copy()
            else:
                try:
                    cur.merge(sk)
                except ValueError:
                    pass  # geometry mismatch already counted by super

    def _rollup_merge(self, name: str, ru: LabelRollup) -> None:
        super()._rollup_merge(name, ru)
        with self._lock:
            cur = self._pending_rollups.get(name)
            if cur is None:
                self._pending_rollups[name] = ru.copy()
            else:
                cur.merge(ru)

    # ------------------------------------------------------------------ #
    def export_delta(self) -> dict:
        """One upstream ``obs.delta`` for the root aggregator: the
        registry's growth since the last export plus the pending
        sketch/rollup deltas, marked ``agg: True``."""
        payload = self._source.pack()
        payload["agg"] = True
        with self._lock:
            sketches = {
                name: sk.to_dict()
                for name, sk in sorted(self._pending_sketches.items())
            }
            self._pending_sketches.clear()
            rollups = dict(self._pending_rollups)
            self._pending_rollups.clear()
        counters = {
            name: total for name, total in payload["counters"].items()
            if not name.startswith("obs.")
        }
        if self._rollup_labels > 0:
            counters = self._fold_label_counters(counters, rollups)
        payload["counters"] = counters
        payload["gauges"] = {
            name: v for name, v in payload["gauges"].items()
            if not name.startswith("obs.")
        }
        # This tier's own stream markers are per-tier bookkeeping; the
        # root stamps its own when it merges this export.
        payload["events"] = [
            ev for ev in payload["events"]
            if not (ev.get("kind") == "event"
                    and ev.get("name") == "obs.delta")
        ]
        if sketches:
            payload["sketches"] = sketches
        if rollups:
            payload["rollups"] = {
                name: ru.to_dict() for name, ru in sorted(rollups.items())
            }
        return payload

    def _fold_label_counters(
            self, counters: Dict[str, Any],
            rollups: Dict[str, LabelRollup]) -> Dict[str, Any]:
        kept: Dict[str, Any] = {}
        with self._lock:
            for name, total in counters.items():
                base, slash, label = name.partition("/")
                if not slash or "->" in label:
                    kept[name] = total
                    continue
                total = float(total)
                prev = self._rollup_base.get(name, 0.0)
                diff = total - prev
                if diff < 0:
                    # Restarted source (elastic rejoin): new life
                    # counts from zero, same as the root's view diff.
                    diff = total
                self._rollup_base[name] = total
                if diff:
                    ru = rollups.get(base)
                    if ru is None:
                        ru = rollups[base] = LabelRollup(
                            self._rollup_labels
                        )
                    ru.add(label, diff)
        return kept

    def close(self) -> None:
        self._source.close()


# ---------------------------------------------------------------------- #
# Straggler profile                                                      #
# ---------------------------------------------------------------------- #
def _pct(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile over an ascending list."""
    if not sorted_vals:
        return 0.0
    rank = max(1, math.ceil(q * len(sorted_vals)))
    return sorted_vals[rank - 1]


def _hist(vals: List[float]) -> List[List[float]]:
    """``[upper_bound_s, count]`` rows over LATENCY_BUCKETS_S."""
    counts = [0] * len(LATENCY_BUCKETS_S)
    for v in vals:
        for i, ub in enumerate(LATENCY_BUCKETS_S):
            if v <= ub:
                counts[i] += 1
                break
    return [
        [ub, c] for ub, c in zip(LATENCY_BUCKETS_S, counts) if c
    ]


def _series_by_token(registry: MetricsRegistry,
                     prefix: str) -> Dict[str, list]:
    out = {}
    for name, pts in registry.series.items():
        if name.startswith(prefix):
            out[name[len(prefix):]] = list(pts)
    return out


def _sketches_by_token(
        sketches: Mapping[str, QuantileSketch],
        prefix: str) -> Dict[str, QuantileSketch]:
    """Non-empty sketches keyed ``<prefix><token>`` (no further label
    dimension), by token."""
    out = {}
    for name, sk in sketches.items():
        if name.startswith(prefix) and sk.n:
            token = name[len(prefix):]
            if "/" not in token:
                out[token] = sk
    return out


def straggler_profile_from_registry(
        registry: MetricsRegistry, *,
        counters: Optional[Mapping[str, float]] = None,
        sketches: Optional[Mapping[str, QuantileSketch]] = None) -> dict:
    """Who is slow, how slow, and how often — from a merged run
    registry.

    Latency source, in preference order: the master's per-round arrival
    lags (``straggler.lag_s/<token>`` — how long each agent kept the
    round waiting; authoritative attribution) or, when no master-side
    data exists, the agents' own round wall times
    (``comm.agent.round_s/<token>`` — in lock-step rounds these include
    waiting on peers, so attribution from them is weak; the profile
    names its ``source`` so a reader knows which it got).  Staleness
    comes from the per-agent ``stale_requests_dropped`` /
    ``requests_deferred`` counters; ``counters`` overrides the
    registry's own totals for callers that reconstructed them from a
    replayed stream (``obs-monitor``, where counter totals travel as
    delta markers, not events).

    ``sketches`` (the aggregator's merged quantile sketches) switch the
    per-agent latency/staleness statistics to the sketch path: counts
    and percentiles come from the eviction-immune
    :class:`~distributed_learning_tpu_torch.obs.sketch.QuantileSketch` state
    (``max`` stays exact — the sketch tracks it), and every entry says
    which path produced it (``"quantiles": "sketch" | "exact"``).
    Without sketches the exact nearest-rank path over the raw rings is
    used — the small-run oracle — and each entry carries the ring's
    ``evicted`` point count so a truncated percentile is never
    presented as a complete one.
    """
    if counters is None:
        counters = registry.counters
    sketches = sketches or {}
    dropped = registry.points_dropped
    lag_prefix = "straggler.lag_s/"
    lag = _series_by_token(registry, lag_prefix)
    lag_sk = _sketches_by_token(sketches, lag_prefix)
    source = "master-arrival-lag"
    if not lag and not lag_sk:
        lag_prefix = "comm.agent.round_s/"
        lag = _series_by_token(registry, lag_prefix)
        lag_sk = _sketches_by_token(sketches, lag_prefix)
        source = "agent-round-wall"
    if not lag and not lag_sk:
        # Pure async runs have no master-gated rounds at all: fall back
        # to the async runtime's per-round wall times.
        lag_prefix = "comm.agent.async_round_s/"
        lag = _series_by_token(registry, lag_prefix)
        lag_sk = _sketches_by_token(sketches, lag_prefix)
        source = "agent-async-round-wall"
    # Per-round grouping for attribution (step == round id).
    rounds: Dict[Any, List[Tuple[str, float]]] = {}
    for token, pts in lag.items():
        for step, val in pts:
            if step is not None:
                rounds.setdefault(step, []).append((token, val))
    slowest_counts: Dict[str, int] = {}
    for entries in rounds.values():
        if len(entries) >= 2:
            tok = max(entries, key=lambda tv: tv[1])[0]
            slowest_counts[tok] = slowest_counts.get(tok, 0) + 1
    # Master-side attribution counters win when present (they cover
    # rounds whose lag series may have been ring-evicted).
    master_counts = {
        name[len("straggler.slowest/"):]: int(total)
        for name, total in counters.items()
        if name.startswith("straggler.slowest/")
    }
    if master_counts:
        slowest_counts = master_counts

    # Staleness-vs-convergence picture (the JAX package's docs/async_runtime.md): the
    # async runtime's per-mix staleness series and per-agent consensus
    # residual trends, so the trade-off τ buys is readable from one
    # merged JSONL.
    staleness = _series_by_token(registry, "comm.agent.staleness/")
    stale_sk = _sketches_by_token(sketches, "comm.agent.staleness/")
    residual = _series_by_token(registry, "consensus.residual/")

    per_agent = {}
    tokens = (set(lag) | set(lag_sk) | set(staleness) | set(stale_sk)
              | set(residual))
    for token in sorted(tokens):
        sk = lag_sk.get(token)
        if sk is not None:
            entry = {
                "count": sk.n,
                "p50_s": sk.quantile(0.50),
                "p95_s": sk.quantile(0.95),
                "max_s": sk.max,
                "hist": sk.histogram(LATENCY_BUCKETS_S),
                "quantiles": "sketch",
            }
        else:
            vals = sorted(v for _, v in lag.get(token, ()))
            entry = {
                "count": len(vals),
                "p50_s": _pct(vals, 0.50),
                "p95_s": _pct(vals, 0.95),
                "max_s": vals[-1] if vals else 0.0,
                "hist": _hist(vals),
                "quantiles": "exact",
            }
        entry["evicted"] = int(dropped.get(lag_prefix + token, 0))
        entry.update({
            "slowest_rounds": slowest_counts.get(token, 0),
            "stale_dropped": counters.get(
                f"comm.agent.stale_requests_dropped/{token}", 0
            ),
            "deferred": counters.get(
                f"comm.agent.requests_deferred/{token}", 0
            ),
        })
        ssk = stale_sk.get(token)
        spts = [v for _, v in staleness.get(token, ())]
        if ssk is not None:
            entry["staleness"] = {
                "n": ssk.n,
                "mean": ssk.mean,
                "max": ssk.max,
            }
        elif spts:
            buckets: Dict[int, int] = {}
            for v in spts:
                buckets[int(v)] = buckets.get(int(v), 0) + 1
            entry["staleness"] = {
                "n": len(spts),
                "mean": sum(spts) / len(spts),
                "max": max(spts),
                "hist": sorted(buckets.items()),
            }
        if ssk is not None or spts:
            entry["stale_mixed"] = counters.get(
                f"comm.agent.async_stale_mixed/{token}", 0
            )
            entry["stale_dropped_mix"] = counters.get(
                f"comm.agent.async_stale_dropped/{token}", 0
            )
        rpts = [v for _, v in residual.get(token, ())]
        if rpts:
            entry["residual_first"] = rpts[0]
            entry["residual_last"] = rpts[-1]
        per_agent[token] = entry
    skew_sk = sketches.get("straggler.skew_s")
    if skew_sk is not None and skew_sk.n:
        skew = {
            "p50_s": skew_sk.quantile(0.50),
            "p95_s": skew_sk.quantile(0.95),
            "max_s": skew_sk.max,
            "quantiles": "sketch",
        }
    else:
        skew_pts = sorted(
            v for _, v in registry.series.get("straggler.skew_s", ())
        )
        skew = {
            "p50_s": _pct(skew_pts, 0.50),
            "p95_s": _pct(skew_pts, 0.95),
            "max_s": skew_pts[-1] if skew_pts else 0.0,
            "quantiles": "exact",
        }
    slowest_agent = (
        max(slowest_counts, key=lambda t: slowest_counts[t])
        if slowest_counts else None
    )
    profile = {
        "source": source,
        "rounds": len(rounds),
        "quantiles": "sketch" if lag_sk else "exact",
        "per_agent": per_agent,
        "skew": skew,
        "slowest_agent": slowest_agent,
    }
    if lag_sk:
        profile["alpha"] = next(iter(lag_sk.values())).alpha
    return profile


# ---------------------------------------------------------------------- #
# Per-edge wire profile                                                  #
# ---------------------------------------------------------------------- #
#: profile field -> bare counter prefix (``FramedStream._edge_inc``).
_EDGE_COUNTER_FIELDS = (
    ("bytes_out", "comm.edge.bytes_out/"),
    ("bytes_in", "comm.edge.bytes_in/"),
    ("frames_out", "comm.edge.frames_out/"),
    ("frames_in", "comm.edge.frames_in/"),
    ("retries", "comm.edge.retries/"),
)

#: Decode scratch-pool attribution (the JAX package's docs/wire.md §Zero-copy receive
#: path): the async runner labels every pool hit/miss with the frame's
#: inbound edge.  Attached to an edge entry as a ``"scratch"`` sub-dict
#: only when the counters exist, so pre-scratch streams keep their
#: exact profile shape.
_SCRATCH_COUNTER_FIELDS = (
    ("hits", "comm.wire.scratch_hits/"),
    ("misses", "comm.wire.scratch_misses/"),
    ("bytes", "comm.wire.scratch_bytes/"),
)


def _bare_edge(name: str, prefix: str) -> Optional[str]:
    """The ``src->dst`` edge label of a BARE per-edge counter name
    (``comm.edge.bytes_out/a->b``); labeled variants with a trailing
    ``/token`` dimension (the aggregator's per-agent copies) return
    None so totals are not double-counted."""
    if not name.startswith(prefix):
        return None
    rest = name[len(prefix):]
    if "->" in rest and "/" not in rest:
        return rest
    return None


def edge_profile_from_registry(
        registry: MetricsRegistry, *,
        counters: Optional[Mapping[str, float]] = None,
        sketches: Optional[Mapping[str, QuantileSketch]] = None) -> dict:
    """The per-edge wire observatory: which directed link moved how
    many bytes/frames, how slowly, and how unreliably — from a merged
    run registry.

    Volume/retry totals come from the bare ``comm.edge.*/<src>-><dst>``
    counters every edge-labeled :class:`FramedStream` maintains;
    latency from the ``comm.edge.latency_s/<edge>`` series (receiver
    wall-clock minus the frame's wire-carried ``TraceContext.t_wall``
    send stamp, so it needs tracing on); per-edge mix staleness from
    ``comm.edge.staleness/<edge>``; injected-fault attribution from the
    ``comm.faults.<kind>/<edge>`` counters; decode scratch-pool
    attribution (a ``"scratch"`` sub-dict, present only when the async
    runner's zero-copy receive path ran) from the
    ``comm.wire.scratch_{hits,misses,bytes}/<edge>`` labeled copies.  ``counters`` overrides the
    registry totals for replayed streams, and ``sketches`` switches the
    latency/staleness statistics to the merged-sketch path (marked per
    edge as ``"quantiles": "sketch" | "exact"``, with ring ``evicted``
    counts disclosed on the exact path), exactly like
    :func:`straggler_profile_from_registry`.  This is the measured
    per-link cost picture topology/schedule choices key off
    (arxiv.org/pdf/2002.01119 §3; the two-tier link split of
    arxiv.org/pdf/2105.09080 needs per-edge latency as input).
    """
    if counters is None:
        counters = registry.counters
    sketches = sketches or {}
    dropped = registry.points_dropped
    edges: Dict[str, dict] = {}

    def entry(edge: str) -> dict:
        return edges.setdefault(edge, {
            "bytes_out": 0.0, "bytes_in": 0.0,
            "frames_out": 0, "frames_in": 0, "retries": 0,
            "faults": {},
        })

    for name, total in counters.items():
        for field, prefix in _EDGE_COUNTER_FIELDS:
            edge = _bare_edge(name, prefix)
            if edge is not None:
                if field.startswith("bytes"):
                    entry(edge)[field] = float(total)
                else:
                    entry(edge)[field] = int(total)
        if name.startswith("comm.faults."):
            rest = name[len("comm.faults."):]
            kind, _slash, label = rest.partition("/")
            if label and "->" in label and "/" not in label:
                entry(label)["faults"][kind] = int(total)
        for field, prefix in _SCRATCH_COUNTER_FIELDS:
            edge = _bare_edge(name, prefix)
            if edge is not None:
                entry(edge).setdefault("scratch", {})[field] = (
                    float(total) if field == "bytes" else int(total)
                )

    lat: Dict[str, List[float]] = {}
    stale: Dict[str, List[float]] = {}
    for name, pts in registry.series.items():
        for prefix, dest in (("comm.edge.latency_s/", lat),
                             ("comm.edge.staleness/", stale)):
            if name.startswith(prefix):
                edge = name[len(prefix):].split("/", 1)[0]
                if "->" in edge:
                    dest.setdefault(edge, []).extend(v for _, v in pts)
    # Merged per-edge sketches: the BARE ``<family>/<src>-><dst>`` keys
    # (labeled ``.../<token>`` copies exist too; the bare key is the
    # edge total, mirroring the raw path's bare-counter convention).
    lat_sk: Dict[str, QuantileSketch] = {}
    stale_sk: Dict[str, QuantileSketch] = {}
    for name, sk in sketches.items():
        for prefix, dest in (("comm.edge.latency_s/", lat_sk),
                             ("comm.edge.staleness/", stale_sk)):
            if name.startswith(prefix) and sk.n:
                edge = name[len(prefix):]
                if "->" in edge and "/" not in edge:
                    dest[edge] = sk
    for edge in sorted(set(lat) | set(lat_sk)):
        sk = lat_sk.get(edge)
        if sk is not None:
            entry(edge)["latency"] = {
                "n": sk.n,
                "p50_s": sk.quantile(0.50),
                "p95_s": sk.quantile(0.95),
                "max_s": sk.max,
                "quantiles": "sketch",
            }
        else:
            vals = sorted(lat[edge])
            entry(edge)["latency"] = {
                "n": len(vals),
                "p50_s": _pct(vals, 0.50),
                "p95_s": _pct(vals, 0.95),
                "max_s": vals[-1] if vals else 0.0,
                "quantiles": "exact",
            }
        entry(edge)["latency"]["evicted"] = sum(
            n for name, n in dropped.items()
            if name.startswith("comm.edge.latency_s/" + edge)
        )
    for edge in sorted(set(stale) | set(stale_sk)):
        sk = stale_sk.get(edge)
        if sk is not None:
            entry(edge)["staleness"] = {
                "n": sk.n,
                "mean": sk.mean,
                "max": sk.max,
            }
        else:
            vals = stale[edge]
            entry(edge)["staleness"] = {
                "n": len(vals),
                "mean": sum(vals) / len(vals) if vals else 0.0,
                "max": max(vals) if vals else 0,
            }

    # Throughput window: the wall spread of the merged event stream
    # (agents' own stamps when the events travelled a delta; the
    # registry clock's otherwise).  Zero/one-stamp registries render
    # totals only.
    stamps: List[float] = []
    for ev in registry.recent_events():
        t = ev.get("agent_ts")
        if t is None:
            t = ev.get("ts")
        if t:
            stamps.append(float(t))
    window = (max(stamps) - min(stamps)) if len(stamps) >= 2 else 0.0
    for e in edges.values():
        e["bytes_out_per_s"] = (
            e["bytes_out"] / window if window > 0 else 0.0
        )
    profile = {
        "edges": {k: edges[k] for k in sorted(edges)},
        "window_s": window,
        "quantiles": "sketch" if lat_sk else "exact",
    }
    if lat_sk:
        profile["alpha"] = next(iter(lat_sk.values())).alpha
    return profile
