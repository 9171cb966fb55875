"""Nested wall-clock span tracing with Chrome trace-event export (port
of ``distributed_learning_tpu/obs/spans.py``).

``torch.profiler`` answers "where did the *device* time go" (see
``utils/profiling.py``); these spans answer the host-side half — "where
did this *step's wall clock* go": jitted-chunk dispatch vs gossip vs
eval vs host bookkeeping.  A span is a context manager; spans nest, the
per-thread stack tracks depth/parentage, and the result exports as
Chrome ``traceEvents`` JSON (load in ``chrome://tracing`` / Perfetto)
or aggregates into the run report through the
:class:`~distributed_learning_tpu_torch.obs.registry.MetricsRegistry`.

``profiler=True`` additionally wraps every span in
``torch.profiler.record_function`` and an NVTX range (via
:func:`distributed_learning_tpu_torch.utils.profiling.annotate`), so the
same span names appear inside a ``torch.profiler`` trace when one is
being captured — one naming scheme across both tools.

Everything is host-side: entering/leaving a span is two monotonic clock
reads and a list append.  No device syncs, no torch import unless
``profiler=True``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import threading
import time
from typing import Any, Dict, Iterator, List, Optional

from distributed_learning_tpu_torch.obs.registry import MetricsRegistry, get_registry

__all__ = [
    "Span",
    "SpanTracer",
    "get_tracer",
    "set_tracer",
    "span",
    "FLOW_EVENT",
    "FLOW_PHASES",
    "emit_flow",
    "flow_key",
    "trace_keep",
]

# ---------------------------------------------------------------------- #
# Frame flow events (the wire trace plane)                               #
# ---------------------------------------------------------------------- #
#: Registry event name every frame-lifecycle hop emits under.
FLOW_EVENT = "trace.flow"

#: The frame lifecycle, in causal order: the sender encodes and sends,
#: the receiver recvs, decodes, and mixes.  A frame is identified
#: across processes by its wire-carried
#: :class:`~distributed_learning_tpu_torch.comm.protocol.TraceContext`
#: ``(run_id, origin, seq)`` triple, so the N processes' phase events
#: chain into one arrow-linked flow in the merged Perfetto trace
#: (``RunAggregator.to_chrome_trace``).
FLOW_PHASES = ("encode", "send", "recv", "decode", "mix")


def flow_key(run_id: int, origin: str, seq: int) -> str:
    """The fleet-unique flow id shared by one frame's phase events."""
    return f"{int(run_id)}:{origin}:{int(seq)}"


def emit_flow(registry: MetricsRegistry, phase: str, *,
              origin: str, seq: int, run_id: int = 0,
              edge: str = "", **fields) -> None:
    """Record one frame-lifecycle hop as a ``trace.flow`` registry
    event.  ``phase`` is one of :data:`FLOW_PHASES`; ``origin``/``seq``/
    ``run_id`` come from the frame's wire-carried ``TraceContext`` (the
    sender stamps them, the receiver replays the received ones — both
    sides of an edge MUST agree or the chain breaks); ``edge`` labels
    the directed link ``src->dst`` when known.  Extra ``fields`` ride
    along into the event (round, staleness, ...).  Cost when tracing is
    on: one dict append into the registry's event ring — no clock
    beyond the registry's own stamp, no device sync."""
    registry.event(
        FLOW_EVENT, phase=phase, origin=origin, seq=int(seq),
        run=int(run_id), edge=edge, **fields,
    )


def _mix64(x: int) -> int:
    """splitmix64 finalizer: a fixed, platform-independent 64-bit
    mix.  NOT Python's ``hash()`` — that is salted per process
    (PYTHONHASHSEED), and the whole point is that every process
    computes the same bits for the same flow identity."""
    x &= 0xFFFFFFFFFFFFFFFF
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9 & 0xFFFFFFFFFFFFFFFF
    x = (x ^ (x >> 27)) * 0x94D049BB133111EB & 0xFFFFFFFFFFFFFFFF
    return x ^ (x >> 31)


def trace_keep(run_id: int, origin: str, seq: int,
               rate: float) -> bool:
    """Consistent flow-sampling decision: keep this frame's trace?

    Derived deterministically from the wire-carried ``TraceContext``
    identity ``(run_id, origin, seq)`` — the SAME triple every hop of
    the frame sees — so the sender and every receiver agree on
    keep/drop without coordination, and a sampled flow chain is always
    complete (encode→send→recv→decode→mix all present or all absent;
    a partially-sampled chain would render as broken arrows).
    ``rate >= 1.0`` short-circuits to True before any hashing: the
    neutral knob is bit-identical to no sampling at all.
    """
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    h = _mix64(int(run_id) * 0x9E3779B97F4A7C15 + int(seq))
    for ch in origin:
        h = _mix64(h ^ ord(ch))
    # Top 53 bits -> uniform float in [0, 1).
    return (h >> 11) * (1.0 / (1 << 53)) < rate


@dataclasses.dataclass(frozen=True)
class Span:
    """One completed span (times are seconds on the tracer's clock)."""

    name: str
    t0: float
    dur: float
    depth: int
    parent: Optional[str]
    tid: int


class SpanTracer:
    """Collects nested wall-clock spans.

    Parameters
    ----------
    registry:
        Optional :class:`MetricsRegistry` to aggregate completed spans
        into (``record_span``), so span stats join the run report and
        the JSONL event log.  A zero-arg callable is resolved per span
        (the default tracer passes ``get_registry`` so
        ``use_registry`` scoping applies to spans too).
    profiler:
        Also emit each span as a ``torch.profiler.record_function`` (and
        an NVTX range on the card) so the names land inside an active
        profile.
    max_spans:
        Bound on the retained per-span detail (aggregates in the
        registry stay exact past the cap; the Chrome export covers the
        first ``max_spans`` spans).

    Span times are read on the monotonic ``clock`` (durations must
    never come from ``time.time()`` deltas), but ``perf_counter`` origins are
    process-local, so every tracer also records ``wall0``: the
    wall-clock epoch of its monotonic zero.  Exports anchor span starts
    to ``wall0``, which is what lets N processes' traces merge onto ONE
    timeline (``RunAggregator.to_chrome_trace``).
    """

    def __init__(self, *, registry: Optional[MetricsRegistry] = None,
                 profiler: bool = False, max_spans: int = 1 << 16,
                 clock=time.perf_counter):
        self.registry = registry
        self.profiler = bool(profiler)
        self._clock = clock
        self._max_spans = int(max_spans)
        self._lock = threading.Lock()
        self._local = threading.local()
        self._epoch = self._clock()
        # Wall-clock anchor: the absolute time of monotonic zero
        # (_epoch).  The two reads are adjacent, so the anchor is good
        # to well under a millisecond — plenty for cross-process trace
        # alignment (gossip rounds are >= milliseconds).
        self.wall0 = time.time()
        self.spans: List[Span] = []
        self.dropped = 0

    def _stack(self) -> List[str]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        """Time the enclosed block as span ``name`` (nested spans record
        their depth and parent)."""
        stack = self._stack()
        depth = len(stack)
        parent = stack[-1] if stack else None
        stack.append(name)
        if self.profiler:
            from distributed_learning_tpu_torch.utils.profiling import annotate

            cm: Any = annotate(name)
        else:
            cm = contextlib.nullcontext()
        t0 = self._clock()
        try:
            with cm:
                yield
        finally:
            dur = self._clock() - t0
            stack.pop()
            with self._lock:
                if len(self.spans) < self._max_spans:
                    self.spans.append(Span(
                        name=name, t0=t0 - self._epoch, dur=dur,
                        depth=depth, parent=parent,
                        tid=threading.get_ident(),
                    ))
                else:
                    self.dropped += 1
            reg = (
                self.registry() if callable(self.registry)
                else self.registry
            )
            if reg is not None:
                # Wall-anchored start: registry/JSONL span events carry
                # an absolute t0, so per-agent logs merge onto one
                # timeline without knowing each tracer's epoch.
                reg.record_span(
                    name, dur, depth=depth,
                    t0=self.wall0 + (t0 - self._epoch),
                )

    # ------------------------------------------------------------------ #
    def aggregate(self) -> Dict[str, dict]:
        """Per-name count/total/mean/max over the retained spans."""
        with self._lock:
            spans = list(self.spans)
        out: Dict[str, dict] = {}
        for s in spans:
            agg = out.setdefault(
                s.name, {"count": 0, "total_s": 0.0, "max_s": 0.0}
            )
            agg["count"] += 1
            agg["total_s"] += s.dur
            agg["max_s"] = max(agg["max_s"], s.dur)
        for agg in out.values():
            agg["mean_s"] = agg["total_s"] / agg["count"]
        return out

    def to_chrome_trace(self, *, wall_clock: bool = True) -> dict:
        """Chrome trace-event JSON (complete 'X' events, microseconds);
        load the exported file in ``chrome://tracing`` or Perfetto.

        ``wall_clock=True`` (default) anchors ``ts`` to the tracer's
        ``wall0`` — absolute unix-epoch microseconds — so traces
        exported by N processes land on ONE shared timeline when merged
        (the run-wide plane's per-agent tracks); ``wall_clock=False``
        keeps the tracer-relative origin."""
        with self._lock:
            spans = list(self.spans)
        base = self.wall0 if wall_clock else 0.0
        events = [
            {
                "name": s.name,
                "ph": "X",
                "ts": round((base + s.t0) * 1e6, 3),
                "dur": round(s.dur * 1e6, 3),
                "pid": 0,
                "tid": s.tid,
                "args": {"depth": s.depth, "parent": s.parent or ""},
            }
            for s in spans
        ]
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def export_chrome_trace(self, path: str) -> int:
        """Write :meth:`to_chrome_trace` to ``path``; returns the event
        count."""
        trace = self.to_chrome_trace()
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(trace, fh)
        return len(trace["traceEvents"])

    def reset(self) -> None:
        with self._lock:
            self.spans.clear()
            self.dropped = 0
            self._epoch = self._clock()
            self.wall0 = time.time()  # re-anchor with the new epoch


# ---------------------------------------------------------------------- #
# Default (process-wide) tracer                                          #
# ---------------------------------------------------------------------- #
_DEFAULT: Optional[SpanTracer] = None
_DEFAULT_LOCK = threading.Lock()


def get_tracer() -> SpanTracer:
    """The process-wide default tracer, lazily bound to the default
    registry (so library spans aggregate into the same run report as the
    library counters)."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = SpanTracer(registry=get_registry)
        return _DEFAULT


def set_tracer(tracer: SpanTracer) -> Optional[SpanTracer]:
    """Replace the default tracer; returns the previous one."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        prev, _DEFAULT = _DEFAULT, tracer
        return prev


def span(name: str):
    """Convenience: a span on the default tracer."""
    return get_tracer().span(name)
