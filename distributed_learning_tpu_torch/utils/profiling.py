"""Tracing and debug instrumentation (port of
``distributed_learning_tpu/utils/profiling.py``).

* :func:`trace` — a context manager around ``torch.profiler`` (CPU
  activity, and CUDA activity when a card is present) that exports a
  Chrome trace into ``log_dir`` (load it in ``chrome://tracing`` or
  Perfetto);
* :func:`annotate` — a named ``torch.profiler.record_function`` span
  inside an NVTX range, visible in the profiler's trace;
* :func:`summarize_trace` / :func:`format_trace_summary` — the "where
  did the step go" table from the exported traces, without a viewer,
  and :func:`trace_coverage`, the share of a timed window the trace's
  device rows cover: ``torch.profiler`` misses part of the device work
  on the H100 (its kernel rows covered 65.9-70.4% of a superstep that
  CUDA events timed at 99.8-99.9% busy), so a table without that figure
  would mislead;
* :class:`DebugLogger` / :func:`enable_debug_logging` — the reference's
  debug-flag pattern as a small structured logger.
"""

from __future__ import annotations

import contextlib
import glob
import json
import logging
import os
import time
from typing import Dict, Iterator, List, Optional, Tuple

__all__ = [
    "trace",
    "annotate",
    "maybe_trace",
    "DebugLogger",
    "enable_debug_logging",
    "summarize_trace",
    "trace_coverage",
    "format_trace_summary",
]

#: Chrome-trace event categories that ``torch.profiler`` gives device work.
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_TRACE_GLOB = "*.pt.trace.json"


def enable_debug_logging(name: str = "dlt") -> logging.Logger:
    """Make the framework's named loggers visible: set the ``dlt`` root
    to DEBUG and attach a stderr handler if none is configured."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    if not logger.handlers and not logging.getLogger().handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(
            logging.Formatter("%(name)s %(levelname).1s %(message)s")
        )
        logger.addHandler(handler)
    return logger


@contextlib.contextmanager
def trace(log_dir: str, *, host_profile: bool = True) -> Iterator[None]:
    """Profile the enclosed block with ``torch.profiler`` and export its
    Chrome trace to ``log_dir/<pid>.<ns>.pt.trace.json``.

    Activities: the CPU's unless ``host_profile=False``, and CUDA's when
    a card is present (on a CUDA-less build there is no device to
    trace).  The export runs when the block ends, also when it raises.
    """
    from torch import cuda
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] if host_profile else []
    if cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    if not activities:
        raise ValueError("host_profile=False without a CUDA device leaves nothing to trace")
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield
    finally:
        prof.__exit__(None, None, None)
        path = os.path.join(log_dir, f"{os.getpid()}.{time.time_ns()}.pt.trace.json")
        prof.export_chrome_trace(path)


def maybe_trace(log_dir: Optional[str]):
    """:func:`trace` when ``log_dir`` is set, a no-op otherwise — so
    "profile this run" is a caller's decision, not a code path."""
    if not log_dir:
        return contextlib.nullcontext()
    return trace(log_dir)


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named span inside an active profiler trace: a
    ``torch.profiler.record_function`` inside an NVTX range (the range
    only where a card is present: NVTX is a CUDA tool)."""
    import torch

    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


class DebugLogger:
    """Structured replacement for the reference's injected logger +
    ``debug`` flag; quacks like ``logging.Logger`` for ``Mixer(logger=)``.
    """

    def __init__(self, name: str = "dlt", *, enabled: bool = True,
                 logger: Optional[logging.Logger] = None):
        self.enabled = enabled
        self._log = logger or logging.getLogger(name)
        self._t0 = time.perf_counter()
        self.residuals: list = []

    def debug(self, msg, *args):
        if self.enabled:
            self._log.debug("[%7.3fs] %s", time.perf_counter() - self._t0,
                            msg % args if args else msg)

    info = debug

    def log_residual(self, round_idx: int, residual: float) -> None:
        """Record + report a per-round consensus residual (the metric the
        reference's Mixer debug lines printed, ``mixer.py:37,54``)."""
        self.residuals.append((round_idx, float(residual)))
        self.debug(f"round {round_idx}: residual {residual:.3e}")


# ---------------------------------------------------------------------- #
# Reading exported traces                                                #
# ---------------------------------------------------------------------- #
def _trace_events(log_dir: str) -> List[dict]:
    paths = sorted(glob.glob(os.path.join(log_dir, "**", _TRACE_GLOB), recursive=True))
    if not paths:
        raise FileNotFoundError(f"no {_TRACE_GLOB} under {log_dir}")
    events: List[dict] = []
    for i, path in enumerate(paths):
        with open(path, "r", encoding="utf-8") as fh:
            data = json.load(fh)
        for ev in data.get("traceEvents", []):
            # "Trace" is the profiler's own span around the whole window.
            if ev.get("ph") == "X" and "dur" in ev and ev.get("cat") != "Trace":
                events.append(dict(ev, _file=i))
    return events


def _is_device(ev: dict) -> bool:
    return str(ev.get("cat", "")).lower() in _DEVICE_CATS


def _self_times(events: List[dict]) -> List[float]:
    """Self time (us) of each host event: its duration less that of its
    direct children on the same thread (complete events nest)."""
    selfs = [float(ev["dur"]) for ev in events]
    by_thread: Dict[Tuple, List[int]] = {}
    for i, ev in enumerate(events):
        by_thread.setdefault((ev["_file"], ev.get("pid"), ev.get("tid")), []).append(i)
    for idx in by_thread.values():
        idx.sort(key=lambda i: (float(events[i]["ts"]), -float(events[i]["dur"])))
        stack: List[int] = []
        for i in idx:
            t0 = float(events[i]["ts"])
            while stack and float(events[stack[-1]]["ts"]) + float(events[stack[-1]]["dur"]) <= t0:
                stack.pop()
            if stack:
                selfs[stack[-1]] -= float(events[i]["dur"])
            stack.append(i)
    return selfs


def summarize_trace(log_dir: str, *, top: int = 15) -> list:
    """Digest the Chrome traces :func:`trace` exported under ``log_dir``
    into the top-``top`` operations by self-time, the reference's rows:
    dicts with ``operation``, ``type`` (the event category),
    ``host_or_device``, ``occurrences``, ``total_self_us``,
    ``avg_self_us`` and, on device rows, ``device_self_pct`` (the share
    of all device rows' time).  A device event's self time is its
    duration (kernels do not nest); a host event's is its duration less
    its children's.  Raises ``FileNotFoundError`` when the directory
    holds no trace."""
    events = _trace_events(log_dir)
    host = [ev for ev in events if not _is_device(ev)]
    rows: Dict[Tuple[str, str, str], dict] = {}
    for ev, self_us in [(ev, float(ev["dur"])) for ev in events if _is_device(ev)] + list(
            zip(host, _self_times(host))):
        where = "device" if _is_device(ev) else "host"
        key = (str(ev.get("name", "")), str(ev.get("cat", "")), where)
        row = rows.setdefault(key, {"operation": key[0], "type": key[1],
                                    "host_or_device": where, "occurrences": 0,
                                    "total_self_us": 0.0})
        row["occurrences"] += 1
        row["total_self_us"] += self_us
    device_total = sum(r["total_self_us"] for r in rows.values()
                       if r["host_or_device"] == "device")
    out = []
    for r in rows.values():
        r["avg_self_us"] = r["total_self_us"] / r["occurrences"]
        r["device_self_pct"] = (
            100.0 * r["total_self_us"] / device_total
            if r["host_or_device"] == "device" and device_total > 0 else None
        )
        out.append(r)
    out.sort(key=lambda d: -(d["total_self_us"] or 0.0))
    return out[:top]


def trace_coverage(log_dir: str, window_s: float) -> Optional[float]:
    """The share of a timed window (``window_s`` seconds, measured with
    CUDA events around the traced work) that the trace's device rows
    cover: the union of their intervals over the window.  ``None`` when
    the trace holds no device row (a CPU run)."""
    spans = sorted((float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]))
                   for ev in _trace_events(log_dir) if _is_device(ev))
    if not spans or window_s <= 0:
        return None
    busy, cur0, cur1 = 0.0, spans[0][0], spans[0][1]
    for t0, t1 in spans[1:]:
        if t0 > cur1:
            busy += cur1 - cur0
            cur0, cur1 = t0, t1
        else:
            cur1 = max(cur1, t1)
    busy += cur1 - cur0
    return busy / (window_s * 1e6)


def format_trace_summary(rows: list, coverage: Optional[float] = None) -> str:
    """Readable table for :func:`summarize_trace` output; with
    ``coverage`` (:func:`trace_coverage`), a first line saying what share
    of the event-timed window the device rows cover."""
    lines = []
    if coverage is not None:
        lines.append(f"device rows cover {100.0 * coverage:.1f}% of the event-timed window")
    lines.append(
        f"{'self us':>12} {'avg us':>10} {'n':>6} {'where':>6}  operation"
    )
    for r in rows:
        lines.append(
            f"{(r['total_self_us'] or 0):12.1f} {(r['avg_self_us'] or 0):10.2f} "
            f"{int(r['occurrences'] or 0):6d} {(r['host_or_device'] or '?'):>6}  "
            f"{(r['type'] or '')}: {str(r['operation'] or '')[:70]}"
        )
    return "\n".join(lines)
