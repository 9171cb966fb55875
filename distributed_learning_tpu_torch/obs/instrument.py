"""Transparent call instrumentation for step functions (port of
``distributed_learning_tpu/obs/instrument.py``).

:func:`instrument_step` wraps a callable with a span and a call counter
while delegating every other attribute to the wrapped function.  The
reference also delegates the jit object's ahead-of-time surface
(``lower`` / ``compile``), which its cost profiles read; PyTorch has no
compiled program to lower, so the port's :class:`InstrumentedStep`
carries the profile hook instead: :meth:`InstrumentedStep.cost_profile`
counts the wrapped function's operations through
:func:`~distributed_learning_tpu_torch.obs.cost.profile_fn`.

The overhead per call is two clock reads and two dict updates on the
host, nothing on the device.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Any, Callable, Iterator

from distributed_learning_tpu_torch.obs.registry import MetricsRegistry, get_registry, use_registry
from distributed_learning_tpu_torch.obs.spans import SpanTracer, get_tracer, set_tracer

__all__ = ["instrument_step", "InstrumentedStep", "muted", "replay_counts"]


class InstrumentedStep:
    """Callable proxy: ``__call__`` is spanned and counted, every other
    attribute delegates to the wrapped function, and
    :meth:`cost_profile` profiles it."""

    def __init__(self, fn: Callable, name: str):
        self.__wrapped__ = fn
        self._name = name
        functools.update_wrapper(self, fn, updated=())

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        get_registry().inc(f"{self._name}.calls")
        with get_tracer().span(self._name):
            return self.__wrapped__(*args, **kwargs)

    def __getattr__(self, attr: str) -> Any:
        return getattr(self.__wrapped__, attr)

    def cost_profile(self, *args: Any, **kwargs: Any):
        """The :class:`~distributed_learning_tpu_torch.obs.cost.CostProfile`
        of one call on these arguments, under this step's name and
        registered process-wide (``profile_fn``).  The call RUNS: the
        wrapped function must leave no state behind, or the caller
        restores it (the trainer profiles its step on a snapshot)."""
        from distributed_learning_tpu_torch.obs.cost import profile_fn

        return profile_fn(self.__wrapped__, *args, name=self._name, **kwargs)

    def __repr__(self) -> str:
        return f"InstrumentedStep({self._name}, {self.__wrapped__!r})"


def instrument_step(fn: Callable, name: str) -> InstrumentedStep:
    """Wrap ``fn`` so each call records span ``name`` and bumps the
    ``{name}.calls`` counter on the default registry."""
    return InstrumentedStep(fn, name)


@contextlib.contextmanager
def muted() -> Iterator[MetricsRegistry]:
    """Inside the block, library hooks count into a fresh registry, which
    is yielded, and spans go to a throwaway tracer: neither reaches the
    process-wide default registry or tracer.  A CUDA-graph warm-up runs
    so (its work is undone), and so does a capture, whose yielded
    registry then holds what ONE replay of the graph represents
    (:func:`replay_counts`); a profile step too."""
    record = MetricsRegistry()
    prev_tracer = set_tracer(SpanTracer(registry=record))
    try:
        with use_registry(record):
            yield record
    finally:
        set_tracer(prev_tracer)


def replay_counts(record: MetricsRegistry, times: int = 1) -> None:
    """Count ``times`` replays of a graph whose capture recorded
    ``record`` under :func:`muted`: its counters are added ``times`` over
    to the default registry and its gauges set there, as the eager calls
    would have."""
    reg = get_registry()
    for name, value in record.counters.items():
        reg.inc(name, value * times)
    for name, value in record.gauges.items():
        reg.gauge(name, value)
