"""Unified observability layer of the port (``distributed_learning_tpu/obs/``'s
export surface, the same names): metrics registry, device-side metrics
carry, span tracing, cost profiles and the run-wide plane.

* :class:`MetricsRegistry` (+ JSONL event-log / run-report exporters)
  — `registry.py`;
* :func:`flush_chunk` / :func:`global_norm` — the device-side metrics
  carry: traces stay on the device through a chunk and reach the
  registry with the one host read per chunk — `carry.py`;
* :class:`SpanTracer` (nested wall-clock spans, Chrome trace export,
  ``torch.profiler`` / NVTX annotation) — `spans.py`;
* :func:`instrument_step` — call counting and spans for step
  functions, with a profile hook — `instrument.py`;
* run-report rendering + the ``obs-report`` / ``obs-monitor`` CLIs —
  `report.py`;
* the run-wide plane — `aggregate.py`, `flight.py`, `sketch.py`,
  `health.py` (the JAX package's copies, jax-free there too);
* the device-cost observatory — `cost.py` (:class:`CostProfile`
  counted from a step run once under a FLOP counter;
  :class:`SampledDispatchTimer`, CUDA-event chunk timing with MFU
  against the card's peak; the perf ledger behind ``obs-report
  --ledger``).

Library code counts into the process-wide default registry/tracer
(`get_registry()` / `get_tracer()`); tests and programs running several trainings scope
them with `use_registry` / `set_tracer`.
"""

from distributed_learning_tpu_torch.obs.carry import flush_chunk, global_norm
from distributed_learning_tpu_torch.obs.cost import (
    CostProfile,
    SampledDispatchTimer,
    all_profiles,
    clear_profiles,
    device_peak_flops,
    get_profile,
    ledger_append,
    profile_fn,
    read_ledger,
    register_profile,
)
from distributed_learning_tpu_torch.obs.instrument import InstrumentedStep, instrument_step
from distributed_learning_tpu_torch.obs.registry import (
    JsonlSink,
    JsonlTelemetry,
    MetricsRegistry,
    get_registry,
    read_jsonl,
    run_report,
    set_registry,
    use_registry,
)
from distributed_learning_tpu_torch.obs.aggregate import (
    OBS_PAYLOAD_KIND,
    OBS_PAYLOAD_SECTIONS,
    OBS_PAYLOAD_VERSION,
    SKETCH_SERIES,
    ObsDeltaSource,
    RunAggregator,
    SubAggregator,
    edge_profile_from_registry,
    is_obs_payload,
    straggler_profile_from_registry,
)
from distributed_learning_tpu_torch.obs.sketch import (
    DEFAULT_ALPHA,
    LabelRollup,
    QuantileSketch,
)
from distributed_learning_tpu_torch.obs.flight import FlightRecorder
from distributed_learning_tpu_torch.obs.health import (
    HealthBreach,
    HealthRule,
    HealthSentinel,
    default_rules,
)
from distributed_learning_tpu_torch.obs.report import format_run_report, obs_report_main
from distributed_learning_tpu_torch.obs.spans import (
    FLOW_EVENT,
    FLOW_PHASES,
    Span,
    SpanTracer,
    emit_flow,
    flow_key,
    get_tracer,
    set_tracer,
    span,
    trace_keep,
)

__all__ = [
    "MetricsRegistry",
    "JsonlSink",
    "JsonlTelemetry",
    "get_registry",
    "set_registry",
    "use_registry",
    "read_jsonl",
    "run_report",
    "flush_chunk",
    "global_norm",
    "Span",
    "SpanTracer",
    "get_tracer",
    "set_tracer",
    "span",
    "InstrumentedStep",
    "instrument_step",
    "CostProfile",
    "SampledDispatchTimer",
    "profile_fn",
    "register_profile",
    "get_profile",
    "all_profiles",
    "clear_profiles",
    "device_peak_flops",
    "ledger_append",
    "read_ledger",
    "format_run_report",
    "obs_report_main",
    "OBS_PAYLOAD_KIND",
    "OBS_PAYLOAD_SECTIONS",
    "OBS_PAYLOAD_VERSION",
    "SKETCH_SERIES",
    "DEFAULT_ALPHA",
    "QuantileSketch",
    "LabelRollup",
    "ObsDeltaSource",
    "RunAggregator",
    "SubAggregator",
    "FlightRecorder",
    "is_obs_payload",
    "straggler_profile_from_registry",
    "edge_profile_from_registry",
    "FLOW_EVENT",
    "FLOW_PHASES",
    "emit_flow",
    "flow_key",
    "trace_keep",
    "HealthBreach",
    "HealthRule",
    "HealthSentinel",
    "default_rules",
]
