"""Host-side utilities of the port: telemetry hooks, tracing, logging."""

from distributed_learning_tpu_torch.utils.profiling import (
    DebugLogger,
    annotate,
    enable_debug_logging,
    trace,
)
from distributed_learning_tpu_torch.utils.telemetry import (
    CallbackTelemetry,
    RecordingTelemetry,
    TelemetryProcessor,
)

__all__ = [
    "CallbackTelemetry",
    "RecordingTelemetry",
    "TelemetryProcessor",
    "DebugLogger",
    "annotate",
    "enable_debug_logging",
    "trace",
]
