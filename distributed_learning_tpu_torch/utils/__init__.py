"""Host-side utilities of the port."""

from distributed_learning_tpu_torch.utils.telemetry import (
    RecordingTelemetry,
    TelemetryProcessor,
)

__all__ = ["TelemetryProcessor", "RecordingTelemetry"]
