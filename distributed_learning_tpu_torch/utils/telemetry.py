"""Telemetry hook (port of ``distributed_learning_tpu/utils/telemetry.py``).

The trainer invokes the processor host-side after each epoch with
per-agent metric payloads.  The abstract interface is the reference's
``TelemetryProcessor.process(token, payload)``, so user subclasses work
unchanged with either package.
"""

from __future__ import annotations

from typing import Any, Dict, Hashable, List, Tuple

__all__ = ["TelemetryProcessor", "RecordingTelemetry"]


class TelemetryProcessor:
    """Abstract telemetry sink: override :meth:`process`."""

    def process(self, token: Hashable, payload: Any) -> None:
        raise NotImplementedError


class RecordingTelemetry(TelemetryProcessor):
    """Appends every (token, payload) pair — handy default and test double."""

    def __init__(self) -> None:
        self.records: List[Tuple[Hashable, Any]] = []

    def process(self, token: Hashable, payload: Any) -> None:
        self.records.append((token, payload))

    def by_token(self) -> Dict[Hashable, List[Any]]:
        out: Dict[Hashable, List[Any]] = {}
        for tok, payload in self.records:
            out.setdefault(tok, []).append(payload)
        return out
