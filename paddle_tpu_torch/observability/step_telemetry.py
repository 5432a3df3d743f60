"""Telemetry sinks (counterpart of paddle_tpu/observability/step_telemetry.py's
``InMemorySink`` and ``JsonlSink``): where the serving engine's
``serve_request`` / ``serve_step`` records and the router's ``route``
records go. Not ported yet: ``StepTelemetry``, the per-train-step records
(ROADMAP.md Queue 1 item 10)."""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List


class InMemorySink:
    """Collects records in a list — for tests and notebook inspection."""

    def __init__(self):
        self.records: List[Dict[str, Any]] = []

    def write(self, record: Dict[str, Any]) -> None:
        self.records.append(record)

    def close(self) -> None:
        pass


class JsonlSink:
    """Appends one JSON line per record; opened lazily, flushed per write so
    a crashed run keeps every completed record."""

    def __init__(self, path: str):
        self.path = path
        self._f = None

    def write(self, record: Dict[str, Any]) -> None:
        if self._f is None:
            d = os.path.dirname(os.path.abspath(self.path))
            os.makedirs(d, exist_ok=True)
            self._f = open(self.path, "a")
        self._f.write(json.dumps(record) + "\n")
        self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None
