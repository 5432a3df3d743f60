"""Crash/NaN flight recorder: last-N records ring, dumped on trigger
(counterpart of paddle_tpu/observability/flight_recorder.py).

Black-box instrument for post-mortem debugging: while enabled it tees the
most recent StepTelemetry / serving records into a bounded in-memory ring
(no I/O on the hot path), and on a trigger writes everything it knows to a
fresh directory:

    <out_dir>/flight_<pid>_<seq>_<reason>/
        records.jsonl   the ring: last-N step/serve records, oldest first
        spans.json      recent tracer events (when the tracer is enabled)
        state.json      trigger metadata + core.monitor counters + metrics
                        registry snapshot (when metrics are active)

Triggers:
- an uncaught exception in ``TrainStepEngine.step`` / ``run_steps`` or the
  serving engine's prefill, decode or verify dispatch (the engines dump
  before re-raising), a failed elastic
  reformation (``elastic_reform_<gen>``), a page-severity SLO fire,
- ``on_nan_inf()`` from a caller that detected a non-finite value,
- an explicit `FlightRecorder.dump()`.

Enabled via ``PADDLE_TPU_FLIGHT_DIR`` (engines call `ensure_from_env()` at
construction) or programmatically via `enable(out_dir)`. Off by default:
`get()` returns None and the engines' per-step cost is one module-global
None check. NaN-triggered dumps are rate-limited (``nan_dump_limit``) so a
diverged run doesn't fill the disk with one dump per step.

Stdlib-only. A dump's ``state.json`` carries ``health_tail``, the
training-health monitor's last records, when a monitor is live.
"""
from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import List, Optional

_DEFAULT_CAPACITY = 256
_SPAN_TAIL = 512


class FlightRecorder:
    def __init__(self, out_dir: str, capacity: int = _DEFAULT_CAPACITY,
                 span_tail: int = _SPAN_TAIL, nan_dump_limit: int = 2):
        self.out_dir = str(out_dir)
        self.capacity = int(capacity)
        self.span_tail = int(span_tail)
        self.nan_dump_limit = int(nan_dump_limit)
        self._ring = collections.deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._dump_seq = 0
        self._nan_dumps = 0
        self.dumps: List[str] = []

    # ---- hot path ---------------------------------------------------------

    def record(self, rec: dict) -> None:
        """Tee one step/serve record into the ring (no I/O)."""
        with self._lock:
            self._ring.append(rec)

    def records(self) -> List[dict]:
        with self._lock:
            return list(self._ring)

    # ---- triggers ---------------------------------------------------------

    def dump(self, reason: str, extra: Optional[dict] = None) -> str:
        """Write the ring + spans + counters to a fresh dump dir."""
        with self._lock:
            ring = list(self._ring)
            self._dump_seq += 1
            seq = self._dump_seq
        safe = "".join(c if c.isalnum() or c in "-_" else "_"
                       for c in reason)[:60] or "manual"
        d = os.path.join(self.out_dir,
                         f"flight_{os.getpid()}_{seq:03d}_{safe}")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "records.jsonl"), "w") as f:
            for rec in ring:
                f.write(json.dumps(rec, default=str) + "\n")
        spans = self._recent_spans()
        if spans is not None:
            with open(os.path.join(d, "spans.json"), "w") as f:
                json.dump(spans, f, default=str)
        with open(os.path.join(d, "state.json"), "w") as f:
            json.dump(self._state(reason, extra), f, indent=2, sort_keys=True,
                      default=str)
        self.dumps.append(d)
        try:  # dump accounting in the metrics registry, by reason label
            from . import metrics as _metrics
            reg = _metrics.active_registry()
            if reg is not None:
                reg.counter("flight.dumps").inc()
                reg.counter("flight.dumps." + safe).inc()
        except ImportError:
            pass
        return d

    def on_nan_inf(self, source: str, extra: Optional[dict] = None
                   ) -> Optional[str]:
        """NaN/Inf trigger (rate-limited)."""
        with self._lock:
            if self._nan_dumps >= self.nan_dump_limit:
                return None
            self._nan_dumps += 1
        return self.dump(f"nan_inf_{source}", extra)

    # ---- dump contents ----------------------------------------------------

    def _recent_spans(self):
        try:
            from .tracer import get_tracer
        except ImportError:
            return None
        tr = get_tracer()
        if not tr.enabled:
            return None
        evs = tr.events()
        return evs[-self.span_tail:]

    def _state(self, reason, extra) -> dict:
        state = {
            "reason": reason,
            "time_unix": time.time(),
            "pid": os.getpid(),
            "ring_len": len(self._ring),
            "extra": extra or {},
        }
        try:
            from paddle_tpu_torch.core import monitor
            state["counters"] = {name: dict(rep) for name, rep in
                                 sorted(monitor.registry().report().items())}
        except ImportError:
            pass
        try:
            from . import metrics as _metrics
            reg = _metrics.active_registry()
            if reg is not None:
                state["metrics"] = reg.snapshot(include_monitor=False,
                                                compact=True)
        except ImportError:
            pass
        try:
            # fleet context: the last collected fleet snapshot + router
            # placement tail when a collector/router is live — a crash
            # dump then shows the fleet, not just the dying process
            from . import fleet as _fleet
            fc = _fleet.flight_context()
            if fc:
                state.update(fc)  # "fleet" + "router_placements" keys
        except Exception:
            pass
        try:
            # training-health tail: the last decoded health records (grad
            # norms, nonfinite attribution) when a monitor is live — the
            # post-mortem context a health-triggered dump points at
            from . import health as _health
            hm = _health.get_monitor()
            if hm is not None:
                state["health_tail"] = hm.recent(32)
        except Exception:
            pass
        return state


# ---- process-global recorder (off until enabled) ---------------------------

_global: Optional[FlightRecorder] = None
_lock = threading.Lock()


def enable(out_dir: str, capacity: int = _DEFAULT_CAPACITY,
           **kw) -> FlightRecorder:
    global _global
    with _lock:
        if _global is None or _global.out_dir != str(out_dir):
            _global = FlightRecorder(out_dir, capacity=capacity, **kw)
        return _global


def disable() -> None:
    global _global
    with _lock:
        _global = None


def get() -> Optional[FlightRecorder]:
    """The recorder iff enabled, else None — the engines' hot-path gate."""
    return _global


def active() -> bool:
    return _global is not None


def ensure_from_env() -> Optional[FlightRecorder]:
    """Enable iff PADDLE_TPU_FLIGHT_DIR is set (idempotent)."""
    if _global is not None:
        return _global
    d = os.environ.get("PADDLE_TPU_FLIGHT_DIR")
    if not d:
        return None
    return enable(d)


def on_nan_inf(source: str, extra: Optional[dict] = None) -> Optional[str]:
    """Module-level NaN hook: no-op unless a recorder is enabled.

    A caller that found a non-finite value calls this on its failure branch
    (the reference's dispatch NaN check does); only a None check when no
    recorder is attached.
    """
    fr = _global
    if fr is None:
        return None
    return fr.on_nan_inf(source, extra)
