"""Host-side span tracer (counterpart of paddle_tpu/observability/tracer.py).

Every span keeps (name, ts, dur, tid, args) in a bounded ring buffer and
exports chrome-trace JSON (``trace_events`` format), so host markers load
into Perfetto/chrome://tracing next to a ``torch.profiler`` device
timeline. The reference analogue is HostEventRecorder + the chrome-trace
serializer in paddle/fluid/platform/profiler/chrometracing_logger.cc.

Two-tier cost model (the subsystem is meant to stay ON in production):

- aggregates (count/total/max/min per span name) are ALWAYS maintained —
  a dict update per span end, the same cost the old ``_event_stats`` paid;
- full events are recorded ONLY while ``enable()`` is active, into a
  fixed-capacity ring buffer (old events are dropped, memory is bounded);
- when tracing is disabled, ``span()`` returns a shared no-op context
  manager: no timestamp is taken, no allocation, no I/O.

Thread safety: one lock guards the ring buffer and the aggregate table;
span objects themselves are not shared across threads (each ``span()`` call
makes its own). tid is the OS thread ident so nested spans from different
threads land on separate chrome-trace rows.
"""
from __future__ import annotations

import collections
import itertools
import json
import os
import threading
import time
from typing import Dict, List, Optional

# chrome trace wants microseconds; all internal timestamps are seconds from
# the process-wide origin below so exported traces from one process align.
_ORIGIN = time.perf_counter()


class _NullSpan:
    """Shared disabled-path context manager: enter/exit do nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """RAII span bound to one tracer; records a complete event on exit."""

    __slots__ = ("_tracer", "name", "args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, args: Optional[dict]):
        self._tracer = tracer
        self.name = name
        self.args = args
        self._t0 = time.perf_counter()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.end()
        return False

    def end(self):
        if self._t0 is None:
            return
        t1 = time.perf_counter()
        self._tracer.record_complete(self.name, self._t0, t1, self.args)
        self._t0 = None


class Tracer:
    def __init__(self, capacity: int = 100_000):
        self._lock = threading.Lock()
        self._events: collections.deque = collections.deque(maxlen=capacity)
        self._stats: Dict[str, list] = {}  # name -> [count, total, max, min]
        self.enabled = False
        self._dropped = 0

    # ---- control ----
    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._dropped = 0

    def clear_stats(self) -> None:
        with self._lock:
            self._stats.clear()

    # ---- recording ----
    def span(self, name: str, **args):
        """Context manager timing a region. Free when tracing is disabled
        AND no aggregate is wanted — aggregates come from explicit
        RecordEvent/record_complete callers, so the fast path here is a
        single attribute check."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, args or None)

    def record_complete(self, name: str, t0: float, t1: float,
                        args: Optional[dict] = None,
                        tid: Optional[int] = None,
                        aggregate: bool = True) -> None:
        """Record a finished [t0, t1] perf_counter interval."""
        dur = t1 - t0
        with self._lock:
            if aggregate:
                st = self._stats.get(name)
                if st is None:
                    st = self._stats[name] = [0, 0.0, 0.0, float("inf")]
                st[0] += 1
                st[1] += dur
                if dur > st[2]:
                    st[2] = dur
                if dur < st[3]:
                    st[3] = dur
            if self.enabled:
                if len(self._events) == self._events.maxlen:
                    self._dropped += 1
                self._events.append((name, t0 - _ORIGIN, dur,
                                     tid if tid is not None
                                     else threading.get_ident(), args))

    def instant(self, name: str, **args) -> None:
        """Zero-duration marker (chrome-trace 'i' event)."""
        if not self.enabled:
            return
        t = time.perf_counter()
        with self._lock:
            self._events.append((name, t - _ORIGIN, None,
                                 threading.get_ident(), args or None))

    # ---- inspection / export ----
    def events(self) -> List[dict]:
        """Snapshot of buffered events as dicts (ts/dur in seconds)."""
        with self._lock:
            return [
                {"name": n, "ts": ts, "dur": dur, "tid": tid,
                 **({"args": args} if args else {})}
                for n, ts, dur, tid, args in self._events
            ]

    def stats(self) -> Dict[str, list]:
        """name -> [count, total_s, max_s, min_s] aggregate table."""
        with self._lock:
            return {n: list(v) for n, v in self._stats.items()}

    @property
    def dropped(self) -> int:
        return self._dropped

    def chrome_trace(self, process_name: str = "paddle_tpu host") -> dict:
        """The buffered timeline in chrome-trace ``trace_events`` format
        (complete 'X' events in microseconds), ready to json.dump or to
        merge with a torch.profiler export."""
        pid = os.getpid()
        trace_events = [{
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": process_name},
        }]
        with self._lock:
            for name, ts, dur, tid, args in self._events:
                ev = {"name": name, "pid": pid, "tid": tid,
                      "ts": round(ts * 1e6, 3)}
                if dur is None:
                    ev["ph"] = "i"
                    ev["s"] = "t"
                else:
                    ev["ph"] = "X"
                    ev["dur"] = round(dur * 1e6, 3)
                if args:
                    ev["args"] = dict(args)
                trace_events.append(ev)
        return {"traceEvents": trace_events, "displayTimeUnit": "ms"}

    def export_chrome_trace(self, path: str) -> str:
        """Write the chrome trace JSON to ``path`` and return the path."""
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path


_global_tracer = Tracer()

_span_ids = itertools.count(1)


def new_span_id() -> int:
    """Process-unique id for cross-component span parentage (fleet trace
    context): the router mints one per placement span; engine-side child
    spans carry it as ``parent_span`` so one chrome trace links routing
    decision -> queue wait -> prefill/decode for a single request."""
    return next(_span_ids)


def get_tracer() -> Tracer:
    return _global_tracer


def enabled() -> bool:
    return _global_tracer.enabled


def span(name: str, **args):
    """Module-level sugar over the global tracer."""
    return _global_tracer.span(name, **args)
