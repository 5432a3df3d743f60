"""Typed metric registry: counters, gauges, log-bucketed histograms
(counterpart of paddle_tpu/observability/metrics.py).

- ``Counter`` / ``Gauge``: thread-safe scalars.
- ``Histogram``: fixed-boundary buckets (log-spaced by default) with exact
  ``min/max/sum/count`` and interpolated p50/p90/p99 estimation — the same
  shape Prometheus client libraries expose, so `observability/exporter.py`
  can render the text format directly from a snapshot.
- ``MetricRegistry``: name -> metric, get-or-create, one lock per metric.
  ``snapshot()`` additionally absorbs the raw monotonic counters living in
  `core.monitor` (jit_compiles, nan_inf_hits, serving.*, grad_comm.* ...),
  so one scrape sees both worlds without double instrumentation.

Everything here is stdlib-only (the disabled path of the engines never
pays an import). The default namespace stays ``paddle_tpu``, so the
Prometheus series keep the reference's names.

Off by default: `active_registry()` returns None until `enable()` (called
by the exporter's env-var autostart or a test). Engine hot paths gate all
observations on that single None check.
"""
from __future__ import annotations

import bisect
import json
import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple


def log_buckets(lo: float, hi: float, factor: float = 2.0) -> Tuple[float, ...]:
    """Geometric bucket upper bounds covering [lo, hi]: lo, lo*f, ... >= hi."""
    if lo <= 0 or hi <= lo or factor <= 1:
        raise ValueError("need 0 < lo < hi and factor > 1")
    out = [lo]
    while out[-1] < hi:
        out.append(out[-1] * factor)
    return tuple(out)


# Default boundaries for millisecond-valued latency histograms: 0.1ms .. ~3.4min
DEFAULT_MS_BUCKETS = log_buckets(0.1, 200_000.0, 2.0)


class Counter:
    """Monotonic float counter."""

    kind = "counter"

    def __init__(self, name: str, description: str = ""):
        self.name = name
        self.description = description
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def merge(self, other: "Counter") -> None:
        """Absorb another counter's value (fleet federation: merged total
        equals the sum of the per-worker totals)."""
        n = other.value
        with self._lock:
            self._value += n

    def snapshot(self) -> dict:
        return {"kind": self.kind, "value": self.value}


class Gauge:
    """Last-write-wins scalar (queue depth, occupancy, ...)."""

    kind = "gauge"

    def __init__(self, name: str, description: str = ""):
        self.name = name
        self.description = description
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        with self._lock:
            self._value -= n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def snapshot(self) -> dict:
        return {"kind": self.kind, "value": self.value}


class Histogram:
    """Fixed-boundary histogram with exact moments and estimated percentiles.

    ``boundaries`` are bucket *upper* bounds (like Prometheus ``le``); an
    implicit +Inf bucket catches overflow. Percentiles are estimated by
    linear interpolation inside the bucket holding the target rank, then
    clamped to the exactly-tracked [min, max] — so the estimate is never
    off by more than one bucket width.
    """

    kind = "histogram"

    def __init__(self, name: str, boundaries: Sequence[float] = None,
                 description: str = ""):
        self.name = name
        self.description = description
        bs = tuple(boundaries) if boundaries is not None else DEFAULT_MS_BUCKETS
        if list(bs) != sorted(bs) or len(set(bs)) != len(bs):
            raise ValueError("boundaries must be strictly increasing")
        self.boundaries: Tuple[float, ...] = bs
        self._lock = threading.Lock()
        self._counts = [0] * (len(bs) + 1)  # last = +Inf overflow
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    def observe(self, v: float) -> None:
        v = float(v)
        i = bisect.bisect_left(self.boundaries, v)
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def merge(self, other: "Histogram") -> None:
        """Absorb another histogram with identical boundaries, losslessly.

        Bucket counts and the exact moments (count/sum/min/max) add
        elementwise — exactly what one histogram observing the pooled
        samples would hold — so percentile estimates recomputed from the
        merged buckets stay within one bucket width of the pooled truth.
        """
        if tuple(other.boundaries) != self.boundaries:
            raise ValueError(
                f"histogram {self.name!r}: cannot merge boundaries "
                f"{list(other.boundaries)} into {list(self.boundaries)}")
        with other._lock:
            counts = list(other._counts)
            count, total = other._count, other._sum
            mn, mx = other._min, other._max
        with self._lock:
            for i, c in enumerate(counts):
                self._counts[i] += c
            self._count += count
            self._sum += total
            if mn < self._min:
                self._min = mn
            if mx > self._max:
                self._max = mx

    def snapshot(self) -> dict:
        with self._lock:
            counts = list(self._counts)
            count, total = self._count, self._sum
            mn = self._min if self._count else None
            mx = self._max if self._count else None
        snap = {
            "kind": self.kind,
            "boundaries": list(self.boundaries),
            "counts": counts,
            "count": count,
            "sum": total,
            "min": mn,
            "max": mx,
        }
        for q in (0.5, 0.9, 0.99):
            snap["p%g" % (q * 100)] = estimate_percentile(snap, q)
        return snap

    def percentile(self, q: float) -> Optional[float]:
        return estimate_percentile(self.snapshot(), q)


def estimate_percentile(snap: dict, q: float) -> Optional[float]:
    """Interpolated percentile from a histogram snapshot dict.

    Works on any dict with boundaries/counts/count/min/max — usable offline
    (the reference's tools/trace_summary.py) on a JSON snapshot without a live registry.
    """
    if not 0 <= q <= 1:
        raise ValueError("q in [0, 1]")
    count = snap.get("count", 0)
    if not count:
        return None
    boundaries = snap["boundaries"]
    counts = snap["counts"]
    mn, mx = snap["min"], snap["max"]
    rank = q * count
    cum = 0.0
    for i, c in enumerate(counts):
        if cum + c >= rank and c > 0:
            # interpolate within bucket i between its lower/upper bounds
            lo = boundaries[i - 1] if i > 0 else mn
            hi = boundaries[i] if i < len(boundaries) else mx
            frac = (rank - cum) / c
            est = lo + (hi - lo) * frac
            return float(min(max(est, mn), mx))
        cum += c
    return float(mx)


def merge_histogram_snapshots(snaps: Sequence[Optional[dict]]
                              ) -> Optional[dict]:
    """Lossless merge of histogram snapshot dicts sharing one boundary set.

    Bucket counts, ``count`` and ``sum`` add elementwise; ``min``/``max``
    combine (None-aware for empty inputs); p50/p90/p99 are recomputed from
    the merged buckets — the same estimate a single histogram observing
    the pooled samples would report, so merged percentiles sit within one
    bucket width of the pooled recompute. Usable offline (fleet collector,
    tools/trace_summary.py) on JSON snapshots without a live registry.
    Returns None when no snapshot is present at all.
    """
    merged: Optional[dict] = None
    for snap in snaps:
        if snap is None:
            continue
        if merged is None:
            merged = {
                "kind": "histogram",
                "boundaries": list(snap["boundaries"]),
                "counts": list(snap["counts"]),
                "count": int(snap["count"]),
                "sum": float(snap["sum"]),
                "min": snap["min"],
                "max": snap["max"],
            }
            continue
        if list(snap["boundaries"]) != merged["boundaries"]:
            raise ValueError(
                "cannot merge histogram snapshots with different boundaries")
        merged["counts"] = [a + b for a, b in
                            zip(merged["counts"], snap["counts"])]
        merged["count"] += int(snap["count"])
        merged["sum"] += float(snap["sum"])
        mns = [v for v in (merged["min"], snap["min"]) if v is not None]
        mxs = [v for v in (merged["max"], snap["max"]) if v is not None]
        merged["min"] = min(mns) if mns else None
        merged["max"] = max(mxs) if mxs else None
    if merged is not None:
        for q in (0.5, 0.9, 0.99):
            merged["p%g" % (q * 100)] = estimate_percentile(merged, q)
    return merged


def subtract_histogram_snapshots(curr: Optional[dict], prev: Optional[dict]
                                 ) -> Optional[dict]:
    """Exact window delta of two histogram snapshots of ONE histogram.

    The dual of :func:`merge_histogram_snapshots`: given a later (``curr``)
    and an earlier (``prev``) snapshot of the same monotonically-observing
    histogram, returns the snapshot the histogram would hold had it only
    observed the samples between the two — bucket counts, ``count`` and
    ``sum`` subtract exactly (boundary mismatch raises, and so does a
    bucket going backwards: that means ``prev`` is not an earlier view of
    ``curr``). The window ``min``/``max`` are not recoverable from
    cumulative state, so they are re-derived from the delta buckets
    (first/last non-empty bucket bounds, tightened by the lifetime
    min/max) — which keeps p50/p90/p99 recomputed from the delta within
    one bucket width of a pooled recompute over the window's samples, the
    same guarantee the merge direction gives. This is the primitive the
    SLO snapshot ring uses for sliding-window percentiles; ``prev=None``
    treats the window as starting from empty.
    """
    if curr is None:
        return None
    if prev is None:
        prev = {"boundaries": curr["boundaries"],
                "counts": [0] * len(curr["counts"]),
                "count": 0, "sum": 0.0, "min": None, "max": None}
    if list(curr["boundaries"]) != list(prev["boundaries"]):
        raise ValueError(
            "cannot subtract histogram snapshots with different boundaries")
    counts = [int(a) - int(b) for a, b in zip(curr["counts"], prev["counts"])]
    if any(c < 0 for c in counts) or curr["count"] < prev["count"]:
        raise ValueError(
            "histogram delta went backwards: prev is not an earlier "
            "snapshot of curr (registry reset mid-window?)")
    boundaries = list(curr["boundaries"])
    delta = {
        "kind": "histogram",
        "boundaries": boundaries,
        "counts": counts,
        "count": int(curr["count"]) - int(prev["count"]),
        "sum": float(curr["sum"]) - float(prev["sum"]),
        "min": None,
        "max": None,
    }
    if delta["count"]:
        nz = [i for i, c in enumerate(counts) if c]
        lo_i, hi_i = nz[0], nz[-1]
        # window min lies inside bucket lo_i: bound it by the bucket's
        # lower edge (or the lifetime min for the first bucket), window
        # max by the bucket's upper edge (lifetime max for overflow)
        delta["min"] = boundaries[lo_i - 1] if lo_i > 0 else curr["min"]
        delta["max"] = (boundaries[hi_i] if hi_i < len(boundaries)
                        else curr["max"])
        for q in (0.5, 0.9, 0.99):
            delta["p%g" % (q * 100)] = estimate_percentile(delta, q)
    else:
        for q in (0.5, 0.9, 0.99):
            delta["p%g" % (q * 100)] = None
    return delta


def subtract_counter_values(curr: float, prev: float) -> float:
    """Window delta of a monotonic counter; raises if it went backwards."""
    d = float(curr) - float(prev)
    if d < 0:
        raise ValueError(
            f"counter delta went backwards ({curr} < {prev}): prev is not "
            "an earlier snapshot of curr")
    return d


def subtract_registry_snapshots(curr: dict, prev: Optional[dict]) -> dict:
    """Window delta of two full ``MetricRegistry.snapshot()`` documents.

    Counters, monitor values and histogram buckets subtract exactly
    (:func:`subtract_counter_values` / :func:`subtract_histogram_snapshots`
    semantics); gauges are level- not event-valued, so the delta carries
    the *current* gauge reading. A counter/histogram present only in
    ``curr`` deltas from zero (it was created inside the window); one that
    went backwards raises. ``prev=None`` returns the full current view.
    """
    prev = prev or {}
    out: dict = {"counters": {}, "gauges": dict(curr.get("gauges", {})),
                 "histograms": {}}
    pc = prev.get("counters", {})
    for name, v in curr.get("counters", {}).items():
        out["counters"][name] = subtract_counter_values(v, pc.get(name, 0.0))
    ph = prev.get("histograms", {})
    for name, h in curr.get("histograms", {}).items():
        out["histograms"][name] = subtract_histogram_snapshots(
            h, ph.get(name))
    if "monitor" in curr:
        pm = prev.get("monitor", {})
        out["monitor"] = {}
        for name, rep in curr["monitor"].items():
            pv = float(pm.get(name, {}).get("value", 0.0))
            out["monitor"][name] = {
                "value": subtract_counter_values(
                    float(rep.get("value", 0.0)), pv),
                "peak": float(rep.get("peak", 0.0)),
            }
    return out


class MetricRegistry:
    """Thread-safe name -> metric map with get-or-create accessors."""

    def __init__(self, namespace: str = "paddle_tpu"):
        self.namespace = namespace
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}

    def _get_or_create(self, cls, name, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, **kw)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {cls.__name__}")
            return m

    def counter(self, name: str, description: str = "") -> Counter:
        return self._get_or_create(Counter, name, description=description)

    def gauge(self, name: str, description: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, description=description)

    def histogram(self, name: str, boundaries: Sequence[float] = None,
                  description: str = "") -> Histogram:
        return self._get_or_create(Histogram, name, boundaries=boundaries,
                                   description=description)

    def metrics(self) -> Dict[str, object]:
        with self._lock:
            return dict(self._metrics)

    # ---- snapshots --------------------------------------------------------

    def snapshot(self, include_monitor: bool = True,
                 compact: bool = False) -> dict:
        """Point-in-time view of every metric + absorbed monitor counters.

        ``compact=True`` replaces per-bucket arrays with the summary stats
        (count/sum/min/max/p50/p90/p99) — the right shape for bench rows.
        """
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for name, m in sorted(self.metrics().items()):
            snap = m.snapshot()
            if m.kind == "histogram":
                if compact:
                    snap = {k: v for k, v in snap.items()
                            if k not in ("boundaries", "counts", "kind")}
                out["histograms"][name] = snap
            elif m.kind == "gauge":
                out["gauges"][name] = snap["value"]
            else:
                out["counters"][name] = snap["value"]
        if include_monitor:
            out["monitor"] = self._monitor_report()
        return out

    @staticmethod
    def _monitor_report() -> dict:
        # Lazy import: core.monitor is stdlib-only too, but keeping it out
        # of module load preserves standalone importability of this file.
        try:
            from paddle_tpu_torch.core import monitor
        except ImportError:  # standalone module load (stdlib-only test)
            return {}
        return {name: dict(rep)
                for name, rep in sorted(monitor.registry().report().items())}

    # ---- Prometheus text exposition ---------------------------------------

    def to_prometheus(self) -> str:
        """Render the registry (+ monitor counters) in Prometheus text
        format 0.0.4: histograms as cumulative ``_bucket{le=...}`` series
        plus ``_sum``/``_count``."""
        lines: List[str] = []
        ns = _sanitize(self.namespace)

        def emit(name, kind, help_, series):
            lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} {kind}")
            lines.extend(series)

        for name, m in sorted(self.metrics().items()):
            full = f"{ns}_{_sanitize(name)}"
            help_ = m.description or name
            if m.kind == "histogram":
                snap = m.snapshot()
                series, cum = [], 0
                for b, c in zip(snap["boundaries"], snap["counts"]):
                    cum += c
                    series.append(
                        f'{full}_bucket{{le="{_fmt_le(b)}"}} {cum}')
                cum += snap["counts"][-1]
                series.append(f'{full}_bucket{{le="+Inf"}} {cum}')
                series.append(f"{full}_sum {_fmt_val(snap['sum'])}")
                series.append(f"{full}_count {snap['count']}")
                emit(full, "histogram", help_, series)
            elif m.kind == "gauge":
                emit(full, "gauge", help_, [f"{full} {_fmt_val(m.value)}"])
            else:
                emit(f"{full}_total", "counter", help_,
                     [f"{full}_total {_fmt_val(m.value)}"])
        for name, rep in self._monitor_report().items():
            full = f"{ns}_monitor_{_sanitize(name)}"
            emit(full, "gauge", f"core.monitor stat {name}",
                 [f"{full} {_fmt_val(rep['value'])}"])
            lines.append(f"{full}_peak {_fmt_val(rep['peak'])}")
        return "\n".join(lines) + "\n"

    def to_json(self, compact: bool = False) -> str:
        return json.dumps(self.snapshot(compact=compact), sort_keys=True)


def _sanitize(name: str) -> str:
    return "".join(c if c.isalnum() or c == "_" else "_" for c in name)


def _fmt_le(b: float) -> str:
    return "%g" % b


def _fmt_val(v: float) -> str:
    f = float(v)
    return "%d" % f if f == int(f) and abs(f) < 1e15 else repr(f)


# ---- process-global default registry (off until enabled) -------------------

_default = MetricRegistry()
_active = False
_state_lock = threading.Lock()


def default_registry() -> MetricRegistry:
    """The process-wide registry (always exists; may be inactive)."""
    return _default


def active_registry() -> Optional[MetricRegistry]:
    """The registry iff metrics are enabled, else None.

    This is the engines' hot-path gate: one module-global read + None
    check per step when metrics are off.
    """
    return _default if _active else None


def enable() -> MetricRegistry:
    global _active
    with _state_lock:
        _active = True
    return _default


def disable() -> None:
    global _active
    with _state_lock:
        _active = False


def reset() -> None:
    """Drop all metrics and deactivate (test isolation)."""
    global _default, _active
    with _state_lock:
        _default = MetricRegistry()
        _active = False
