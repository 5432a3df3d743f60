"""Fleet observability: cross-process metrics federation + trace context
(counterpart of paddle_tpu/observability/fleet.py).

Elastic worker pools over the store and a ReplicaRouter over K serving
engines make a fleet; this module federates its per-process observability:

- **Metrics federation.** Each worker runs a :class:`FleetPublisher` that
  periodically writes a compact (zlib+base64 JSON) registry snapshot +
  tracer span tail under a generation-scoped store key::

      __fleet__/gen<g>/snap/<wid>    {"wid", "ts", "deadline", "pid",
                                      "origin_unix", "snapshot", "spans"}

  reusing membership.py's lease idiom (wall-clock deadlines — records are
  compared across processes; `gc_generation` sweeps retired generations).
  The controller runs a :class:`FleetCollector` that reads every unexpired
  snapshot, evicts stale publishers past their deadline, and merges the
  registries losslessly: counters/gauges sum, log-bucket histograms merge
  elementwise (`Histogram.merge` semantics) with p50/p90/p99 recomputed
  from the merged buckets — so the fleet-wide p99 is exactly what one
  histogram observing the pooled samples would estimate. The existing
  exporter serves the result at ``/fleet/metrics`` (Prometheus, merged
  series + per-worker-labeled quantiles) and ``/fleet/metrics.json``.

- **Distributed trace context.** :class:`TraceContext` carries a request
  id + parent span id from the ReplicaRouter's placement span into the
  chosen engine's queue-wait/prefill/decode spans, so one chrome trace
  renders the routing decision and the replica execution on a single
  timeline; ``FleetCollector.merged_chrome_trace()`` stitches every
  worker's span tail onto one wall-clock-aligned timeline (per-worker
  pid rows).

Cost model matches the rest of observability: everything here is dark by
default. ``FleetPublisher.publish_once`` gates on ``active_registry()``
(no registry -> no snapshot, no store write) and nothing in this module
runs unless explicitly constructed. Payloads are bounded
(``PADDLE_TPU_FLEET_MAX_BYTES``): an oversized publish first drops its
span tail, then drops entirely and counts ``fleet.publish_drops`` so
store pressure is visible.

Env knobs (all optional): ``PADDLE_TPU_FLEET_PUBLISH_S`` (publish period,
default 2.0), ``PADDLE_TPU_FLEET_DEADLINE_S`` (staleness deadline,
default 3x period), ``PADDLE_TPU_FLEET_MAX_BYTES`` (payload bound,
default 262144), ``PADDLE_TPU_FLEET_SPAN_TAIL`` (span-tail length,
default 256).

Stdlib-only, and no import of distributed/ (membership imports observability — the generation counter
key is re-read here instead).
"""
from __future__ import annotations

import base64
import itertools
import json
import os
import threading
import time
import weakref
import zlib
from typing import Dict, List, Optional, Sequence

from . import metrics as _metrics
from . import tracer as _tracer

# Generation counter key — membership.py's GEN_KEY, re-declared (not
# imported: distributed/membership imports observability).
GEN_KEY = "__elastic__/gen"
FLEET_PREFIX = "__fleet__"

_DEF_PUBLISH_S = 2.0
_DEF_MAX_BYTES = 262144
_DEF_SPAN_TAIL = 256


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, ""))
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, ""))
    except ValueError:
        return default


def current_generation(store) -> int:
    """The fleet's generation number; 0 before any coordinator ran."""
    try:
        return int(store.get(GEN_KEY, wait=False))
    except KeyError:
        return 0


def snap_key(generation: int, wid: str) -> str:
    return f"{FLEET_PREFIX}/gen{int(generation)}/snap/{wid}"


def _encode(doc: dict) -> bytes:
    """Compact store-safe payload: minified JSON -> zlib -> base64."""
    raw = json.dumps(doc, separators=(",", ":"), default=str).encode()
    return base64.b64encode(zlib.compress(raw, 6))


def _decode(blob: bytes) -> dict:
    return json.loads(zlib.decompress(base64.b64decode(blob)).decode())


# ---- trace context ----------------------------------------------------------

_req_ids = itertools.count(1)


def new_request_id() -> str:
    """Fleet-unique request id (pid-qualified so ids from different
    router/worker processes never collide in a merged trace)."""
    return f"{os.getpid():x}.{next(_req_ids)}"


class TraceContext:
    """Request-scoped trace identity carried across component boundaries.

    ``request_id`` tags every span of one request end to end;
    ``parent_span`` is the minting span's ``tracer.new_span_id()`` (the
    router's placement span), recorded on engine-side child spans so a
    chrome-trace consumer can reconstruct the parentage.
    """

    __slots__ = ("request_id", "parent_span")

    def __init__(self, request_id: Optional[str] = None,
                 parent_span: Optional[int] = None):
        self.request_id = (request_id if request_id is not None
                           else new_request_id())
        self.parent_span = parent_span

    def span_args(self) -> dict:
        out = {"request_id": self.request_id}
        if self.parent_span is not None:
            out["parent_span"] = self.parent_span
        return out

    def __repr__(self):
        return (f"TraceContext(request_id={self.request_id!r}, "
                f"parent_span={self.parent_span!r})")


# ---- registry-snapshot federation -------------------------------------------

def merge_registry_snapshots(snaps: Sequence[Optional[dict]]) -> dict:
    """Merge per-worker ``MetricRegistry.snapshot()`` dicts into one
    fleet-wide snapshot: counters and gauges sum, monitor stats sum value /
    max peak, histograms merge losslessly via
    :func:`metrics.merge_histogram_snapshots` (merged count == sum of
    per-worker counts; percentiles recomputed from merged buckets)."""
    out: dict = {"counters": {}, "gauges": {}, "histograms": {},
                 "monitor": {}}
    hists: Dict[str, List[dict]] = {}
    for s in snaps:
        if not s:
            continue
        for name, v in s.get("counters", {}).items():
            out["counters"][name] = out["counters"].get(name, 0.0) + v
        for name, v in s.get("gauges", {}).items():
            out["gauges"][name] = out["gauges"].get(name, 0.0) + v
        for name, h in s.get("histograms", {}).items():
            hists.setdefault(name, []).append(h)
        for name, rep in s.get("monitor", {}).items():
            m = out["monitor"].setdefault(name, {"value": 0.0, "peak": 0.0})
            m["value"] += float(rep.get("value", 0.0))
            m["peak"] = max(m["peak"], float(rep.get("peak", 0.0)))
    for name, hs in sorted(hists.items()):
        merged = _metrics.merge_histogram_snapshots(hs)
        if merged is not None:
            out["histograms"][name] = merged
    return out


def compact_snapshot(snap: dict) -> dict:
    """Per-bucket arrays -> summary stats (count/sum/min/max/p50/p90/p99),
    the right shape for flight dumps and bench rows."""
    out = dict(snap)
    out["histograms"] = {
        name: {k: v for k, v in h.items()
               if k not in ("boundaries", "counts", "kind")}
        for name, h in snap.get("histograms", {}).items()}
    return out


# ---- publisher --------------------------------------------------------------

class FleetPublisher:
    """One worker's metrics/span feed into the fleet store namespace.

    ``publish_once()`` snapshots the active registry (dark: returns False
    without touching the store when metrics are off), bounds the payload,
    and writes it under the *current* generation — after a reformation the
    next publish lands in the new namespace automatically, and
    ``gc_generation`` sweeps the old one. ``start()`` runs it on a daemon
    thread every ``interval_s``.
    """

    def __init__(self, store, worker_id: str,
                 interval_s: Optional[float] = None,
                 deadline_s: Optional[float] = None,
                 max_bytes: Optional[int] = None,
                 span_tail: Optional[int] = None):
        self.store = store
        self.worker_id = str(worker_id)
        self.interval_s = float(
            interval_s if interval_s is not None
            else _env_float("PADDLE_TPU_FLEET_PUBLISH_S", _DEF_PUBLISH_S))
        self.deadline_s = float(
            deadline_s if deadline_s is not None
            else _env_float("PADDLE_TPU_FLEET_DEADLINE_S",
                            3.0 * self.interval_s))
        self.max_bytes = int(
            max_bytes if max_bytes is not None
            else _env_int("PADDLE_TPU_FLEET_MAX_BYTES", _DEF_MAX_BYTES))
        self.span_tail = int(
            span_tail if span_tail is not None
            else _env_int("PADDLE_TPU_FLEET_SPAN_TAIL", _DEF_SPAN_TAIL))
        self.publishes = 0
        self.drops = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _span_tail(self) -> List[dict]:
        tr = _tracer.get_tracer()
        if not tr.enabled or self.span_tail <= 0:
            return []
        return tr.events()[-self.span_tail:]

    def payload(self) -> Optional[bytes]:
        """Encoded snapshot document, or None when dark / oversized."""
        reg = _metrics.active_registry()
        if reg is None:
            return None
        now = time.time()
        doc = {
            "wid": self.worker_id,
            "pid": os.getpid(),
            "ts": now,
            "deadline": now + self.deadline_s,
            # maps tracer perf_counter-relative span ts to wall clock so
            # the collector can align workers on one merged timeline
            "origin_unix": now - (time.perf_counter() - _tracer._ORIGIN),
            "snapshot": reg.snapshot(include_monitor=True),
            "spans": self._span_tail(),
        }
        blob = _encode(doc)
        if len(blob) > self.max_bytes and doc["spans"]:
            doc["spans"] = []  # spans are the elastic part; shed them first
            blob = _encode(doc)
        if len(blob) > self.max_bytes:
            reg.counter("fleet.publish_drops").inc()
            self.drops += 1
            return None
        return blob

    def publish_once(self) -> bool:
        blob = self.payload()
        if blob is None:
            return False
        gen = current_generation(self.store)
        self.store.set(snap_key(gen, self.worker_id), blob)
        self.publishes += 1
        reg = _metrics.active_registry()
        if reg is not None:
            reg.counter("fleet.publishes").inc()
        return True

    # ---- background loop ----
    def start(self) -> "FleetPublisher":
        if self._thread is not None:
            return self
        self._stop.clear()

        def _loop():
            while not self._stop.wait(self.interval_s):
                try:
                    self.publish_once()
                except Exception:
                    return  # dead store: the deadline evicts us naturally

        self._thread = threading.Thread(
            target=_loop, name=f"fleet-pub-{self.worker_id}", daemon=True)
        self._thread.start()
        return self

    def stop(self, final_publish: bool = False) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        if final_publish:
            try:
                self.publish_once()
            except Exception:
                pass

    def retire(self) -> None:
        """Gracefully remove this worker's snapshot (announce-leave
        analogue: the collector sees a departure, not a deadline expiry)."""
        self.stop()
        try:
            gen = current_generation(self.store)
            self.store.delete_key(snap_key(gen, self.worker_id))
        except Exception:
            pass


# ---- collector --------------------------------------------------------------

class FleetCollector:
    """Controller-side federation point: read every worker's snapshot under
    the current generation, evict the stale (deadline passed — the read IS
    the failure detector, like ``live_members``), merge the rest."""

    def __init__(self, store, span_limit: int = 20000):
        self.store = store
        self.span_limit = int(span_limit)
        self.collections = 0
        self.evictions = 0
        self.last: Optional[dict] = None
        self._docs: Dict[str, dict] = {}
        self._slo = None  # optional slo.SloEngine judging merged snapshots
        self._lock = threading.Lock()

    def attach_slo(self, slo_engine) -> None:
        """Evaluate fleet-level SLOs on every collect(): the engine's ring
        is fed the *merged* snapshot, so burn rates and alerts reflect the
        whole fleet (works with no local registry — merged counts are the
        evaluation input, gauges are skipped when metrics are dark). The
        collected document gains a ``slo`` section."""
        self._slo = slo_engine

    def generation(self) -> int:
        return current_generation(self.store)

    def _read_docs(self, generation: int):
        prefix = f"{FLEET_PREFIX}/gen{int(generation)}/snap/"
        now = time.time()
        docs: Dict[str, dict] = {}
        evicted: List[str] = []
        for key in self.store.list_keys(prefix):
            try:
                doc = _decode(self.store.get(key, wait=False))
            except KeyError:
                continue
            except Exception:
                doc = None  # corrupt payload: evict like a stale one
            wid = (doc or {}).get("wid") or key[len(prefix):]
            if doc is None or float(doc.get("deadline", 0.0)) < now:
                self.store.delete_key(key)
                evicted.append(wid)
                continue
            docs[wid] = doc
        return docs, evicted

    def collect(self) -> dict:
        """One federation pass. Returns (and caches as ``.last``) the
        fleet snapshot: merged registry + per-worker registries + ages."""
        t0 = time.perf_counter()
        gen = self.generation()
        docs, evicted = self._read_docs(gen)
        now = time.time()
        merged = merge_registry_snapshots(
            [d.get("snapshot") for d in docs.values()])
        result = {
            "generation": gen,
            "ts": now,
            "workers": {wid: {"ts": d.get("ts"), "pid": d.get("pid"),
                              "age_s": max(0.0, now - float(d.get("ts", now)))}
                        for wid, d in sorted(docs.items())},
            "evicted": evicted,
            "merged": merged,
            "per_worker": {wid: d.get("snapshot") or {}
                           for wid, d in sorted(docs.items())},
        }
        if self._slo is not None:
            try:
                events = self._slo.tick(now=now, snapshot=merged)
                result["slo"] = self._slo.status()
                if events:
                    result["slo"]["events"] = events
            except Exception as exc:  # judgement must not break federation
                result["slo"] = {"status": "error", "error": repr(exc)}
        with self._lock:
            self.last = result
            self._docs = docs
        self.collections += 1
        self.evictions += len(evicted)
        reg = _metrics.active_registry()
        if reg is not None:
            reg.counter("fleet.collections").inc()
            if evicted:
                reg.counter("fleet.evicted").inc(len(evicted))
            reg.gauge("fleet.workers").set(float(len(docs)))
            reg.histogram("fleet.collect_ms").observe(
                (time.perf_counter() - t0) * 1000.0)
            for w in result["workers"].values():
                reg.histogram("fleet.snapshot_age_ms").observe(
                    w["age_s"] * 1000.0)
        return result

    # ---- merged views ----
    def merged_chrome_trace(self) -> dict:
        """Every worker's span tail on one wall-clock-aligned chrome-trace
        timeline: one pid row per worker (process_name ``fleet:<wid>``),
        span ts shifted by each publisher's ``origin_unix`` so concurrent
        work lines up across processes."""
        with self._lock:
            docs = dict(self._docs)
        trace_events: List[dict] = []
        origins = [float(d.get("origin_unix", 0.0)) for d in docs.values()
                   if d.get("spans")]
        base = min(origins) if origins else 0.0
        emitted = 0
        for i, (wid, doc) in enumerate(sorted(docs.items())):
            pid = int(doc.get("pid") or (i + 1))
            trace_events.append({
                "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                "args": {"name": f"fleet:{wid}"},
            })
            shift = float(doc.get("origin_unix", base)) - base
            for ev in doc.get("spans") or []:
                if emitted >= self.span_limit:
                    break
                out = {"name": ev.get("name"), "pid": pid,
                       "tid": ev.get("tid", 0),
                       "ts": round((float(ev.get("ts", 0.0)) + shift) * 1e6,
                                   3)}
                dur = ev.get("dur")
                if dur is None:
                    out["ph"] = "i"
                    out["s"] = "t"
                else:
                    out["ph"] = "X"
                    out["dur"] = round(float(dur) * 1e6, 3)
                if ev.get("args"):
                    out["args"] = dict(ev["args"])
                trace_events.append(out)
                emitted += 1
        return {"traceEvents": trace_events, "displayTimeUnit": "ms"}

    def to_json(self) -> str:
        fleet = self.last if self.last is not None else self.collect()
        return json.dumps(fleet, sort_keys=True, default=str)

    def to_prometheus(self) -> str:
        return fleet_to_prometheus(
            self.last if self.last is not None else self.collect())


def fleet_to_prometheus(fleet: dict, namespace: str = "paddle_tpu_fleet"
                        ) -> str:
    """Prometheus text 0.0.4 for a collected fleet snapshot: merged
    counters/gauges/histograms (cumulative buckets + recomputed quantile
    gauges), plus per-worker-labeled quantiles and counts alongside."""
    san = _metrics._sanitize
    lines: List[str] = []
    ns = san(namespace)
    merged = fleet.get("merged") or {}

    def emit(name, kind, help_, series):
        lines.append(f"# HELP {name} {help_}")
        lines.append(f"# TYPE {name} {kind}")
        lines.extend(series)

    lines.append(f"# HELP {ns}_workers live publishers in the fleet")
    lines.append(f"# TYPE {ns}_workers gauge")
    lines.append(f"{ns}_workers {len(fleet.get('workers') or {})}")
    lines.append(f"{ns}_generation {fleet.get('generation', 0)}")
    for name, v in sorted((merged.get("counters") or {}).items()):
        full = f"{ns}_{san(name)}_total"
        emit(full, "counter", f"fleet-merged {name}",
             [f"{full} {_metrics._fmt_val(v)}"])
    for name, v in sorted((merged.get("gauges") or {}).items()):
        full = f"{ns}_{san(name)}"
        emit(full, "gauge", f"fleet-merged {name}",
             [f"{full} {_metrics._fmt_val(v)}"])
    per_worker = fleet.get("per_worker") or {}
    for name, snap in sorted((merged.get("histograms") or {}).items()):
        full = f"{ns}_{san(name)}"
        series, cum = [], 0
        for b, c in zip(snap["boundaries"], snap["counts"]):
            cum += c
            series.append(f'{full}_bucket{{le="{_metrics._fmt_le(b)}"}} {cum}')
        cum += snap["counts"][-1]
        series.append(f'{full}_bucket{{le="+Inf"}} {cum}')
        series.append(f"{full}_sum {_metrics._fmt_val(snap['sum'])}")
        series.append(f"{full}_count {snap['count']}")
        for q in ("p50", "p90", "p99"):
            if snap.get(q) is not None:
                series.append(f"{full}_{q} {_metrics._fmt_val(snap[q])}")
        # per-worker quantiles next to the merged series, label-scoped
        for wid, wsnap in sorted(per_worker.items()):
            h = (wsnap.get("histograms") or {}).get(name)
            if not h or not h.get("count"):
                continue
            series.append(f'{full}_count{{worker="{wid}"}} {h["count"]}')
            for q in ("p50", "p90", "p99"):
                if h.get(q) is not None:
                    series.append(
                        f'{full}_{q}{{worker="{wid}"}} '
                        f'{_metrics._fmt_val(h[q])}')
        emit(full, "histogram", f"fleet-merged {name}", series)
    return "\n".join(lines) + "\n"


# ---- process-global wiring (exporter routes, flight dumps) ------------------

_collector: Optional[FleetCollector] = None
_router_ref = None  # weakref.ref to the last-registered ReplicaRouter
_state_lock = threading.Lock()


def install_collector(collector: FleetCollector) -> FleetCollector:
    """Make a collector visible to the exporter's ``/fleet/metrics``
    routes and the flight recorder's crash-dump context."""
    global _collector
    with _state_lock:
        _collector = collector
    return collector


def uninstall_collector() -> None:
    global _collector
    with _state_lock:
        _collector = None


def active_collector() -> Optional[FleetCollector]:
    return _collector


def register_router(router) -> None:
    """Remember the live ReplicaRouter (weakly) so flight dumps can embed
    its recent placement decisions."""
    global _router_ref
    with _state_lock:
        _router_ref = weakref.ref(router)


def flight_context() -> Optional[dict]:
    """Fleet-level context for a crash dump: the last collected fleet
    snapshot (compact) + the router's placement tail. None when neither a
    collector nor a router is live — the dump stays per-process then."""
    out = {}
    c = _collector
    if c is not None and c.last is not None:
        last = c.last
        out["fleet"] = {
            "generation": last.get("generation"),
            "ts": last.get("ts"),
            "workers": last.get("workers"),
            "evicted": last.get("evicted"),
            "merged": compact_snapshot(last.get("merged") or {}),
        }
    ref = _router_ref
    router = ref() if ref is not None else None
    if router is not None:
        try:
            out["router_placements"] = router.recent_placements()
        except Exception:
            pass
    return out or None
