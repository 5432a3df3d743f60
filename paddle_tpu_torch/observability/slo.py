"""Declarative SLOs: multi-window burn-rate alerting over the registry
(counterpart of paddle_tpu/observability/slo.py).

The judgement layer on top of the metrics, tracer and fleet planes: an
`SloSpec` declares a service-level indicator plus objective, a
`SnapshotRing` over `metrics.MetricRegistry.snapshot()` documents gives
exact sliding-window deltas (the subtraction dual of the fleet merge
math — `metrics.subtract_registry_snapshots`), and `SloEngine.tick()`
evaluates every spec with the standard SRE multi-window multi-burn-rate
recipe, driving an `AlertManager` state machine whose transitions feed
every consumer the plane already has:

- ``slo.<name>.burn_rate`` / ``.error_budget_remaining`` /
  ``.firing`` gauges back into the registry (scraped at /metrics),
- an ``alerts.jsonl`` sink (one line per pending/firing/resolved
  transition, which the reference's `tools/trace_summary.py` renders),
- rate-limited flight-recorder dumps on page-severity fires,
- exporter routes: ``GET /alerts`` (full alert/spec state) and the
  upgraded ``GET /healthz`` (503 + ``{"status": "degraded"}`` while a
  page-severity alert fires),
- self-healing hooks (`add_hook`): `serving.router.ReplicaRouter
  .attach_slo` sheds (and can drain) a replica whose per-replica SLO
  fires; `distributed.membership.ElasticCoordinator.note_alert` annotates
  reformation postmortems.

SLI forms:

- **ratio** (`ratio_slo`): bad-events / total-events counters over the
  window — e.g. ``serve.errors / serve.requests`` with objective 0.999.
  Names resolve against the snapshot's counters, then the absorbed
  ``monitor`` stats, then a histogram's ``count`` (so a rate like
  nonfinite-losses / train-steps mixes sources freely).
- **latency** (`latency_slo`): a histogram + threshold — e.g.
  ``serve.ttft_ms p99 < 50ms`` is objective 0.99 with threshold 50.0:
  at most 1% of window observations above 50ms. Good events are counted
  from the delta buckets at bucket granularity (the threshold
  effectively snaps down to its containing bucket's lower boundary).

Burn rate = (bad fraction over the window) / (1 - objective): 1.0 means
spending the error budget exactly at the rate that exhausts it at the
window's end. An alert condition requires the threshold exceeded in BOTH
a long window and its short companion (the short window gates on
*current* badness, so a long-ago burst doesn't page for hours after
recovery). `default_windows()` ships the classic fast 1h/5m page pair
(14.4x) and slow 3d/6h warn pair (1x), with a ``scale`` knob that
shrinks wall-clock for tests.

Dark by default, like everything in observability: `SloEngine.tick()`
returns immediately when `metrics.active_registry()` is None and no
explicit snapshot is passed — no ring growth, no gauges, no I/O.
"""
from __future__ import annotations

import bisect
import collections
import json
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from . import metrics as _metrics

_SEV_RANK = {"warn": 1, "page": 2}


class BurnWindow:
    """One (long, short) burn-rate window pair with its firing threshold."""

    __slots__ = ("long_s", "short_s", "factor", "severity")

    def __init__(self, long_s: float, short_s: float, factor: float,
                 severity: str = "page"):
        if severity not in _SEV_RANK:
            raise ValueError(f"severity must be warn|page, got {severity!r}")
        if not 0 < short_s <= long_s:
            raise ValueError("need 0 < short_s <= long_s")
        self.long_s = float(long_s)
        self.short_s = float(short_s)
        self.factor = float(factor)
        self.severity = severity

    def as_dict(self) -> dict:
        return {"long_s": self.long_s, "short_s": self.short_s,
                "factor": self.factor, "severity": self.severity}

    def __repr__(self):
        return (f"BurnWindow({self.long_s:g}s/{self.short_s:g}s "
                f"x{self.factor:g} {self.severity})")


def default_windows(scale: float = 1.0) -> Tuple[BurnWindow, ...]:
    """The SRE-workbook pairs: fast 1h/5m page at 14.4x budget burn
    (2% of a 30d budget in 1h) + slow 3d/6h warn at 1x. ``scale``
    multiplies every window (e.g. scale=1/3600 turns hours into
    seconds for tests) without changing the burn thresholds."""
    s = float(scale)
    return (BurnWindow(3600.0 * s, 300.0 * s, 14.4, "page"),
            BurnWindow(259200.0 * s, 21600.0 * s, 1.0, "warn"))


class SloSpec:
    """One declarative objective over registry-resident signals.

    Use the `ratio_slo` / `latency_slo` constructors rather than spelling
    the fields out. ``objective`` is the good-events target in (0, 1);
    the error budget is ``1 - objective``. ``labels`` tag the spec (the
    router's self-healing hook keys on ``labels["replica"]``).
    """

    def __init__(self, name: str, kind: str, objective: float,
                 windows: Optional[Sequence[BurnWindow]] = None,
                 bad: Optional[str] = None, total: Optional[str] = None,
                 metric: Optional[str] = None,
                 threshold: Optional[float] = None,
                 labels: Optional[Dict[str, str]] = None,
                 description: str = ""):
        if kind not in ("ratio", "latency"):
            raise ValueError(f"kind must be ratio|latency, got {kind!r}")
        if not 0.0 < objective < 1.0:
            raise ValueError(f"objective must be in (0, 1), got {objective}")
        if kind == "ratio" and (not bad or not total):
            raise ValueError("ratio SLO needs bad= and total= metric names")
        if kind == "latency" and (not metric or threshold is None):
            raise ValueError("latency SLO needs metric= and threshold=")
        self.name = str(name)
        self.kind = kind
        self.objective = float(objective)
        self.windows: Tuple[BurnWindow, ...] = tuple(
            windows if windows is not None else default_windows())
        if not self.windows:
            raise ValueError("SloSpec needs at least one BurnWindow")
        self.bad = bad
        self.total = total
        self.metric = metric
        self.threshold = None if threshold is None else float(threshold)
        self.labels = dict(labels or {})
        self.description = description

    @property
    def budget(self) -> float:
        return 1.0 - self.objective

    def as_dict(self) -> dict:
        out = {"name": self.name, "kind": self.kind,
               "objective": self.objective,
               "windows": [w.as_dict() for w in self.windows],
               "labels": dict(self.labels)}
        if self.kind == "ratio":
            out.update(bad=self.bad, total=self.total)
        else:
            out.update(metric=self.metric, threshold=self.threshold)
        return out

    def __repr__(self):
        sli = (f"{self.bad}/{self.total}" if self.kind == "ratio"
               else f"{self.metric}<={self.threshold:g}")
        return f"SloSpec({self.name}: {sli} @ {self.objective})"


def ratio_slo(name: str, bad: str, total: str, objective: float,
              windows: Optional[Sequence[BurnWindow]] = None,
              labels: Optional[Dict[str, str]] = None,
              description: str = "") -> SloSpec:
    """Counter-ratio SLI: ``bad/total`` events over the window must stay
    under ``1 - objective`` (e.g. serve.errors / serve.requests @ 0.999)."""
    return SloSpec(name, "ratio", objective, windows=windows, bad=bad,
                   total=total, labels=labels, description=description)


def latency_slo(name: str, metric: str, threshold: float, objective: float,
                windows: Optional[Sequence[BurnWindow]] = None,
                labels: Optional[Dict[str, str]] = None,
                description: str = "") -> SloSpec:
    """Histogram-percentile SLI: ``metric pXX <= threshold`` where
    XX = objective*100 (e.g. serve.ttft_ms p99 < 50ms is objective 0.99,
    threshold 50.0)."""
    return SloSpec(name, "latency", objective, windows=windows,
                   metric=metric, threshold=threshold, labels=labels,
                   description=description)


# ---- SLI event extraction ---------------------------------------------------

def _events(snap: dict, name: str) -> float:
    """Monotonic event count for ``name`` from a registry snapshot:
    counters first, then absorbed monitor stats, then histogram count."""
    v = snap.get("counters", {}).get(name)
    if v is not None:
        return float(v)
    rep = snap.get("monitor", {}).get(name)
    if rep is not None:
        return float(rep.get("value", 0.0))
    h = snap.get("histograms", {}).get(name)
    if h is not None:
        return float(h.get("count", 0))
    return 0.0


def _good_bad(spec: SloSpec, delta: dict) -> Tuple[float, float]:
    """(good, bad) event counts for a spec over one window-delta snapshot."""
    if spec.kind == "ratio":
        bad = _events(delta, spec.bad)
        total = _events(delta, spec.total)
        return max(0.0, total - bad), bad
    h = delta.get("histograms", {}).get(spec.metric)
    if h is None or not h.get("count"):
        return 0.0, 0.0
    boundaries = h["boundaries"]
    counts = h["counts"]
    # buckets whose upper bound <= threshold are wholly good; the bucket
    # straddling the threshold counts bad (conservative: the threshold
    # snaps down to bucket granularity, never hides a breach)
    k = bisect.bisect_right(boundaries, spec.threshold)
    good = float(sum(counts[:k]))
    return good, float(h["count"]) - good


def burn_rate(spec: SloSpec, delta: dict) -> float:
    """Error-budget burn rate over one window delta: bad-fraction divided
    by the budget. 0.0 with no traffic (an idle window spends nothing)."""
    good, bad = _good_bad(spec, delta)
    total = good + bad
    if total <= 0:
        return 0.0
    return (bad / total) / spec.budget


# ---- snapshot ring ----------------------------------------------------------

class SnapshotRing:
    """Timestamped registry snapshots; window deltas by exact subtraction.

    ``push()`` appends and trims entries older than the retention horizon
    (longest window + slack); ``delta(window_s)`` subtracts the newest
    snapshot taken at-or-before ``now - window_s`` from the latest (the
    oldest entry serves as baseline while history is still shorter than
    the window — the partial-window burn is computed over what exists,
    matching how a freshly-deployed alerting stack behaves)."""

    def __init__(self, retention_s: float, max_entries: int = 4096):
        self.retention_s = float(retention_s)
        self.max_entries = int(max_entries)
        self._entries: collections.deque = collections.deque()

    def __len__(self) -> int:
        return len(self._entries)

    def push(self, ts: float, snapshot: dict) -> None:
        self._entries.append((float(ts), snapshot))
        horizon = float(ts) - self.retention_s
        while len(self._entries) > 2 and (
                self._entries[0][0] < horizon
                or len(self._entries) > self.max_entries):
            self._entries.popleft()

    def latest(self) -> Optional[Tuple[float, dict]]:
        return self._entries[-1] if self._entries else None

    def at(self, ts: float) -> Optional[Tuple[float, dict]]:
        """Newest entry with timestamp <= ts (None before history)."""
        best = None
        for t, snap in self._entries:
            if t <= ts:
                best = (t, snap)
            else:
                break
        return best

    def delta(self, window_s: float, now: Optional[float] = None
              ) -> Optional[dict]:
        """Exact event delta over the trailing ``window_s`` (None when the
        ring is empty). The returned snapshot-shaped dict carries a
        ``_window_s`` key with the actual covered span."""
        if not self._entries:
            return None
        t1, curr = self._entries[-1]
        now = t1 if now is None else float(now)
        base = self.at(now - float(window_s))
        if base is None:
            base = self._entries[0]
        t0, prev = base
        if t0 >= t1:
            # baseline IS the latest snapshot: the window predates the
            # ring, so delta from empty (everything the registry has seen)
            prev = None
        d = _metrics.subtract_registry_snapshots(curr, prev)
        d["_window_s"] = (t1 - t0) if prev is not None else 0.0
        return d


# ---- evaluation -------------------------------------------------------------

def evaluate(spec: SloSpec, ring: SnapshotRing,
             now: Optional[float] = None) -> dict:
    """Multi-window multi-burn-rate evaluation of one spec.

    Each window pair fires when burn >= factor over BOTH its long and
    short windows; the result's severity is the highest firing pair's.
    ``burn`` reports the fast (shortest long-window) pair's long burn —
    the number an operator watches — and ``budget_remaining`` the
    fraction of error budget left over the longest window."""
    per = []
    firing_sev = 0
    for w in spec.windows:
        d_long = ring.delta(w.long_s, now)
        d_short = ring.delta(w.short_s, now)
        b_long = burn_rate(spec, d_long) if d_long else 0.0
        b_short = burn_rate(spec, d_short) if d_short else 0.0
        hit = b_long >= w.factor and b_short >= w.factor
        if hit:
            firing_sev = max(firing_sev, _SEV_RANK[w.severity])
        per.append({"window": w.as_dict(), "burn_long": b_long,
                    "burn_short": b_short, "firing": hit})
    fast = min(range(len(spec.windows)),
               key=lambda i: spec.windows[i].long_s)
    slow = max(range(len(spec.windows)),
               key=lambda i: spec.windows[i].long_s)
    d_slow = ring.delta(spec.windows[slow].long_s, now)
    if d_slow:
        good, bad = _good_bad(spec, d_slow)
        total = good + bad
        spent = (bad / total) / spec.budget if total > 0 else 0.0
    else:
        spent = 0.0
    sev = {v: k for k, v in _SEV_RANK.items()}.get(firing_sev)
    return {
        "slo": spec.name,
        "labels": dict(spec.labels),
        "burn": per[fast]["burn_long"],
        "budget_remaining": max(0.0, 1.0 - spent),
        "breach": firing_sev > 0,
        "severity": sev,
        "windows": per,
    }


# ---- alert state machine ----------------------------------------------------

class AlertManager:
    """pending -> firing -> resolved, deduped per SLO name.

    A breach opens a *pending* alert; one that persists ``for_s`` seconds
    transitions to *firing* (for_s=0: the same evaluation). While firing,
    repeated breaches only update the peak burn — no re-emission (dedup).
    A clean evaluation resolves a firing alert (emitting fire->resolve
    duration) and silently drops a pending one. Every transition becomes
    one event dict, handed to the engine's sinks and hooks; page-severity
    fires also dump the flight recorder, rate-limited per alert name
    (``dump_limit`` over the manager's lifetime, so a flapping SLO cannot
    fill the disk)."""

    def __init__(self, for_s: float = 0.0, dump_limit: int = 1):
        self.for_s = float(for_s)
        self.dump_limit = int(dump_limit)
        self.active: Dict[str, dict] = {}
        self.resolved_count = 0
        self._dumps: Dict[str, int] = {}

    def update(self, results: Sequence[dict],
               now: Optional[float] = None) -> List[dict]:
        now = time.time() if now is None else float(now)
        events: List[dict] = []
        for res in results:
            name = res["slo"]
            al = self.active.get(name)
            if res["breach"]:
                if al is None:
                    al = {"slo": name, "state": "pending", "since": now,
                          "severity": res["severity"],
                          "labels": res["labels"], "peak_burn": res["burn"]}
                    self.active[name] = al
                    events.append(self._event(al, now, res))
                al["peak_burn"] = max(al["peak_burn"], res["burn"])
                # escalation (warn pair firing, then page pair joins)
                # re-arms severity but not the state machine
                if _SEV_RANK.get(res["severity"], 0) > _SEV_RANK.get(
                        al["severity"], 0):
                    al["severity"] = res["severity"]
                if (al["state"] == "pending"
                        and now - al["since"] >= self.for_s):
                    al["state"] = "firing"
                    al["fired_at"] = now
                    events.append(self._event(al, now, res))
                    self._maybe_dump(al, res)
            elif al is not None:
                del self.active[name]
                if al["state"] == "firing":
                    al["state"] = "resolved"
                    self.resolved_count += 1
                    ev = self._event(al, now, res)
                    ev["duration_s"] = now - al["fired_at"]
                    events.append(ev)
                # pending that clears before for_s elapses: drop silently
        return events

    def firing(self, severity: Optional[str] = None) -> List[dict]:
        out = [dict(a) for a in self.active.values()
               if a["state"] == "firing"]
        if severity is not None:
            out = [a for a in out if a["severity"] == severity]
        return sorted(out, key=lambda a: a["slo"])

    def pending(self) -> List[dict]:
        return sorted((dict(a) for a in self.active.values()
                       if a["state"] == "pending"), key=lambda a: a["slo"])

    @staticmethod
    def _event(al: dict, now: float, res: dict) -> dict:
        return {"event": "alert", "ts": now, "slo": al["slo"],
                "state": al["state"], "severity": al["severity"],
                "labels": dict(al["labels"]), "burn": res["burn"],
                "peak_burn": al["peak_burn"],
                "budget_remaining": res["budget_remaining"]}

    def _maybe_dump(self, al: dict, res: dict) -> None:
        if al["severity"] != "page":
            return
        n = self._dumps.get(al["slo"], 0)
        if n >= self.dump_limit:
            return
        self._dumps[al["slo"]] = n + 1
        try:
            from . import flight_recorder as _flight
            fr = _flight.get()
            if fr is not None:
                fr.dump("slo_" + al["slo"],
                        {"alert": {k: v for k, v in al.items()},
                         "evaluation": res})
        except Exception:
            pass


# ---- default SLO packs ------------------------------------------------------

def default_serving_slos(windows: Optional[Sequence[BurnWindow]] = None,
                         replica: Optional[str] = None,
                         ttft_ms: float = 200.0, tpot_ms: float = 50.0,
                         queue_wait_ms: float = 500.0
                         ) -> List[SloSpec]:
    """The serving pack: availability (errors/requests @ 3 nines), TTFT
    and TPOT p99, queue-wait p95. With ``replica=<name>`` the specs read
    the engine's per-replica metric namespace and carry a replica label —
    the shape `ReplicaRouter.attach_slo` sheds on."""
    pfx = f"serve.replica.{replica}." if replica else "serve."
    suffix = f".{replica}" if replica else ""
    labels = {"replica": replica} if replica else None
    out = [
        ratio_slo(f"serve.availability{suffix}", pfx + "errors",
                  pfx + "requests", 0.999, windows=windows, labels=labels,
                  description="completed requests that did not error"),
        latency_slo(f"serve.ttft{suffix}", pfx + "ttft_ms", ttft_ms, 0.99,
                    windows=windows, labels=labels,
                    description=f"TTFT p99 <= {ttft_ms:g}ms"),
    ]
    if not replica:  # engine publishes tpot/queue-wait process-wide only
        out.append(latency_slo("serve.tpot", "serve.tpot_ms", tpot_ms, 0.99,
                               windows=windows,
                               description=f"TPOT p99 <= {tpot_ms:g}ms"))
        out.append(latency_slo("serve.queue_wait", "serve.queue_wait_ms",
                               queue_wait_ms, 0.95, windows=windows,
                               description="queue wait p95"))
    return out


def default_train_slos(windows: Optional[Sequence[BurnWindow]] = None,
                       step_ms: float = 5000.0) -> List[SloSpec]:
    """The training pack: step-time p99 and the nonfinite-loss rate
    (nan-loss steps / train steps, budget one per thousand)."""
    return [
        latency_slo("train.step_time", "train.step_ms", step_ms, 0.99,
                    windows=windows,
                    description=f"train step p99 <= {step_ms:g}ms"),
        ratio_slo("train.finite_loss", "engine.nan_loss_steps",
                  "train.step_ms", 0.999, windows=windows,
                  description="train steps with a finite loss"),
    ]


def default_slos(windows: Optional[Sequence[BurnWindow]] = None
                 ) -> List[SloSpec]:
    return default_serving_slos(windows) + default_train_slos(windows)


# ---- engine -----------------------------------------------------------------

class SloEngine:
    """Snapshot, evaluate, alert: one `tick()` runs the whole loop.

    Dark by default: with no active registry and no explicit snapshot,
    ``tick()`` is one None check — no ring growth, no gauges, no I/O.
    With one, each tick pushes a snapshot, evaluates every spec, writes
    ``slo.*`` gauges back (when a registry is active — fleet-offline
    evaluation over merged snapshots skips them), appends transition
    events to ``alerts_path`` / the sink, and calls the self-healing
    hooks. Thread-safe: exporter scrapes may tick concurrently with the
    owner's loop.
    """

    def __init__(self, specs: Optional[Sequence[SloSpec]] = None,
                 alerts_path: Optional[str] = None, sink=None,
                 for_s: float = 0.0, dump_limit: int = 1,
                 retention_slack: float = 1.25, max_entries: int = 4096):
        self.specs: List[SloSpec] = list(
            specs if specs is not None else default_slos())
        if not self.specs:
            raise ValueError("SloEngine needs at least one SloSpec")
        horizon = max(w.long_s for s in self.specs for w in s.windows)
        self.ring = SnapshotRing(horizon * float(retention_slack),
                                 max_entries=max_entries)
        self.alerts = AlertManager(for_s=for_s, dump_limit=dump_limit)
        self.alerts_path = alerts_path
        self.sink = sink
        self.ticks = 0
        self.events_emitted = 0
        self.last_results: List[dict] = []
        self._hooks: List[Callable[[dict], None]] = []
        self._lock = threading.Lock()

    # -- wiring
    def add_spec(self, spec: SloSpec) -> None:
        with self._lock:
            self.specs.append(spec)
            horizon = max(w.long_s for w in spec.windows)
            self.ring.retention_s = max(self.ring.retention_s,
                                        horizon * 1.25)

    def add_hook(self, fn: Callable[[dict], None]) -> None:
        """Register a transition callback (one event dict per call) — the
        self-healing attachment point (router shed, coordinator note)."""
        self._hooks.append(fn)

    # -- the loop
    def tick(self, now: Optional[float] = None,
             snapshot: Optional[dict] = None) -> List[dict]:
        """One evaluation pass; returns the transition events it caused.

        ``snapshot`` overrides the registry read — the fleet collector
        passes its merged snapshot so one process judges the whole fleet
        (and that works with no local registry at all)."""
        if snapshot is None:
            reg = _metrics.active_registry()
            if reg is None:
                return []  # dark: zero cost, zero side effects
            snapshot = reg.snapshot(include_monitor=True)
        now = time.time() if now is None else float(now)
        with self._lock:
            self.ring.push(now, snapshot)
            results = [evaluate(spec, self.ring, now) for spec in self.specs]
            self.last_results = results
            events = self.alerts.update(results, now)
            self.ticks += 1
            self.events_emitted += len(events)
        self._publish_gauges(results)
        for ev in events:
            self._emit(ev)
        return events

    def _publish_gauges(self, results: Sequence[dict]) -> None:
        reg = _metrics.active_registry()
        if reg is None:
            return
        for res in results:
            base = "slo." + res["slo"]
            reg.gauge(base + ".burn_rate").set(res["burn"])
            reg.gauge(base + ".error_budget_remaining").set(
                res["budget_remaining"])
            reg.gauge(base + ".firing").set(
                float(_SEV_RANK.get(res["severity"], 0)
                      if res["breach"] else 0))

    def _emit(self, ev: dict) -> None:
        if self.alerts_path:
            try:
                with open(self.alerts_path, "a") as f:
                    f.write(json.dumps(ev, sort_keys=True) + "\n")
            except OSError:
                pass
        if self.sink is not None:
            self.sink.write(ev)
        for fn in self._hooks:
            try:
                fn(ev)
            except Exception:
                pass  # a broken hook must not take down evaluation

    # -- views
    def firing(self, severity: Optional[str] = None) -> List[dict]:
        with self._lock:
            return self.alerts.firing(severity)

    def status(self) -> dict:
        """The /healthz + /alerts document: degraded iff a page-severity
        alert is firing."""
        with self._lock:
            firing = self.alerts.firing()
            pending = self.alerts.pending()
        degraded = any(a["severity"] == "page" for a in firing)
        return {
            "status": "degraded" if degraded else "ok",
            "firing": [{"slo": a["slo"], "severity": a["severity"],
                        "since": a.get("fired_at", a["since"]),
                        "peak_burn": a["peak_burn"],
                        "labels": a["labels"]} for a in firing],
            "pending": [a["slo"] for a in pending],
            "ticks": self.ticks,
        }

    def poll(self) -> dict:
        """tick-then-status: what a scrape-driven consumer (/healthz,
        /alerts) calls so HTTP polling IS the evaluation loop when no
        owner loop ticks — same idiom as /fleet/* collect-on-scrape."""
        self.tick()
        return self.status()

    def doc(self) -> dict:
        """Full /alerts body: status + per-spec evaluation + specs."""
        out = self.status()
        with self._lock:
            out["results"] = [dict(r) for r in self.last_results]
        out["specs"] = [s.as_dict() for s in self.specs]
        return out


# ---- process-global engine (off until installed) ----------------------------

_engine: Optional[SloEngine] = None
_glock = threading.Lock()


def install_engine(engine: Optional[SloEngine] = None, **kw) -> SloEngine:
    """Install (or build+install) the process-global SLO engine — the
    exporter's /alerts and upgraded /healthz serve it once present."""
    global _engine
    with _glock:
        _engine = engine if engine is not None else SloEngine(**kw)
        return _engine


def uninstall_engine() -> None:
    global _engine
    with _glock:
        _engine = None


def active_engine() -> Optional[SloEngine]:
    """The installed engine, else None (exporter's healthz gate: old
    plain-200 contract is preserved while this is None)."""
    return _engine
