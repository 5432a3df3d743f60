"""Closed-loop capacity controller: SLO burn + load signals -> replica count
(counterpart of paddle_tpu/observability/capacity.py).

The last arc of the observe/act loop: slo.py's burn-rate alerts *observe*,
the membership/router drain machinery *acts*, and this module decides.
``CapacityController.poll()`` reads the current signal set — firing SLO
alerts (local engine or the fleet-merged one a FleetCollector evaluates),
mean slot occupancy, queued-requests-per-slot — computes a target replica
count, and drives the difference through the ReplicaRouter:

- **scale out** when a page/warn alert is firing, or occupancy / queue
  depth stay above the high-water marks for ``high_sustain_s``
  (target = ceil(current * scale_out_factor), clamped to max_replicas);
- **scale in** when nothing is firing, every SLO retains at least
  ``budget_min`` of its error budget, and the fleet sits idle
  (occupancy/queue below the low-water marks) for ``idle_sustain_s``
  (target = floor(current / scale_in_factor), clamped to min_replicas);
- **hysteresis / flap damping**: distinct high/low water marks, sustain
  windows on both directions, and a ``cooldown_s`` dead time after every
  action — a spike that resolves mid-cooldown cannot bounce the fleet.

Scale-out spawns replicas via the injected ``spawn(name) -> engine``
factory (only the application knows how to build one), adds them to the
router, and registers a membership lease when a store is attached.
Scale-in uses the router's drain protocol — ``begin_drain`` re-places
queued work on survivors, later polls reap fully drained replicas via
``remove_replica`` (which releases the lease) — so no request is ever
lost to a scaling decision.

Every decision is first-class evidence: a ``capacity.decide`` span (with
``capacity.scale_out`` / ``capacity.scale_in`` children pointing back at
it) when the tracer is on, and one ``capacity.jsonl`` record carrying the
full input-signal snapshot that justified it, rendered as a scaling
timeline by the reference's tools/trace_summary.py and served live at the exporter's
``/capacity`` route.

Dark by default: nothing is installed at import, ``poll()`` only runs
when called (or via ``start()``'s daemon loop), and with no registry /
tracer / jsonl path a poll touches none of them. This module never
imports serving or distributed — the router, spawn factory, and
store are injected and duck-typed (observability stays import-light).
"""
from __future__ import annotations

import collections
import json
import math
import threading
import time
from typing import Callable, Dict, List, Optional

from . import metrics as _metrics
from . import tracer as _tracer


class CapacityPolicy:
    """Scaling policy knobs (see module doc for the decision rules)."""

    def __init__(self, min_replicas: int = 1, max_replicas: int = 8,
                 occupancy_high: float = 0.85, occupancy_low: float = 0.15,
                 queue_high: float = 2.0, queue_low: float = 0.25,
                 high_sustain_s: float = 0.0, idle_sustain_s: float = 2.0,
                 cooldown_s: float = 5.0, budget_min: float = 0.25,
                 scale_out_factor: float = 2.0,
                 scale_in_factor: float = 2.0):
        if min_replicas < 1 or max_replicas < min_replicas:
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas, got "
                f"[{min_replicas}, {max_replicas}]")
        if scale_out_factor <= 1.0 or scale_in_factor <= 1.0:
            raise ValueError("scale factors must be > 1.0")
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.occupancy_high = float(occupancy_high)
        self.occupancy_low = float(occupancy_low)
        self.queue_high = float(queue_high)    # queued requests per slot
        self.queue_low = float(queue_low)
        self.high_sustain_s = float(high_sustain_s)
        self.idle_sustain_s = float(idle_sustain_s)
        self.cooldown_s = float(cooldown_s)
        self.budget_min = float(budget_min)    # min error budget to shrink
        self.scale_out_factor = float(scale_out_factor)
        self.scale_in_factor = float(scale_in_factor)

    def as_dict(self) -> dict:
        return {k: getattr(self, k) for k in (
            "min_replicas", "max_replicas", "occupancy_high",
            "occupancy_low", "queue_high", "queue_low", "high_sustain_s",
            "idle_sustain_s", "cooldown_s", "budget_min",
            "scale_out_factor", "scale_in_factor")}


class CapacityController:
    """Poll signals, decide a target replica count, drive the router.

    router: a serving.ReplicaRouter (duck-typed: live_replicas /
    add_replica / begin_drain / drained / remove_replica / replicas).
    spawn(name) -> ServingEngine builds a new replica (the application
    owns model/engine construction). slo_engine: the SloEngine whose
    firing alerts / error budgets gate scaling — pass the same engine a
    FleetCollector.attach_slo holds and the judgement is fleet-merged.
    collector: optional FleetCollector; when set, each poll runs a
    collect() first so the SLO state reflects the whole fleet, not just
    this process. store/lease_s: membership wiring for spawned replicas
    (engine.register_replica) — None skips it (single-process drills).
    jsonl_path: capacity.jsonl decision log. clock: injectable time
    source for tests.
    """

    def __init__(self, router, spawn: Callable[[str], object],
                 policy: Optional[CapacityPolicy] = None, slo_engine=None,
                 collector=None, store=None, lease_s: Optional[float] = None,
                 jsonl_path: Optional[str] = None, name_prefix: str = "r",
                 log_holds: bool = True,
                 clock: Callable[[], float] = time.monotonic):
        self.router = router
        self.spawn = spawn
        self.policy = policy or CapacityPolicy()
        self.slo_engine = slo_engine
        self.collector = collector
        self.store = store
        self.lease_s = lease_s
        self.jsonl_path = jsonl_path
        self.name_prefix = str(name_prefix)
        self.log_holds = bool(log_holds)
        self.clock = clock
        self.polls = 0
        self.scale_outs = 0
        self.scale_ins = 0
        self.last_decision: Optional[dict] = None
        self.decisions: collections.deque = collections.deque(maxlen=256)
        self._retiring: Dict[str, float] = {}     # name -> drain start
        self._last_action_ts: Optional[float] = None
        self._high_since: Optional[float] = None
        self._idle_since: Optional[float] = None
        self._next_index = self._seed_index()
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def _seed_index(self) -> int:
        idx = 0
        for name in self.router.replicas:
            tail = name[len(self.name_prefix):] \
                if name.startswith(self.name_prefix) else ""
            if tail.isdigit():
                idx = max(idx, int(tail) + 1)
        return max(idx, len(self.router.replicas))

    # -------------------------------------------------------------- signals
    def _signals(self) -> dict:
        live = self.router.live_replicas()
        occ = [e.occupancy() for e in live.values()]
        queued = sum(e.queue_depth() for e in live.values())
        slots = sum(e.slot_count for e in live.values())
        firing: List[dict] = []
        budget_remaining = 1.0
        if self.collector is not None:
            # a poll is a federation pass: the merged snapshot feeds the
            # attached SLO engine, so `firing` below is fleet-level truth
            self.collector.collect()
        if self.slo_engine is not None:
            firing = [{"slo": a["slo"], "severity": a["severity"],
                       "labels": a.get("labels") or {}}
                      for a in self.slo_engine.firing()]
            results = self.slo_engine.last_results
            if results:
                budget_remaining = min(r["budget_remaining"]
                                       for r in results)
        return {
            "replicas": len(live),
            "retiring": sorted(self._retiring),
            "occupancy": round(sum(occ) / len(occ), 4) if occ else 0.0,
            "queued": queued,
            "queue_per_slot": round(queued / slots, 4) if slots else 0.0,
            "firing": firing,
            "budget_remaining": round(budget_remaining, 4),
        }

    # ------------------------------------------------------------- the loop
    def poll(self, now: Optional[float] = None) -> dict:
        """One decide(+act) pass; returns the decision record. Thread-safe
        against concurrent /capacity scrapes (doc() takes the same lock)."""
        with self._lock:
            return self._poll_locked(now)

    def _poll_locked(self, now: Optional[float]) -> dict:
        now = self.clock() if now is None else float(now)
        tr = _tracer.get_tracer()
        t0 = time.perf_counter() if tr.enabled else None
        self._reap()
        sig = self._signals()
        pol = self.policy
        cur = sig["replicas"]
        action, reason, target = "hold", "steady", cur

        hot = (sig["occupancy"] >= pol.occupancy_high
               or sig["queue_per_slot"] >= pol.queue_high)
        idle = (sig["occupancy"] <= pol.occupancy_low
                and sig["queue_per_slot"] <= pol.queue_low)
        # explicit None checks: a sustain clock started at t=0.0 is falsy
        if hot:
            self._high_since = now if self._high_since is None \
                else self._high_since
        else:
            self._high_since = None
        if idle:
            self._idle_since = now if self._idle_since is None \
                else self._idle_since
        else:
            self._idle_since = None
        in_cooldown = (self._last_action_ts is not None
                       and now - self._last_action_ts < pol.cooldown_s)

        want_out = bool(sig["firing"]) or (
            hot and now - self._high_since >= pol.high_sustain_s)
        want_in = (not sig["firing"] and not self._retiring
                   and sig["budget_remaining"] >= pol.budget_min
                   and idle
                   and now - self._idle_since >= pol.idle_sustain_s)

        if want_out and cur < pol.max_replicas and not in_cooldown:
            target = min(pol.max_replicas,
                         max(cur + 1,
                             math.ceil(cur * pol.scale_out_factor)))
            action = "scale_out"
            reason = ("slo_burn" if sig["firing"] else
                      "occupancy" if sig["occupancy"] >= pol.occupancy_high
                      else "queue_depth")
        elif want_in and cur > pol.min_replicas and not in_cooldown:
            target = max(pol.min_replicas,
                         min(cur - 1,
                             math.floor(cur / pol.scale_in_factor)))
            action = "scale_in"
            reason = "idle_budget"
        elif (want_out or want_in) and in_cooldown:
            reason = "cooldown"

        span_id = _tracer.new_span_id() if tr.enabled else None
        if action == "scale_out":
            added = self._scale_out(target - cur, span_id)
            self.scale_outs += 1
            self._last_action_ts = now
            self._high_since = None
        elif action == "scale_in":
            drained = self._scale_in(cur - target, now, span_id)
            self.scale_ins += 1
            self._last_action_ts = now
            self._idle_since = None
        rec = {
            "event": "capacity", "ts": time.time(), "action": action,
            "reason": reason, "replicas": cur, "target": target,
            "signals": sig,
        }
        if action == "scale_out":
            rec["added"] = added
        elif action == "scale_in":
            rec["draining"] = drained
        self.polls += 1
        self.last_decision = rec
        self.decisions.append(rec)
        if tr.enabled:
            tr.record_complete("capacity.decide", t0, time.perf_counter(), {
                "span_id": span_id, "action": action, "reason": reason,
                "replicas": cur, "target": target,
                "occupancy": sig["occupancy"],
                "queue_per_slot": sig["queue_per_slot"],
                "firing": len(sig["firing"]),
            })
        mreg = _metrics.active_registry()
        if mreg is not None:
            mreg.gauge("capacity.replicas").set(float(cur))
            mreg.gauge("capacity.target_replicas").set(float(target))
            mreg.gauge("capacity.retiring").set(float(len(self._retiring)))
            if action == "scale_out":
                mreg.counter("capacity.scale_outs").inc()
            elif action == "scale_in":
                mreg.counter("capacity.scale_ins").inc()
        if self.jsonl_path and (action != "hold" or self.log_holds):
            try:
                with open(self.jsonl_path, "a") as f:
                    f.write(json.dumps(rec, sort_keys=True) + "\n")
            except OSError:
                pass
        return rec

    # -------------------------------------------------------------- actions
    def _scale_out(self, n: int, parent_span: Optional[int]) -> List[str]:
        tr = _tracer.get_tracer()
        added = []
        for _ in range(n):
            name = f"{self.name_prefix}{self._next_index}"
            self._next_index += 1
            t0 = time.perf_counter() if tr.enabled else None
            eng = self.spawn(name)
            self.router.add_replica(name, eng)
            if self.store is not None:
                eng.register_replica(self.store, name, lease_s=self.lease_s)
            if tr.enabled:
                tr.record_complete(
                    "capacity.scale_out", t0, time.perf_counter(),
                    {"replica": name, "parent_span": parent_span})
            added.append(name)
        return added

    def _scale_in(self, n: int, now: float,
                  parent_span: Optional[int]) -> List[str]:
        # retire the most-recently-added live replicas first (reverse
        # add order): the original fleet keeps its warm caches
        tr = _tracer.get_tracer()
        live = [name for name, e in self.router.live_replicas().items()]
        victims = list(reversed(live))[:n]
        for name in victims:
            t0 = time.perf_counter() if tr.enabled else None
            replaced = self.router.begin_drain(name, reason="capacity")
            self._retiring[name] = now
            if tr.enabled:
                tr.record_complete(
                    "capacity.scale_in", t0, time.perf_counter(),
                    {"replica": name, "replaced": len(replaced),
                     "parent_span": parent_span})
        return victims

    def _reap(self) -> None:
        """Remove retiring replicas whose drain has completed (their
        active slots finished under the shared drive loop)."""
        for name in [n for n in self._retiring
                     if n in self.router.replicas
                     and self.router.drained(n)]:
            self.router.remove_replica(name)
            del self._retiring[name]
        # a retiring name no longer in the router was removed externally
        for name in [n for n in self._retiring
                     if n not in self.router.replicas]:
            del self._retiring[name]

    # ----------------------------------------------------- background loop
    def start(self, interval_s: float = 1.0) -> "CapacityController":
        """Poll on a daemon thread every interval_s (production mode; the
        drills call poll() inline from their drive loops)."""
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop():
            while not self._stop.wait(interval_s):
                try:
                    self.poll()
                except Exception:
                    pass  # a signal-read hiccup must not kill the loop

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="paddle-tpu-capacity")
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=5)
            self._thread = None

    # ---------------------------------------------------------------- views
    def doc(self) -> dict:
        """The /capacity document: policy, live state, decision tail."""
        with self._lock:
            return {
                "policy": self.policy.as_dict(),
                "replicas": sorted(self.router.replicas),
                "live": sorted(self.router.live_replicas()),
                "retiring": sorted(self._retiring),
                "polls": self.polls,
                "scale_outs": self.scale_outs,
                "scale_ins": self.scale_ins,
                "last": self.last_decision,
                "decisions": list(self.decisions)[-32:],
            }


# ---- process-global controller (dark until installed) -----------------------

_controller: Optional[CapacityController] = None
_glock = threading.Lock()


def install_controller(controller: CapacityController) -> CapacityController:
    """Install the process-global controller — the exporter's /capacity
    route serves it once present."""
    global _controller
    with _glock:
        _controller = controller
        return _controller


def uninstall_controller() -> None:
    global _controller
    with _glock:
        if _controller is not None:
            _controller.stop()
        _controller = None


def active_controller() -> Optional[CapacityController]:
    """The installed controller, else None (the exporter's /capacity gate)."""
    return _controller
