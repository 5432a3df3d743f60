"""Elastic membership: generation-scoped worker leases over the TCP/File store
(counterpart of paddle_tpu/distributed/membership.py).

The live-autoscaling half of distributed/elastic.py (which owns the disk
path). A fleet member runs a :class:`WorkerAgent` — register + heartbeat
lease under the current *generation*, announce leave/preemption on the way
out — and the single controller runs an :class:`ElasticCoordinator`
that polls membership at step boundaries and, when the live world changes,
pauses training, re-forms the engine at the new world size through
``engine.reform_mesh(new_hcg)``, and resumes. The port's TrainStepEngine
has no ``reform_mesh`` yet (a world of torch.distributed ranks changes by
relaunching them): against it a reformation fails like any other, with a
flight dump and the ``restore_latest`` fallback when a checkpoint dir is
configured. Serving replicas use only the lease half (``kind="replica"``).

Store schema (all keys under one generation namespace, GC'd when the world
moves on — a re-formed world never trips over a dead generation's keys):

    __elastic__/gen                      current generation number (str int)
    __elastic__/gen.ctr                  add()-counter backing the bumps
    __elastic__/gen<g>/member/<wid>      lease JSON {wid, deadline, ts}
    __elastic__/gen<g>/leave/<wid>       leave JSON {wid, reason, ts}
    __elastic__/gen<g>/replica/<rid>     serving-replica lease (same JSON)
    __barrier__/gen<g>/...               generation-scoped barrier keys

Wall-clock (``time.time()``) lease deadlines, not monotonic: leases are
compared across processes. Counters: ``elastic.reformations``,
``elastic.preemptions``, ``elastic.joins``/``leaves``,
``elastic.lease_expiries``, ``elastic.resumed_steps``,
``elastic.reform_failures`` (core.monitor always; mirrored into the
metrics registry when one is enabled, plus ``elastic.pause_ms`` /
``elastic.drain_ms`` histograms and ``elastic.generation`` /
``elastic.world_size`` gauges). A failed reformation (lease timeout
mid-reshard, generation moved underneath us) dumps an
``elastic_reform_<gen>`` flight-recorder ring — membership state + last-N
step records — instead of hanging.
"""
from __future__ import annotations

import collections
import json
import signal
import threading
import time
from typing import Callable, Dict, List, Optional

import torch.distributed as dist

from ..core import flags as _flags
from ..core import monitor as _monitor
from ..observability import flight_recorder as _obs_flight
from ..observability import metrics as _obs_metrics
from ..observability import tracer as _obs_tracer
from .mesh import HybridCommunicateGroup

GEN_KEY = "__elastic__/gen"
GEN_CTR = "__elastic__/gen.ctr"

REFORMATIONS = _monitor.stat("elastic.reformations")
REFORM_FAILURES = _monitor.stat("elastic.reform_failures")
PREEMPTIONS = _monitor.stat("elastic.preemptions")
JOINS = _monitor.stat("elastic.joins")
LEAVES = _monitor.stat("elastic.leaves")
LEASE_EXPIRIES = _monitor.stat("elastic.lease_expiries")
RESUMED_STEPS = _monitor.stat("elastic.resumed_steps")


def _reg_inc(name: str, n: float = 1.0) -> None:
    reg = _obs_metrics.active_registry()
    if reg is not None:
        reg.counter(name).inc(n)


def current_generation(store) -> int:
    """The fleet's generation number; 0 before any coordinator ran."""
    try:
        return int(store.get(GEN_KEY, wait=False))
    except KeyError:
        return 0


def bump_generation(store) -> int:
    """Atomically advance the generation. The add()-counter is the source
    of truth (two concurrent bumps can never mint the same number); the
    plain GEN_KEY mirror exists so readers never mix add() and get() on
    the same key (the C++ TCPStore stores add() values in binary)."""
    g = store.add(GEN_CTR, 1)
    store.set(GEN_KEY, str(g))
    return g


def member_key(generation: int, wid: str, kind: str = "member") -> str:
    return f"__elastic__/gen{int(generation)}/{kind}/{wid}"


def _live_reshard(engine, new_hcg) -> None:
    """Re-form ``engine`` on ``new_hcg`` in memory (the reference's
    elastic.live_reshard). Raises NotImplementedError for an engine without
    ``reform_mesh``: the coordinator then takes its failure path."""
    reform = getattr(engine, "reform_mesh", None)
    if reform is None:
        raise NotImplementedError(
            f"{type(engine).__name__} has no reform_mesh: the port re-forms "
            "a torch.distributed world by relaunching its ranks from a "
            "checkpoint")
    reform(new_hcg)


def _parse_member(raw: bytes) -> dict:
    try:
        return json.loads(raw.decode())
    except (ValueError, UnicodeDecodeError):
        return {}


class WorkerAgent:
    """One fleet member's view of the membership protocol.

    ``register()`` writes a lease under the current generation;
    ``heartbeat()`` refreshes it (and follows generation bumps — after a
    reformation the next beat re-registers under the new namespace).
    ``announce_leave()`` posts a leave record and revokes the lease so the
    coordinator sees a graceful departure instead of waiting out the
    lease. ``install_sigterm_handler()`` turns SIGTERM into exactly that
    announcement (reason ``"sigterm"`` → ``elastic.preemptions``).

    ``kind="replica"`` registers under the serving-replica namespace —
    same protocol, separate member set (ServingEngine uses this).
    """

    def __init__(self, store, worker_id: str,
                 lease_s: Optional[float] = None, kind: str = "member"):
        self.store = store
        self.worker_id = str(worker_id)
        self.lease_s = float(lease_s if lease_s is not None
                             else _flags.flag("elastic_lease_s"))
        self.kind = kind
        self._registered_gen: Optional[int] = None
        self._hb_stop = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None
        self._prev_sigterm = None
        self._lock = threading.Lock()

    # ---- lease lifecycle ----
    def generation(self) -> int:
        return current_generation(self.store)

    def _lease_record(self) -> bytes:
        now = time.time()
        return json.dumps({"wid": self.worker_id, "ts": now,
                           "deadline": now + self.lease_s}).encode()

    def register(self, generation: Optional[int] = None) -> int:
        g = self.generation() if generation is None else int(generation)
        with self._lock:
            self.store.set(member_key(g, self.worker_id, self.kind),
                           self._lease_record())
            fresh = self._registered_gen is None
            self._registered_gen = g
        if fresh:
            JOINS.increase()
            _reg_inc("elastic.joins")
        return g

    def heartbeat(self) -> int:
        """Refresh the lease; follows generation moves automatically."""
        return self.register()

    def start_heartbeat(self) -> None:
        if self._hb_thread is not None:
            return
        self._hb_stop.clear()
        interval = max(0.05, self.lease_s / 3.0)

        def _beat():
            while not self._hb_stop.wait(interval):
                try:
                    self.heartbeat()
                except Exception:
                    # a dead store ends the lease naturally; the
                    # coordinator treats the expiry as a departure
                    return

        self._hb_thread = threading.Thread(
            target=_beat, name=f"elastic-hb-{self.worker_id}", daemon=True)
        self._hb_thread.start()

    def stop_heartbeat(self) -> None:
        self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=2.0)
            self._hb_thread = None

    def announce_leave(self, reason: str = "leave") -> None:
        self.stop_heartbeat()
        with self._lock:
            # a reformation may have carried this lease into a newer
            # generation before our heartbeat followed it: revoke the
            # lease everywhere we might be registered, announce in the
            # newest namespace (where the coordinator looks next)
            gens = {g for g in (self._registered_gen, self.generation())
                    if g is not None}
            g = max(gens) if gens else 0
            now = time.time()
            self.store.set(
                member_key(g, self.worker_id, "leave"),
                json.dumps({"wid": self.worker_id, "reason": reason,
                            "ts": now}).encode())
            for gg in gens:
                self.store.delete_key(
                    member_key(gg, self.worker_id, self.kind))
            self._registered_gen = None
        LEAVES.increase()
        _reg_inc("elastic.leaves")
        if reason == "sigterm":
            PREEMPTIONS.increase()
            _reg_inc("elastic.preemptions")

    # ---- preemption ----
    def install_sigterm_handler(self) -> None:
        """SIGTERM → announce a preemption-leave, then chain the previous
        handler (so the process's own shutdown path still runs)."""
        def _on_sigterm(signum, frame):
            try:
                self.announce_leave("sigterm")
            finally:
                prev = self._prev_sigterm
                if callable(prev):
                    prev(signum, frame)

        self._prev_sigterm = signal.signal(signal.SIGTERM, _on_sigterm)


class ElasticCoordinator:
    """Single-controller membership poller + live mesh re-former.

    ``maybe_reform(engine)`` reads the live member set (expired leases are
    evicted and counted), asks ``topology_for(n_live)`` for the hcg the
    fleet should run at, and — when that differs from the engine's current
    topology — bumps the generation, carries the live leases into the new
    namespace, re-forms the engine in memory, validates the generation
    didn't move underneath the reshard, and GCs the dead generation's
    keys. Failures dump ``elastic_reform_<gen>`` to the flight recorder
    and fall back to ``restore_latest`` when a checkpoint dir is
    configured; without one the error propagates (hard crash).

    ``topology_for(n) -> Optional[HybridCommunicateGroup]``: defaults to a
    pure dp-n mesh over the first n local devices; return None to keep the
    current topology (e.g. n has no valid mesh factorization yet).
    """

    def __init__(self, store,
                 topology_for: Optional[Callable[[int], Optional[
                     HybridCommunicateGroup]]] = None,
                 lease_s: Optional[float] = None,
                 ckpt_dir: Optional[str] = None,
                 check_interval: Optional[int] = None):
        self.store = store
        self.topology_for = topology_for or self._default_topology
        self.lease_s = float(lease_s if lease_s is not None
                             else _flags.flag("elastic_lease_s"))
        self.ckpt_dir = ckpt_dir
        self.check_interval = max(1, int(
            check_interval if check_interval is not None
            else _flags.flag("elastic_check_interval")))
        self.last_pause_ms: Optional[float] = None
        self.reformations = 0
        self._fault_hook: Optional[Callable[[], None]] = None
        # bounded tail of SLO alert transitions (note_alert, typically
        # wired as slo_engine.add_hook(coordinator.note_alert)): a failed
        # reformation's flight dump then shows what the SLO layer was
        # screaming about when the world changed
        self._alert_tail: collections.deque = collections.deque(maxlen=16)

    def note_alert(self, event: dict) -> None:
        """SLO-engine hook target: remember recent alert transitions for
        reformation postmortems (observability.slo.SloEngine.add_hook)."""
        self._alert_tail.append(dict(event))

    def recent_alerts(self) -> List[dict]:
        return list(self._alert_tail)

    @staticmethod
    def _default_topology(n: int) -> Optional[HybridCommunicateGroup]:
        """A pure dp-n topology over the process group. The port's groups
        span the whole torch.distributed world, so only n equal to the
        world size has one; any other n keeps the current topology."""
        world = dist.get_world_size() if dist.is_initialized() else 1
        if n != world:
            return None
        return HybridCommunicateGroup(dp_degree=n)

    # ---- membership ----
    def generation(self) -> int:
        return current_generation(self.store)

    def live_members(self, generation: Optional[int] = None,
                     kind: str = "member") -> Dict[str, dict]:
        """Current holders of unexpired leases in a generation. Expired
        leases are evicted here (the poll IS the failure detector) and
        counted as ``elastic.lease_expiries`` + ``store.lease_expiries``."""
        from . import store as _store_mod

        g = self.generation() if generation is None else int(generation)
        now = time.time()
        out: Dict[str, dict] = {}
        prefix = f"__elastic__/gen{g}/{kind}/"
        for key in self.store.list_keys(prefix):
            try:
                rec = _parse_member(self.store.get(key, wait=False))
            except KeyError:
                continue
            wid = rec.get("wid") or key[len(prefix):]
            if float(rec.get("deadline", 0.0)) < now:
                self.store.delete_key(key)
                LEASE_EXPIRIES.increase()
                _store_mod.LEASE_EXPIRIES.increase()
                _reg_inc("elastic.lease_expiries")
                continue
            out[wid] = rec
        return out

    def _membership_snapshot(self, generation: int) -> dict:
        """Flight-dump payload: everything a postmortem needs to see why a
        reformation failed — who held leases, who announced leaving."""
        snap = {"generation": generation}
        for kind in ("member", "leave", "replica"):
            prefix = f"__elastic__/gen{generation}/{kind}/"
            recs = {}
            for key in self.store.list_keys(prefix):
                try:
                    recs[key[len(prefix):]] = _parse_member(
                        self.store.get(key, wait=False))
                except KeyError:
                    pass
            snap[kind + "s"] = recs
        if self._alert_tail:
            snap["slo_alerts"] = list(self._alert_tail)
        return snap

    # ---- reformation ----
    def maybe_reform(self, engine) -> bool:
        """Poll membership; re-form the engine's mesh when the live world
        size changed. Returns True when a reformation happened (the engine
        now runs at the new world size; committed steps are intact)."""
        old_gen = self.generation()
        members = self.live_members(old_gen)
        n_live = len(members)
        if n_live == 0:
            return False  # nothing registered yet — membership not in use
        new_hcg = self.topology_for(n_live)
        if new_hcg is None or new_hcg.topology() == engine.hcg.topology():
            return False

        t0 = time.perf_counter()
        tr = _obs_tracer.get_tracer()
        new_gen = bump_generation(self.store)
        if tr.enabled:
            # reformation lifecycle as first-class spans: bump (instant) ->
            # pause (whole stopped-world window) -> reshard (redistribution
            # only) -> commit (instant) — one per-generation fleet timeline
            tr.instant("elastic.generation_bump", generation=new_gen,
                       from_generation=old_gen, n_live=n_live)
        # carry live leases into the new namespace so the first
        # coordinator poll after the reshard doesn't see an empty world;
        # workers' own heartbeats take over the new keys at the next beat
        now = time.time()
        for wid, rec in members.items():
            self.store.set(
                member_key(new_gen, wid),
                json.dumps({"wid": wid, "ts": now,
                            "deadline": now + self.lease_s}).encode())
        try:
            if self._fault_hook is not None:
                self._fault_hook()
            t_rs = time.perf_counter()
            _live_reshard(engine, new_hcg)
            if tr.enabled:
                tr.record_complete(
                    "elastic.reshard", t_rs, time.perf_counter(),
                    {"generation": new_gen,
                     "to_topology": dict(new_hcg.degrees)})
            g_now = self.generation()
            if g_now != new_gen:
                raise RuntimeError(
                    f"generation moved mid-reshard ({new_gen} -> {g_now}); "
                    "membership changed under the reformation")
        except Exception as exc:
            REFORM_FAILURES.increase()
            _reg_inc("elastic.reform_failures")
            if tr.enabled:
                tr.instant("elastic.reform_failed", generation=new_gen,
                           error=f"{type(exc).__name__}: {exc}")
            fr = _obs_flight.get()
            if fr is not None:
                fr.dump(f"elastic_reform_{new_gen}", {
                    "error": f"{type(exc).__name__}: {exc}",
                    "from_topology": dict(engine.hcg.degrees),
                    "to_topology": dict(new_hcg.degrees),
                    "membership": self._membership_snapshot(old_gen),
                })
            if self.ckpt_dir:
                from .elastic import restore_latest

                restore_latest(engine, self.ckpt_dir)
                return False
            raise
        self.store.gc_generation(old_gen)

        t_end = time.perf_counter()
        self.last_pause_ms = (t_end - t0) * 1000.0
        if tr.enabled:
            tr.record_complete("elastic.pause", t0, t_end,
                               {"generation": new_gen,
                                "from_generation": old_gen,
                                "world_size": new_hcg.nranks})
            tr.instant("elastic.commit", generation=new_gen,
                       world_size=new_hcg.nranks,
                       pause_ms=round(self.last_pause_ms, 3))
        self.reformations += 1
        REFORMATIONS.increase()
        reg = _obs_metrics.active_registry()
        if reg is not None:
            reg.counter("elastic.reformations").inc()
            reg.histogram("elastic.pause_ms").observe(self.last_pause_ms)
            reg.gauge("elastic.generation").set(float(new_gen))
            reg.gauge("elastic.world_size").set(float(new_hcg.nranks))
        return True

    def on_step(self, engine, step: Optional[int] = None) -> bool:
        """Step-boundary hook for training loops: polls membership every
        ``check_interval`` steps; steps taken in a re-formed world count
        as ``elastic.resumed_steps``."""
        if self.reformations:
            RESUMED_STEPS.increase()
            _reg_inc("elastic.resumed_steps")
        s = engine._step_count if step is None else int(step)
        if s % self.check_interval:
            return False
        return self.maybe_reform(engine)
