"""Replica router: queue-depth / occupancy / prefix-locality-aware
admission over K ServingEngine replicas (counterpart of
paddle_tpu/serving/router.py).

One engine replica saturates at slot_count concurrent decodes; the
"millions of users" tier is K replicas behind a router. Placement uses
the telemetry the engines already export plus the paged engines'
prefix trie (kv_pages/prefix_cache):

    score = w_queue * queue_depth / slots
          + w_occupancy * occupancy
          - w_prefix * (matched prefix tokens / prompt tokens)

Lowest score wins (ties break deterministically by replica name), so an
idle replica that already holds this prompt's prefix pages beats an
equally idle cold one — prefix locality is worth real TTFT (the replica
skips straight to decode on a full hit). The prefix probe is
``engine.prefix_match_len`` (a refcount-free trie peek; contiguous
replicas score 0).

Drain integration: a replica whose ``_draining`` flag is set —
by ``begin_drain()``, ``drain()``, or the SIGTERM handler — stops
receiving admissions immediately but keeps being stepped so its active
slots run to completion. ``submit()`` raises only when NO live replica
remains.

Metrics (route.*, metrics registry when active): ``route.requests``,
``route.prefix_routed`` counters, ``route.replicas_live`` gauge, and a
``route.queue_depth`` histogram of the chosen replica's depth at
admission. The sink (if any) gets one ``route`` record per placement.

Distributed tracing: when the tracer is enabled, each
placement records a ``route.place`` span carrying a minted span id and a
fleet request id, and hands the engine a ``fleet.TraceContext`` so every
engine-side span of that request (queue wait, prefill, decode, retire)
is tagged ``request_id=...`` with ``parent_span`` pointing back at the
placement — one chrome trace then renders routing decision + replica
execution as a single parented timeline. Dark path unchanged: tracer
off means no context allocation, no extra span args.

Host-side only — the router never touches device state. ``step()``
steps the replicas one after the other from one thread, so replicas that
share a GPU run on its one stream in turn and do not overlap there. The
router keeps no reference to a removed replica (``remove_replica``): its
weights and KV cache are freed when the caller drops the engine.
"""
from __future__ import annotations

import collections
import time
from typing import Dict, List, Optional, Sequence, Union

from ..observability import fleet as _obs_fleet
from ..observability import metrics as _obs_metrics
from ..observability import tracer as _obs_tracer
from .engine import Request, ServingEngine


class ReplicaRouter:
    """Front K in-process ServingEngine replicas with placement-aware
    admission and a shared drive loop.

    replicas: list (auto-named r0..rK-1) or dict name -> engine.
    """

    def __init__(self, replicas: Union[Sequence[ServingEngine],
                                       Dict[str, ServingEngine]],
                 sink=None, w_queue: float = 1.0, w_occupancy: float = 1.0,
                 w_prefix: float = 2.0):
        if not isinstance(replicas, dict):
            replicas = {f"r{i}": e for i, e in enumerate(replicas)}
        if not replicas:
            raise ValueError("ReplicaRouter needs at least one replica")
        self.replicas: Dict[str, ServingEngine] = dict(replicas)
        self.sink = sink
        self.w_queue = float(w_queue)
        self.w_occupancy = float(w_occupancy)
        self.w_prefix = float(w_prefix)
        self.routed: Dict[str, int] = {name: 0 for name in self.replicas}
        self.prefix_routed = 0
        # SLO self-healing (observability.slo): firing per-replica alerts
        # add a score penalty here so traffic flows away from the sick
        # replica; resolution removes it. See attach_slo().
        self._shed: Dict[str, float] = {}
        for name, eng in self.replicas.items():
            if eng.replica_name is None:
                eng.replica_name = name
        # bounded tail of placement decisions: flight dumps embed it via
        # fleet.flight_context() so a crash shows where traffic was going
        self._placements: collections.deque = collections.deque(maxlen=64)
        _obs_fleet.register_router(self)

    # ---------------------------------------------------------- placement
    def live_replicas(self) -> Dict[str, ServingEngine]:
        """Replicas currently accepting admissions (not draining)."""
        return {n: e for n, e in self.replicas.items() if not e._draining}

    def _score(self, name: str, eng: ServingEngine, prompt_ids) -> Dict:
        qd = eng.queue_depth()
        occ = eng.occupancy()
        plen = max(1, len(prompt_ids))
        matched = min(eng.prefix_match_len(prompt_ids), plen)
        frac = matched / plen
        return {
            "replica": name,
            "queue_depth": qd,
            "occupancy": round(occ, 4),
            "prefix_tokens": matched,
            "score": (self.w_queue * qd / eng.slot_count
                      + self.w_occupancy * occ
                      - self.w_prefix * frac
                      + self._shed.get(name, 0.0)),
        }

    def submit(self, prompt_ids, trace_ctx=None, _replaced=False,
               **kwargs) -> Request:
        """Place one request on the best live replica (see module doc for
        the score). Raises RuntimeError when every replica is draining.

        With the tracer enabled, the placement itself becomes a
        ``route.place`` span whose minted span id is the ``parent_span``
        of every engine-side span this request records; ``trace_ctx``
        lets a re-placement (begin_drain) keep the original request id.
        ``_replaced`` marks a begin_drain re-placement: the same logical
        request, already counted at first submission — it must not
        re-increment ``route.requests`` (the capacity controller's
        scale-in signal reads that counter; double counting would read as
        phantom load). It counts under ``route.replaced`` instead.
        """
        tr = _obs_tracer.get_tracer()
        t0 = time.perf_counter() if tr.enabled else None
        live = self.live_replicas()
        if not live:
            raise RuntimeError(
                "ReplicaRouter: all replicas are draining; no admission "
                "target remains")
        scored = [self._score(n, e, prompt_ids)
                  for n, e in sorted(live.items())]
        best = min(scored, key=lambda s: (s["score"], s["replica"]))
        name = best["replica"]
        ctx = trace_ctx
        if tr.enabled:
            if ctx is None:
                ctx = _obs_fleet.TraceContext()
            ctx.parent_span = _obs_tracer.new_span_id()
        req = live[name].submit(prompt_ids, trace_ctx=ctx, **kwargs)
        self.routed[name] += 1
        if best["prefix_tokens"] > 0:
            self.prefix_routed += 1
        if tr.enabled:
            # span_id (not parent_span): the placement IS the parent the
            # engine-side children point back at
            tr.record_complete("route.place", t0, time.perf_counter(), {
                "request": req.id, "request_id": ctx.request_id,
                "span_id": ctx.parent_span, "replica": name,
                "score": round(best["score"], 4),
                "prefix_tokens": best["prefix_tokens"],
            })
        self._placements.append({
            "ts": time.time(), "request": req.id, "replica": name,
            "score": round(best["score"], 4),
            "queue_depth": best["queue_depth"],
            "occupancy": best["occupancy"],
            "prefix_tokens": best["prefix_tokens"],
            **({"request_id": ctx.request_id} if ctx is not None else {}),
        })
        mreg = _obs_metrics.active_registry()
        if mreg is not None:
            if _replaced:
                mreg.counter("route.replaced").inc()
            else:
                mreg.counter("route.requests").inc()
            if best["prefix_tokens"] > 0:
                mreg.counter("route.prefix_routed").inc()
            mreg.gauge("route.replicas_live").set(len(live))
            mreg.histogram("route.queue_depth").observe(best["queue_depth"])
        if self.sink is not None:
            rec = {
                "event": "route", "ts": time.time(), "request_id": req.id,
                "replica": name, "score": round(best["score"], 4),
                "queue_depth": best["queue_depth"],
                "occupancy": best["occupancy"],
                "prefix_tokens": best["prefix_tokens"],
                "replicas_live": len(live),
                "candidates": len(scored),
            }
            if _replaced:
                rec["replaced"] = True
            if ctx is not None:
                rec["fleet_request_id"] = ctx.request_id
            self.sink.write(rec)
        return req

    def recent_placements(self) -> List[Dict]:
        """Bounded tail of placement decisions, oldest first (embedded in
        flight-recorder state.json via fleet.flight_context())."""
        return list(self._placements)

    # ------------------------------------------------------ SLO shedding
    def shed(self, name: str, penalty: float = 10.0) -> None:
        """Deprioritize one replica: add a flat score penalty so every
        other live replica wins placement while it recovers. Idempotent;
        the replica still serves (it is not draining) if every other
        replica is worse by more than the penalty."""
        if name not in self.replicas:
            raise KeyError(f"unknown replica {name!r}")
        self._shed[name] = float(penalty)
        mreg = _obs_metrics.active_registry()
        if mreg is not None:
            mreg.counter("route.sheds").inc()
            mreg.gauge("route.shedding").set(float(len(self._shed)))

    def unshed(self, name: str) -> None:
        if self._shed.pop(name, None) is not None:
            mreg = _obs_metrics.active_registry()
            if mreg is not None:
                mreg.gauge("route.shedding").set(float(len(self._shed)))

    def shedding(self) -> List[str]:
        return sorted(self._shed)

    def attach_slo(self, slo_engine, penalty: float = 10.0,
                   drain: bool = False) -> None:
        """Close the loop from per-replica SLOs to placement: register a
        hook on ``slo_engine`` (observability.slo.SloEngine) that sheds a
        replica while an alert labeled ``{"replica": <name>}`` is firing
        and unsheds it on resolve. With ``drain=True``, a *page*-severity
        fire also begins draining the replica (its queued work re-places
        on healthy replicas) — only while at least one other live replica
        remains, so healing never closes the last admission target."""
        def _hook(ev: Dict) -> None:
            name = (ev.get("labels") or {}).get("replica")
            if name is None or name not in self.replicas:
                return
            if ev.get("state") == "firing":
                self.shed(name, penalty)
                if (drain and ev.get("severity") == "page"
                        and not self.replicas[name]._draining
                        and len(self.live_replicas()) > 1):
                    self.begin_drain(name, reason="slo")
            elif ev.get("state") == "resolved":
                self.unshed(name)

        slo_engine.add_hook(_hook)

    # -------------------------------------------------------------- drive
    def step(self) -> int:
        """One engine step on every replica (draining ones included — their
        active slots must finish). Returns total live slots after."""
        return sum(e.step() for e in self.replicas.values())

    def pending(self) -> int:
        return sum(len(e._queue) + int(e._active.sum())
                   for e in self.replicas.values())

    def run(self, max_steps: Optional[int] = None) -> None:
        """Drive all replicas until queues and slots drain everywhere."""
        steps = 0
        while self.pending():
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                return

    # -------------------------------------------------------------- drain
    def begin_drain(self, name: str, reason: str = "drain") -> List[Request]:
        """Close admission on one replica. Its active slots keep decoding
        to completion under step()/run(), but queued-not-yet-admitted work
        would strand (a draining engine stops pulling its queue), so it is
        re-placed on the remaining live replicas. Returns the re-placed
        Request handles (the stranded originals never produce tokens).

        Counter audit (capacity controller reads these): the drained
        replica's ``routed`` credit for never-admitted requests moves with
        them, and the re-submission goes through the ``_replaced`` path —
        ``route.requests`` counts each logical request exactly once, and
        ``serve.replica.<name>.requests`` (finish-time) only ever counts
        the replica that actually served it."""
        eng = self.replicas[name]
        requeue = []
        with eng._lock:
            while eng._queue:
                requeue.append(eng._queue.popleft())
        self.routed[name] -= len(requeue)
        eng.begin_drain(reason)
        return [self.submit(req.prompt_ids, trace_ctx=req.trace_ctx,
                            _replaced=True,
                            max_new_tokens=req.max_new_tokens,
                            temperature=req.temperature, top_k=req.top_k,
                            top_p=req.top_p, eos_token_id=req.eos_token_id,
                            seed=req.seed, tenant=req.tenant)
                for req in requeue]

    def drained(self, name: str) -> bool:
        eng = self.replicas[name]
        return bool(eng._draining) and not eng._active.any()

    # ------------------------------------------------- elastic replica set
    def add_replica(self, name: str, engine: ServingEngine) -> None:
        """Grow the fleet in place (capacity controller scale-out): the new
        replica is eligible for placement on the very next submit()."""
        if name in self.replicas:
            raise ValueError(f"replica {name!r} already exists")
        if engine.replica_name is None:
            engine.replica_name = name
        self.replicas[name] = engine
        self.routed.setdefault(name, 0)
        mreg = _obs_metrics.active_registry()
        if mreg is not None:
            mreg.gauge("route.replicas_live").set(len(self.live_replicas()))

    def remove_replica(self, name: str) -> ServingEngine:
        """Retire a fully drained replica (capacity controller scale-in):
        refuses while it still holds queued or active work — drain first
        (begin_drain + step until drained()). Calls engine.retire() so a
        registered membership lease is released (graceful leave)."""
        eng = self.replicas[name]
        if not eng._draining or eng._active.any() or eng._queue:
            raise RuntimeError(
                f"replica {name!r} is not drained (draining="
                f"{eng._draining}, active={int(eng._active.sum())}, "
                f"queued={len(eng._queue)}); begin_drain and step first")
        del self.replicas[name]
        self.routed.pop(name, None)
        self._shed.pop(name, None)
        eng.retire()
        mreg = _obs_metrics.active_registry()
        if mreg is not None:
            mreg.gauge("route.replicas_live").set(len(self.live_replicas()))
        return eng

    def stats(self) -> Dict:
        return {
            "replicas": {n: {"draining": e._draining,
                             "queued": e.queue_depth(),
                             "active": int(e._active.sum()),
                             "routed": self.routed[n],
                             "completed": len(e._completed)}
                         for n, e in self.replicas.items()},
            "prefix_routed": self.prefix_routed,
            "total_routed": sum(self.routed.values()),
            "shedding": sorted(self._shed),
        }
