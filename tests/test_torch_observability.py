"""The port's fleet observability and membership modules against the JAX
package's: metrics, tracer, fleet federation, SLO burn rates and alerts, the
capacity controller, loadgen schedules, the stores and the membership
protocol.

Every check runs one script against each package's modules (the same
inputs, an injected clock where time enters) and compares the two logs.
Everything compared is exact: the modules are host-side Python with the
same float arithmetic in both packages, so no tolerance is stated. Wall-
clock fields (``ts``, ``age_s``, ``time_unix``) and process-local ids are
left out of the comparison, and named where they are.
"""
import collections
import json
import os
import signal
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

import paddle_tpu.distributed.membership as jax_membership
import paddle_tpu.distributed.store as jax_store
import paddle_tpu.observability.capacity as jax_capacity
import paddle_tpu.observability.exporter as jax_exporter
import paddle_tpu.observability.fleet as jax_fleet
import paddle_tpu.observability.flight_recorder as jax_flight
import paddle_tpu.observability.metrics as jax_metrics
import paddle_tpu.observability.slo as jax_slo
import paddle_tpu.observability.tracer as jax_tracer
import paddle_tpu.serving.loadgen as jax_loadgen
import paddle_tpu.serving.router as jax_router
from paddle_tpu.core import monitor as jax_monitor
from paddle_tpu_torch.core import flags, monitor
from paddle_tpu_torch.distributed import membership, store
from paddle_tpu_torch.observability import (capacity, exporter, fleet,
                                            flight_recorder, metrics, slo,
                                            step_telemetry, tracer)
from paddle_tpu_torch.serving import loadgen, router

JAX = types.SimpleNamespace(
    metrics=jax_metrics, tracer=jax_tracer, fleet=jax_fleet, slo=jax_slo,
    capacity=jax_capacity, exporter=jax_exporter, flight=jax_flight,
    loadgen=jax_loadgen, router=jax_router, store=jax_store,
    membership=jax_membership, monitor=jax_monitor)
PORT = types.SimpleNamespace(
    metrics=metrics, tracer=tracer, fleet=fleet, slo=slo, capacity=capacity,
    exporter=exporter, flight=flight_recorder, loadgen=loadgen, router=router,
    store=store, membership=membership, monitor=monitor)
PKGS = (JAX, PORT)


def _reset():
    for p in PKGS:
        p.capacity.uninstall_controller()
        p.exporter.stop_exporter()
        p.metrics.reset()
        p.slo.uninstall_engine()
        p.flight.disable()
        p.fleet.uninstall_collector()
        tr = p.tracer.get_tracer()
        tr.disable()
        tr.clear()
        tr.clear_stats()


@pytest.fixture(autouse=True)
def _clean_observability():
    """Registries, tracers, exporters and recorders are process globals of
    each package: start dark, leave dark."""
    _reset()
    yield
    _reset()


def _both(script, *args, **kw):
    """Run script(pkg, ...) on the JAX package, then on the port."""
    return [script(p, *args, **kw) for p in PKGS]


def _strip(obj, keys=("ts", "age_s", "time_unix", "pid", "origin_unix",
                      "deadline")):
    """obj without wall-clock and process fields, at any depth."""
    if isinstance(obj, dict):
        return {k: _strip(v, keys) for k, v in obj.items() if k not in keys}
    if isinstance(obj, (list, tuple)):
        return [_strip(v, keys) for v in obj]
    return obj


# ------------------------------------------------------------------ metrics
def _observations(seed):
    rng = np.random.RandomState(seed)
    return [float(v) for v in np.exp(rng.randn(400)) * 10.0]


def _fixed_monitor():
    return {"serving.requests": {"value": 7, "peak": 7},
            "grad_comm.bytes": {"value": 1024, "peak": 2048}}


def _registry_script(p, seed):
    reg = p.metrics.MetricRegistry()
    h = reg.histogram("serve.ttft_ms")
    for v in _observations(seed):
        h.observe(v)
    reg.histogram("occ", boundaries=tuple(round(0.1 * i, 1)
                                          for i in range(1, 11))).observe(0.35)
    reg.counter("serve.requests").inc(400)
    reg.counter("route.requests").inc(3)
    reg.gauge("serve.queue_depth").set(5)
    reg.gauge("serve.queue_depth").dec(2)
    snap = reg.snapshot(include_monitor=False)
    pct = {q: h.percentile(q) for q in (0.0, 0.5, 0.9, 0.99, 1.0)}
    est = {q: p.metrics.estimate_percentile(h.snapshot(), q)
           for q in (0.25, 0.75)}
    compact = reg.snapshot(include_monitor=False, compact=True)
    return snap, pct, est, compact, reg.to_json(compact=True)


def _pin_monitor(monkeypatch):
    """Each package absorbs its own core.monitor: pin both to one report so
    what they render is compared on the same input."""
    for p in PKGS:
        monkeypatch.setattr(p.metrics.MetricRegistry, "_monitor_report",
                            staticmethod(_fixed_monitor))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_snapshots_and_percentiles_equal(seed, monkeypatch):
    _pin_monitor(monkeypatch)
    jax_out, port_out = _both(_registry_script, seed)
    assert port_out == jax_out


@pytest.mark.parametrize("seed", [0, 3])
def test_prometheus_text_equal(seed, monkeypatch):
    _pin_monitor(monkeypatch)

    def script(p):
        reg = p.metrics.MetricRegistry()
        for v in _observations(seed):
            reg.histogram("serve.tpot_ms").observe(v)
        reg.counter("route.requests").inc(48)
        reg.gauge("route.replicas_live").set(2)
        return reg.to_prometheus()

    jax_text, port_text = _both(script)
    assert port_text == jax_text
    assert "paddle_tpu_route_requests_total 48" in port_text.splitlines()


def test_snapshot_absorbs_the_port_monitor():
    monitor.stat("test_torch_observability.probe").increase(3)
    snap = metrics.MetricRegistry().snapshot()
    assert snap["monitor"]["test_torch_observability.probe"]["value"] >= 3
    assert "test_torch_observability.probe" not in jax_monitor.registry().report()


@pytest.mark.parametrize("lo,hi,factor", [(0.5, 100.0, 2.0), (0.01, 6e4, 1.5),
                                          (1.0, 1024.0, 4.0)])
def test_log_buckets_equal(lo, hi, factor):
    assert metrics.log_buckets(lo, hi, factor) == jax_metrics.log_buckets(lo, hi, factor)


def _merge_subtract_script(p):
    snaps = []
    for seed in (4, 5, 6):
        h = p.metrics.Histogram("h")
        for v in _observations(seed):
            h.observe(v)
        snaps.append(h.snapshot())
    merged = p.metrics.merge_histogram_snapshots([snaps[0], None, snaps[1]])
    sub = p.metrics.subtract_histogram_snapshots(merged, snaps[0])
    reg_a = {"counters": {"c": 2.0}, "gauges": {"g": 1.5},
             "histograms": {"h": snaps[0]},
             "monitor": {"s": {"value": 3.0, "peak": 5.0}}}
    reg_b = {"counters": {"c": 5.0, "d": 1.0}, "gauges": {"g": 0.5},
             "histograms": {"h": snaps[2]},
             "monitor": {"s": {"value": 2.0, "peak": 9.0}}}
    fleet_merged = p.fleet.merge_registry_snapshots([reg_a, None, reg_b])
    delta = p.metrics.subtract_registry_snapshots(fleet_merged, reg_a)
    return merged, sub, fleet_merged, delta


def test_merge_and_subtract_equal():
    jax_out, port_out = _both(_merge_subtract_script)
    assert port_out == jax_out
    assert port_out[2]["counters"] == {"c": 7.0, "d": 1.0}


# ------------------------------------------------------------------- tracer
def test_tracer_chrome_trace_equal():
    def script(p):
        tr = p.tracer.Tracer()
        tr.enable()
        tr.record_complete("route.place", 1.0, 1.5, {"span_id": 3})
        tr.instant("serve.enqueue", request=0, queue_depth=2)
        with tr.span("serve.step", step=1):
            pass
        doc = tr.chrome_trace()
        evs = [{k: v for k, v in e.items() if k not in ("pid", "tid", "ts", "dur")}
               for e in doc["traceEvents"]]
        return evs, sorted(tr.stats()), tr.dropped

    jax_out, port_out = _both(script)
    assert port_out == jax_out


def test_tracer_export_writes_chrome_json(tmp_path):
    tr = tracer.get_tracer()
    tr.enable()
    tr.record_complete("serve.decode", 2.0, 2.25, {"request": 1, "parent_span": 9})
    path = tr.export_chrome_trace(str(tmp_path / "t.json"))
    doc = json.loads(open(path).read())
    x = [e for e in doc["traceEvents"] if e["name"] == "serve.decode"][0]
    assert x["ph"] == "X" and x["dur"] == 250000.0 and x["args"]["parent_span"] == 9


def test_new_span_ids_unique_and_trace_context_keys():
    ids = {tracer.new_span_id() for _ in range(100)}
    assert len(ids) == 100
    ctx, jctx = fleet.TraceContext(), jax_fleet.TraceContext()
    ctx.parent_span, jctx.parent_span = 7, 7
    assert sorted(ctx.span_args()) == sorted(jctx.span_args())
    assert ctx.request_id != fleet.new_request_id()


# -------------------------------------------------------------------- fleet
def _fleet_script(p, root):
    st = p.store.FileStore(str(root), timeout=2.0)
    reg = p.metrics.enable()
    for v in (10.0, 20.0, 30.0):
        reg.histogram("serve.ttft_ms").observe(v)
    reg.counter("serve.requests").inc(3)
    reg.gauge("serve.queue_depth").set(1)
    pubs = [p.fleet.FleetPublisher(st, w, interval_s=0.1, deadline_s=30.0)
            for w in ("w0", "w1")]
    ok = [pub.publish_once() for pub in pubs]
    coll = p.fleet.FleetCollector(st)
    snap = coll.collect()
    snap = _strip(snap)
    for w in snap["per_worker"].values():
        w.pop("monitor", None)
    snap["merged"].pop("monitor", None)
    prom = p.fleet.fleet_to_prometheus(
        {"merged": snap["merged"], "per_worker": snap["per_worker"],
         "workers": {w: {} for w in snap["per_worker"]}})
    keys = st.list_keys(p.fleet.FLEET_PREFIX)
    p.metrics.reset()
    return ok, snap, prom, keys


def test_fleet_publish_collect_equal(tmp_path):
    jax_out, port_out = (_fleet_script(p, tmp_path / name)
                         for p, name in zip(PKGS, ("jax", "port")))
    assert port_out == jax_out
    assert port_out[1]["merged"]["counters"]["serve.requests"] == 6.0


def test_fleet_dark_by_default(tmp_path):
    st = store.FileStore(str(tmp_path), timeout=2.0)
    pub = fleet.FleetPublisher(st, "w0", interval_s=0.1)
    assert metrics.active_registry() is None
    assert pub.payload() is None and pub.publish_once() is False
    assert st.list_keys(fleet.FLEET_PREFIX) == []


def test_fleet_collector_evicts_dead_publisher(tmp_path):
    st = store.FileStore(str(tmp_path), timeout=2.0)
    metrics.enable()
    assert fleet.FleetPublisher(st, "alive", deadline_s=30.0).publish_once()
    assert fleet.FleetPublisher(st, "dead", deadline_s=0.05).publish_once()
    time.sleep(0.1)
    snap = fleet.FleetCollector(st).collect()
    assert snap["evicted"] == ["dead"] and list(snap["workers"]) == ["alive"]
    assert st.list_keys(fleet.snap_key(0, "dead")) == []


# ---------------------------------------------------------------------- SLO
def _slo_snapshots():
    """A sequence of registry snapshots: traffic, a burst of errors and slow
    first tokens, then recovery (the same documents go to both engines)."""
    reg = jax_metrics.MetricRegistry()   # builds plain dicts only
    out, rng = [], np.random.RandomState(11)
    for t in range(12):
        reg.counter("serve.requests").inc(100)
        bad = 30 if 3 <= t < 6 else 0
        reg.counter("serve.errors").inc(bad)
        for _ in range(20):
            reg.histogram("serve.ttft_ms").observe(
                float(rng.uniform(500, 900) if 3 <= t < 6 else rng.uniform(5, 50)))
        out.append((float(t * 10), reg.snapshot(include_monitor=False)))
    return out


def _slo_script(p, specs_fn):
    eng = p.slo.SloEngine(specs=specs_fn(p), for_s=5.0)
    seen, events, burns = [], [], []
    eng.add_hook(seen.append)
    for now, snap in _slo_snapshots():
        events.append(eng.tick(now=now, snapshot=json.loads(json.dumps(snap))))
        burns.append([(r["slo"], r["burn"], r["budget_remaining"], r["breach"])
                      for r in eng.last_results])
    return events, burns, seen, eng.status(), [s.as_dict() for s in eng.specs]


def _windows(p):
    return [p.slo.BurnWindow(40.0, 10.0, 2.0, "page"),
            p.slo.BurnWindow(80.0, 20.0, 1.0, "warn")]


@pytest.mark.parametrize("which", ["ratio", "latency", "serving_pack"])
def test_slo_burn_rates_and_alerts_equal(which):
    def specs(p):
        if which == "ratio":
            return [p.slo.ratio_slo("avail", "serve.errors", "serve.requests",
                                    0.99, windows=_windows(p),
                                    labels={"replica": "r0"})]
        if which == "latency":
            return [p.slo.latency_slo("ttft", "serve.ttft_ms", 100.0, 0.9,
                                      windows=_windows(p))]
        return p.slo.default_serving_slos(windows=_windows(p))

    jax_out, port_out = _both(_slo_script, specs)
    assert port_out == jax_out
    states = [e["state"] for evs in port_out[0] for e in evs]
    assert "firing" in states and "resolved" in states


def test_slo_default_packs_equal():
    for name in ("default_serving_slos", "default_train_slos", "default_slos"):
        got = [s.as_dict() for s in getattr(slo, name)()]
        want = [s.as_dict() for s in getattr(jax_slo, name)()]
        assert got == want, name


def test_slo_snapshot_ring_windows_equal():
    def script(p):
        ring = p.slo.SnapshotRing(retention_s=50.0, max_entries=5)
        out = []
        for now, snap in _slo_snapshots():
            ring.push(now, snap)
            d = ring.delta(30.0, now)
            out.append((len(ring), None if d is None else _strip(d)))
        return out

    jax_out, port_out = _both(script)
    assert port_out == jax_out


def test_slo_engine_dark_by_default(tmp_path):
    eng = slo.SloEngine(specs=slo.default_slos(), alerts_path=str(tmp_path / "a.jsonl"))
    assert eng.tick() == [] and eng.ticks == 0
    assert not (tmp_path / "a.jsonl").exists()


# ----------------------------------------------------------------- capacity
class _FakeEngine:
    """The ServingEngine surface the router and the controller touch
    (tests/test_capacity.py's fake)."""

    def __init__(self, occupancy=0.0):
        self.replica_name = None
        self.slot_count = 1
        self._draining = False
        self._queue = collections.deque()
        self._active = np.zeros(1, bool)
        self._lock = threading.Lock()
        self._completed = []
        self._occ = occupancy
        self.retired = False

    def queue_depth(self):
        return len(self._queue)

    def occupancy(self):
        return self._occ

    def prefix_match_len(self, prompt_ids):
        return 0

    def submit(self, prompt_ids, trace_ctx=None, max_new_tokens=None,
               temperature=1.0, top_k=0, top_p=1.0, eos_token_id=None,
               seed=None, tenant=None):
        if self._draining:
            raise RuntimeError("draining")
        req = types.SimpleNamespace(
            id=len(self._completed) + len(self._queue),
            prompt_ids=list(prompt_ids), trace_ctx=trace_ctx,
            max_new_tokens=max_new_tokens, temperature=temperature,
            top_k=top_k, top_p=top_p, eos_token_id=eos_token_id,
            seed=seed, tenant=tenant, done=False, outcome=None, ttft_s=None,
            tpot_s=None)
        self._queue.append(req)
        return req

    def step(self):
        if self._queue:
            req = self._queue.popleft()
            req.done, req.outcome = True, "length"
            self._completed.append(req)
        return 0

    def begin_drain(self, reason="drain"):
        self._draining = True

    def retire(self):
        self.retired = True


class _FakeSlo:
    def __init__(self):
        self._firing = []
        self.last_results = []

    def firing(self, severity=None):
        return list(self._firing)

    def fire(self, name="serve.ttft", severity="page"):
        self._firing = [{"slo": name, "severity": severity, "labels": {}}]

    def calm(self, budget_remaining=1.0):
        self._firing = []
        self.last_results = [{"budget_remaining": budget_remaining}]


def _capacity_script(p):
    """Scale out on a burn, hold through the cooldown, scale in when idle
    with budget, reap the drained replicas: the decision records, the
    router's state after each poll, the registry's capacity series."""
    p.metrics.enable()
    rt = p.router.ReplicaRouter({f"r{i}": _FakeEngine() for i in range(2)})
    fake = _FakeSlo()
    ctl = p.capacity.CapacityController(
        rt, lambda name: _FakeEngine(),
        policy=p.capacity.CapacityPolicy(min_replicas=1, max_replicas=4,
                                         cooldown_s=5.0, idle_sustain_s=1.0,
                                         occupancy_low=0.2, queue_low=0.5),
        slo_engine=fake, clock=lambda: 0.0)
    log = []
    script = [(0.0, "fire"), (1.0, None), (2.0, "calm"), (3.0, "submit"),
              (7.0, None), (9.0, None), (10.0, None), (20.0, None),
              (21.0, None), (30.0, None), (31.0, None)]
    for now, what in script:
        if what == "fire":
            fake.fire()
        elif what == "calm":
            fake.calm(budget_remaining=0.9)
        elif what == "submit":
            for i in range(3):
                rt.submit([i, i + 1], max_new_tokens=2)
        rec = ctl.poll(now=now)
        rt.run()
        log.append((_strip(rec), sorted(rt.replicas), rt.stats()))
    snap = p.metrics.default_registry().snapshot(include_monitor=False)
    doc = _strip(ctl.doc())
    return log, snap["counters"], snap["gauges"], doc


def test_capacity_decisions_equal():
    jax_out, port_out = _both(_capacity_script)
    assert port_out == jax_out
    actions = [rec["action"] for rec, _, _ in port_out[0]]
    assert "scale_out" in actions and "scale_in" in actions


@pytest.mark.parametrize("occupancy,want", [(0.95, "occupancy"), (0.0, None)])
def test_capacity_sustained_occupancy_equal(occupancy, want):
    def script(p):
        rt = p.router.ReplicaRouter({f"r{i}": _FakeEngine(occupancy)
                                     for i in range(2)})
        ctl = p.capacity.CapacityController(
            rt, lambda name: _FakeEngine(occupancy),
            policy=p.capacity.CapacityPolicy(occupancy_high=0.9,
                                             high_sustain_s=1.0))
        return [_strip(ctl.poll(now=t)) for t in (10.0, 10.5, 11.1, 12.0)]

    jax_out, port_out = _both(script)
    assert port_out == jax_out
    reasons = [r["reason"] for r in port_out if r["action"] == "scale_out"]
    assert reasons == ([want] if want else [])


def test_capacity_policy_validation_and_jsonl(tmp_path):
    with pytest.raises(ValueError, match="min_replicas"):
        capacity.CapacityPolicy(min_replicas=4, max_replicas=2)
    with pytest.raises(ValueError, match="factors"):
        capacity.CapacityPolicy(scale_out_factor=1.0)
    path = str(tmp_path / "capacity.jsonl")
    rt = router.ReplicaRouter({"r0": _FakeEngine()})
    fake = _FakeSlo()
    ctl = capacity.CapacityController(
        rt, lambda name: _FakeEngine(), policy=capacity.CapacityPolicy(max_replicas=2),
        slo_engine=fake, jsonl_path=path, log_holds=False)
    ctl.poll(now=0.0)
    fake.fire()
    ctl.poll(now=1.0)
    recs = [json.loads(ln) for ln in open(path)]
    assert [r["action"] for r in recs] == ["scale_out"]
    assert sorted(rt.replicas) == ["r0", "r1"]


def test_router_begin_drain_counts_each_request_once():
    """Re-placement moves routed credit and counts route.replaced, not
    route.requests (the reference's counter audit), in both packages."""
    def script(p):
        p.metrics.enable()
        rt = p.router.ReplicaRouter({"a": _FakeEngine(), "b": _FakeEngine()})
        for i in range(6):
            rt.submit([i, i + 1])
        placed_a = rt.routed["a"]
        replaced = rt.begin_drain("a")
        counters = p.metrics.default_registry().snapshot(
            include_monitor=False)["counters"]
        rt.run()
        out = (placed_a, len(replaced), counters, dict(rt.routed), rt.drained("a"),
               [_strip(pl, ("ts",)) for pl in rt.recent_placements()])
        p.metrics.reset()
        return out

    jax_out, port_out = _both(script)
    assert port_out == jax_out
    placed_a, n_replaced, counters, routed, drained, _ = port_out
    assert n_replaced == placed_a > 0 and drained
    assert counters["route.requests"] == 6 and counters["route.replaced"] == n_replaced
    assert routed == {"a": 0, "b": 6}


def test_router_shed_and_attach_slo_equal():
    def script(p):
        rt = p.router.ReplicaRouter({"r0": _FakeEngine(), "r1": _FakeEngine()})
        hooks = []
        rt.attach_slo(types.SimpleNamespace(add_hook=hooks.append), drain=True)
        out = [rt.submit([1]).id]
        hooks[0]({"state": "firing", "severity": "warn", "labels": {"replica": "r0"}})
        out += [rt.shedding(), rt._score("r0", rt.replicas["r0"], [1])["score"]]
        hooks[0]({"state": "firing", "severity": "page", "labels": {"replica": "r0"}})
        out += [rt.replicas["r0"]._draining]
        hooks[0]({"state": "resolved", "labels": {"replica": "r0"}})
        out += [rt.shedding(), rt.stats()]
        return out

    jax_out, port_out = _both(script)
    assert port_out == jax_out
    assert port_out[3] is True


# ------------------------------------------------------------------ loadgen
def _scenarios(p):
    lg = p.loadgen
    return [
        lg.spike_scenario(),
        lg.Scenario("fleet", seed=7, duration_s=4.0,
                    arrival={"process": "poisson", "rate_rps": 12.0},
                    prompt_len={"dist": "choice", "values": [16, 32, 48, 64]},
                    max_new={"dist": "fixed", "value": 32},
                    tenants=lg.zipf_tenants(4)),
        lg.Scenario("diurnal", seed=3, duration_s=20.0,
                    arrival={"process": "diurnal", "rate_rps": 3.0,
                             "period_s": 10.0, "amplitude": 0.8},
                    prompt_len={"dist": "lognormal", "median": 12, "sigma": 0.6,
                                "min": 2, "max": 64},
                    max_new={"dist": "cycle", "values": [4, 8, 16]}),
        lg.Scenario("batch", seed=1, arrival={"process": "batch", "count": 9}),
    ]


@pytest.mark.parametrize("index", range(4))
def test_loadgen_schedule_doc_byte_equal(index, tmp_path):
    jax_sc, port_sc = (_scenarios(p)[index] for p in PKGS)
    assert port_sc.schedule_doc() == jax_sc.schedule_doc()
    assert port_sc.dumps() == jax_sc.dumps()
    path = port_sc.save(str(tmp_path / "s.json"))
    assert loadgen.Scenario.load(path).schedule_doc() == jax_sc.schedule_doc()
    assert port_sc.prompt_tokens(3, 10, 50304) == jax_sc.prompt_tokens(3, 10, 50304)


def test_loadgen_drives_router_in_order():
    sc = loadgen.Scenario("t", seed=2, arrival={"process": "batch", "count": 5},
                          tenants=loadgen.zipf_tenants(2))
    rt = router.ReplicaRouter({"r0": _FakeEngine(), "r1": _FakeEngine()})
    lg = loadgen.LoadGenerator(sc, rt, vocab=100, time_scale=0.0)
    handles = lg.run()
    assert [row["i"] for row, _ in handles] == list(range(5))
    assert all(req.done for _, req in handles)
    summ = lg.summary()
    assert summ["requests"] == 5 and summ["good"] == 5
    assert set(summ["per_tenant"]) <= {"t0", "t1"}


# ------------------------------------------------------------------- stores
def _store_script(p, make):
    s = make(p)
    out = []
    s.set("k", b"v")
    s.set("s", "text")
    out += [s.get("k"), s.get("s"), s.add("ctr", 2), s.add("ctr", 3)]
    with pytest.raises(KeyError):
        s.get("missing", wait=False)
    with pytest.raises(TimeoutError):
        s.wait(["missing"], timeout=0.1)
    s.set("__elastic__/gen5/member/w0", b"{}")
    s.set("__elastic__/gen5/leave/w1", b"{}")
    s.set("__elastic__/gen6/member/w0", b"{}")
    s.set("__fleet__/gen5/snap/w0", b"x")
    s.barrier("sync", 1, generation=5)
    s.barrier("sync", 1, generation=6)
    out += [s.list_keys("__elastic__/"), s.num_keys(), s.delete_key("k"),
            s.delete_key("k")]
    gc0 = p.monitor.stat("store.gc_keys").get()
    removed = s.gc_generation(5)
    out += [removed, p.monitor.stat("store.gc_keys").get() - gc0,
            sorted(s.list_keys(""))]
    return out


@pytest.mark.parametrize("kind", ["file", "tcp"])
def test_store_scripts_equal(kind, tmp_path):
    def make(p):
        if kind == "file":
            return p.store.FileStore(str(tmp_path / p.store.__name__), timeout=2.0)
        return p.store.TCPStore("127.0.0.1", 0, is_master=True, world_size=1,
                                timeout=5.0)

    jax_out, port_out = _both(_store_script, make)
    assert port_out == jax_out
    assert port_out[-3] >= 4


def test_tcp_store_two_clients_and_barrier():
    s = store.TCPStore("127.0.0.1", 0, is_master=True, world_size=2, timeout=10.0)
    c = store.TCPStore("127.0.0.1", s.port, is_master=False, world_size=2,
                       timeout=10.0)
    c.set("x", b"y")
    assert s.get("x") == b"y" and s.add("n", 1) == 1 and c.add("n", 1) == 2
    for _ in range(2):
        t = threading.Thread(target=lambda: c.barrier("step", 2))
        t.start()
        s.barrier("step", 2)
        t.join(timeout=10)
        assert not t.is_alive()
    with pytest.raises(TimeoutError):
        s.wait(["never"], timeout=0.2)


# --------------------------------------------------------------- membership
def _membership_script(p, root):
    st = p.store.FileStore(str(root), timeout=2.0)
    coord = p.membership.ElasticCoordinator(st, lease_s=5.0)
    a = p.membership.WorkerAgent(st, "w0", lease_s=5.0)
    b = p.membership.WorkerAgent(st, "w1", lease_s=5.0)
    r = p.membership.WorkerAgent(st, "r0", lease_s=5.0, kind="replica")
    c0 = {n: p.monitor.stat(n).get() for n in (
        "elastic.joins", "elastic.leaves", "elastic.preemptions",
        "elastic.lease_expiries")}
    out = [a.register(), b.register(), r.register(),
           sorted(coord.live_members()), sorted(coord.live_members(kind="replica"))]
    b.announce_leave("sigterm")
    out.append(sorted(coord.live_members()))
    leave = json.loads(st.get(p.membership.member_key(0, "w1", "leave"),
                              wait=False).decode())
    out.append(leave["reason"])
    g1 = p.membership.bump_generation(st)
    a.heartbeat()
    out += [g1, p.membership.current_generation(st),
            st.list_keys(f"__elastic__/gen{g1}/member/")]
    e = p.membership.WorkerAgent(st, "w9", lease_s=0.05)
    e.register()
    time.sleep(0.1)
    out.append(sorted(coord.live_members()))
    out.append({n: p.monitor.stat(n).get() - v for n, v in c0.items()})
    out.append(sorted(_strip(coord._membership_snapshot(g1))["members"]))
    return out


def test_membership_protocol_equal(tmp_path):
    jax_out, port_out = (_membership_script(p, tmp_path / n)
                         for p, n in zip(PKGS, ("jax", "port")))
    assert port_out == jax_out
    assert port_out[-2] == {"elastic.joins": 4, "elastic.leaves": 1,
                            "elastic.preemptions": 1, "elastic.lease_expiries": 1}


class _Hcg:
    def __init__(self, n):
        self.degrees = {"dp": n}
        self.nranks = n

    def topology(self):
        return dict(self.degrees)


class _ReformEngine:
    """An engine with the reference's in-memory reformation hook."""

    def __init__(self, n):
        self.hcg = _Hcg(n)
        self._step_count = 0

    def reform_mesh(self, hcg):
        self.hcg = hcg


def test_coordinator_reforms_through_reform_mesh(tmp_path):
    st = store.FileStore(str(tmp_path), timeout=2.0)
    coord = membership.ElasticCoordinator(st, topology_for=_Hcg, lease_s=5.0,
                                          check_interval=1)
    agents = [membership.WorkerAgent(st, f"w{i}", lease_s=5.0) for i in range(4)]
    for a in agents:
        a.register()
    eng = _ReformEngine(4)
    assert coord.maybe_reform(eng) is False
    ref0 = monitor.stat("elastic.reformations").get()
    agents[3].announce_leave("sigterm")
    agents[2].announce_leave("sigterm")
    assert coord.on_step(eng) is True
    assert eng.hcg.degrees["dp"] == 2 and coord.generation() == 1
    assert monitor.stat("elastic.reformations").get() == ref0 + 1
    assert st.list_keys("__elastic__/gen0/") == []
    assert sorted(coord.live_members()) == ["w0", "w1"]


def test_coordinator_without_reform_mesh_fails_loudly(tmp_path):
    """The port's TrainStepEngine has no reform_mesh: a reformation against
    it takes the failure path (flight dump, then raise without a
    checkpoint dir)."""
    flight_recorder.enable(str(tmp_path / "flight"))
    st = store.FileStore(str(tmp_path / "s"), timeout=2.0)
    coord = membership.ElasticCoordinator(st, topology_for=_Hcg, lease_s=5.0)
    for i in range(2):
        membership.WorkerAgent(st, f"w{i}", lease_s=5.0).register()
    eng = types.SimpleNamespace(hcg=_Hcg(4), _step_count=0)
    fails0 = monitor.stat("elastic.reform_failures").get()
    with pytest.raises(NotImplementedError, match="reform_mesh"):
        coord.maybe_reform(eng)
    assert monitor.stat("elastic.reform_failures").get() == fails0 + 1
    dumps = [d for d in os.listdir(tmp_path / "flight") if "elastic_reform_" in d]
    state = json.loads(open(tmp_path / "flight" / dumps[0] / "state.json").read())
    assert "reform_mesh" in state["extra"]["error"]
    assert state["extra"]["membership"]["members"]
    assert "health_tail" not in state


def test_worker_agent_sigterm_announces_leave(tmp_path):
    st = store.FileStore(str(tmp_path), timeout=2.0)
    a = membership.WorkerAgent(st, "w0", lease_s=5.0)
    a.register()
    pre0 = membership.PREEMPTIONS.get()
    a.install_sigterm_handler()
    try:
        os.kill(os.getpid(), signal.SIGTERM)
        time.sleep(0.05)
    finally:
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
    assert membership.PREEMPTIONS.get() == pre0 + 1
    assert st.list_keys("__elastic__/gen0/member/") == []


def test_elastic_flags_match_the_reference():
    from paddle_tpu.core import flags as jax_flags

    for name in ("elastic_lease_s", "elastic_check_interval",
                 "elastic_drain_timeout_s"):
        assert flags.flag(name) == jax_flags.flag(name), name


# ---------------------------------------------- flight recorder, exporter
def test_flight_dump_sections(tmp_path):
    fr = flight_recorder.enable(str(tmp_path))
    reg = metrics.enable()
    reg.counter("serve.requests").inc(2)
    rt = router.ReplicaRouter({"r0": _FakeEngine()})
    rt.submit([1, 2])
    fr.record({"event": "serve_step", "step": 1})
    monitor.stat("test_torch_observability.flight").increase()
    d = fr.dump("serve_decode_exception", {"step": 1})
    state = json.loads(open(os.path.join(d, "state.json")).read())
    assert state["reason"] == "serve_decode_exception"
    assert "test_torch_observability.flight" in state["counters"]
    assert state["metrics"]["counters"]["serve.requests"] == 2.0
    assert state["router_placements"][-1]["replica"] == "r0"
    assert "health_tail" not in state
    recs = [json.loads(ln) for ln in open(os.path.join(d, "records.jsonl"))]
    assert recs == [{"event": "serve_step", "step": 1}]
    assert reg.snapshot()["counters"]["flight.dumps"] == 1.0
    assert sorted(os.listdir(d)) == sorted(os.listdir(
        jax_flight.FlightRecorder(str(tmp_path / "j")).dump("x")))


def test_sinks_write_records(tmp_path):
    mem = step_telemetry.InMemorySink()
    mem.write({"event": "route"})
    path = str(tmp_path / "sub" / "serve.jsonl")
    js = step_telemetry.JsonlSink(path)
    js.write({"event": "serve_request", "request_id": 3})
    js.close()
    assert mem.records == [{"event": "route"}]
    assert [json.loads(ln) for ln in open(path)] == [
        {"event": "serve_request", "request_id": 3}]


def test_exporter_routes(tmp_path):
    ex = exporter.start_exporter(0)

    def get(path):
        try:
            with urllib.request.urlopen(ex.url + path, timeout=10) as r:
                return r.status, r.read().decode()
        except urllib.error.HTTPError as err:
            return err.code, err.read().decode()

    metrics.active_registry().counter("route.requests").inc(4)
    code, body = get("/metrics")
    assert code == 200 and "paddle_tpu_route_requests_total 4" in body
    assert get("/capacity")[0] == 404 and get("/fleet/metrics")[0] == 404
    assert get("/healthz") == (200, "ok\n")
    rt = router.ReplicaRouter({"r0": _FakeEngine(), "r1": _FakeEngine()})
    ctl = capacity.install_controller(capacity.CapacityController(
        rt, lambda name: _FakeEngine()))
    ctl.poll(now=0.0)
    code, body = get("/capacity")
    assert code == 200 and json.loads(body)["replicas"] == ["r0", "r1"]
    st = store.FileStore(str(tmp_path), timeout=2.0)
    fleet.FleetPublisher(st, "w0").publish_once()
    fleet.install_collector(fleet.FleetCollector(st))
    code, body = get("/fleet/metrics")
    assert code == 200 and "route_requests" in body
    slo.install_engine(specs=[slo.ratio_slo("a", "serve.errors", "serve.requests", 0.9)])
    code, body = get("/alerts")
    assert code == 200 and json.loads(body)["specs"][0]["name"] == "a"
