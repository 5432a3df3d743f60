"""The port's ReplicaRouter, drain and SIGTERM handling and serving
telemetry against the JAX package's.

Both packages serve ``gpt_tiny`` with the same weights (JAX from
``paddle.seed(0)``, carried into the port by ``models.load_jax_state``),
paged (2 slots, ladder (8, 16, 32), max_seq_len 48, 8-token pages). The
router script (one run per package, cached for the module) submits
requests behind three shared two-page prefixes, steps, drains ``r0`` with
work still queued on it, runs to the end and removes ``r0``. Compared
exactly: each request's replica and greedy tokens, ``routed``,
``prefix_routed``, both ``stats()``, the ``route.*`` / ``serve.*`` /
``elastic.*`` counters, gauges and histogram counts (not their timing
values), the sink records with their timing fields left out, and the span
names with their parenting. The drain tests hold ``drain()``,
``drain(timeout_s=0)`` and SIGTERM to the JAX engine's outcomes, pages and
``serving.outcome.*`` counters.
"""
import collections
import os
import signal
import time

import numpy as np
import pytest

import paddle_tpu as paddle
import paddle_tpu.distributed.membership as jax_membership
import paddle_tpu.distributed.store as jax_store
import paddle_tpu.observability.metrics as jax_metrics
import paddle_tpu.observability.tracer as jax_tracer
from paddle_tpu.core import monitor as jax_monitor
from paddle_tpu.models import GPTForPretraining as JaxGPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.observability.step_telemetry import InMemorySink as JaxSink
from paddle_tpu.serving import ReplicaRouter as JaxRouter
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu_torch.core import monitor
from paddle_tpu_torch.distributed import membership, store
from paddle_tpu_torch.models import GPTForPretraining, gpt_tiny, load_jax_state
from paddle_tpu_torch.observability import InMemorySink, metrics, tracer
from paddle_tpu_torch.serving import ReplicaRouter, ServingEngine

# timing fields of the records: wall clock, host latencies and rates
TIMING = ("ts", "ttft_s", "queue_wait_s", "tpot_s", "wall_s", "tokens_per_sec")


class _Pkg:
    def __init__(self, name, model, engine, router, sink, metrics_mod,
                 tracer_mod, monitor_mod, membership_mod, store_mod):
        self.name, self.model = name, model
        self.Engine, self.Router, self.Sink = engine, router, sink
        self.metrics, self.tracer, self.monitor = metrics_mod, tracer_mod, monitor_mod
        self.membership, self.store = membership_mod, store_mod


@pytest.fixture(scope="module")
def pkgs():
    from paddle_tpu.distributed.mesh import set_hybrid_communicate_group

    set_hybrid_communicate_group(None)
    paddle.seed(0)
    jm = JaxGPT(jax_gpt_tiny())
    jm.eval()
    state = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    pm = load_jax_state(GPTForPretraining(gpt_tiny(), device="cpu"), state)
    return (_Pkg("jax", jm, JaxEngine, JaxRouter, JaxSink, jax_metrics, jax_tracer,
                 jax_monitor, jax_membership, jax_store),
            _Pkg("port", pm, ServingEngine, ReplicaRouter, InMemorySink, metrics,
                 tracer, monitor, membership, store))


def _dark(p):
    p.metrics.reset()
    tr = p.tracer.get_tracer()
    tr.disable()
    tr.clear()


@pytest.fixture(autouse=True)
def _clean(pkgs):
    for p in pkgs:
        _dark(p)
    yield
    for p in pkgs:
        _dark(p)
    signal.signal(signal.SIGTERM, signal.SIG_DFL)


def _engine(p, sink=None, paged=True, slots=2, **kw):
    args = dict(slot_count=slots, ladder=(8, 16, 32), max_new_cap=8,
                max_seq_len=48, steps_per_dispatch=2, sink=sink)
    if paged:
        args.update(kv_layout="paged", kv_page_tokens=8)
    args.update(kw)
    return p.Engine(p.model, **args)


def _counter(p, name):
    return p.monitor.registry().report().get(name, {}).get("value", 0)


# ------------------------------------------------------------ the router run
def _traffic():
    rng = np.random.RandomState(3)
    prefixes = [rng.randint(0, 1024, (16,)).astype(np.int64) for _ in range(3)]
    work = []
    for i in range(10):
        tail = rng.randint(0, 1024, (int(rng.choice([2, 5, 9])),)).astype(np.int64)
        work.append((f"t{i % 3}", np.concatenate([prefixes[i % 3], tail])))
    return work


def _router_run(p):
    """Two paged replicas behind the router, the tracer and the registry on:
    submit 6, step, submit 4, drain r0 (its queued work re-placed on r1),
    run to the end, remove r0. Returns everything the tests compare."""
    reg = p.metrics.enable()
    tr = p.tracer.get_tracer()
    tr.enable()
    tr.clear()
    sink = p.Sink()
    engines = {f"r{i}": _engine(p, sink=sink) for i in range(2)}
    rt = p.Router(engines, sink=sink)
    work = _traffic()
    oc0 = {o: _counter(p, "serving.outcome." + o) for o in ("length", "eos", "drained")}
    handles = [rt.submit(prompt, max_new_tokens=6, tenant=t) for t, prompt in work[:6]]
    rt.step()
    handles += [rt.submit(prompt, max_new_tokens=6, tenant=t) for t, prompt in work[6:]]
    queued_r0 = len(engines["r0"]._queue)
    replaced = rt.begin_drain("r0")
    admit_closed = engines["r0"]._draining
    rt.run()
    drained = rt.drained("r0")
    router_stats = rt.stats()
    engine_stats = {n: e.stats() for n, e in engines.items()}
    rt.remove_replica("r0")
    # the handles each logical request ends in: re-placed ones replace the
    # stranded originals
    by_prompt = {tuple(r.prompt_ids): r for r in replaced}
    final = [by_prompt.get(tuple(h.prompt_ids), h) if not h.done else h
             for h in handles]
    placements = rt.recent_placements()
    snap = reg.snapshot(include_monitor=False)
    events = tr.events()
    tr.disable()
    p.metrics.reset()
    return {
        "final": final, "replaced": replaced, "queued_r0": queued_r0,
        "admit_closed": admit_closed, "drained": drained,
        "router_stats": router_stats, "engine_stats": engine_stats,
        "placements": placements, "snap": snap, "events": events,
        "records": sink.records,
        "outcomes": {o: _counter(p, "serving.outcome." + o) - v
                     for o, v in oc0.items()},
        "replicas_after": sorted(rt.replicas),
    }


@pytest.fixture(scope="module")
def runs(pkgs):
    return {p.name: _router_run(p) for p in pkgs}


def test_router_places_and_decodes_like_jax(runs):
    j, t = runs["jax"], runs["port"]
    assert [r.tokens for r in t["final"]] == [r.tokens for r in j["final"]]
    assert all(r.done and len(r.tokens) == 6 for r in t["final"])
    assert ([pl["replica"] for pl in t["placements"]]
            == [pl["replica"] for pl in j["placements"]])
    assert [{k: v for k, v in pl.items() if k not in ("ts", "request", "request_id")}
            for pl in t["placements"]] == [
        {k: v for k, v in pl.items() if k not in ("ts", "request", "request_id")}
        for pl in j["placements"]]
    assert t["router_stats"] == j["router_stats"]
    assert t["router_stats"]["prefix_routed"] > 0


def test_router_drain_replaces_queued_work(runs):
    j, t = runs["jax"], runs["port"]
    assert t["queued_r0"] == j["queued_r0"] == len(t["replaced"]) > 0
    assert t["admit_closed"] and t["drained"] and t["replicas_after"] == ["r1"]
    assert [r.tokens for r in t["replaced"]] == [r.tokens for r in j["replaced"]]
    # every re-placed request was placed on r1 and completed there
    n = len(t["replaced"])
    assert all(r.done for r in t["replaced"])
    assert [pl["replica"] for pl in t["placements"][-n:]] == ["r1"] * n
    assert t["router_stats"]["replicas"]["r0"]["routed"] == (
        t["router_stats"]["replicas"]["r0"]["completed"])


def test_engine_stats_after_drain_match_jax(runs):
    def drop(st):
        return {k: v for k, v in st.items() if not k.endswith("_executables")}

    j, t = runs["jax"], runs["port"]
    for name in ("r0", "r1"):
        assert drop(t["engine_stats"][name]) == drop(j["engine_stats"][name]), name
    assert t["engine_stats"]["r0"]["draining"] is True
    assert t["engine_stats"]["r1"]["draining"] is False


@pytest.mark.parametrize("kind", ["counters", "gauges"])
def test_registry_counters_and_gauges_match_jax(runs, kind):
    j, t = runs["jax"]["snap"][kind], runs["port"]["snap"][kind]
    keep = ("route.", "serve.", "elastic.")
    j = {k: v for k, v in j.items() if k.startswith(keep)}
    t = {k: v for k, v in t.items() if k.startswith(keep)}
    assert t == j
    if kind == "counters":
        assert t["route.requests"] == 10 and t["serve.requests"] == 10
        assert t["route.replaced"] == len(runs["port"]["replaced"])


def test_registry_histogram_names_and_counts_match_jax(runs):
    def counts(snap):
        return {k: v["count"] for k, v in snap["histograms"].items()
                if k.startswith(("route.", "serve.", "elastic.", "spec."))}

    assert counts(runs["port"]["snap"]) == counts(runs["jax"]["snap"])
    assert counts(runs["port"]["snap"])["serve.replica.r1.ttft_ms"] > 0


def _records(run, event):
    ids = {}
    out = []
    for rec in run["records"]:
        if rec["event"] != event:
            continue
        rec = {k: v for k, v in rec.items() if k not in TIMING}
        for key in ("request_id", "fleet_request_id"):
            if key in rec:   # process-local ids: compared by first appearance
                rec[key] = ids.setdefault((key, rec[key]), len(ids))
        out.append(rec)
    return out


@pytest.mark.parametrize("event", ["serve_request", "serve_step", "route"])
def test_sink_records_match_jax(runs, event):
    got, want = _records(runs["port"], event), _records(runs["jax"], event)
    assert got == want
    assert got


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_exec_registry_rollup_keeps_the_reference_labels(pkgs, paged):
    """run() ends with an exec_registry record: the port's carries the JAX
    engine's executable labels, each with its dispatch count."""
    out = []
    for p in pkgs:
        sink = p.Sink()
        eng = _engine(p, sink=sink, paged=paged)
        eng.submit([1, 2, 3], max_new_tokens=4)
        eng.submit(list(range(20)), max_new_tokens=4, temperature=0.8, seed=3)
        eng.run()
        out.append([r for r in sink.records if r["event"] == "exec_registry"])
    (j,), (t,) = out
    assert sorted(t["labels"]) == sorted(j["labels"])
    assert t["entries"] == j["entries"] == len(t["labels"])
    assert t["dispatches"] == sum(v["dispatches"] for v in t["labels"].values())
    assert {"serve.prefill_b8", "serve.prefill_b32"} <= set(t["labels"])


def _span_view(run):
    """(name, request index, parented by this request's route.place) for
    every route and serve span; the decode and verify step spans by (name,
    step, family). (The JAX tracer also holds its dispatcher's op spans.)"""
    events = [e for e in run["events"] if e["name"].startswith(("route.", "serve."))]
    # a re-placement keeps the request id and mints a new placement span:
    # a span's parent is one of its request's placements
    place = collections.defaultdict(set)
    for e in events:
        if e["name"] == "route.place":
            place[e["args"]["request_id"]].add(e["args"]["span_id"])
    order = {}
    out = []
    for e in events:
        a = e.get("args") or {}
        if e["name"] in ("serve.decode_step", "serve.verify_step"):
            out.append((e["name"], a["step"], a["family"]))
            continue
        rid = a.get("request_id")
        idx = order.setdefault(rid, len(order))
        parent = a.get("span_id") if e["name"] == "route.place" else a.get("parent_span")
        out.append((e["name"], idx, parent in place.get(rid, ())))
    return sorted(out)


def test_span_names_and_parenting_match_jax(runs):
    got, want = _span_view(runs["port"]), _span_view(runs["jax"])
    assert got == want
    names = {s[0] for s in got}
    assert {"route.place", "serve.enqueue", "serve.queue_wait", "serve.prefill",
            "serve.decode", "serve.request", "serve.retire",
            "serve.decode_step"} <= names
    assert all(s[2] for s in got if s[0] not in ("serve.decode_step",))


def test_outcome_counters_match_jax(runs):
    assert runs["port"]["outcomes"] == runs["jax"]["outcomes"]
    assert runs["port"]["outcomes"] == {"length": 10, "eos": 0, "drained": 0}


# ---------------------------------------------------------------- the drains
def _drain_timeout_zero(p):
    """3 requests on a paged 2-slot engine; one step admits two, then
    drain(timeout_s=0) cuts them short."""
    c0 = {o: _counter(p, "serving.outcome." + o) for o in ("drained", "length", "error")}
    sink = p.Sink()
    eng = _engine(p, sink=sink)
    prompts = [w[1] for w in _traffic()[:3]]
    reqs = [eng.submit(pr, max_new_tokens=8) for pr in prompts]
    eng.step()
    in_use_before = eng.stats()["pages_in_use"]
    done = eng.drain(timeout_s=0)
    st = {k: v for k, v in eng.stats().items() if not k.endswith("_executables")}
    recs = [{k: v for k, v in r.items() if k not in TIMING + ("request_id",)}
            for r in sink.records if r["event"] == "serve_request"]
    return {"outcomes": [r.outcome for r in reqs], "tokens": [r.tokens for r in reqs],
            "done": len(done), "in_use_before": in_use_before, "stats": st,
            "records": recs,
            "counters": {o: _counter(p, "serving.outcome." + o) - v
                         for o, v in c0.items()},
            "completed": len(eng._completed)}


def test_drain_timeout_zero_finishes_drained_and_frees_pages(pkgs):
    j, t = (_drain_timeout_zero(p) for p in pkgs)
    assert t == j
    assert t["outcomes"] == ["drained", "drained", None]
    assert t["in_use_before"] > 0 and t["stats"]["pages_in_use"] == 0
    assert t["stats"]["queued"] == 1 and t["stats"]["draining"] is True
    assert t["counters"] == {"drained": 2, "length": 0, "error": 0}
    assert t["completed"] == 0 and t["done"] == 0


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_drain_completes_active_refuses_new(pkgs, paged, tmp_path):
    out = []
    for p in pkgs:
        eng = _engine(p, paged=paged)
        st = p.store.FileStore(str(tmp_path / p.name / str(paged)), timeout=2.0)
        eng.register_replica(st, "r0", lease_s=5.0)
        coord = p.membership.ElasticCoordinator(st, lease_s=5.0)
        live = sorted(coord.live_members(kind="replica"))
        r1 = eng.submit([1, 2, 3], max_new_tokens=4)
        eng.step()
        eng.begin_drain()
        with pytest.raises(RuntimeError, match="draining"):
            eng.submit([4, 5], max_new_tokens=2)
        done = eng.drain(timeout_s=30.0)
        out.append((live, r1 in done, r1.done, r1.tokens, r1.outcome,
                    bool(eng._active.any()), eng.stats()["draining"],
                    coord.live_members(kind="replica"),
                    sorted(st.list_keys("__elastic__/gen0/leave/"))))
    assert out[1] == out[0]
    assert out[1][:3] == (["r0"], True, True) and out[1][7] == {}


def _sigterm_run(p):
    """Two requests decoding when SIGTERM lands: admission closes at once,
    drain() completes both; then a submit is refused."""
    prev_calls = []
    signal.signal(signal.SIGTERM, lambda s, f: prev_calls.append(s))
    pre0 = p.membership.PREEMPTIONS.get()
    c0 = {o: _counter(p, "serving.outcome." + o) for o in ("drained", "length")}
    eng = _engine(p)
    reqs = [eng.submit(w[1], max_new_tokens=8) for w in _traffic()[:2]]
    eng.step()
    eng.install_sigterm_handler()
    os.kill(os.getpid(), signal.SIGTERM)
    time.sleep(0.05)
    draining = eng._draining
    with pytest.raises(RuntimeError, match="draining"):
        eng.submit([1, 2], max_new_tokens=2)
    done = eng.drain()
    return {"draining": draining, "done": [r.tokens for r in done],
            "outcomes": [r.outcome for r in reqs], "chained": prev_calls,
            "preemptions": p.membership.PREEMPTIONS.get() - pre0,
            "counters": {o: _counter(p, "serving.outcome." + o) - v
                         for o, v in c0.items()},
            "stats": eng.stats()["draining"], "pages": eng.stats()["pages_in_use"]}


def test_sigterm_mid_decode_then_drain(pkgs):
    j, t = (_sigterm_run(p) for p in pkgs)
    assert t == j
    assert t["draining"] and t["outcomes"] == ["length", "length"]
    assert t["chained"] == [signal.SIGTERM] and t["preemptions"] == 1
    assert t["counters"] == {"drained": 0, "length": 2} and t["pages"] == 0


def test_sigterm_handler_only_flips_flags(pkgs):
    """The handler counts nothing itself (the counters take locks the
    serving thread may hold): the preemption is counted on the serving
    thread's next call."""
    eng = _engine(pkgs[1])
    eng.install_sigterm_handler()
    pre0 = membership.PREEMPTIONS.get()
    os.kill(os.getpid(), signal.SIGTERM)
    time.sleep(0.05)
    assert eng._draining and eng._sigterm_pending
    assert membership.PREEMPTIONS.get() == pre0
    eng.step()
    assert not eng._sigterm_pending and membership.PREEMPTIONS.get() == pre0 + 1
    os.kill(os.getpid(), signal.SIGTERM)   # already draining: counted once
    time.sleep(0.05)
    eng.step()
    assert membership.PREEMPTIONS.get() == pre0 + 1


def test_run_stops_admitting_while_draining(pkgs):
    out = []
    for p in pkgs:
        eng = _engine(p, slots=1)
        reqs = [eng.submit(w[1], max_new_tokens=4) for w in _traffic()[:3]]
        eng.step()
        eng.begin_drain()
        done = eng.run()
        out.append(([r.done for r in reqs], len(done), eng.stats()["queued"]))
    assert out[1] == out[0] == ([True, False, False], 1, 2)


def test_finish_outcomes_counted_like_jax(pkgs):
    """serving.outcome.<outcome> for every finished request, "drained" and
    "error" kept out of the completions, as the JAX engine counts them."""
    out = []
    for p in pkgs:
        names = ("length", "eos", "drained")
        c0 = {o: _counter(p, "serving.outcome." + o) for o in names}
        req0 = _counter(p, "serving.requests")
        eng = _engine(p, paged=False)
        a = eng.submit([5, 6, 7], max_new_tokens=3)
        eng.run()
        b = eng.submit([5, 6, 7], max_new_tokens=8, eos_token_id=a.tokens[1])
        eng.run()
        c = eng.submit([9, 10], max_new_tokens=8)
        eng.step()
        eng.drain(timeout_s=0)
        out.append(([r.outcome for r in (a, b, c)], len(eng._completed),
                    {o: _counter(p, "serving.outcome." + o) - v for o, v in c0.items()},
                    _counter(p, "serving.requests") - req0))
    assert out[1] == out[0]
    assert out[1][0] == ["length", "eos", "drained"] and out[1][1] == 2
    assert out[1][2] == {"length": 1, "eos": 1, "drained": 1}


# ----------------------------------------------- replica metrics, trace args
def test_replica_metrics_and_trace_context(pkgs):
    out = []
    for p in pkgs:
        reg = p.metrics.enable()
        sink = p.Sink()
        eng = _engine(p, sink=sink, paged=False)
        eng.replica_name = "r0"
        h = eng.submit([1, 2, 3], max_new_tokens=3, tenant=7)
        eng.run()
        snap = reg.snapshot(include_monitor=False)
        rec = [r for r in sink.records if r["event"] == "serve_request"][-1]
        out.append((h.outcome, rec["tenant"], snap["counters"]["serve.replica.r0.requests"],
                    snap["histograms"]["serve.replica.r0.ttft_ms"]["count"],
                    sorted(h.trace_args(x=1))))
        p.metrics.reset()
    assert out[1] == out[0]
    assert out[1][1] == "7"


def test_telemetry_dark_by_default(pkgs):
    p = pkgs[1]
    assert p.metrics.active_registry() is None
    eng = _engine(p)
    eng.submit([1, 2, 3], max_new_tokens=3)
    eng.run()
    assert p.tracer.get_tracer().events() == []


# ------------------------------------------------------ speculative telemetry
def _spec_run(p, draft):
    reg = p.metrics.enable()
    tr = p.tracer.get_tracer()
    tr.enable()
    sink = p.Sink()
    eng = _engine(p, sink=sink, paged=False, slots=3, max_new_cap=16,
                  steps_per_dispatch=4, draft_model=draft, spec_ladder=(4,))
    rng = np.random.RandomState(0)
    for i, n in enumerate((5, 7, 9, 12)):
        eng.submit(rng.randint(0, 1024, (n,)).astype(np.int64), max_new_tokens=8,
                   speculate_k=4 if i % 2 == 0 else 0)
    eng.run()
    snap = reg.snapshot(include_monitor=False)
    steps = [{k: v for k, v in r.items() if k != "ts"} for r in sink.records
             if r["event"] == "serve_step"]
    verify = sorted((e["args"]["step"], e["args"]["k"]) for e in tr.events()
                    if e["name"] == "serve.verify_step")
    tr.disable()
    tr.clear()
    p.metrics.reset()
    return ({k: v for k, v in snap["counters"].items() if k.startswith("serve.spec")},
            snap["histograms"]["spec.accept_rate"]["count"],
            snap["histograms"]["spec.accept_rate"]["sum"], steps, verify)


def test_speculative_telemetry_matches_jax(pkgs):
    """The target as its own draft (the same weights in both packages):
    the serve.spec.* counters, spec.accept_rate, the verify serve_step
    records and serve.verify_step spans."""
    j, t = (_spec_run(p, p.model) for p in pkgs)
    assert t == j
    assert t[0]["serve.spec.proposed"] > 0 and t[1] > 0 and t[4]
    assert any(r.get("spec") for r in t[3])


# ----------------------------------------------------- loadgen over a router
def _loadgen_run(p, lg_mod):
    sink = p.Sink()
    rt = p.Router([_engine(p, sink=sink) for _ in range(2)])
    sc = lg_mod.spike_scenario(max_new=3)
    lg = lg_mod.LoadGenerator(sc, rt, vocab=1024, time_scale=0.0)
    handles = lg.run()
    summ = lg.summary()
    return ([(row, req.tokens, req.outcome) for row, req in handles],
            {k: summ[k] for k in ("requests", "good", "outcomes", "per_tenant")},
            rt.stats(), sorted(r["tenant"] for r in sink.records
                               if r["event"] == "serve_request"))


def test_loadgen_drives_the_router_like_jax(pkgs):
    """The pinned spike scenario, open loop (time_scale 0: every arrival
    submitted in order, then driven to the end), over two paged replicas:
    the same rows, tokens, outcomes, summary counts and tenant tags."""
    from paddle_tpu.serving import loadgen as jax_loadgen
    from paddle_tpu_torch.serving import loadgen

    j, t = _loadgen_run(pkgs[0], jax_loadgen), _loadgen_run(pkgs[1], loadgen)
    assert t == j
    assert t[1]["requests"] == t[1]["good"] > 0


# ------------------------------------------------- failed dispatch, flight dump
@pytest.mark.parametrize("where", ["prefill", "decode"])
def test_failed_dispatch_dumps_flight_ring_and_errors_requests(pkgs, where, tmp_path):
    from paddle_tpu_torch.observability import flight_recorder

    fr = flight_recorder.enable(str(tmp_path))
    try:
        reg = metrics.enable()
        e0 = _counter(pkgs[1], "serving.outcome.error")
        eng = _engine(pkgs[1], sink=InMemorySink())
        reqs = [eng.submit([1, 2, 3], max_new_tokens=4), eng.submit([4, 5], max_new_tokens=4)]
        if where == "decode":
            eng.step()

        def boom(*a, **k):
            raise RuntimeError("injected")

        setattr(eng, "_prefill_paged" if where == "prefill" else "_decode_chunk", boom)
        if where == "prefill":
            eng.submit([7, 8, 9], max_new_tokens=4)
        with pytest.raises(RuntimeError, match="injected"):
            eng.step() if where == "decode" else eng.run()
        reason = f"serve_{where}_exception"
        assert any(reason in d for d in fr.dumps)
        errored = reqs if where == "decode" else [reqs[0]]
        assert all(r.outcome == "error" and r not in eng._completed for r in errored)
        assert _counter(pkgs[1], "serving.outcome.error") - e0 == len(errored)
        assert reg.snapshot()["counters"]["serve.errors"] == len(errored)
    finally:
        flight_recorder.disable()
