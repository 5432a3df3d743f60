"""The train step's observability and its last entry points:
paddle_tpu_torch's ``TrainStepEngine`` telemetry (``StepTelemetry``), health
monitor (observability/health.py), flight records, metrics histograms and
tracer spans, ``run_steps``, ``prefetch`` and the checkpoint's histograms and
dumps, against the JAX engine on the same weights and batches.

gpt_tiny with the JAX model's weights (``load_jax_state``), ids [4, 128]
from ``RandomState``. One script drives each package's engine: a plain
step, a step of 2 microbatches, ``run_steps`` of 2 steps and 2 prefetched
steps, telemetry and the health monitor (interval 1) on, with SGD (lr
0.05): its update is linear in the gradient, so the two packages' weights
stay within rounding of each other and so do the per-parameter norms.
(Under Adam a gradient within rounding of 0 moves its entry by another
share of lr in each package, tests/test_torch_accum.py's rule; a
zero-initialized bias's norm after one step shows it at 5e-5.) The tests of
the port alone use AdamW(1e-3, weight decay 0.01). Bars: losses rtol 1e-5
(tests/test_torch_accum.py's), the health records' norms and update ratios
rtol 1e-5 per parameter, counts and record fields exactly. The counters
that only the JAX package registers (its compiled step's and its eager op
dispatcher's, ``JAX_ONLY_KEYS``) are absent from the port's records by
design. At dp 2 (2 gloo ranks, rank bodies in tests/torch_obs_workers.py,
SGD) the ZeRO and FSDP health records equal the replicated run's (rtol
1e-5), which equals the JAX engine's at dp 2.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import paddle_tpu as paddle
import torch_obs_workers as OW
from paddle_tpu.core import monitor as jmonitor
from paddle_tpu.distributed import elastic as jelastic
from paddle_tpu.distributed.engine import TrainStepEngine as JaxEngine
from paddle_tpu.distributed.mesh import (HybridCommunicateGroup,
                                         set_hybrid_communicate_group)
from paddle_tpu.models import GPTForPretraining as JaxGPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.observability import flight_recorder as jfr
from paddle_tpu.observability import health as jhealth
from paddle_tpu.observability import metrics as jmetrics
from paddle_tpu.observability import tracer as jtracer
from paddle_tpu_torch.core import monitor as pmonitor
from paddle_tpu_torch.distributed import TrainStepEngine, spawn
from paddle_tpu_torch.distributed import elastic as pelastic
from paddle_tpu_torch.models import GPTForPretraining, gpt_tiny, load_jax_state
from paddle_tpu_torch.observability import flight_recorder as pfr
from paddle_tpu_torch.observability import health as phealth
from paddle_tpu_torch.observability import metrics as pmetrics
from paddle_tpu_torch.observability import tracer as ptracer
from paddle_tpu_torch.observability.step_telemetry import StepTelemetry
from paddle_tpu_torch.optimizer import SGD, AdamW

LR = 1e-3
SGD_LR = 0.05
RTOL = 1e-5
DEADLINE_S = 240     # the 2 gloo ranks, all cases; they take ~10 s
# registered only by the JAX package: its compiled step's compile counters
# and its eager op dispatcher's counters
JAX_ONLY_KEYS = {"jit_compiles", "jit_compiles_delta", "jit_compile_ms", "jit_recompiles",
                 "compile_cold", "compile_cold_ms", "compile_warm", "compile_warm_ms",
                 "dispatch_calls", "nan_inf_hits"}
# the records carry the counters' process totals: the grad_comm ones are
# compared by their increments over the script; the serving and decode
# ones, registered by whatever ran before in the process, not at all
GRAD_COMM_FIELDS = {"grad_comm_steps": "grad_comm.steps",
                    "grad_comm_microbatches": "grad_comm.microbatches",
                    "grad_comm_bytes_moved": "grad_comm.bytes_moved",
                    "grad_comm_lowp_steps": "grad_comm.lowp_steps",
                    "grad_comm_rs_bytes": "grad_comm.rs_bytes",
                    "grad_comm_ag_bytes": "grad_comm.ag_bytes"}
OTHER_COUNTERS = {"decode_jit_compiles", "decode_cache_evictions", "serving_prefill_compiles",
                  "serving_decode_compiles", "serving_steps", "serving_tokens"}
TIMING_KEYS = {"ts", "wall_time_s", "samples_per_sec", "tokens_per_sec", "tflops_per_sec",
               "h2d_ms"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the run is deterministic without the slow
    deterministic kernels, and many test processes sharing the cores do
    not spin on each other's parallel regions."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def _observability_reset():
    for m in (jmetrics, pmetrics):
        m.reset()
    for f in (jfr, pfr):
        f.disable()
    for h in (jhealth, phealth):
        h.reset()
    for t in (jtracer, ptracer):
        t.get_tracer().disable()
        t.get_tracer().clear()


@pytest.fixture(autouse=True)
def _observability_cleanup():
    _observability_reset()     # whatever ran before in this process
    yield
    _observability_reset()


def _batch(b=4, s=128, seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 1024, (b, s)).astype(np.int64)
    labels = np.roll(ids, -1, 1)
    labels[:, -1] = -100
    return ids, labels


def _jax_engine(microbatches=1, model=None, sgd=False):
    set_hybrid_communicate_group(None)
    paddle.seed(0)
    jm = model if model is not None else JaxGPT(jax_gpt_tiny())
    hcg = HybridCommunicateGroup(dp_degree=1, devices=jax.devices()[:1])
    if sgd:
        opt = paddle.optimizer.SGD(learning_rate=SGD_LR, parameters=jm.parameters())
    else:
        opt = paddle.optimizer.AdamW(learning_rate=LR, parameters=jm.parameters(),
                                     weight_decay=0.01)
    return JaxEngine(jm, opt, hcg=hcg, microbatches=microbatches), jm


def _jax_state(jm):
    return {n: np.asarray(v._data) for n, v in jm.state_dict().items()}


def _port_opt(params, sgd=False):
    if sgd:
        return SGD(learning_rate=SGD_LR, parameters=params)
    return AdamW(learning_rate=LR, parameters=params, weight_decay=0.01)


def _port_engine(state=None, microbatches=1, seed=2, sgd=False):
    pm = GPTForPretraining(gpt_tiny(), device="cpu", seed=seed)
    if state is not None:
        load_jax_state(pm, state)
    opt = _port_opt(pm.named_parameters(), sgd)
    return TrainStepEngine(pm, opt, microbatches=microbatches), pm


def _drive(eng, to_batch, metrics, tracer, monitor):
    """The shared script: a plain step, a 2-microbatch step, run_steps of 2,
    2 prefetched steps; telemetry, health (interval 1), the package's
    metrics registry and tracer on. Returns the telemetry records (the
    grad_comm counters as increments over the script), the health
    records, the losses, the engine's spans (name, argument names) and the
    histograms' counts."""
    base = {f: monitor.stat(name).get() for f, name in GRAD_COMM_FIELDS.items()}
    tele = eng.enable_telemetry()
    health = eng.enable_health(interval=1)
    metrics.enable()
    tracer.get_tracer().enable()
    ids, labels = to_batch(*_batch())
    losses = [float(eng.step(ids, labels).item())]
    eng.microbatches = 2
    losses.append(float(eng.step(ids, labels).item()))
    eng.microbatches = 1
    losses += [float(x) for x in np.asarray(eng.run_steps(ids, labels, steps=2).numpy())]
    loader = [to_batch(*_batch(seed=s)) for s in (1, 2)]
    for b in eng.prefetch(loader):
        losses.append(float(eng.step(*b).item()))
    spans = [(ev["name"], sorted(ev.get("args", {})))
             for ev in tracer.get_tracer().events() if ev["name"].startswith("engine.")]
    counts = {h: metrics.active_registry().histogram(h).snapshot()["count"]
              for h in ("train.step_ms", "train.run_steps_ms", "train.h2d_ms")}
    recs = [{k: v - base[k] if k in base else v for k, v in r.items()}
            for r in tele.sink.records]
    return recs, health.recent(), losses, spans, counts


_RUNS = {}


def _runs():
    """(JAX, port) results of ``_drive``, each run once for the module."""
    if not _RUNS:
        jeng, jm = _jax_engine(sgd=True)
        state = _jax_state(jm)
        _RUNS["jax"] = _drive(jeng, lambda i, l: (paddle.to_tensor(i), paddle.to_tensor(l)),
                              jmetrics, jtracer, jmonitor)
        jeng.disable_health()
        peng, _ = _port_engine(state, sgd=True)
        _RUNS["port"] = _drive(peng, lambda i, l: (i, l), pmetrics, ptracer, pmonitor)
        peng.disable_health()
        _observability_reset()
    return _RUNS["jax"], _RUNS["port"]


def test_telemetry_records_match_the_jax_engine():
    """The records of the script, and its losses: those of run_steps (the
    3rd and 4th) against the JAX engine's scan."""
    (jrecs, _, jl, _, _), (precs, _, pl, _, _) = _runs()
    np.testing.assert_allclose(pl, jl, rtol=RTOL)
    assert len(precs) == len(jrecs) == 5
    for j, p in zip(jrecs, precs):
        assert set(p) - OTHER_COUNTERS == set(j) - JAX_ONLY_KEYS - OTHER_COUNTERS, (
            sorted(p), sorted(j))
        np.testing.assert_allclose(p["loss"], j["loss"], rtol=RTOL)
        for key in set(p) - TIMING_KEYS - OTHER_COUNTERS - {"loss", "device_memory"}:
            assert p[key] == j[key], key
        assert p["device_memory"] == j["device_memory"] == {}
    assert [r.get("microbatches") for r in precs] == [None, 2, None, None, None]
    assert precs[1]["grad_comm_dtype"] == "f32" and precs[1]["grad_comm_bytes"] == 0
    assert [r["grad_comm_microbatches"] for r in precs] == [0, 2, 2, 2, 2]
    assert precs[2]["steps_fused"] == 2 and precs[2]["tokens"] == 2 * 4 * 128
    assert [r.get("prefetch_depth") for r in precs[3:]] == [2, 1]
    assert "mfu" not in precs[0]     # no peak on the CPU


def test_health_records_match_the_jax_engine():
    (_, jh, _, _, _), (_, ph, _, _, _) = _runs()
    # run_steps (steps 3 and 4) does not ride the monitor, in either package
    assert [r["step"] for r in ph] == [r["step"] for r in jh] == [1, 2, 5, 6]
    for j, p in zip(jh, ph):
        assert p["nonfinite_count"] == j["nonfinite_count"] == 0
        assert p["first_nonfinite_param"] is None and not p["spike"] and not j["spike"]
        for key in ("grad_norm", "weight_norm", "update_ratio"):
            np.testing.assert_allclose(p[key], j[key], rtol=RTOL, err_msg=key)
        assert set(p["per_param"]) == set(j["per_param"])
        for name, pp in p["per_param"].items():
            jp = j["per_param"][name]
            for key in ("grad_norm", "weight_norm", "update_ratio"):
                np.testing.assert_allclose(pp[key], jp[key], rtol=RTOL,
                                           err_msg=f"step {p['step']} {name} {key}")
            assert pp["nonfinite"] == jp["nonfinite"] == 0


def test_spans_and_histograms_match_the_jax_engine():
    (_, _, _, jspans, jcounts), (_, _, _, spans, counts) = _runs()
    assert spans == jspans
    assert [n for n, _ in spans] == ["engine.step", "engine.accum_step", "engine.run_steps",
                                     "engine.step", "engine.step"]
    assert counts == jcounts == {"train.step_ms": 4, "train.run_steps_ms": 1,
                                 "train.h2d_ms": 5}


# ------------------------------------------------------------- health alone

def _packed(g2, w2, u2, nf):
    return np.asarray(list(g2) + list(w2) + list(u2) + list(nf), np.float32)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_spike_detection_ema_and_dump_rate_limit(tmp_path, pkg):
    """tests/test_health.py:231's synthetic buffers through each package's
    host half: the same records, spikes and at most two dumps a reason."""
    health, fr_mod = (jhealth, jfr) if pkg == "jax" else (phealth, pfr)
    fr = fr_mod.enable(str(tmp_path))
    m = health.TrainingHealthMonitor({"a": (2,), "b": (3,)}, interval=1, spike_factor=10.0)
    rec = m.on_step(1, _packed([1, 1], [4, 4], [.01, .01], [0, 0]))
    assert rec["spike"] is False
    assert rec["grad_norm"] == pytest.approx(np.sqrt(2.0))
    assert rec["update_ratio"] == pytest.approx(np.sqrt(0.02) / np.sqrt(8.0))
    for step, g2 in ((2, 1e10), (3, 1e14), (4, 1e18)):
        rec = m.on_step(step, _packed([g2, g2], [4, 4], [.01, .01], [0, 0]))
        assert rec["spike"] is True, f"step {step} not flagged"
    assert len([d for d in fr.dumps if "health_grad_spike" in d]) == 2


def test_the_host_half_decodes_as_the_jax_package_does():
    bufs = [_packed([1, 1], [1, 1], [0, 0], [0, 0]),
            _packed([4, 9], [1, 4], [1e-4, 0], [0, 0]),
            _packed([np.inf, np.nan], [1, 1], [0, 0], [0, 3]),
            _packed([1e12, 1e12], [1, 1], [0, 0], [0, 0])]
    shapes = {"a": (2,), "b": (3,)}
    recs = []
    for health in (jhealth, phealth):
        m = health.TrainingHealthMonitor(shapes, interval=1, spike_factor=10.0)
        recs.append([{k: v for k, v in m.on_step(i + 1, b).items() if k != "ts"}
                     for i, b in enumerate(bufs)])
        assert m.on_step(5, None) is None
    assert recs[0] == recs[1]
    assert recs[1][2]["first_nonfinite_param"] == "b" and recs[1][2]["grad_norm"] is None


def test_the_device_half_packs_segments_in_sorted_name_order():
    """begin_stats / end_stats against the plain sums, per piece: whole
    parameters, and a shard's pieces placed at their ordinals."""
    m = phealth.TrainingHealthMonitor({"b": (2, 3), "a": (4,), "c": (5,)}, interval=1)
    assert m.names == ["a", "b", "c"]
    gen = torch.Generator().manual_seed(0)
    g = [torch.randn(4, generator=gen), torch.randn(2, 3, generator=gen),
         torch.randn(5, generator=gen)]
    g[2][1] = float("inf")
    w = [torch.randn(t.shape, generator=gen) for t in g]
    new = [t - 0.1 * torch.randn(t.shape, generator=gen) for t in w]
    got = m.end_stats(m.begin_stats(g, w), new)
    want = torch.tensor([[float((t.double() ** 2).sum()) for t in ts] for ts in (g, w)]
                        + [[float(((a.double() - b.double()) ** 2).sum())
                            for a, b in zip(new, w)], [0, 0, 1]]).reshape(-1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6)
    part = m.end_stats(m.begin_stats([g[1][:1].reshape(-1)], [w[1][:1].reshape(-1)], [1]),
                       [new[1][:1].reshape(-1)])
    assert part.shape == (12,) and part.view(4, 3)[:, [0, 2]].abs().sum() == 0
    np.testing.assert_allclose(part.view(4, 3)[0, 1].item(),
                               float((g[1][0].double() ** 2).sum()), rtol=1e-6)


def test_health_interval_gates_the_stats_and_the_single_fetch(monkeypatch):
    """interval 2 over 5 steps: stats computed, fetched and recorded at
    steps 2 and 4 only (tests/test_health.py:77's gate, and the port's
    off-interval steps compute nothing)."""
    from paddle_tpu_torch.core import monitor

    calls = []
    real = phealth.TrainingHealthMonitor.begin_stats
    monkeypatch.setattr(phealth.TrainingHealthMonitor, "begin_stats",
                        lambda self, *a: calls.append(1) or real(self, *a))
    eng, _ = _port_engine()
    eng.enable_health(interval=2)
    pmetrics.enable()
    fetches0 = monitor.stat("health.fetches").get()
    ids, labels = _batch()
    for _ in range(5):
        eng.step(ids, labels)
    recs = eng._health.recent()
    assert [r["step"] for r in recs] == [2, 4] and len(calls) == 2
    assert monitor.stat("health.fetches").get() - fetches0 == 2
    assert set(recs[0]["per_param"]) == set(eng.params)
    hist = pmetrics.active_registry().histogram("train.grad_norm",
                                                boundaries=phealth.NORM_BUCKETS).snapshot()
    assert hist["count"] == 2
    assert pmetrics.active_registry().gauge("health.last_step").value == 4


def test_health_jsonl_sink(tmp_path):
    p = tmp_path / "health.jsonl"
    eng, _ = _port_engine()
    eng.enable_health(interval=1, path=str(p))
    ids, labels = _batch()
    for _ in range(3):
        eng.step(ids, labels)
    eng.disable_health()
    recs = [json.loads(ln) for ln in open(p) if ln.strip()]
    assert [r["step"] for r in recs] == [1, 2, 3]
    assert all(r["event"] == "health" for r in recs)


@pytest.mark.parametrize("mode", ["zero", "fsdp"])
def test_one_process_shards_give_the_plain_steps_health(mode):
    """ZeRO and FSDP without a group (one shard holding every parameter's
    piece): the health records of the plain step."""
    ids, labels = _batch()
    recs = []
    for kw in ({}, {mode: True}):
        eng, _ = _port_engine(seed=6)
        eng.zero_update, eng.fsdp = kw.get("zero", False), kw.get("fsdp", False)
        health = eng.enable_health(interval=1)
        for _ in range(2):
            eng.step(ids, labels)
        assert (eng._zero_opt is not None, eng._fsdp_params is not None) == (
            kw.get("zero", False), kw.get("fsdp", False))
        recs.append(health.recent())
    _assert_health_close(recs[1], recs[0])


def test_env_probes_attach_telemetry_health_and_the_flight_recorder(tmp_path, monkeypatch):
    """PADDLE_TPU_TELEMETRY_DIR, PADDLE_TPU_HEALTH_DIR (or FLAGS_health_monitor)
    and PADDLE_TPU_FLIGHT_DIR at engine construction."""
    import paddle_tpu_torch as P

    monkeypatch.setenv("PADDLE_TPU_TELEMETRY_DIR", str(tmp_path / "tele"))
    monkeypatch.setenv("PADDLE_TPU_HEALTH_DIR", str(tmp_path / "health"))
    monkeypatch.setenv("PADDLE_TPU_FLIGHT_DIR", str(tmp_path / "flight"))
    P.set_flags({"health_interval": 1})
    try:
        eng, _ = _port_engine()
        assert eng.telemetry.flops_per_token == 6 * sum(p.numel() for p in eng.params.values())
        eng.step(*_batch())
        eng.disable_telemetry()
        eng.disable_health()
        monkeypatch.delenv("PADDLE_TPU_HEALTH_DIR")
        P.set_flags({"health_monitor": True})
        assert _port_engine()[0]._health is not None
    finally:
        P.set_flags({"health_monitor": False, "health_interval": 10})
    tele = [json.loads(ln) for ln in open(tmp_path / "tele" / "step_telemetry.jsonl")]
    health = [json.loads(ln) for ln in open(tmp_path / "health" / "health.jsonl")]
    assert [r["step"] for r in tele] == [r["step"] for r in health] == [1]
    assert pfr.get() is not None and pfr.get().records()[-1]["step"] == 1


# --------------------------------------------------------- NaN localization

class _JaxProbe(paddle.nn.Layer):
    """tests/test_health.py's probe: the ``s`` column drives tail.weight's
    gradient to inf without touching any other parameter's."""

    def __init__(self):
        super().__init__()
        self.body = paddle.nn.Linear(8, 8)
        self.tail = paddle.nn.Linear(8, 8)

    def forward(self, x, y, s):
        h = self.tail(self.body(x))
        return ((h - y) ** 2).mean() + ((self.tail.weight * s.mean()) ** 2).sum()


class _Probe(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.body = torch.nn.Linear(8, 8)
        self.tail = torch.nn.Linear(8, 8)

    def forward(self, x, y, s):
        h = self.tail(self.body(x))
        return ((h - y) ** 2).mean() + ((self.tail.weight * s.mean()) ** 2).sum()


def _probe_run(pkg, tmp_path):
    fr = (jfr if pkg == "jax" else pfr).enable(str(tmp_path / pkg / "flight"))
    (jmetrics if pkg == "jax" else pmetrics).enable()
    rng = np.random.RandomState(0)
    x, y = (rng.randn(8, 8).astype("float32") for _ in range(2))
    healthy, poisoned = np.zeros(8, np.float32), np.full(8, 1e25, np.float32)
    if pkg == "jax":
        eng, jm = _jax_engine(microbatches=2, model=_JaxProbe(), sgd=True)
        batch = lambda s: [paddle.to_tensor(a) for a in (x, y, s)]  # noqa: E731
        _RUNS["probe_state"] = _jax_state(jm)
    else:
        pm = _Probe()
        pm.load_state_dict({n: torch.from_numpy(a.T.copy() if a.ndim == 2 else a.copy())
                            for n, a in _RUNS["probe_state"].items()})
        eng = TrainStepEngine(pm, _port_opt(pm.named_parameters(), sgd=True), microbatches=2)
        batch = lambda s: [x, y, s]  # noqa: E731
    eng.enable_health(interval=1, path=str(tmp_path / pkg / "health.jsonl"))
    for s in (healthy, healthy, poisoned):
        eng.step(*batch(s))
    recs = eng._health.recent()
    eng.disable_health()
    return fr, recs


def test_nan_localization_names_the_jax_engines_parameter(tmp_path):
    _, jrecs = _probe_run("jax", tmp_path)
    fr, recs = _probe_run("port", tmp_path)
    assert [r["step"] for r in recs] == [1, 2, 3]
    for j, p in zip(jrecs[:2], recs[:2]):
        np.testing.assert_allclose(p["grad_norm"], j["grad_norm"], rtol=RTOL)
    bad = recs[2]
    assert bad["first_nonfinite_param"] == jrecs[2]["first_nonfinite_param"] == "tail.weight"
    assert bad["first_nonfinite_segment"] == jrecs[2]["first_nonfinite_segment"]
    assert {n for n, pp in bad["per_param"].items() if pp["nonfinite"]} == {"tail.weight"}
    reg = pmetrics.active_registry()
    assert reg.counter("health.nonfinite.tail.weight").value == 1
    dumps = [d for d in fr.dumps if "health_nonfinite" in os.path.basename(d)]
    assert len(dumps) == 1 and "tail_weight" in os.path.basename(dumps[0])
    state = json.load(open(os.path.join(dumps[0], "state.json")))
    assert state["extra"]["param"] == "tail.weight" and state["extra"]["step"] == 3
    assert state["health_tail"][-1]["first_nonfinite_param"] == "tail.weight"
    # the step's loss is inf: the train_loss dump and the counter
    assert any("train_loss" in os.path.basename(d) for d in fr.dumps)
    recs = [json.loads(ln) for ln in open(tmp_path / "port" / "health.jsonl") if ln.strip()]
    assert recs[-1]["first_nonfinite_param"] == "tail.weight"


# ------------------------------------------------------- off costs nothing

class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.fixture
def deterministic():
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


def _ops_of_a_step(eng, ids, labels):
    with _CountOps() as c:
        eng.step(ids, labels)
    return c.n


def test_off_runs_no_stats_code_and_no_extra_op(monkeypatch):
    """With telemetry, health, the flight recorder and metrics off a step
    reads no value back and runs the ops it ran before any of them was
    attached; an off-interval step of the health monitor runs no more."""
    ids, labels = _batch()
    eng, _ = _port_engine()
    eng.step(ids, labels)
    base = _ops_of_a_step(eng, ids, labels)

    def boom(*_a, **_k):
        raise AssertionError("ran while off")

    with monkeypatch.context() as mp:
        for obj, name in ((torch.Tensor, "item"), (torch.Tensor, "cpu"),
                          (phealth.TrainingHealthMonitor, "begin_stats"),
                          (StepTelemetry, "record_step"),
                          (TrainStepEngine, "_obs_step_tail")):
            mp.setattr(obj, name, boom)
        assert _ops_of_a_step(eng, ids, labels) == base
    eng.enable_telemetry()
    eng.enable_health(interval=2)
    eng.disable_telemetry()
    assert _ops_of_a_step(eng, ids, labels) > base      # step 4: an interval step
    assert _ops_of_a_step(eng, ids, labels) == base     # step 5
    eng.disable_health()
    assert _ops_of_a_step(eng, ids, labels) == base


def test_everything_on_leaves_losses_and_weights_bit_equal(deterministic, tmp_path):
    ids, labels = _batch()
    (a, ma), (b, mb) = _port_engine(seed=3), _port_engine(seed=3)
    a.enable_telemetry()
    a.enable_health(interval=1)
    pfr.enable(str(tmp_path))
    pmetrics.enable()
    ptracer.get_tracer().enable()
    la = [a.step(ids, labels) for _ in range(3)]
    pfr.disable()
    pmetrics.disable()
    ptracer.get_tracer().disable()
    lb = [b.step(ids, labels) for _ in range(3)]
    assert all(torch.equal(x, y) for x, y in zip(la, lb))
    for (n, p), (_, q) in zip(ma.named_parameters(), mb.named_parameters()):
        assert torch.equal(p, q), n


# --------------------------------------------------------------- run_steps

def test_run_steps_is_k_steps_bit_for_bit(deterministic):
    ids, labels = _batch()
    (a, ma), (b, mb) = _port_engine(seed=4), _port_engine(seed=4)
    loop = torch.stack([a.step(ids, labels) for _ in range(3)])
    fused = b.run_steps(ids, labels, steps=3)
    assert fused.shape == (3,) and torch.equal(fused, loop)
    assert a._step_count == b._step_count == b.optimizer._step_count == 3
    stacked = b.run_steps(np.stack([ids] * 2), np.stack([labels] * 2))
    assert torch.equal(stacked, torch.stack([a.step(ids, labels) for _ in range(2)]))
    for (n, p), (_, q) in zip(ma.named_parameters(), mb.named_parameters()):
        assert torch.equal(p, q), n


def test_run_steps_interleaves_with_step_and_rejects_what_the_reference_rejects():
    ids, labels = _batch()
    eng, _ = _port_engine()
    a = eng.step(ids, labels).item()
    assert eng.run_steps(ids, labels, steps=4).shape == (4,)
    b = eng.step(ids, labels).item()
    assert eng._step_count == 6 and b < a
    with pytest.raises(ValueError, match="at least one step"):
        eng.run_steps(ids, labels, steps=0)
    sharded, _ = _port_engine()
    sharded.zero_update = True
    with pytest.raises(ValueError, match="does not compose with zero_update"):
        sharded.run_steps(ids, labels, steps=2)
    sharded.fsdp = True
    with pytest.raises(ValueError, match="does not compose with fsdp"):
        sharded.run_steps(ids, labels, steps=2)


def test_run_steps_saves_an_interval_inside_its_window(tmp_path, monkeypatch):
    """interval 3, run_steps of 4 then of 2: saves at steps 4 and 6; and
    both packages' CheckpointManager.on_step take the same windows."""
    eng, _ = _port_engine()
    ids, labels = _batch()
    mgr = eng.enable_checkpointing(str(tmp_path / "port"), interval=3, keep=5,
                                   async_save=False)
    eng.run_steps(ids, labels, steps=4)
    eng.run_steps(ids, labels, steps=2)
    assert [s for s, _ in mgr.checkpoints()] == [4, 6]
    eng.disable_checkpointing()
    calls = [(1, 1), (2, 1), (6, 4), (7, 1), (9, 2), (13, 4), (20, 7), (21, 1)]
    saved = []
    for elastic in (jelastic, pelastic):
        m = elastic.CheckpointManager(str(tmp_path / elastic.__name__), interval=3)
        at = []
        monkeypatch.setattr(m, "save", at.append)   # the "engine" is the step
        for step, window in calls:
            m.on_step(step, step, 1.0, window=window)
        saved.append(at)
        m.close()
    assert saved[0] == saved[1] == [6, 9, 13, 20, 21]


# ---------------------------------------------------------------- prefetch

def test_prefetch_gives_the_steps_losses_and_its_stats(deterministic):
    batches = [_batch(seed=s) for s in range(4)]
    (a, _), (b, _) = _port_engine(seed=5), _port_engine(seed=5)
    plain = [a.step(*x) for x in batches]
    tele = b.enable_telemetry()
    got = [b.step(*x) for x in b.prefetch(batches, depth=2)]
    assert all(torch.equal(x, y) for x, y in zip(plain, got))
    pf = b.prefetcher
    assert pf.batches == 4 and pf.skipped_puts == 8 and pf.puts == 0
    assert [r["prefetch_depth"] for r in tele.sink.records] == [2, 2, 2, 1]
    assert all("h2d_ms" in r for r in tele.sink.records)
    with pytest.raises(ValueError, match="depth must be >= 1"):
        b.prefetch(batches, depth=0)


# ------------------------------------------------ flight records and dumps

def test_step_and_run_steps_exceptions_dump_before_raising(tmp_path):
    fr = pfr.enable(str(tmp_path))
    eng, _ = _port_engine()
    ids, labels = _batch()
    with pytest.raises(Exception):
        eng.step(ids, labels[:, :64])       # labels of another length
    with pytest.raises(Exception):
        eng.run_steps(ids, labels[:, :64], steps=2)
    reasons = [os.path.basename(d) for d in fr.dumps]
    assert any("train_step_exception" in r for r in reasons)
    assert any("run_steps_exception" in r for r in reasons)
    eng.step(ids, labels)
    rec = fr.records()[-1]
    assert rec["event"] == "train_step" and rec["step"] == 3 and rec["compiled"] is False


# ------------------------------------------------- checkpoint metrics, dumps

def _ckpt_script(eng, elastic, fr_mod, reg_mod, to, d, monkeypatch):
    """Async saves every 2 of 4 steps, a blocking save, a failed save, a
    flipped byte in the newest checkpoint walked past, and a rollback:
    the histogram counts and the dump reasons."""
    fr = fr_mod.enable(str(d / "flight"))
    reg_mod.enable()
    ids, labels = (to(a) for a in _batch())
    mgr = eng.enable_checkpointing(str(d / "ckpt"), interval=2, keep=5, async_save=True)
    for _ in range(5):
        eng.step(ids, labels)
    mgr.wait()
    mgr.save(eng, block=True)       # step 5
    with monkeypatch.context() as mp:
        mp.setattr(elastic, "write_checkpoint",
                   lambda *a, **k: (_ for _ in ()).throw(OSError("disk full")))
        with pytest.warns(UserWarning, match="save failed"), pytest.raises(OSError):
            mgr.save(eng, block=True)
    newest = elastic.checkpoint_path(str(d / "ckpt"), 5)
    payload = sorted(f for f in os.listdir(newest) if f.endswith(".npy"))[0]
    with open(os.path.join(newest, payload), "r+b") as f:
        f.seek(128)
        byte = f.read(1)
        f.seek(128)
        f.write(bytes([byte[0] ^ 0xFF]))
    with pytest.warns(UserWarning, match="corrupt"):
        assert mgr.restore(eng) == 4
    mgr.rollback_on_nonfinite = True
    with pytest.warns(UserWarning, match="rolled back"):
        assert mgr.on_step(eng, 5, float("nan")) == 4
    eng.disable_checkpointing()
    r = reg_mod.active_registry()
    counts = {h: r.histogram(h).snapshot()["count"]
              for h in ("ckpt.save_ms", "ckpt.capture_ms", "ckpt.overlap_ms")}
    names = [os.path.basename(p) for p in fr.dumps]
    return counts, {n: sum(n in x for x in names)
                    for n in ("ckpt_corrupt", "ckpt_save_failed", "ckpt_rollback")}


def test_checkpoint_histograms_and_dumps_match_the_jax_package(tmp_path, monkeypatch):
    jeng, jm = _jax_engine()
    peng, _ = _port_engine(_jax_state(jm))
    want = _ckpt_script(jeng, jelastic, jfr, jmetrics, paddle.to_tensor, tmp_path / "jax",
                        monkeypatch)
    got = _ckpt_script(peng, pelastic, pfr, pmetrics, lambda a: a, tmp_path / "port",
                       monkeypatch)
    assert got == want
    assert got == ({"ckpt.save_ms": 3, "ckpt.capture_ms": 3, "ckpt.overlap_ms": 2},
                   {"ckpt_corrupt": 2, "ckpt_save_failed": 1, "ckpt_rollback": 1})


# ------------------------------------------------------ dp 2: ZeRO and FSDP

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("obs")
    set_hybrid_communicate_group(None)
    paddle.seed(0)
    jm = JaxGPT(jax_gpt_tiny())
    for p in jm.parameters():
        p.dist_attr = None
    np.savez(d / "state.npz", **_jax_state(jm))
    spawn(OW.run_cases, args=(str(d), str(d / "state.npz")), nprocs=2, timeout=DEADLINE_S)
    return [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(2)], jm


def _assert_health_close(got, want):
    assert [r["step"] for r in got] == [r["step"] for r in want]
    for p, j in zip(got, want):
        assert p["nonfinite_count"] == j["nonfinite_count"] == 0
        for key in ("grad_norm", "weight_norm", "update_ratio"):
            np.testing.assert_allclose(p[key], j[key], rtol=RTOL, err_msg=key)
        for name, pp in p["per_param"].items():
            for key in ("grad_norm", "weight_norm", "update_ratio"):
                np.testing.assert_allclose(pp[key], j["per_param"][name][key], rtol=RTOL,
                                           err_msg=f"{name} {key}")


@pytest.mark.parametrize("case", ["zero", "fsdp"])
def test_sharded_health_equals_the_replicated_runs(ranks, case):
    (r0, r1), _ = ranks
    assert r0[case][f"{case}_engaged"]
    _assert_health_close(r0[case]["health"], r0["replicated"]["health"])
    assert r0[case]["health"] == r1[case]["health"]       # one all_reduce: both ranks
    np.testing.assert_allclose(r0[case]["losses"], r0["replicated"]["losses"], rtol=RTOL)


def test_replicated_health_at_dp2_matches_the_jax_engine(ranks):
    (r0, _), jm = ranks
    hcg = HybridCommunicateGroup(dp_degree=2, devices=jax.devices()[:2])
    opt = paddle.optimizer.SGD(learning_rate=OW.SGD_LR, parameters=jm.parameters())
    eng = JaxEngine(jm, opt, hcg=hcg)
    health = eng.enable_health(interval=1)
    ids, labels = (paddle.to_tensor(t.numpy()) for t in OW.W.batch())
    for _ in range(OW.STEPS):
        eng.step(ids, labels)
    _assert_health_close(r0["replicated"]["health"], health.recent())


def test_sharded_telemetry_carries_the_grad_comm_fields(ranks):
    (r0, _), _ = ranks
    z, f = r0["zero"]["telemetry"][-1], r0["fsdp"]["telemetry"][-1]
    rep = r0["replicated"]["telemetry"][-1]
    assert z["zero_update"] is True and z["microbatches"] == 1 and z["grad_comm_bytes"] > 0
    assert f["fsdp"] is True and f["fsdp_prefetch"] == 2
    assert f["fsdp_window_bytes"] == r0["fsdp"]["window_bytes"]
    assert "microbatches" not in rep and rep["samples"] == 8 and rep["tokens"] == 8 * 128
