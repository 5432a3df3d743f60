"""Pipeline and expert parallelism of the port (distributed/mesh.py's pp and
ep axes, distributed/pipeline_schedule.py, meta_parallel/pp_layers.py,
pipeline_parallel.py and moe.py, models/gpt.py's GPTForPretrainingPipe,
models/convert.py's stage shards, the engine's pp and ep step) against the
JAX package.

Three spawns of gloo ranks (2, 4 and 8; rank bodies in
tests/torch_pp_workers.py, torch on one intra-op thread) run every rank
case once; each test reads its case from the ranks' result files. The JAX
side runs the same weights (the JAX Pipe's state at one stage, its [1, L]
stacked leaves reshaped to each case's stages, which each port rank loads
as its stage and mp shards) and the same global batch (ids [8, 64] from
``RandomState(0)``, 4 pipeline micro-batches) on the 8 virtual CPU devices
of tests/conftest.py, its engine on a ``HybridCommunicateGroup`` of the
same degrees.

Bars: the schedule's arrays equal; the tanh pipelines (tests/
test_pipeline.py's) forward rtol 2e-5 and gradients rtol 1e-4 / atol 1e-5;
the Pipe eager at pp = 1, loss and logits rtol 2e-5; every engine case
AdamW losses (3 steps) rtol 1e-5 and SGD's parameters after 2 steps rtol
1e-5 (atol 1e-5 x max|p|: SGD shows a gradient factor that Adam's
normalisation hides; against the JAX engine at pp 2, whose step is one
function at every degree); checkpoints across pp rtol 1e-5; MoELayer's output
and every gradient rtol 1e-5 (atol 1e-6), ep 2 against ep 1 the same.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import torch_pp_workers as W
from paddle_tpu.distributed.engine import TrainStepEngine as JaxEngine
from paddle_tpu.distributed.mesh import HybridCommunicateGroup as JaxHCG
from paddle_tpu.distributed.mesh import set_hybrid_communicate_group as jax_set_hcg
from paddle_tpu.models import GPTConfig as JaxConfig
from paddle_tpu.models import GPTForPretrainingPipe as JaxPipe
from paddle_tpu_torch.distributed import spawn
from paddle_tpu_torch.distributed.meta_parallel.sequence_parallel import VirtualRing
from paddle_tpu_torch.distributed.pipeline_schedule import (_interleaved_schedule,
                                                            spmd_pipeline,
                                                            spmd_pipeline_interleaved)
from paddle_tpu_torch.models import (GPTConfig, GPTForPretraining, GPTForPretrainingPipe,
                                     gather_to_jax, gpt_state_from_pipe, load_jax_state,
                                     pipe_state_from_gpt, state_from_jax)

DEADLINE_S = 240     # each spawn; ~10 s alone


def _jax_pipe(hcg=None, stages=None, virtual=1, state=None):
    jax_set_hcg(hcg)
    paddle.seed(0)
    m = JaxPipe(JaxConfig(**W.CFG), num_stages=stages, num_microbatches=W.MICRO,
                num_virtual_stages=virtual)
    if state is not None:
        m.set_state_dict(W.stacked_state(state, m.num_stages, virtual))
    return m


@pytest.fixture(scope="module")
def state():
    try:
        return {n: np.asarray(v._data) for n, v in _jax_pipe(stages=1).state_dict().items()}
    finally:
        jax_set_hcg(None)


def _spawn(tmp_path_factory, state, world):
    d = tmp_path_factory.mktemp(f"pp{world}")
    np.savez(d / "state.npz", **state)
    spawn(W.run_world, args=(str(d), str(d / "state.npz"), world), nprocs=world,
          timeout=DEADLINE_S)
    ranks = [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(world)]
    ranks[0]["ckpt_dir"] = d / "ckpt_pp2"
    return ranks


@pytest.fixture(scope="module")
def ranks2(tmp_path_factory, state):
    return _spawn(tmp_path_factory, state, 2)


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory, state):
    return _spawn(tmp_path_factory, state, 4)


@pytest.fixture(scope="module")
def ranks8(tmp_path_factory, state):
    return _spawn(tmp_path_factory, state, 8)


_JAX = {}


def jax_run(state, degrees, virtual=1, rule="AdamW"):
    """The JAX engine's steps at ``degrees``: (losses, parameters)."""
    key = (tuple(sorted(degrees.items())), virtual, rule)
    if key not in _JAX:
        d = {a: degrees.get(f"{a}_degree", 1) for a in ("dp", "mp", "pp")}
        hcg = JaxHCG(dp_degree=d["dp"], mp_degree=d["mp"], pp_degree=d["pp"],
                     devices=jax.devices()[:d["dp"] * d["mp"] * d["pp"]])
        try:
            jm = _jax_pipe(hcg, virtual=virtual, state=state)
            if rule == "SGD":
                opt = paddle.optimizer.SGD(learning_rate=W.SGD_LR, parameters=jm.parameters())
            else:
                opt = paddle.optimizer.AdamW(learning_rate=W.LR, parameters=jm.parameters(),
                                             weight_decay=0.01)
            eng = JaxEngine(jm, opt, hcg=hcg)
            ids, labels = (paddle.to_tensor(t.numpy()) for t in W.batch())
            steps = W.SGD_STEPS if rule == "SGD" else W.STEPS
            losses = [float(eng.step(ids, labels).item()) for _ in range(steps)]
            params = {n: np.asarray(a) for n, a in eng.params.items()}
        finally:
            jax_set_hcg(None)
        _JAX[key] = (losses, params)
    return _JAX[key]


def assert_params_close(got, want):
    """Each parameter within rtol 1e-5; stacked leaves compared in layer
    order (the stage layouts of two degrees reshape into each other)."""
    for n in sorted(want):
        w = want[n]
        g = got[n].numpy().reshape(w.shape)
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5 * max(1.0, np.abs(w).max()),
                                   err_msg=n)


# ------------------------------------------------------------ the schedule

@pytest.mark.parametrize("P_,V,M", [(2, 2, 4), (4, 2, 8), (2, 4, 4), (4, 4, 8)])
def test_the_interleaved_schedule_is_the_jax_packages(P_, V, M):
    from paddle_tpu.distributed.pipeline_schedule import _interleaved_schedule as jax_sched

    got, T, slots = _interleaved_schedule(P_, V, M)
    want, T_w, slots_w = jax_sched(P_, V, M)
    assert (T, slots) == (T_w, slots_w) and T == M * V + P_ - 1
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def _jax_tanh(S, V):
    """JAX spmd_pipeline / spmd_pipeline_interleaved of the tanh stages over
    a pp mesh of S devices: [out, grad x, grad w, grad b] of sum(out ** 2)."""
    from jax.sharding import Mesh

    from paddle_tpu.distributed.pipeline_schedule import (
        spmd_pipeline as jsp, spmd_pipeline_interleaved as jspi)

    params, x = W.tanh_case(S=S, V=V)
    params = {n: jnp.asarray(a) for n, a in params.items()}
    x = jnp.asarray(x)
    if V > 1:
        mesh = Mesh(np.array(jax.devices()[:S]), ("pp",))

        def body(p, xb):
            return jnp.tanh(xb @ p["w"] + p["b"])

        def fn(p, x):
            return jspi(body, p, x, mesh, "pp", V)
    else:
        mesh = JaxHCG(pp_degree=S, dp_degree=1, devices=jax.devices()[:S]).mesh

        def body(lp, h):
            def one(h, layer):
                return jnp.tanh(h @ layer["w"] + layer["b"]), None
            return jax.lax.scan(one, h, lp)[0]

        def fn(p, x):
            return jsp(body, p, x, mesh, "pp")
    out = jax.jit(fn)(params, x)
    gp, gx = jax.jit(jax.grad(lambda p, x: (fn(p, x) ** 2).sum(), argnums=(0, 1)))(params, x)
    return [np.asarray(a) for a in (out, gx, gp["w"], gp["b"])]


def _check_tanh(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=2e-5, atol=2e-5)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("S,V", [(2, 1), (4, 1), (4, 2), (2, 4)])
def test_the_pipelines_over_a_virtual_ring_match_jax(S, V):
    params, x = W.tanh_case(S=S, V=V)
    p = {n: torch.from_numpy(a).requires_grad_() for n, a in params.items()}
    xt = torch.from_numpy(x).requires_grad_()
    if V > 1:
        y = spmd_pipeline_interleaved(W.tanh_body, p, xt, VirtualRing(S), V)
    else:
        y = spmd_pipeline(W.tanh_body, p, xt, VirtualRing(S))
    (y ** 2).sum().backward()
    _check_tanh([t.detach().numpy() for t in (y, xt.grad, p["w"].grad, p["b"].grad)],
                _jax_tanh(S, V))


@pytest.mark.parametrize("world,case,V", [(2, "plain", 1), (2, "v2", 2), (2, "v4", 4),
                                          (4, "plain", 1), (4, "v2", 2)])
def test_the_pipelines_over_gloo_ranks_match_jax(ranks2, ranks4, world, case, V):
    """Every rank holds the whole output and x's gradient; its stage slice
    of the parameters' gradients, concatenated over the ranks."""
    ranks = ranks2 if world == 2 else ranks4
    res = [r["tanh"][case] for r in ranks]
    want = _jax_tanh(world, V)
    dim = 1 if V > 1 else 0
    for r in res:
        _check_tanh([r["y"].numpy(), r["x"].numpy(), want[2], want[3]], want)
    _check_tanh([want[0], want[1]] + [torch.cat([r[n] for r in res], dim=dim).numpy()
                                      for n in ("w", "b")], want)


# ------------------------------------------------------------ the model

def test_the_pipe_at_pp_one_matches_the_jax_model(state):
    """GPTForPretrainingPipe eager at pp = 1 (one pass over the layers, the
    CPU's dense attention) against the JAX Pipe's eager fallback (its
    dense masked einsum), loss and logits; tied and at 2 stages x 2 chunks."""
    ids, labels = W.batch()
    for stages, virtual in ((1, 1), (2, 2)):
        try:
            jm = _jax_pipe(stages=stages, virtual=virtual, state=state)
            jids, jlabels = paddle.to_tensor(ids.numpy()), paddle.to_tensor(labels.numpy())
            j_loss = float(jm(jids, jlabels).item())
            j_logits = np.asarray(jm(jids).numpy())
        finally:
            jax_set_hcg(None)
        m = GPTForPretrainingPipe(GPTConfig(**W.CFG), num_stages=stages,
                                  num_microbatches=W.MICRO, num_virtual_stages=virtual,
                                  device="cpu")
        m = load_jax_state(m, W.stacked_state(state, stages, virtual))
        np.testing.assert_allclose(m(ids, labels).item(), j_loss, rtol=2e-5)
        np.testing.assert_allclose(m(ids).detach().numpy(), j_logits, rtol=2e-5, atol=2e-5)


def test_the_pipe_is_gpt_for_pretraining_on_the_same_weights():
    """pipe_state_from_gpt / gpt_state_from_pipe round-trip bit for bit;
    the Pipe at pp = 1 and through a VirtualRing of its stages gives
    GPTForPretraining's loss and (mapped back) its gradients."""
    cfg = GPTConfig(**W.CFG)
    g = GPTForPretraining(cfg, device="cpu", seed=3)
    gsd = {k: v.detach() for k, v in g.state_dict().items()}
    ids, labels = W.batch()
    loss = g(ids, labels)
    loss.backward()
    for stages, virtual in ((1, 1), (2, 1), (4, 1), (2, 2)):
        st = pipe_state_from_gpt(gsd, stages, virtual)
        back = gpt_state_from_pipe(st, virtual)
        assert back.keys() == gsd.keys()
        assert all(torch.equal(back[k], gsd[k]) for k in gsd)
        pipe = GPTForPretrainingPipe(cfg, num_stages=stages, num_microbatches=W.MICRO,
                                     num_virtual_stages=virtual, device="cpu")
        pipe.load_state_dict(st)
        for ring in (None, VirtualRing(stages)):
            pipe.pipeline_ring = ring
            pipe.zero_grad()
            got = pipe(ids, labels)
            got.backward()
            np.testing.assert_allclose(got.item(), loss.item(), rtol=2e-6)
            grads = gpt_state_from_pipe({n: p.grad for n, p in pipe.named_parameters()},
                                        virtual)
            for n, p in g.named_parameters():
                np.testing.assert_allclose(grads[n].numpy(), p.grad.numpy(), rtol=1e-4,
                                           atol=1e-6, err_msg=n)


@pytest.mark.parametrize("granularity", ["full", "selective"])
def test_the_pipe_recomputes_each_block_through_the_schedule(granularity):
    """use_recompute checkpoints each block inside the schedule's ticks: the
    replays in the hand-driven backward give the run without recompute's
    loss and gradients."""
    cfg = dict(W.CFG)
    ids, labels = W.batch()
    runs = []
    for recompute in (False, True):
        m = GPTForPretrainingPipe(GPTConfig(use_recompute=recompute,
                                            recompute_granularity=granularity, **cfg),
                                  num_stages=2, num_microbatches=W.MICRO,
                                  num_virtual_stages=2, device="cpu", seed=4)
        m.pipeline_ring = VirtualRing(2)
        loss = m(ids, labels)
        loss.backward()
        runs.append((loss.item(), {n: p.grad for n, p in m.named_parameters()}))
    (l0, g0), (l1, g1) = runs
    np.testing.assert_allclose(l1, l0, rtol=1e-6)
    for n in g0:
        np.testing.assert_allclose(g1[n].numpy(), g0[n].numpy(), rtol=1e-5, atol=1e-7,
                                   err_msg=n)


def test_the_pipe_refuses_dropout_with_the_jax_message():
    with pytest.raises(ValueError, match="does not support dropout yet"):
        GPTForPretrainingPipe(GPTConfig(**{**W.CFG, "dropout": 0.1}), device="cpu")
    with pytest.raises(ValueError, match="not divisible by pp x virtual"):
        GPTForPretrainingPipe(GPTConfig(**W.CFG), num_stages=3, device="cpu")


@pytest.mark.parametrize("pp,mp,virtual", [(2, 1, 1), (2, 2, 1), (4, 2, 1), (2, 2, 2)])
def test_convert_round_trips_stage_and_mp_shards_bit_for_bit(state, pp, mp, virtual):
    full = W.stacked_state(state, pp, virtual)
    shards = [state_from_jax(full, m, mp, p, pp, virtual) for p in range(pp)
              for m in range(mp)]
    back = gather_to_jax(shards, mp, virtual)
    assert back.keys() == full.keys()
    for n, a in full.items():
        assert back[n].dtype == a.dtype and np.array_equal(back[n], a), n
    # rank (p, m)'s qkv: its stage's layers, its heads of q, of k and of v
    w = full["qkv_w"]
    h, nh = w.shape[-2], W.CFG["num_heads"]
    for p in range(pp):
        for m in range(mp):
            got = shards[p * mp + m]["qkv_w"].numpy()
            stage = w[:, p:p + 1] if virtual > 1 else w[p:p + 1]
            heads = stage.reshape(stage.shape[:-1] + (3, nh, h // nh))
            want = heads[..., m * nh // mp:(m + 1) * nh // mp, :]
            np.testing.assert_array_equal(got, want.reshape(stage.shape[:-1] + (-1,)))


# ------------------------------------------------------------ the engine

ENGINE_CASES = [("pp2", 2, {"pp_degree": 2}, 1), ("pp2v2", 2, {"pp_degree": 2}, 2),
                ("pp4", 4, {"pp_degree": 4}, 1),
                ("pp2dp2", 4, {"pp_degree": 2, "dp_degree": 2}, 1),
                ("dp2mp2pp2", 8, {"dp_degree": 2, "mp_degree": 2, "pp_degree": 2}, 1)]


def _world(world, ranks2, ranks4, ranks8):
    return {2: ranks2, 4: ranks4, 8: ranks8}[world]


@pytest.mark.parametrize("case,world,degrees,virtual", ENGINE_CASES)
def test_adamw_losses_match_the_jax_engine(state, ranks2, ranks4, ranks8, case, world,
                                           degrees, virtual):
    ranks = _world(world, ranks2, ranks4, ranks8)
    losses, _ = jax_run(state, degrees, virtual)
    got = ranks[0][f"{case}_adamw"]["losses"]
    np.testing.assert_allclose(got, losses, rtol=1e-5)
    assert all(r[f"{case}_adamw"]["losses"] == got for r in ranks)
    assert got[-1] < got[0]


@pytest.mark.parametrize("case,world,degrees,virtual", ENGINE_CASES)
def test_sgd_parameters_match_the_jax_engine(state, ranks2, ranks4, ranks8, case, world,
                                             degrees, virtual):
    ranks = _world(world, ranks2, ranks4, ranks8)
    key = f"{case}_sgd"
    # the JAX engine at pp 2 (its step is one function at every degree; the
    # AdamW cases run it at each case's own)
    losses, params = jax_run(state, {"pp_degree": 2}, virtual, rule="SGD")
    np.testing.assert_allclose(ranks[0][key]["losses"], losses, rtol=1e-5)
    assert_params_close(ranks[0][key]["params"], params)


def test_the_interleaved_pipe_under_dp_mp_matches_the_plain_one(ranks8):
    """dp 2 x mp 2 x pp 2 at V = 2 takes the V = 1 run's losses (the JAX
    package's test_gpt_pipe_interleaved_trains_identically)."""
    np.testing.assert_allclose(ranks8[0]["dp2mp2pp2v2_adamw"]["losses"],
                               ranks8[0]["dp2mp2pp2_adamw"]["losses"], rtol=1e-5)


def test_zero_and_microbatches_compose_with_pp(ranks4):
    """ZeRO over the replica group at pp 2 x dp 2 is the replicated update
    bit for bit; with 2 engine microbatches of 2 pipeline micro-batches
    each, the losses at rtol 1e-5 and the weights within 5 x lr."""
    rep, zero, k2 = (ranks4[0][c] for c in ("pp2dp2_adamw", "pp2dp2_zero", "pp2dp2_zero_k2"))
    assert zero["zero"] and k2["zero"] and not rep["zero"]
    assert zero["losses"] == rep["losses"]
    assert all(torch.equal(zero["params"][n], rep["params"][n]) for n in rep["params"])
    np.testing.assert_allclose(k2["losses"], rep["losses"], rtol=1e-5)
    for n, p in rep["params"].items():
        np.testing.assert_allclose(k2["params"][n].numpy(), p.numpy(), atol=5 * W.LR,
                                   rtol=0, err_msg=n)


@pytest.mark.parametrize("case", ["pp2mp2_clip", "pp2dp2_zero_clip"])
def test_the_global_norm_clip_counts_stage_and_mp_shards_once(ranks4, case):
    """ClipGradByGlobalNorm(0.5) at pp 2 x mp 2 (replicated) and pp 2 x dp 2
    (ZeRO) against dp 4, where every rank holds every stage whole."""
    got, want = ranks4[0][case], ranks4[0]["dp4_clip"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    for n, p in want["params"].items():   # [2, 2, ...] stages against [1, 4, ...]
        np.testing.assert_allclose(got["params"][n].numpy().reshape(p.shape), p.numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=n)


def test_a_pp_run_resumes_at_pp_one(ranks2, state):
    """The pp 2 run's gathered state (after 3 steps) in a pp = 1 engine
    (the Pipe holding both stages) takes the next steps as the pp run did;
    set_state_dict gives the pp ranks their stages back bit for bit."""
    from paddle_tpu_torch.distributed import TrainStepEngine
    from paddle_tpu_torch.optimizer import AdamW

    mine = ranks2[0]["pp2_adamw"]
    assert all(r["pp2_adamw"]["set_state_dict_same"] for r in ranks2)
    assert tuple(mine["state"]["model"]["qkv_w"].shape[:2]) == (2, 2)
    m = GPTForPretrainingPipe(GPTConfig(**W.CFG), num_stages=2, num_microbatches=W.MICRO,
                              device="cpu")
    eng = TrainStepEngine(m, AdamW(learning_rate=W.LR, parameters=m.named_parameters(),
                                   weight_decay=0.01))
    eng.set_state_dict(mine["state"])
    assert eng._step_count == W.STEPS
    ids, labels = W.batch()
    resumed = [eng.step(ids, labels).item() for _ in range(W.RESUME_STEPS)]
    np.testing.assert_allclose(resumed, mine["resumed"], rtol=1e-5)


def test_a_pp_checkpoint_resumes_at_pp_one_and_in_the_jax_package(ranks2, state):
    """The pp 2 run's checkpoint (the logical [S, Lp, ...] tensors, written
    by rank 0) restores into a pp = 1 port engine and into the JAX engine;
    both take the next steps as the pp run did."""
    from paddle_tpu.distributed import elastic as jelastic
    from paddle_tpu_torch.distributed import TrainStepEngine, elastic
    from paddle_tpu_torch.optimizer import AdamW

    ckpt = str(ranks2[0]["ckpt_dir"])
    want = ranks2[0]["pp2_adamw"]["resumed"]
    ids, labels = W.batch()
    m = GPTForPretrainingPipe(GPTConfig(**W.CFG), num_stages=2, num_microbatches=W.MICRO,
                              device="cpu", seed=9)
    eng = TrainStepEngine(m, AdamW(learning_rate=W.LR, parameters=m.named_parameters(),
                                   weight_decay=0.01))
    assert elastic.restore_latest(eng, ckpt) == W.STEPS
    got = [eng.step(ids, labels).item() for _ in range(W.RESUME_STEPS)]
    np.testing.assert_allclose(got, want, rtol=1e-5)

    hcg = JaxHCG(dp_degree=1, devices=jax.devices()[:1])
    try:
        jm = _jax_pipe(hcg, stages=2)
        je = JaxEngine(jm, paddle.optimizer.AdamW(learning_rate=W.LR,
                                                  parameters=jm.parameters(),
                                                  weight_decay=0.01), hcg=hcg)
        assert jelastic.restore_latest(je, ckpt) == W.STEPS
        jids, jlabels = (paddle.to_tensor(t.numpy()) for t in (ids, labels))
        got = [float(je.step(jids, jlabels).item()) for _ in range(W.RESUME_STEPS)]
    finally:
        jax_set_hcg(None)
    np.testing.assert_allclose(got, want, rtol=1e-5)


# ------------------------------------------------------------ the layers

def test_pipeline_layer_segments_as_the_jax_package():
    from paddle_tpu.distributed.meta_parallel import LayerDesc as JLayerDesc
    from paddle_tpu.distributed.meta_parallel import PipelineLayer as JPipelineLayer
    from paddle_tpu_torch.distributed.meta_parallel import LayerDesc, PipelineLayer

    def jdescs():
        return [JLayerDesc(paddle.nn.Linear, 8, 8 * (1 + i % 3)) if i % 4 else
                JLayerDesc(paddle.nn.ReLU) for i in range(10)]

    def tdescs():
        return [LayerDesc(torch.nn.Linear, 8, 8 * (1 + i % 3)) if i % 4 else
                LayerDesc(torch.nn.ReLU) for i in range(10)]

    for method in ("uniform", "layer:Linear", "layer:ReLU", "param_size"):
        for stages in (2, 3, 4):
            want = JPipelineLayer(jdescs(), num_stages=stages, seg_method=method)
            got = PipelineLayer(tdescs(), num_stages=stages, seg_method=method)
            assert got.segment_parts == want.segment_parts, (method, stages)
            assert [len(got.get_stage_layers(s)) for s in range(stages)] == [
                len(want.get_stage_layers(s)) for s in range(stages)]


def test_pipeline_parallel_train_batch_matches_one_batch_and_the_jax_facade():
    """accumulate_steps 4: the facade's loss and weights after one SGD step
    against one big batch (the port) and the JAX package's facade."""
    from paddle_tpu.distributed import DistributedStrategy as JStrategy
    from paddle_tpu.distributed.meta_parallel import LayerDesc as JLayerDesc
    from paddle_tpu.distributed.meta_parallel import PipelineLayer as JPipelineLayer
    from paddle_tpu.distributed.meta_parallel import PipelineParallel as JPipelineParallel
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.meta_parallel import (LayerDesc, PipelineLayer,
                                                            PipelineParallel)

    rng = np.random.RandomState(3)
    x = rng.randn(8, 8).astype(np.float32)
    y = rng.randint(0, 4, (8, 1)).astype(np.int64)
    paddle.seed(7)
    jm = JPipelineLayer([JLayerDesc(paddle.nn.Linear, 8, 16), JLayerDesc(paddle.nn.ReLU),
                         JLayerDesc(paddle.nn.Linear, 16, 4)], num_stages=1,
                        loss_fn=paddle.nn.CrossEntropyLoss())
    init = [np.asarray(p.numpy()) for p in jm.parameters()]
    js = JStrategy()
    js.pipeline_configs.accumulate_steps = 4
    jopt = paddle.optimizer.SGD(learning_rate=0.1, parameters=jm.parameters())
    j_loss = float(JPipelineParallel(jm, strategy=js).train_batch(
        (paddle.to_tensor(x), paddle.to_tensor(y)), jopt).item())

    def ce(out, label):
        return torch.nn.functional.cross_entropy(out, label.reshape(-1))

    def model():
        m = PipelineLayer([LayerDesc(torch.nn.Linear, 8, 16), LayerDesc(torch.nn.ReLU),
                           LayerDesc(torch.nn.Linear, 16, 4)], num_stages=1, loss_fn=ce)
        with torch.no_grad():   # the JAX Linear's [in, out] weights, transposed
            for p, a in zip(m.parameters(), init):
                p.copy_(torch.from_numpy(np.array(a.T if a.ndim == 2 else a)))
        return m

    s = fleet.DistributedStrategy()
    s.pipeline_configs.accumulate_steps = 4
    m1, m2 = model(), model()
    opt1 = optimizer.SGD(learning_rate=0.1, parameters=m1.named_parameters())
    loss_pp = PipelineParallel(m1, strategy=s).train_batch(
        (torch.from_numpy(x), torch.from_numpy(y)), opt1)
    opt2 = optimizer.SGD(learning_rate=0.1, parameters=m2.named_parameters())
    loss_ref = m2.loss(m2(torch.from_numpy(x)), torch.from_numpy(y))
    loss_ref.backward()
    opt2.step()
    np.testing.assert_allclose(loss_pp.item(), loss_ref.item(), rtol=1e-5)
    np.testing.assert_allclose(loss_pp.item(), j_loss, rtol=1e-5)
    for p1, p2, pj in zip(m1.parameters(), m2.parameters(), jm.parameters()):
        np.testing.assert_allclose(p1.detach().numpy(), p2.detach().numpy(), rtol=1e-5,
                                   atol=1e-6)
        a = np.asarray(pj.numpy())
        np.testing.assert_allclose(p1.detach().numpy(), a.T if a.ndim == 2 else a,
                                   rtol=1e-5, atol=1e-6)


def _jax_moe(k, cf, act="gelu"):
    from paddle_tpu.distributed.meta_parallel import MoELayer as JMoE

    paddle.seed(0)
    jm = JMoE(top_k=k, capacity_factor=cf, activation=act, **W.MOE)
    x, y = W.moe_inputs()
    jx = paddle.to_tensor(x, stop_gradient=False)
    out = jm(jx)
    (out * paddle.to_tensor(y)).sum().backward()
    grads = {"moe.gate.gate.weight": jm.gate.gate.weight.grad.numpy().T,
             "moe.gate.gate.bias": jm.gate.gate.bias.grad.numpy(),
             **{f"moe.experts.{n}": getattr(jm.experts, n).grad.numpy()
                for n in ("w1", "b1", "w2", "b2")}}
    state = {"moe.gate.gate.weight": jm.gate.gate.weight.numpy().T,
             "moe.gate.gate.bias": jm.gate.gate.bias.numpy(),
             **{f"moe.experts.{n}": getattr(jm.experts, n).numpy()
                for n in ("w1", "b1", "w2", "b2")}}
    return state, np.asarray(out.numpy()), jx.grad.numpy(), grads


@pytest.mark.parametrize("k,cf,act", [(1, 2.0, "gelu"), (2, 2.0, "gelu"), (2, 0.5, "relu"),
                                      (2, 1.25, "silu")])
def test_moe_layer_matches_the_jax_layer(k, cf, act):
    """Forward and every gradient of sum(out * y) on the same weights; at
    capacity factor 0.5 tokens overflow their experts' capacity."""
    state, out, gx, grads = _jax_moe(k, cf, act)
    net = W.MoENet(k, cf)
    net.moe.experts.act = act
    net.load_state_dict({n: torch.from_numpy(np.array(a)) for n, a in state.items()})
    x, y = (torch.from_numpy(a) for a in W.moe_inputs())
    x.requires_grad_()
    got = net.moe(x)
    (got * y).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), out, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), gx, rtol=1e-5, atol=1e-6)
    for n, p in net.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), grads[n], rtol=1e-5, atol=1e-6, err_msg=n)
    if cf < 1:
        cap = net.moe.capacity(x.shape[0] * x.shape[1])
        dispatch, _ = net.moe.routing(net.moe.gate(x.detach().reshape(-1, 16)), cap)
        assert dispatch.sum() < k * x.shape[0] * x.shape[1]   # some choices dropped
        assert dispatch.sum(dim=0).max() <= 1                 # one token a slot


@pytest.mark.parametrize("k,cf", [(1, 2.0), (2, 2.0), (2, 0.5)])
def test_moe_at_ep_two_equals_ep_one(ranks2, k, cf):
    torch.manual_seed(0)
    net = W.MoENet(k, cf)
    x, y = (torch.from_numpy(a) for a in W.moe_inputs())
    x.requires_grad_()
    out = net.moe(x)
    (out * y).sum().backward()
    per = W.MOE["num_experts"] // 2
    for r, res in enumerate(ranks2):
        got = res["moe"][(k, cf)]
        np.testing.assert_allclose(got["y"].numpy(), out.detach().numpy(), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(got["x"].numpy(), x.grad.numpy(), rtol=1e-5, atol=1e-6)
        for n, p in net.named_parameters():
            want = p.grad[r * per:(r + 1) * per] if ".experts." in n else p.grad
            np.testing.assert_allclose(got[n].numpy(), want.numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=n)


def test_the_moe_engine_step_at_ep_two_equals_ep_one(ranks2):
    from paddle_tpu_torch.distributed import TrainStepEngine

    torch.manual_seed(0)
    net = W.MoENet(2, 1.0)
    eng = TrainStepEngine(net, W._optimizer(net, "SGD"))
    x, y = (torch.from_numpy(a) for a in W.moe_inputs())
    losses = [eng.step(x, y).item() for _ in range(W.SGD_STEPS)]
    got = ranks2[0]["moe"]["engine"]
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    for n, p in net.named_parameters():
        np.testing.assert_allclose(got["params"][n].numpy(), p.detach().numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=n)


# ------------------------------------------------------------ topology

def test_the_topology_of_each_world(ranks2, ranks4, ranks8):
    t2 = [r["topology"] for r in ranks2]
    assert [t["pp_group"] for t in t2] == [[0, 1], [0, 1]]
    assert [t["stage"] for t in t2] == [0, 1] and t2[0]["mode"] == "pipeline"
    assert [t["replica_group"] for t in t2] == [[0], [1]]
    t4 = [r["topology"] for r in ranks4]   # pp 2 x dp 2: rank = pp_i * 2 + dp_i
    assert [t["pp_group"] for t in t4] == [[0, 2], [1, 3], [0, 2], [1, 3]]
    assert [t["replica_group"] for t in t4] == [[0, 1], [0, 1], [2, 3], [2, 3]]
    t8 = [r["topology"] for r in ranks8]
    # rank = (pp_i * dp + dp_i) * mp + mp_i
    assert t8[5]["pp_group"] == [1, 5] and t8[5]["mp_group"] == [4, 5]
    assert t8[5]["dp_group"] == [5, 7] and t8[5]["replica_group"] == [5, 7]
    assert [t["stage"] for t in t8] == [0, 0, 0, 0, 1, 1, 1, 1]


def test_what_still_raises_at_pp_names_item_11(ranks2):
    refused = ranks2[0]["refusals"]
    assert set(refused) == {"health", "bf16", "fsdp", "clip_by_norm", "distributed_model"}
    for name in ("health", "bf16", "fsdp", "clip_by_norm"):
        assert refused[name] is not None and "item 11" in refused[name], name
    assert "requires a PipelineLayer or a pipeline-stacked model" in refused[
        "distributed_model"]
