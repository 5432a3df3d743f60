"""The eager data-parallel entry points of the port (fleet.distributed_model
-> DataParallel and its bucketed Reducer, fleet.distributed_optimizer -> the
meta-optimizer chain and HybridParallelOptimizer, group_sharded_parallel,
save / load, the engine's strategy.amp and offload) against the JAX package.

Single-process cases hold each piece against its JAX counterpart on the
same inputs: the Reducer's bucket layout (exact), the StrategyCompiler's
selection, order and conflicts (exact), the Lamb and Lars swaps over 3
steps of a small MLP (rtol 1e-5), gradient merge against JAX's and the big
batch (rtol 1e-5), DGC's masks and residuals and FP16AllReduce's rounding
(exact, f32), the AMP meta's fp16 scale contract (rtol 1e-5), the Stage3
segment_size marks, group_sharded_parallel's returns, DataParallel's API,
the engine under strategy.amp (bit for bit the engine under the same
auto_cast; losses within the bf16 bar, rtol 1e-2, of the JAX engine's
traced amp), offload (the same bits, state on the CPU) and save / load
across the packages (exact, bf16 included).

Two gloo ranks (tests/torch_fleet_workers.py, spawned once for every case)
run gpt_tiny through the entry points on their halves of the global ids
[8, 128]; the JAX package's eager step on the global batch (or on each
half, for LocalSGD) is the oracle. Bars: losses rtol 2e-5; SGD parameters
within 2e-5 x max(1, max|want|) of each tensor; AdamW parameters under
tests/test_torch_accum.py's rule (atol 5 x lr, at most 0.1% of the entries
more than 1e-5 apart: Adam moves an entry by about lr where a gradient
within rounding of 0 takes the other sign); gradients of the unused-branch
case rtol 2e-5 (atol 1e-7).
"""
import types

import jax
import ml_dtypes
import numpy as np
import pytest
import torch
import torch.distributed as tdist

import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
import paddle_tpu.nn as jnn
import torch_fleet_workers as W
from paddle_tpu.distributed.engine import TrainStepEngine as JaxEngine
from paddle_tpu.distributed.fleet import meta_optimizers as jmeta
from paddle_tpu.distributed.mesh import (HybridCommunicateGroup,
                                         set_hybrid_communicate_group)
from paddle_tpu.distributed.meta_parallel import data_parallel as jdp
from paddle_tpu.distributed.meta_parallel import sharding as jsharding
from paddle_tpu.models import GPTForPretraining as JaxGPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
import paddle_tpu_torch as P
from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch.amp import auto_cast
from paddle_tpu_torch.distributed import TrainStepEngine, fleet, spawn
from paddle_tpu_torch.distributed import mesh as pmesh
from paddle_tpu_torch.distributed.fleet import meta_optimizers as pmeta
from paddle_tpu_torch.distributed.meta_parallel import data_parallel as pdp
from paddle_tpu_torch.distributed.meta_parallel import sharding as psharding
from paddle_tpu_torch.models import GPTForPretraining, GPTConfig, gpt_tiny, load_jax_state
from paddle_tpu_torch.models import state_from_jax

DEADLINE_S = 240        # the group of 2 ranks, every case (~12 s)
RTOL = 1e-5             # single-process trajectories against JAX
RANK_TOL = 2e-5         # the 2-rank runs against the JAX oracles


# ---------------------------------------------------------------- helpers
class FakeHcg:
    """What the compilers read of a topology: the dp world size."""

    def __init__(self, dp):
        self.dp = dp

    def get_data_parallel_world_size(self):
        return self.dp


def _strategies():
    """name -> (flags, configs) of the compiler cases."""
    return {
        "default": ({}, {}),
        "amp_gm_localsgd": ({"amp": True, "gradient_merge": True, "localsgd": True},
                            {"gradient_merge_configs": {"k_steps": 4}}),
        "localsgd_dgc": ({"localsgd": True, "dgc": True}, {}),
        "dgc_fp16": ({"dgc": True, "fp16_allreduce": True}, {}),
        "sharding_only": ({"sharding": True, "without_graph_optimization": False}, {}),
        "recompute": ({"recompute": True}, {}),
        "gm_k1": ({"gradient_merge": True}, {}),
        "lamb": ({"lamb": True}, {}),
        "lars": ({"lars": True}, {}),
        "everything": ({k: True for k in ("amp", "recompute", "gradient_merge", "sharding",
                                          "dgc", "localsgd", "lars", "lamb",
                                          "fp16_allreduce")},
                       {"gradient_merge_configs": {"k_steps": 2}}),
    }


def _make_strategy(mod, name):
    flags, cfgs = _strategies()[name]
    s = mod.DistributedStrategy()
    for k, v in {**flags, **cfgs}.items():
        setattr(s, k, v)
    return s


def _mlp_weights(seed=0):
    """The MLP's weights in the JAX layout (Linear [in, out])."""
    rs = np.random.RandomState(seed)
    return [rs.randn(8, 16).astype(np.float32) * 0.3, rs.randn(16).astype(np.float32) * 0.1,
            rs.randn(16, 1).astype(np.float32) * 0.3, rs.randn(1).astype(np.float32) * 0.1]


def _mlp_pair(seed=0):
    """The JAX MLP (Linear 8 -> 16, ReLU, Linear 16 -> 1) and the port's,
    from the same weights."""
    w = _mlp_weights(seed)
    jnet = jnn.Sequential(jnn.Linear(8, 16), jnn.ReLU(), jnn.Linear(16, 1))
    tnet = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.ReLU(),
                               torch.nn.Linear(16, 1))
    for jp, tp, a in zip(jnet.parameters(), tnet.parameters(), w):
        jp.set_value(a)
        with torch.no_grad():
            tp.copy_(torch.from_numpy(a.T.copy() if a.ndim == 2 else a))
    return jnet, tnet


def _data(seed=0, n=32):
    rs = np.random.RandomState(seed)
    return rs.rand(n, 8).astype(np.float32), (rs.rand(n, 1) > 0.5).astype(np.float32)


def _jax_loss(net, x, y):
    return ((net(paddle.to_tensor(x)) - paddle.to_tensor(y)) ** 2).mean()


def _port_loss(net, x, y):
    return ((net(torch.from_numpy(x)) - torch.from_numpy(y)) ** 2).mean()


def _jax_params_port_layout(jnet):
    return [np.asarray(p._data).T if p._data.ndim == 2 else np.asarray(p._data)
            for p in jnet.parameters()]


def _assert_mlp_close(tnet, jnet, rtol=RTOL, atol=1e-7):
    for tp, jp in zip(tnet.parameters(), _jax_params_port_layout(jnet)):
        np.testing.assert_allclose(tp.detach().numpy(), jp, rtol=rtol, atol=atol)


def _inner(opt):
    while hasattr(opt, "_inner_opt"):
        opt = opt._inner_opt
    return opt


@pytest.fixture
def deterministic():
    """The CPU embedding backward in one order, so two runs repeat bit for
    bit."""
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(prev)


@pytest.fixture
def world_one():
    """fleet.init at world 1 on the CPU in this process, undone afterwards
    (the process group, the topology and the fleet singleton)."""
    yield
    pmesh.set_hybrid_communicate_group(None)
    fleet.fleet.__init__()
    if tdist.is_initialized():
        tdist.destroy_process_group()


# ---------------------------------------------------------------- Reducer
def _layouts(shapes_dtypes, cap, last):
    """Bucket layouts of both packages' Reducers over the same parameters:
    lists of (parameter indices, dtype name) per bucket."""
    jparams = [types.SimpleNamespace(
        _data=types.SimpleNamespace(nbytes=int(np.prod(s)) * np.dtype(d).itemsize,
                                    dtype=np.dtype(d)),
        size=int(np.prod(s)), stop_gradient=False) for s, d in shapes_dtypes]
    tparams = [torch.empty(s, dtype=getattr(torch, d), device="meta", requires_grad=True)
               for s, d in shapes_dtypes]
    jred = jdp.Reducer(jparams, group=types.SimpleNamespace(nranks=2),
                       comm_buffer_size=cap, last_comm_buffer_size=last)
    tred = pdp.Reducer(tparams, group=types.SimpleNamespace(nranks=2),
                       comm_buffer_size=cap, last_comm_buffer_size=last)
    jidx = {id(p): i for i, p in enumerate(jparams)}
    tidx = {id(p): i for i, p in enumerate(tparams)}
    jl = [([jidx[id(p)] for p in b], str(b[0]._data.dtype)) for b in jred._buckets]
    tl = [([tidx[id(p)] for p in b], str(b[0].dtype).replace("torch.", ""))
          for b in tred._buckets]
    return jl, tl


def _gpt_shapes(cfg):
    with torch.device("meta"):
        m = GPTForPretraining.__new__(GPTForPretraining)
        torch.nn.Module.__init__(m)
        from paddle_tpu_torch.models.gpt import GPTModel

        m.gpt = GPTModel(cfg)
    return [(tuple(p.shape), "float32") for p in m.parameters()]


@pytest.mark.parametrize("case", ["mixed_dtypes", "gpt_tiny", "gpt2_124m"])
def test_the_reducers_bucket_layout_is_the_jax_packages(case):
    if case == "mixed_dtypes":   # tests/test_reducer.py:38's parameters and caps
        sd = [((256, 1024), "float32")] * 6 + [((4,), "float16")]
        cap, last = 2, 1
    else:
        sd = _gpt_shapes(gpt_tiny() if case == "gpt_tiny" else GPTConfig())
        cap, last = 25, 1
    jl, tl = _layouts(sd, cap, last)
    assert tl == jl
    assert sorted(i for b, _ in tl for i in b) == list(range(len(sd)))
    if case == "mixed_dtypes":
        assert any(d == "float16" and len(b) == 1 for b, d in tl)
    if case == "gpt2_124m":
        # the tied embedding (50304 x 768 f32, 154.5 MB) is a bucket alone
        wte = [i for i, (s, _) in enumerate(sd) if s == (50304, 768)]
        assert [b for b, _ in tl if wte[0] in b] == [wte]
        assert 15 <= len(tl) <= 25, len(tl)


# ---------------------------------------------------------------- compiler
@pytest.mark.parametrize("dp", [1, 2])
@pytest.mark.parametrize("name", sorted(_strategies()))
def test_the_strategy_compiler_selects_orders_and_chains_as_jax(name, dp):
    for rule in ("Adam", "SGD", "Momentum"):
        jnet, tnet = _mlp_pair()
        jopt = getattr(paddle.optimizer, rule)(learning_rate=0.01,
                                               parameters=jnet.parameters())
        topt = getattr(popt, rule)(learning_rate=0.01, parameters=tnet.named_parameters())
        hcg = FakeHcg(dp)
        jfinal, japplied = jmeta.StrategyCompiler().compile(
            jopt, _make_strategy(jdist, name), hcg)
        tfinal, tapplied = pmeta.StrategyCompiler().compile(
            topt, _make_strategy(fleet, name), hcg)
        assert tapplied == japplied, (rule, tapplied, japplied)
        jchain = getattr(jfinal, "applied_meta_list", [])
        assert getattr(tfinal, "applied_meta_list", []) == jchain
        assert (getattr(tfinal, "_handles_dp_sync", False)
                == getattr(jfinal, "_handles_dp_sync", False))
        assert _inner(tfinal)._rule == _inner(jfinal)._rule
        if _inner(tfinal)._rule == "lars":
            assert isinstance(_inner(tfinal), popt.Lars)
            assert _inner(tfinal)._hyper["momentum"] == 0.9
        if _inner(tfinal)._rule == "lamb":
            assert isinstance(_inner(tfinal), popt.Lamb)


# ---------------------------------------------------------------- swaps
@pytest.mark.parametrize("exclude", [[], ["bias"], [""]])
@pytest.mark.parametrize("swap", ["lamb", "lars"])
def test_the_rule_swaps_step_as_jax_over_3_steps(swap, exclude):
    """Both swaps match their exclude strings against the parameter's name
    attribute, "" here in both packages (no ParamAttr names): "bias", which
    the port's own parameter names contain, excludes nothing, and ""
    excludes every parameter, in both."""
    jnet, tnet = _mlp_pair()
    rule = "Adam" if swap == "lamb" else "SGD"
    jopt = getattr(paddle.optimizer, rule)(learning_rate=0.05, parameters=jnet.parameters())
    topt = getattr(popt, rule)(learning_rate=0.05, parameters=tnet.named_parameters())
    strategies = []
    for mod in (jdist, fleet):
        s = mod.DistributedStrategy()
        setattr(s, swap, True)
        cfg = {"exclude_from_weight_decay": list(exclude)}
        if swap == "lars":
            cfg.update(lars_coeff=0.1, lars_weight_decay=0.01)
        else:
            cfg.update(lamb_weight_decay=0.1)
        setattr(s, f"{swap}_configs", cfg)
        strategies.append(s)
    jfinal, _ = jmeta.StrategyCompiler().compile(jopt, strategies[0])
    tfinal, tapplied = pmeta.StrategyCompiler().compile(topt, strategies[1])
    assert tapplied[0] == swap and _inner(tfinal)._rule == swap
    x, y = _data()
    for _ in range(3):
        jl = _jax_loss(jnet, x, y)
        jl.backward()
        jfinal.step()
        jfinal.clear_grad()
        tl = _port_loss(tnet, x, y)
        tl.backward()
        tfinal.step()
        tfinal.clear_grad()
        np.testing.assert_allclose(tl.item(), float(jl.item()), rtol=RTOL)
    _assert_mlp_close(tnet, jnet)
    jinner, inner = _inner(jfinal), _inner(tfinal)
    want = [jinner._rule_kwargs(p).get("exclude_from_decay", False)
            for p in jinner._parameter_list]
    got = [inner._rule_kwargs(n).get("exclude_from_decay", False) for n in inner._param_names]
    assert got == want == [exclude == [""]] * 4


# ---------------------------------------------------------------- gradient merge
def test_gradient_merge_matches_jax_and_the_big_batch():
    x, y = _data(7)
    nets = {}
    for mod, (jnet, tnet) in ((None, _mlp_pair(7)),):
        nets["j"], nets["t"] = jnet, tnet
    strat = []
    for mod in (jdist, fleet):
        s = mod.DistributedStrategy()
        s.gradient_merge = True
        s.gradient_merge_configs = {"k_steps": 2, "avg": True}
        strat.append(s)
    jm, _ = jmeta.StrategyCompiler().compile(
        paddle.optimizer.SGD(learning_rate=0.1, parameters=nets["j"].parameters()), strat[0])
    tm, _ = pmeta.StrategyCompiler().compile(
        popt.SGD(learning_rate=0.1, parameters=nets["t"].named_parameters()), strat[1])
    w0 = [p.detach().clone() for p in nets["t"].parameters()]
    for i, half in enumerate((slice(0, 16), slice(16, 32))):
        _jax_loss(nets["j"], x[half], y[half]).backward()
        jm.step()
        jm.clear_grad()
        _port_loss(nets["t"], x[half], y[half]).backward()
        tm.step()
        tm.clear_grad()
        moved = any(not torch.equal(a, b) for a, b in zip(w0, nets["t"].parameters()))
        assert moved == (i == 1)   # one update, at the boundary
    _assert_mlp_close(nets["t"], nets["j"])
    _, big = _mlp_pair(7)
    opt = popt.SGD(learning_rate=0.1, parameters=big.named_parameters())
    _port_loss(big, x, y).backward()
    opt.step()
    for a, b in zip(nets["t"].parameters(), big.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=RTOL,
                                   atol=1e-7)


# ---------------------------------------------------------------- dgc, fp16_allreduce
def _set_grads(jnet, tnet, grads):
    for jp, tp, g in zip(jnet.parameters(), tnet.parameters(), grads):
        jp.grad = paddle.to_tensor(g)
        tp.grad = torch.from_numpy(g.T.copy() if g.ndim == 2 else g.copy())


def _grad_sets(seed, ties):
    rs = np.random.RandomState(seed)
    shapes = [(8, 16), (16,), (16, 1), (1,)]
    if ties:   # few distinct magnitudes: ties at the threshold
        return [rs.randint(-4, 5, s).astype(np.float32) * 0.25 for s in shapes]
    return [rs.randn(*s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("ties", [False, True])
def test_dgc_masks_and_residuals_are_jaxs_exactly(ties):
    jnet, tnet = _mlp_pair()
    strat = []
    for mod in (jdist, fleet):
        s = mod.DistributedStrategy()
        s.dgc = True
        s.dgc_configs = {"rampup_begin_step": 0, "sparsity": [0.75, 0.5]}
        strat.append(s)
    jw, _ = jmeta.StrategyCompiler().compile(
        paddle.optimizer.SGD(learning_rate=0.0, parameters=jnet.parameters()), strat[0])
    tw, _ = pmeta.StrategyCompiler().compile(
        popt.SGD(learning_rate=0.0, parameters=tnet.named_parameters()), strat[1])
    for step in range(3):   # sparsity 0.75, then 0.5 twice; the residual carries over
        _set_grads(jnet, tnet, _grad_sets(step, ties))
        jw.step()
        tw.step()
        for jp, tp in zip(jnet.parameters(), tnet.parameters()):
            g, r = np.asarray(jp.grad._data), np.asarray(jw._residual[id(jp)])
            if g.ndim == 2:
                g, r = g.T, r.T
            np.testing.assert_array_equal(tp.grad.numpy(), g)
            np.testing.assert_array_equal(tw._residual[id(tp)].numpy(), r)
            k = max(1, round(tp.numel() * (0.25 if step == 0 else 0.5)))
            assert int((tw._residual[id(tp)] == 0).sum()) >= k


def test_fp16_allreduce_rounds_through_bfloat16_as_jax():
    jnet, tnet = _mlp_pair()
    s_j, s_t = jdist.DistributedStrategy(), fleet.DistributedStrategy()
    s_j.fp16_allreduce = s_t.fp16_allreduce = True
    jw, _ = jmeta.StrategyCompiler().compile(
        paddle.optimizer.SGD(learning_rate=0.0, parameters=jnet.parameters()), s_j)
    tw, applied = pmeta.StrategyCompiler().compile(
        popt.SGD(learning_rate=0.0, parameters=tnet.named_parameters()), s_t)
    assert "fp16_allreduce" in applied
    grads = _grad_sets(3, False)
    _set_grads(jnet, tnet, grads)
    jw.step()
    tw.step()
    for jp, tp, g in zip(jnet.parameters(), tnet.parameters(), grads):
        want = g.astype(ml_dtypes.bfloat16).astype(np.float32)
        jg = np.asarray(jp.grad._data)
        np.testing.assert_array_equal(jg, want)
        np.testing.assert_array_equal(tp.grad.numpy(), want.T if want.ndim == 2 else want)


# ---------------------------------------------------------------- amp
def test_the_amp_metas_fp16_scale_contract_matches_jax():
    """step() without scale() is a plain step; scale().backward(); step()
    unscales; the weights of both flows against JAX's."""
    jnet, tnet = _mlp_pair()
    x, y = _data()
    ws = []
    for mod in (jdist, fleet):
        s = mod.DistributedStrategy()
        s.amp = True
        s.amp_configs = {"dtype": "float16"}
        ws.append(s)
    jw, _ = jmeta.StrategyCompiler().compile(
        paddle.optimizer.SGD(learning_rate=1.0, parameters=jnet.parameters()), ws[0])
    tw, _ = pmeta.StrategyCompiler().compile(
        popt.SGD(learning_rate=1.0, parameters=tnet.named_parameters()), ws[1])
    assert tw._scaler._enable and jw._scaler._enable
    w0 = tnet[0].weight.detach().clone()
    _port_loss(tnet, x, y).backward()
    g = tnet[0].weight.grad.clone()
    tw.step()          # no scale(): the plain step
    np.testing.assert_allclose(tnet[0].weight.detach().numpy(), (w0 - g).numpy(),
                               rtol=1e-5, atol=1e-7)
    tw.clear_grad()
    _jax_loss(jnet, x, y).backward()
    jw.step()
    jw.clear_grad()
    _assert_mlp_close(tnet, jnet)
    tw.scale(_port_loss(tnet, x, y)).backward()
    tw.step()          # scaled: unscaled before the update
    jw.scale(_jax_loss(jnet, x, y)).backward()
    jw.step()
    _assert_mlp_close(tnet, jnet)
    assert tw._scaler._scale == jw._scaler._scale


def test_the_amp_metas_context_is_the_configs_auto_cast():
    _, tnet = _mlp_pair()
    s = fleet.DistributedStrategy()
    s.amp = True
    tw, applied = pmeta.StrategyCompiler().compile(
        popt.Adam(learning_rate=0.01, parameters=tnet.named_parameters()), s)
    assert "amp" in applied and not tw._scaler._enable   # bf16: no loss scaling
    x = torch.from_numpy(_data()[0])
    from paddle_tpu_torch.ops import nn_functional as F

    with tw.amp_context() as ctx:
        out = F.linear(x, tnet[0].weight, tnet[0].bias)
    assert out.dtype == torch.bfloat16 and ctx.level == "O1"
    s.amp_configs = {"use_pure_fp16": True, "custom_black_list": ["linear"]}
    with tw.amp_context() as ctx:
        out = F.linear(x, tnet[0].weight, tnet[0].bias)
    assert ctx.level == "O2" and out.dtype == torch.float32


# ---------------------------------------------------------------- recompute
def test_the_recompute_meta_turns_on_the_blocks_recompute(world_one):
    from paddle_tpu.distributed import fleet as jfleet

    paddle.seed(0)
    jm = JaxGPT(jax_gpt_tiny())
    pm = GPTForPretraining(gpt_tiny(), device="cpu")
    assert not pm.gpt.blocks[0].use_recompute
    counts = []
    for mod, m, opt in ((jmeta, jm, paddle.optimizer.Adam(parameters=jm.parameters())),
                        (pmeta, pm, popt.Adam(parameters=pm.named_parameters()))):
        s = (jdist if mod is jmeta else fleet).DistributedStrategy()
        s.recompute = True
        s.recompute_configs = {"granularity": "selective"}
        w = mod.RecomputeOptimizer(opt, s)
        counts.append(w.enable_on(m))
    assert counts[0] == counts[1] == 2
    assert all(b.use_recompute and b.recompute_granularity == "selective"
               for b in pm.gpt.blocks)
    # and through fleet.distributed_optimizer(model=)
    pm2 = GPTForPretraining(gpt_tiny(), device="cpu")
    s = fleet.DistributedStrategy()
    s.recompute = True
    fleet.init(is_collective=True, strategy=s, device="cpu")
    fleet.distributed_optimizer(popt.Adam(parameters=pm2.named_parameters()), s, model=pm2)
    assert pm2.gpt.blocks[1].use_recompute and "recompute" in fleet.fleet._applied_meta_list
    del jfleet


# ---------------------------------------------------------------- offload
def _gpt_pair():
    set_hybrid_communicate_group(None)
    paddle.seed(0)
    jm = JaxGPT(jax_gpt_tiny())
    state = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    return jm, state


def _port_gpt(state):
    return load_jax_state(GPTForPretraining(gpt_tiny(), device="cpu"), state)


def test_eager_offload_gives_the_same_bits_with_the_state_on_the_cpu(deterministic):
    _, state = _gpt_pair()
    ids, labels = W.batch(b=2)
    runs = []
    for offload in (False, True):
        m = _port_gpt(state)
        opt = popt.AdamW(learning_rate=1e-3, parameters=m.named_parameters(),
                         weight_decay=0.01)
        _, opt = psharding.group_sharded_parallel(m, opt, "os_g", offload=offload)
        for _ in range(3):
            m(ids, labels).backward()
            opt.step()
            opt.clear_grad()
        runs.append((m, opt))
    (m0, o0), (m1, o1) = runs
    assert o1._optim._offload and not o0._optim._offload
    for (n, a), b in zip(m0.named_parameters(), m1.parameters()):
        assert torch.equal(a, b), n
    for n, st in o1._states.items():
        assert all(s.device.type == "cpu" for s in st)
        assert all(torch.equal(a, b) for a, b in zip(st, o0._states[n]))


@pytest.mark.parametrize("zero", [False, True])
def test_the_engines_offload_gives_the_same_bits(zero, deterministic):
    _, state = _gpt_pair()
    ids, labels = W.batch(b=4)
    runs = []
    for offload in (False, True):
        m = _port_gpt(state)
        opt = popt.AdamW(learning_rate=1e-3, parameters=m.named_parameters(),
                         weight_decay=0.01)
        opt._offload = offload
        eng = TrainStepEngine(m, opt, zero_update=zero)
        losses = [eng.step(ids, labels).item() for _ in range(3)]
        runs.append((losses, m, eng))
    (l0, m0, e0), (l1, m1, e1) = runs
    assert l0 == l1
    assert all(torch.equal(a, b) for a, b in zip(m0.parameters(), m1.parameters()))
    if zero:
        assert e1._zero_opt is not None
        assert all(s.device.type == "cpu" for s in e1._zero_opt)
        assert all(torch.equal(a, b) for a, b in zip(e0._zero_opt, e1._zero_opt))
    else:
        assert all(s.device.type == "cpu" for st in e1.optimizer._states.values() for s in st)
    sd0, sd1 = e0.state_dict()["optimizer"], e1.state_dict()["optimizer"]
    assert sd0.keys() == sd1.keys()
    assert all(torch.equal(torch.as_tensor(sd0[k]), torch.as_tensor(sd1[k])) for k in sd0)


def test_fsdp_with_offload_raises_naming_the_roadmap_item():
    _, state = _gpt_pair()
    m = _port_gpt(state)
    opt = popt.AdamW(learning_rate=1e-3, parameters=m.named_parameters())
    opt._offload = True
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        TrainStepEngine(m, opt, fsdp=True).step(*W.batch(b=2))


# ---------------------------------------------------------------- sharding wrappers
class _ShardingHcg:
    degrees = {"sharding": 2}

    def replica_group(self):
        return None


@pytest.mark.parametrize("segment_size", [2 ** 20, 4096])
def test_stage3_marks_the_parameters_jax_marks(segment_size):
    jm, state = _gpt_pair()
    set_hybrid_communicate_group(HybridCommunicateGroup(sharding_degree=2,
                                                        devices=jax.devices()[:2]))
    pmesh.set_hybrid_communicate_group(_ShardingHcg())
    try:
        for p in jm.parameters():
            p.dist_attr = None
        jsharding.GroupShardedStage3(jm, segment_size=segment_size)
        pm = _port_gpt(state)
        psharding.GroupShardedStage3(pm, segment_size=segment_size)
    finally:
        set_hybrid_communicate_group(None)
        pmesh.set_hybrid_communicate_group(None)
    jmarked = {n for n, p in jm.named_parameters() if p.dist_attr is not None}
    pmarked = {n for n, p in pm.named_parameters() if getattr(p, "dist_attr", None)}
    assert pmarked == jmarked
    assert pmarked == {n for n, p in pm.named_parameters() if p.numel() > segment_size}
    for n, p in pm.named_parameters():
        if n in pmarked:   # "sharding" on the first dim 2 divides (the port's layout)
            i = next(i for i, s in enumerate(p.shape) if s % 2 == 0)
            assert p.dist_attr == tuple("sharding" if j == i else None
                                        for j in range(p.dim()))


@pytest.mark.parametrize("scaler", [False, True])
@pytest.mark.parametrize("level", ["os", "os_g", "p_g_os"])
def test_group_sharded_parallels_returns_are_jaxs(level, scaler):
    jnet, tnet = _mlp_pair()
    jopt = paddle.optimizer.AdamW(parameters=jnet.parameters())
    topt = popt.AdamW(parameters=tnet.named_parameters())
    jout = jsharding.group_sharded_parallel(
        jnet, jopt, level, scaler=paddle.amp.GradScaler() if scaler else None)
    tout = psharding.group_sharded_parallel(
        tnet, topt, level, scaler=P.amp.GradScaler() if scaler else None)
    assert len(tout) == len(jout) == (3 if scaler else 2)
    assert [type(o).__name__ for o in tout] == [type(o).__name__ for o in jout]
    assert (tout[1] is topt) == (jout[1] is jopt) == (level == "p_g_os")
    assert topt._zero_stage == jopt._zero_stage == (3 if level == "p_g_os" else 2)
    assert tout[0].state_dict().keys() == tnet.state_dict().keys()
    with pytest.raises(ValueError):
        psharding.group_sharded_parallel(tnet, topt, "bad")


# ---------------------------------------------------------------- DataParallel, fleet
def test_the_data_parallel_wrappers_api_is_jaxs():
    set_hybrid_communicate_group(HybridCommunicateGroup(dp_degree=8))
    try:
        jdpm = jdp.DataParallel(jnn.Linear(2, 2))
    finally:
        set_hybrid_communicate_group(None)
    dp = P.DataParallel(torch.nn.Linear(2, 2))
    assert dp(torch.ones(1, 2)).shape == (1, 2)
    with dp.no_sync():
        assert not dp._enable_sync
    assert dp._enable_sync
    assert set(dp.state_dict()) == set(jdpm.state_dict()) == {"weight", "bias"}
    dp.set_state_dict({"weight": torch.zeros(2, 2), "bias": torch.ones(2)})
    assert torch.equal(dp._layers.bias, torch.ones(2))
    dp.sync_gradients()     # one rank: nothing to sync
    assert dp._reducer.n_collectives == 0 and dp.scale_loss(3) == 3


def test_fleet_at_world_one_runs_the_eager_step_as_the_engine(world_one, deterministic):
    """distributed_model returns the model itself, distributed_optimizer
    wraps the chain in HybridParallelOptimizer, and three eager steps are
    the engine's three, bit for bit."""
    _, state = _gpt_pair()
    ids, labels = W.batch(b=2)
    fleet.init(is_collective=True, device="cpu")
    m = _port_gpt(state)
    assert fleet.distributed_model(m) is m
    opt = fleet.distributed_optimizer(popt.AdamW(learning_rate=1e-3,
                                                 parameters=m.named_parameters()))
    assert type(opt).__name__ == "HybridParallelOptimizer"
    assert fleet.fleet._applied_meta_list == ["raw_program"]
    eager = []
    for _ in range(3):
        loss = m(ids, labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        eager.append(loss.item())
    m2 = _port_gpt(state)
    eng = fleet.distributed_engine(m2, fleet.distributed_optimizer(
        popt.AdamW(learning_rate=1e-3, parameters=m2.named_parameters())))
    assert isinstance(eng.optimizer, popt.AdamW)
    assert [eng.step(ids, labels).item() for _ in range(3)] == eager
    assert all(torch.equal(a, b) for a, b in zip(m.parameters(), m2.parameters()))
    assert fleet.worker_num() == 1 and fleet.is_first_worker()
    assert fleet.minimize(opt, m(ids, labels)) == (None, [])


def test_the_strategys_switches_and_configs_are_jaxs():
    j, t = jdist.DistributedStrategy().to_dict(), fleet.DistributedStrategy().to_dict()
    assert t == j
    s = fleet.DistributedStrategy()
    s.amp_configs = {"dtype": "float16", "use_pure_fp16": True}
    assert s.amp_configs.dtype == "float16" and s.amp_configs.init_loss_scaling == 32768.0
    with pytest.raises(ValueError, match="unknown amp_configs key"):
        s.amp_configs = {"no_such_key": 1}


def test_the_names_not_ported_raise_naming_their_roadmap_items():
    from paddle_tpu_torch.distributed import meta_parallel

    # the pipeline and MoE names are ported (item 11)
    from paddle_tpu_torch.distributed.meta_parallel import moe, pipeline_parallel, pp_layers

    for name, module in (("LayerDesc", pp_layers), ("SharedLayerDesc", pp_layers),
                         ("PipelineLayer", pp_layers), ("PipelineParallel", pipeline_parallel),
                         ("PipelineParallelWithInterleave", pipeline_parallel),
                         ("MoELayer", moe), ("NaiveGate", moe), ("GShardGate", moe),
                         ("SwitchGate", moe)):
        assert getattr(meta_parallel, name) is getattr(module, name), name
        assert name in meta_parallel.__all__
    # the tensor-parallel names are ported (item 9)
    assert callable(meta_parallel.ColumnParallelLinear)
    assert callable(meta_parallel.get_rng_state_tracker)
    with pytest.raises(AttributeError):
        meta_parallel.no_such_name
    with pytest.raises(NotImplementedError, match="planner"):
        fleet.distributed_engine(None, None, auto=True)


# ---------------------------------------------------------------- engine amp
def test_the_engine_under_strategy_amp(deterministic):
    """strategy.amp: the port's step is its step under the config's
    auto_cast, bit for bit, differs from the f32 step, and its losses are
    the JAX engine's traced amp within the bf16 bar (rtol 1e-2)."""
    jm, state = _gpt_pair()
    ids, labels = W.batch(b=2)
    s = fleet.DistributedStrategy()
    s.amp = True
    s.amp_configs = {"dtype": "float16"}     # forced to bf16 in the engine

    def port_run(strategy=None, ctx=None):
        m = _port_gpt(state)
        eng = TrainStepEngine(m, popt.AdamW(learning_rate=1e-3,
                                            parameters=m.named_parameters()),
                              strategy=strategy)
        with ctx or auto_cast(enable=False):
            return [eng.step(ids, labels).item() for _ in range(2)], m

    amp_l, amp_m = port_run(strategy=s)
    ctx_l, ctx_m = port_run(ctx=auto_cast(dtype="bfloat16"))
    f32_l, _ = port_run()
    assert amp_l == ctx_l
    assert all(torch.equal(a, b) for a, b in zip(amp_m.parameters(), ctx_m.parameters()))
    assert amp_l[0] != f32_l[0]
    js = jdist.DistributedStrategy()
    js.amp = True
    js.amp_configs = {"dtype": "float16"}
    jeng = JaxEngine(jm, paddle.optimizer.AdamW(learning_rate=1e-3,
                                                parameters=jm.parameters()),
                     hcg=HybridCommunicateGroup(dp_degree=1, devices=jax.devices()[:1]),
                     strategy=js)
    jl = [float(jeng.step(paddle.to_tensor(ids.numpy()),
                          paddle.to_tensor(labels.numpy())).item()) for _ in range(2)]
    set_hybrid_communicate_group(None)
    np.testing.assert_allclose(amp_l, jl, rtol=1e-2)


# ---------------------------------------------------------------- save / load
def _nested(mod_tensor, arrays):
    return {"w": mod_tensor(arrays[0]), "nest": [mod_tensor(arrays[1]), (mod_tensor(arrays[2]),
            3, "s")], "step": 7}


def _arrays():
    rs = np.random.RandomState(0)
    return [rs.randn(3, 4).astype(np.float32), rs.randint(0, 9, (5,)).astype(np.int64),
            rs.randn(6).astype(np.float32)]


def test_the_port_reads_what_jax_saves_bf16_included(tmp_path):
    a = _arrays()
    obj = _nested(paddle.to_tensor, a)
    obj["bf16"] = paddle.to_tensor(a[0]).astype("bfloat16")
    paddle.save(obj, str(tmp_path / "j.pdparams"))
    got = P.load(str(tmp_path / "j.pdparams"), device="cpu")
    assert got["step"] == 7 and got["nest"][1][1:] == (3, "s")
    assert isinstance(got["nest"][1], tuple)
    np.testing.assert_array_equal(got["w"].numpy(), a[0])
    assert got["nest"][0].dtype == torch.int64
    np.testing.assert_array_equal(got["nest"][0].numpy(), a[1])
    assert got["bf16"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["bf16"].float().numpy(),
                                  a[0].astype(ml_dtypes.bfloat16).astype(np.float32))
    raw = P.load(str(tmp_path / "j.pdparams"), return_numpy=True)
    assert isinstance(raw["w"], np.ndarray) and raw["bf16"].dtype == np.float32


def test_jax_reads_what_the_port_saves_bf16_included(tmp_path):
    a = _arrays()
    obj = _nested(torch.from_numpy, a)
    obj["bf16"] = torch.from_numpy(a[0]).to(torch.bfloat16)
    P.save(obj, str(tmp_path / "sub" / "t.pdparams"))
    got = paddle.load(str(tmp_path / "sub" / "t.pdparams"))
    assert got["step"] == 7 and isinstance(got["nest"][1], tuple)
    np.testing.assert_array_equal(got["w"].numpy(), a[0])
    np.testing.assert_array_equal(got["nest"][0].numpy(), a[1])
    assert str(got["bf16"].dtype) == "bfloat16"
    np.testing.assert_array_equal(np.asarray(got["bf16"].numpy()).astype(np.float32),
                                  a[0].astype(ml_dtypes.bfloat16).astype(np.float32))
    back = P.load(str(tmp_path / "sub" / "t.pdparams"), device="cpu")
    assert torch.equal(back["bf16"], obj["bf16"]) and torch.equal(back["w"], obj["w"])


def test_save_persistables_writes_a_model_jax_loads(tmp_path, world_one):
    _, state = _gpt_pair()
    fleet.init(is_collective=True, device="cpu")
    m = _port_gpt(state)
    fleet.save_persistables(m, str(tmp_path))
    got = paddle.load(str(tmp_path / "model.pdparams"))
    want = {n: v.numpy() for n, v in m.state_dict().items()}
    assert set(got) == set(want)
    for n in want:
        np.testing.assert_array_equal(got[n].numpy(), want[n])
    assert P.load(str(tmp_path / "model.pdparams"), device="cpu").keys() == want.keys()


def test_load_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is right there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.load(__file__)


# ---------------------------------------------------------------- two gloo ranks
@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("fleet")
    _, state = _gpt_pair()
    np.savez(d / "state.npz", **state)
    spawn(W.run_cases, args=(str(d), str(d / "state.npz")), nprocs=2, timeout=DEADLINE_S)
    return [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(2)]


_JAX = {}


def _jax_gpt(state):
    set_hybrid_communicate_group(None)
    jm = JaxGPT(jax_gpt_tiny())
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    return jm


def _jax_opt(jm, rule):
    if rule == "SGD":
        return paddle.optimizer.SGD(learning_rate=W.SGD_LR, parameters=jm.parameters())
    return paddle.optimizer.AdamW(learning_rate=W.ADAMW_LR, parameters=jm.parameters(),
                                  weight_decay=0.01)


def _port_layout(jm):
    return {n: v.numpy() for n, v in state_from_jax(
        {n: np.asarray(p._data) for n, p in jm.named_parameters()}).items()}


def jax_global(rule, steps=W.STEPS, batches=None):
    """The JAX eager step on the global batch (or on ``batches``, one
    backward each, before one step): (losses, parameters, port layout)."""
    key = (rule, steps, batches)
    if key not in _JAX:
        _, state = _gpt_pair()
        jm = _jax_gpt(state)
        opt = _jax_opt(jm, rule)
        ids, labels = (t.numpy() for t in W.batch())
        losses = []
        for _ in range(steps):
            for sl in batches or (slice(None),):
                rows = np.r_[sl] if isinstance(sl, tuple) else sl
                loss = jm(paddle.to_tensor(ids[rows]), paddle.to_tensor(labels[rows]))
                loss.backward()
                losses.append(float(loss.item()))
            opt.step()
            opt.clear_grad()
        _JAX[key] = (losses, _port_layout(jm))
    return _JAX[key]


def _close_to_scale(got, want, tol=RANK_TOL):
    for n in sorted(want):
        bar = tol * max(1.0, float(np.abs(want[n]).max()))
        np.testing.assert_allclose(got[n].numpy(), want[n], atol=bar, rtol=0, err_msg=n)


def _adam_close(got, want, lr=W.ADAMW_LR):
    apart = total = 0
    for n in sorted(want):
        g = got[n].numpy()
        np.testing.assert_allclose(g, want[n], atol=5 * lr, rtol=0, err_msg=n)
        apart += int((np.abs(g - want[n]) > 1e-5).sum())
        total += want[n].size
    assert apart <= 1e-3 * total, (apart, total)


@pytest.mark.parametrize("rule", ["SGD", "AdamW"])
def test_data_parallel_eager_steps_match_jaxs_global_batch(ranks, rule):
    mine = ranks[0][rule.lower()]
    assert mine["wrapper"] == "DataParallel" and mine["applied"] == ["raw_program"]
    losses, params = jax_global(rule)
    np.testing.assert_allclose(mine["global_losses"], losses, rtol=RANK_TOL)
    assert mine["global_losses"][-1] < mine["global_losses"][0]
    (_close_to_scale if rule == "SGD" else _adam_close)(mine["params"], params)


@pytest.mark.parametrize("case", ["sgd", "adamw", "no_sync", "gradient_merge",
                                  "stage2_offload", "stage3"])
def test_every_rank_holds_the_same_weights(ranks, case):
    a, b = ranks[0][case]["params"], ranks[1][case]["params"]
    assert all(torch.equal(a[n], b[n]) for n in a), case


def test_eager_adamw_is_the_engines_replicated_step_bit_for_bit(ranks):
    eager, eng = ranks[0]["adamw"], ranks[0]["engine"]
    np.testing.assert_allclose(eager["global_losses"], eng["losses"], rtol=1e-7)
    assert all(torch.equal(eager["params"][n], eng["params"][n]) for n in eng["params"])


def test_the_reducer_runs_one_collective_a_bucket_a_step(ranks):
    for r in ranks:
        for case, steps in (("sgd", W.STEPS), ("adamw", W.STEPS), ("no_sync", 1)):
            got = r[case]
            assert got["n_buckets"] >= 1
            assert got["n_collectives"] == steps * got["n_buckets"], case


def test_no_sync_accumulates_then_one_sync_averages(ranks):
    got = ranks[0]["no_sync"]
    assert not got["enabled_inside"] and got["enabled_after"]
    # rank r's microbatches are its rows [4r, 4r+2) and [4r+2, 4r+4): the two
    # backward passes over the ranks are JAX's over rows {0,1,4,5} and {2,3,6,7}
    _, params = jax_global("SGD", steps=1, batches=((slice(0, 2), slice(4, 6)),
                                                    (slice(2, 4), slice(6, 8))))
    _close_to_scale(got["params"], params)


def test_find_unused_parameters_averages_a_skipped_branch_as_zeros(ranks):
    xs = W.branch_inputs()
    w = W.branch_weights()
    grads = []
    for r, use_c in ((0, True), (1, False)):
        net = _JaxBranchy(w)
        loss = net(paddle.to_tensor(xs[4 * r:4 * r + 4]), use_c)
        loss.backward()
        grads.append({n: np.zeros_like(w[n]) if p.grad is None
                      else np.asarray(p.grad._data).reshape(w[n].shape[::-1]).T
                      if w[n].ndim == 2 else np.asarray(p.grad._data)
                      for n, p in net.named_parameters()})
    want = {n: (grads[0][n] + grads[1][n]) / 2 for n in grads[0]}
    for r in ranks:
        for path in ("optimizer", "sync_gradients"):
            assert r["unused"][f"{path}_find_unused"]
            for n in want:
                np.testing.assert_allclose(r["unused"][path][n].numpy(), want[n],
                                           rtol=RANK_TOL, atol=1e-7, err_msg=f"{path} {n}")
    assert np.abs(want["c.weight"]).max() > 0


class _JaxBranchy(jnn.Layer):
    def __init__(self, w):
        super().__init__()
        self.a, self.b, self.c = jnn.Linear(8, 8), jnn.Linear(8, 1), jnn.Linear(8, 1)
        for n, p in self.named_parameters():
            p.set_value(w[n].T.copy() if w[n].ndim == 2 else w[n])

    def forward(self, x, use_c=True):
        h = paddle.tanh(self.a(x))
        out = self.b(h)
        if use_c:
            out = out + self.c(h)
        return (out ** 2).mean()


def test_broadcast_dp_parameters_makes_divergent_inits_agree(ranks):
    a, b = ranks[0]["broadcast"], ranks[1]["broadcast"]
    assert not all(torch.equal(a["before"][n], b["before"][n]) for n in a["before"])
    for n in a["before"]:
        assert torch.equal(a["after"][n], a["before"][n])
        assert torch.equal(b["after"][n], a["before"][n])


def test_localsgd_matches_two_jax_optimizers_averaged_every_2_steps(ranks):
    _, state = _gpt_pair()
    ids, labels = (t.numpy() for t in W.batch())
    jms = [_jax_gpt(state) for _ in range(2)]
    opts = [_jax_opt(jm, "SGD") for jm in jms]
    for step in range(4):
        for r, (jm, opt) in enumerate(zip(jms, opts)):
            jm(paddle.to_tensor(ids[4 * r:4 * r + 4]),
               paddle.to_tensor(labels[4 * r:4 * r + 4])).backward()
            opt.step()
            opt.clear_grad()
        if step % 2 == 1:
            for pa, pb in zip(jms[0].parameters(), jms[1].parameters()):
                avg = (pa._data + pb._data) / 2
                pa.set_value(avg)
                pb.set_value(avg)
        for r in range(2):
            _close_to_scale(ranks[r]["localsgd"]["after_step"][step], _port_layout(jms[r]))
    assert ranks[0]["localsgd"]["applied"] == ["localsgd", "raw_program"]
    first = [ranks[r]["localsgd"]["after_step"][0] for r in range(2)]
    assert not all(torch.equal(first[0][n], first[1][n]) for n in first[0])


def test_gradient_merge_over_ranks_is_jaxs_global_batch(ranks):
    got = ranks[0]["gradient_merge"]
    assert got["applied"] == ["gradient_merge", "raw_program"]
    _close_to_scale(got["params"], jax_global("SGD", steps=2)[1])


@pytest.mark.parametrize("case", ["stage2_offload", "stage3"])
def test_group_sharded_eager_steps_are_the_data_parallel_steps(ranks, case):
    for r in ranks:
        got, ref = r[case], r["adamw"]
        assert got["losses"] == ref["losses"]
        assert all(torch.equal(got["params"][n], ref["params"][n]) for n in ref["params"])
        assert got["state_devices"] == ["cpu"] and got["n_state"] > 0
    assert ranks[0]["stage2_offload"]["wrapper"] == "GroupShardedStage2"
    assert ranks[0]["stage3"]["wrapper"] == "GroupShardedStage3"
