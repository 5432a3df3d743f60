"""paddle_tpu_torch.optimizer vs the JAX package's optimizer on identical numpy
parameters, gradients and state.

- each update rule (sgd, momentum, adam, adamw) over several steps against
  paddle_tpu.optimizer.functional;
- clip_grads with global norm, norm and value;
- the schedulers' values over 20 steps;
- apply_decay_param_fun: the rule kwargs by name, and an eager AdamW
  trajectory with a decay exclusion against the JAX Optimizer.step().

Tolerances: f32 rtol 1e-6, atol 1e-7 on parameters and state (the same f32
arithmetic; the JAX bias correction runs in f64 under its x64 mode, the
port's in Python floats); schedulers rtol 1e-12 (the same Python floats).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nn import clip as jax_clip
from paddle_tpu.optimizer import functional as jax_fn
from paddle_tpu.optimizer import lr as jax_lr
from paddle_tpu_torch import optimizer as port_opt
from paddle_tpu_torch.nn import clip as port_clip
from paddle_tpu_torch.optimizer import functional as port_fn
from paddle_tpu_torch.optimizer import lr as port_lr

RTOL, ATOL = 1e-6, 1e-7


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=RTOL, atol=ATOL)


RULE_CASES = [
    ("sgd", {}),
    ("sgd", {"weight_decay": 0.1}),
    ("momentum", {"momentum": 0.9}),
    ("momentum", {"momentum": 0.8, "use_nesterov": True, "weight_decay": 0.05}),
    ("adam", {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}),
    ("adam", {"beta1": 0.8, "beta2": 0.99, "epsilon": 1e-6, "weight_decay": 0.1}),
    ("adamw", {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8, "weight_decay": 0.01}),
    ("adamw", {"beta1": 0.85, "beta2": 0.95, "epsilon": 1e-8, "weight_decay": 0.3}),
]


@pytest.mark.parametrize("rule,kw", RULE_CASES, ids=lambda c: str(c))
def test_rule_matches_jax_over_steps(rule, kw):
    rng = np.random.RandomState(0)
    p0 = rng.randn(6, 5).astype(np.float32)
    jp, jst = jnp.asarray(p0), jax_fn.init_state(rule, jnp.asarray(p0))
    tp, tst = torch.from_numpy(p0.copy()), port_fn.init_state(rule, torch.from_numpy(p0))
    assert all(s.dtype == torch.float32 for s in tst) and len(tst) == len(jst)
    for step in range(1, 6):
        g = rng.randn(6, 5).astype(np.float32)
        lr = 0.05 / step
        extra = {"step": step} if rule in ("adam", "adamw") else {}
        jp, jst = jax_fn.RULES[rule](jp, jnp.asarray(g), jst, lr=lr, **kw, **extra)
        tp, tst = port_fn.RULES[rule](tp, torch.from_numpy(g), tst, lr=lr, **kw, **extra)
        _close(tp, jp)
        for a, b in zip(tst, jst):
            _close(a, b)


def test_rule_keeps_a_bf16_param_bf16_with_f32_state():
    p = torch.randn(4, 4).to(torch.bfloat16)
    st = port_fn.init_state("adamw", p)
    new_p, new_st = port_fn.adamw(p, torch.randn(4, 4).to(torch.bfloat16), st,
                                  lr=1e-3, step=1)
    assert new_p.dtype == torch.bfloat16
    assert all(s.dtype == torch.float32 for s in st + new_st)


def _grads(seed=1):
    rng = np.random.RandomState(seed)
    return {"a": rng.randn(3, 4).astype(np.float32) * 3,
            "b": rng.randn(5).astype(np.float32) * 0.1,
            "c": rng.randn(2, 2).astype(np.float32)}


@pytest.mark.parametrize("kind,arg", [("global", 1.0), ("global", 100.0),
                                      ("norm", 0.5), ("value", 0.3)])
def test_clip_grads_matches_jax(kind, arg):
    jax_rule = {"global": jax_clip.ClipGradByGlobalNorm, "norm": jax_clip.ClipGradByNorm,
                "value": jax_clip.ClipGradByValue}[kind](arg)
    port_rule = {"global": port_clip.ClipGradByGlobalNorm,
                 "norm": port_clip.ClipGradByNorm,
                 "value": port_clip.ClipGradByValue}[kind](arg)
    g = _grads()
    want = jax_fn.clip_grads({n: jnp.asarray(v) for n, v in g.items()}, jax_rule)
    got = port_fn.clip_grads({n: torch.from_numpy(v) for n, v in g.items()}, port_rule)
    assert list(got) == list(g)
    for n in g:
        _close(got[n], want[n])
    assert port_fn.clip_grads({"a": torch.ones(2)}, None)["a"].sum() == 2


def test_global_norm_and_clip_objects_on_pairs():
    g = _grads(2)
    jrule, prule = jax_clip.ClipGradByGlobalNorm(1.0), port_clip.ClipGradByGlobalNorm(1.0)
    from paddle_tpu.core.tensor import Tensor

    jn = jrule.compute_global_norm([Tensor(jnp.asarray(v)) for v in g.values()])
    pn = prule.compute_global_norm([torch.from_numpy(v) for v in g.values()] + [None])
    _close(pn, jn)
    pairs = prule([("x", torch.from_numpy(g["a"])), ("y", None)])
    assert pairs[1] == ("y", None)


def _sched_pairs():
    return [
        ("cosine", lambda m: m.CosineAnnealingDecay(0.1, T_max=7, eta_min=0.01)),
        ("poly", lambda m: m.PolynomialDecay(0.1, decay_steps=8, end_lr=0.001, power=2.0)),
        ("poly_cycle", lambda m: m.PolynomialDecay(0.1, decay_steps=6, cycle=True)),
        ("step", lambda m: m.StepDecay(0.5, step_size=3, gamma=0.5)),
        ("warmup_const", lambda m: m.LinearWarmup(0.1, warmup_steps=5, start_lr=0.0,
                                                  end_lr=0.1)),
        ("warmup_cosine", lambda m: m.LinearWarmup(
            m.CosineAnnealingDecay(0.1, T_max=10), warmup_steps=4, start_lr=0.01,
            end_lr=0.1)),
    ]


@pytest.mark.parametrize("name", [n for n, _ in _sched_pairs()])
def test_scheduler_values_over_20_steps(name):
    make = dict(_sched_pairs())[name]
    js, ps = make(jax_lr), make(port_lr)
    jv, pv = [], []
    for _ in range(20):
        jv.append(js())
        pv.append(ps())
        js.step()
        ps.step()
    np.testing.assert_allclose(pv, jv, rtol=1e-12, atol=0)
    assert ps.state_dict()["last_epoch"] == js.state_dict()["last_epoch"] == 20


def test_optimizer_reads_a_scheduler():
    sched = port_lr.StepDecay(0.5, step_size=2)
    opt = port_opt.AdamW(learning_rate=sched, parameters=[torch.zeros(2)])
    assert opt.get_lr() == 0.5
    sched.step()
    sched.step()
    assert opt.get_lr() == pytest.approx(0.05)


def _no_decay(name):
    return not name.endswith("bias")


def test_apply_decay_param_fun_rule_kwargs_match_jax():
    jw = paddle.create_parameter([3, 2], dtype="float32", name="fc.weight")
    jb = paddle.create_parameter([2], dtype="float32", name="fc.bias")
    jopt = paddle.optimizer.AdamW(learning_rate=0.1, parameters=[jw, jb],
                                  weight_decay=0.2, apply_decay_param_fun=_no_decay)
    tw, tb = torch.zeros(3, 2, requires_grad=True), torch.zeros(2, requires_grad=True)
    popt = port_opt.AdamW(learning_rate=0.1,
                          parameters=[("fc.weight", tw), ("fc.bias", tb)],
                          weight_decay=0.2, apply_decay_param_fun=_no_decay)
    for jp, name in ((jw, "fc.weight"), (jb, "fc.bias")):
        assert popt._rule_kwargs(name) == jopt._rule_kwargs(jp)
    assert popt._rule_kwargs("fc.bias")["weight_decay"] == 0.0
    assert popt._rule_kwargs("fc.weight")["weight_decay"] == 0.2


def test_eager_adamw_trajectory_with_decay_exclusion_matches_jax():
    """Optimizer.step() over 4 steps with a global-norm clip and a decay
    exclusion, parameters and both moments against the JAX Optimizer."""
    from paddle_tpu.core.tensor import Tensor

    rng = np.random.RandomState(3)
    w0, b0 = rng.randn(4, 3).astype(np.float32), rng.randn(3).astype(np.float32)
    jw = paddle.create_parameter([4, 3], dtype="float32", name="fc.weight")
    jb = paddle.create_parameter([3], dtype="float32", name="fc.bias")
    jw.set_value(w0)
    jb.set_value(b0)
    tw = torch.from_numpy(w0.copy()).requires_grad_()
    tb = torch.from_numpy(b0.copy()).requires_grad_()
    kw = dict(learning_rate=0.01, weight_decay=0.1, apply_decay_param_fun=_no_decay)
    jopt = paddle.optimizer.AdamW(parameters=[jw, jb],
                                  grad_clip=jax_clip.ClipGradByGlobalNorm(1.0), **kw)
    popt = port_opt.AdamW(parameters=[("fc.weight", tw), ("fc.bias", tb)],
                          grad_clip=port_clip.ClipGradByGlobalNorm(1.0), **kw)
    for _ in range(4):
        gw, gb = rng.randn(4, 3).astype(np.float32), rng.randn(3).astype(np.float32)
        jw.grad, jb.grad = Tensor(jnp.asarray(gw)), Tensor(jnp.asarray(gb))
        tw.grad, tb.grad = torch.from_numpy(gw), torch.from_numpy(gb)
        jopt.step()
        popt.step()
    _close(tw.detach(), jw._data)
    _close(tb.detach(), jb._data)
    jsd, psd = jopt.state_dict(), popt.state_dict()
    assert psd["_step_count"] == jsd["_step_count"] == 4
    for key in ("param0_state0", "param0_state1", "param1_state0", "param1_state1"):
        _close(psd[key], jsd[key]._data)
    popt.clear_grad()
    assert tw.grad is None and tb.grad is None


def test_state_dict_round_trip():
    p = torch.randn(3, requires_grad=True)
    opt = port_opt.Adam(learning_rate=0.1, parameters=[p])
    p.grad = torch.ones(3)
    opt.step()
    sd = opt.state_dict()
    q = torch.randn(3, requires_grad=True)
    opt2 = port_opt.Adam(learning_rate=0.1, parameters=[q])
    opt2.set_state_dict(sd)
    assert opt2._step_count == 1
    assert torch.equal(opt2._states["param_0"][0], opt._states["param_0"][0])


def test_weight_decay_objects_are_refused():
    with pytest.raises(TypeError):
        port_opt.SGD(parameters=[torch.zeros(1)], weight_decay=object())
