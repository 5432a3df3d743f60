"""paddle_tpu_torch.optimizer vs the JAX package's optimizer on identical numpy
parameters, gradients and state.

- each of the ten update rules over several steps against
  paddle_tpu.optimizer.functional, with the same state slots (count, order,
  f32);
- clip_grads with global norm, norm and value, ``clip_grad_norm_``;
- the sixteen schedulers' values over 20 steps (ReduceOnPlateau fed a loss
  curve: floats to the JAX one, 0-d torch tensors to the port's);
- apply_decay_param_fun: the rule kwargs by name, and an eager AdamW
  trajectory with a decay exclusion against the JAX Optimizer.step();
- the rule kwargs of every optimizer class under a float, L2Decay and
  L1Decay weight_decay; L1 and L2 decay, global and per parameter, and
  Lamb's and Lars's exclusions in eager trajectories; set_lr, minimize,
  clear_gradients and set_dict; the GradScaler with an injected inf.

Tolerances: f32 rtol 1e-6, atol 1e-7 on parameters and state (the same f32
arithmetic; the JAX bias correction runs in f64 under its x64 mode, the
port's in Python floats); Lamb and Lars rtol 1e-5, atol 1e-7
(``NORM_RTOL``): their trust ratio is a quotient of two norms over the
whole parameter, each a sum that XLA and PyTorch take in other orders, so
the ratio, and every entry it scales, may differ by a few f32 ulps times
the square root of the count of entries; schedulers rtol 1e-12 (the same
Python floats).
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
NORM_RTOL = 1e-5
NORM_RULES = ("lamb", "lars")


def _close(got, want, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=rtol, atol=ATOL)


RULE_CASES = [
    ("sgd", {}),
    ("sgd", {"weight_decay": 0.1}),
    ("momentum", {"momentum": 0.9}),
    ("momentum", {"momentum": 0.8, "use_nesterov": True, "weight_decay": 0.05}),
    ("adam", {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}),
    ("adam", {"beta1": 0.8, "beta2": 0.99, "epsilon": 1e-6, "weight_decay": 0.1}),
    ("adamw", {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8, "weight_decay": 0.01}),
    ("adamw", {"beta1": 0.85, "beta2": 0.95, "epsilon": 1e-8, "weight_decay": 0.3}),
    ("adamax", {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}),
    ("adamax", {"beta1": 0.8, "beta2": 0.9, "epsilon": 1e-6, "weight_decay": 0.1}),
    ("adagrad", {"epsilon": 1e-6}),
    ("adagrad", {"epsilon": 1e-4, "weight_decay": 0.05}),
    ("adadelta", {"rho": 0.95, "epsilon": 1e-6}),
    ("adadelta", {"rho": 0.9, "epsilon": 1e-4, "weight_decay": 0.1}),
    ("rmsprop", {"rho": 0.95, "epsilon": 1e-6}),
    ("rmsprop", {"rho": 0.9, "epsilon": 1e-6, "momentum": 0.9, "centered": True,
                 "weight_decay": 0.05}),
    ("lamb", {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-6, "lamb_weight_decay": 0.01}),
    ("lamb", {"beta1": 0.8, "beta2": 0.99, "epsilon": 1e-6, "lamb_weight_decay": 0.1,
              "exclude_from_decay": True}),
    ("lars", {"momentum": 0.9, "lars_coeff": 0.001, "lars_weight_decay": 0.0005}),
    ("lars", {"momentum": 0.8, "lars_coeff": 0.01, "lars_weight_decay": 0.1,
              "epsilon": 1e-6, "exclude_from_decay": True}),
]


@pytest.mark.parametrize("rule,kw", RULE_CASES, ids=lambda c: str(c))
def test_rule_matches_jax_over_steps(rule, kw):
    rng = np.random.RandomState(0)
    p0 = rng.randn(6, 5).astype(np.float32)
    jp, jst = jnp.asarray(p0), jax_fn.init_state(rule, jnp.asarray(p0))
    tp, tst = torch.from_numpy(p0.copy()), port_fn.init_state(rule, torch.from_numpy(p0))
    assert all(s.dtype == torch.float32 for s in tst) and len(tst) == len(jst)
    assert [tuple(s.shape) for s in tst] == [tuple(s.shape) for s in jst]
    rtol = NORM_RTOL if rule in NORM_RULES else RTOL
    for step in range(1, 6):
        g = rng.randn(6, 5).astype(np.float32)
        lr = 0.05 / step
        extra = {"step": step} if rule in jax_fn._NEEDS_STEP else {}
        jp, jst = jax_fn.RULES[rule](jp, jnp.asarray(g), jst, lr=lr, **kw, **extra)
        tp, tst = port_fn.RULES[rule](tp, torch.from_numpy(g), tst, lr=lr, **kw, **extra)
        _close(tp, jp, rtol)
        for a, b in zip(tst, jst):
            _close(a, b, rtol)
    assert not torch.equal(tp, torch.from_numpy(p0))


def test_the_rule_tables_are_the_jax_packages():
    assert set(port_fn.RULES) == set(jax_fn.RULES)
    assert port_fn._NEEDS_STEP == jax_fn._NEEDS_STEP
    from paddle_tpu.distributed.engine import TrainStepEngine as JaxEngine

    assert port_fn.ELEMENTWISE_RULES == JaxEngine._ZERO_RULES
    for rule in jax_fn.RULES:
        want = jax_fn.init_state(rule, jnp.zeros((3, 2), jnp.bfloat16))
        got = port_fn.init_state(rule, torch.zeros(3, 2, dtype=torch.bfloat16))
        assert len(got) == len(want), rule
        assert all(s.dtype == torch.float32 and tuple(s.shape) == (3, 2) for s in got)


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
        ("noam", lambda m: m.NoamDecay(d_model=64, warmup_steps=5, learning_rate=2.0)),
        ("piecewise", lambda m: m.PiecewiseDecay(boundaries=[3, 8, 12],
                                                 values=[0.1, 0.05, 0.01, 0.001])),
        ("natural_exp", lambda m: m.NaturalExpDecay(0.1, gamma=0.3)),
        ("inverse_time", lambda m: m.InverseTimeDecay(0.1, gamma=0.5)),
        ("exponential", lambda m: m.ExponentialDecay(0.1, gamma=0.9)),
        ("multistep", lambda m: m.MultiStepDecay(0.1, milestones=[4, 9, 15], gamma=0.5)),
        ("lambda", lambda m: m.LambdaDecay(0.1, lr_lambda=lambda e: 0.95 ** e)),
        ("multiplicative", lambda m: m.MultiplicativeDecay(0.1, lr_lambda=lambda e: 0.9)),
        ("cosine_restarts", lambda m: m.CosineAnnealingWarmRestarts(0.1, T_0=3, T_mult=2,
                                                                    eta_min=0.001)),
        ("one_cycle", lambda m: m.OneCycleLR(0.1, total_steps=15, end_learning_rate=1e-4)),
        ("one_cycle_linear", lambda m: m.OneCycleLR(0.1, total_steps=12, phase_pct=0.25,
                                                    anneal_strategy="linear")),
        ("cyclic", lambda m: m.CyclicLR(0.01, 0.1, step_size_up=3, step_size_down=5)),
        ("cyclic_triangular2", lambda m: m.CyclicLR(0.01, 0.1, step_size_up=2,
                                                    mode="triangular2")),
        ("cyclic_exp_range", lambda m: m.CyclicLR(0.01, 0.1, step_size_up=2,
                                                  mode="exp_range", exp_gamma=0.9)),
        ("plateau", lambda m: m.ReduceOnPlateau(0.1, factor=0.5, patience=2, cooldown=1,
                                                min_lr=0.01)),
        ("plateau_max_abs", lambda m: m.ReduceOnPlateau(0.1, mode="max", patience=1,
                                                        threshold=0.05,
                                                        threshold_mode="abs")),
    ]


# a loss that falls, stalls, rises and falls again (ReduceOnPlateau's feed)
_METRICS = [5.0, 4.0, 3.9, 3.9, 3.95, 4.1, 3.0, 3.0, 3.0, 3.0, 2.9, 3.2, 3.3, 3.1,
            3.4, 2.0, 2.0, 2.0, 2.5, 2.5]


@pytest.mark.parametrize("name", [n for n, _ in _sched_pairs()])
def test_scheduler_values_over_20_steps(name):
    make = dict(_sched_pairs())[name]
    js, ps = make(jax_lr), make(port_lr)
    jv, pv = [], []
    for i in range(20):
        jv.append(js())
        pv.append(ps())
        if name.startswith("plateau"):
            js.step(_METRICS[i])
            ps.step(torch.tensor(_METRICS[i]) if i % 2 else _METRICS[i])
        else:
            js.step()
            ps.step()
    np.testing.assert_allclose(pv, jv, rtol=1e-12, atol=0)
    assert len(set(pv)) > 1
    assert ps.state_dict()["last_epoch"] == js.state_dict()["last_epoch"] == 20
    assert ps.state_dict() == js.state_dict()


def test_every_jax_scheduler_is_ported():
    want = {n for n, c in vars(jax_lr).items()
            if isinstance(c, type) and issubclass(c, jax_lr.LRScheduler)}
    got = {n for n, c in vars(port_lr).items()
           if isinstance(c, type) and issubclass(c, port_lr.LRScheduler)}
    assert got == want and len(want) == 17


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


def test_the_weight_decay_objects_are_taken_as_the_jax_package_takes_them():
    from paddle_tpu import regularizer as jreg
    from paddle_tpu_torch import regularizer as preg

    l1 = port_opt.SGD(parameters=[torch.zeros(1)], weight_decay=preg.L1Decay(0.2))
    assert l1._weight_decay == 0.0 and l1._l1_decay.coeff == 0.2
    jl1 = paddle.optimizer.SGD(parameters=[], weight_decay=jreg.L1Decay(0.2))
    assert jl1._weight_decay == 0.0 and jl1._l1_decay.coeff == 0.2
    for wd in (preg.L2Decay(0.3), 0.3, 1):
        opt = port_opt.Momentum(parameters=[torch.zeros(1)], weight_decay=wd)
        assert opt._weight_decay == float(getattr(wd, "coeff", wd)) and opt._l1_decay is None
    with pytest.raises(TypeError):
        paddle.optimizer.SGD(parameters=[], weight_decay=object())
    assert repr(preg.L2Decay(0.5)) == repr(jreg.L2Decay(0.5)) == "L2Decay(coeff=0.5)"


def _jax_param(name, value):
    p = paddle.create_parameter(list(value.shape), dtype="float32", name=name)
    p.set_value(value)
    return p


_CLASS_CASES = [
    ("SGD", {"learning_rate": 0.1}),
    ("Momentum", {"learning_rate": 0.1, "momentum": 0.8, "use_nesterov": True}),
    ("Adam", {"learning_rate": 0.1, "lazy_mode": True, "multi_precision": False}),
    ("AdamW", {"learning_rate": 0.1, "lr_ratio": 0.5, "lazy_mode": True}),
    ("Adamax", {"learning_rate": 0.1, "beta1": 0.8}),
    ("Adagrad", {"learning_rate": 0.1, "initial_accumulator_value": 0.3}),
    ("Adadelta", {"learning_rate": 0.1, "rho": 0.9}),
    ("RMSProp", {"learning_rate": 0.1, "momentum": 0.9, "centered": True}),
]


@pytest.mark.parametrize("cls,kw", _CLASS_CASES, ids=[c for c, _ in _CLASS_CASES])
@pytest.mark.parametrize("wd", ["float", "l2", "l1"])
def test_rule_kwargs_of_every_class_match_jax(cls, kw, wd):
    from paddle_tpu import regularizer as jreg
    from paddle_tpu_torch import regularizer as preg

    jwd, pwd = {"float": (0.2, 0.2), "l2": (jreg.L2Decay(0.2), preg.L2Decay(0.2)),
                "l1": (jreg.L1Decay(0.2), preg.L1Decay(0.2))}[wd]
    value = np.ones((2, 2), np.float32)
    jw, jb = _jax_param("fc.weight", value), _jax_param("fc.bias", value[0])
    jopt = getattr(paddle.optimizer, cls)(parameters=[jw, jb], weight_decay=jwd,
                                          apply_decay_param_fun=_no_decay, **kw)
    popt = getattr(port_opt, cls)(parameters=[("fc.weight", torch.ones(2, 2)),
                                              ("fc.bias", torch.ones(2))],
                                  weight_decay=pwd, apply_decay_param_fun=_no_decay, **kw)
    for jp, name in ((jw, "fc.weight"), (jb, "fc.bias")):
        assert popt._rule_kwargs(name) == jopt._rule_kwargs(jp), name
    assert (popt._l1_decay is None) == (jopt._l1_decay is None)
    if cls == "RMSProp":
        assert len(port_fn.init_state("rmsprop", torch.zeros(2))) == 3


def _pair(rng, shapes=((4, 3), (3,))):
    """The same values as JAX parameters and as named port tensors."""
    names = ["fc.weight", "fc.bias"][:len(shapes)]
    vals = [rng.randn(*s).astype(np.float32) for s in shapes]
    jps = [_jax_param(n, v) for n, v in zip(names, vals)]
    tps = [torch.from_numpy(v.copy()).requires_grad_() for v in vals]
    return jps, tps, list(zip(names, tps))


def _feed(rng, jps, tps):
    """The same random gradients into both packages' parameters."""
    from paddle_tpu.core.tensor import Tensor

    for jp, tp in zip(jps, tps):
        g = rng.randn(*tp.shape).astype(np.float32)
        jp.grad = Tensor(jnp.asarray(g))
        tp.grad = torch.from_numpy(g)


def _trajectory(make_jax, make_port, steps=4, rtol=RTOL, seed=4, before_step=None):
    rng = np.random.RandomState(seed)
    jps, tps, named = _pair(rng)
    jopt, popt = make_jax(jps), make_port(named)
    for _ in range(steps):
        _feed(rng, jps, tps)
        if before_step is not None:
            before_step(jps, tps)
        jopt.step()
        popt.step()
        for jp, tp in zip(jps, tps):
            _close(tp.detach(), jp._data, rtol)
    jsd, psd = jopt.state_dict(), popt.state_dict()
    assert sorted(k for k in psd if k.startswith("param")) == sorted(
        k for k in jsd if k.startswith("param"))
    for key in psd:
        if key.startswith("param"):
            _close(psd[key], jsd[key]._data, rtol)
    return jps, tps, jopt, popt


def test_eager_lamb_with_an_exclusion_matches_jax():
    """Lamb's exclusion: the JAX package calls it with the parameter, the
    port with its name; the bias takes no lamb_weight_decay in either."""
    kw = dict(learning_rate=0.05, lamb_weight_decay=0.1)
    calls = []

    def port_fn_(name):
        calls.append(name)
        return name.endswith("bias")

    _trajectory(lambda ps: paddle.optimizer.Lamb(
                    parameters=ps, exclude_from_weight_decay_fn=lambda p: p.name.endswith("bias"),
                    **kw),
                lambda ps: port_opt.Lamb(parameters=ps,
                                         exclude_from_weight_decay_fn=port_fn_, **kw),
                rtol=NORM_RTOL)
    assert set(calls) == {"fc.weight", "fc.bias"}


def test_eager_lars_with_exclude_from_weight_decay_matches_jax():
    kw = dict(learning_rate=0.5, momentum=0.9, lars_coeff=0.01, lars_weight_decay=0.05,
              exclude_from_weight_decay=["bias"])
    _trajectory(lambda ps: paddle.optimizer.LarsMomentum(parameters=ps, **kw),
                lambda ps: port_opt.LarsMomentum(parameters=ps, **kw), rtol=NORM_RTOL)
    assert port_opt.LarsMomentum is port_opt.Lars


@pytest.mark.parametrize("case", ["global_l1", "global_l2", "param_l1", "param_l1_l2",
                                  "param_l2_ignored"])
def test_l1_and_l2_decay_match_jax(case):
    """Global weight_decay=L1Decay or L2Decay, and a per-parameter
    ``regularizer`` (an L1Decay on the weight, beside a global L2Decay, or a
    per-parameter L2Decay, which ``step`` ignores in both packages)."""
    from paddle_tpu import regularizer as jreg
    from paddle_tpu_torch import regularizer as preg

    glob = {"global_l1": "l1", "global_l2": "l2", "param_l1_l2": "l2"}.get(case)
    per = {"param_l1": "l1", "param_l1_l2": "l1", "param_l2_ignored": "l2"}.get(case)
    mods = {"l1": (jreg.L1Decay, preg.L1Decay), "l2": (jreg.L2Decay, preg.L2Decay)}
    jwd, pwd = (None, None) if glob is None else (mods[glob][0](0.05), mods[glob][1](0.05))

    def before(jps, tps):
        if per is not None:
            jps[0].regularizer = mods[per][0](0.3)
            tps[0].regularizer = mods[per][1](0.3)

    _trajectory(lambda ps: paddle.optimizer.Momentum(learning_rate=0.1, parameters=ps,
                                                     weight_decay=jwd),
                lambda ps: port_opt.Momentum(learning_rate=0.1, parameters=ps,
                                             weight_decay=pwd),
                before_step=before)


def test_l1_decay_moves_the_step_by_coeff_times_the_sign():
    from paddle_tpu_torch.regularizer import L1Decay

    p = torch.tensor([2.0, -3.0, 0.0], requires_grad=True)
    p.regularizer = L1Decay(0.5)
    opt = port_opt.SGD(learning_rate=1.0, parameters=[p])
    p.grad = torch.zeros(3)
    opt.step()
    assert p.detach().tolist() == [1.5, -2.5, 0.0]


def test_set_lr_minimize_clear_gradients_and_set_dict_match_jax():
    """set_lr replaces a scheduler with a float; minimize is backward + step
    and returns (None, [(param, grad)]); clear_gradients drops every grad;
    a JAX Lamb state_dict taken into the port by set_dict continues as the
    JAX optimizer does."""
    rng = np.random.RandomState(6)
    jps, tps, named = _pair(rng)
    x = rng.randn(4).astype(np.float32)
    jsched, psched = jax_lr.StepDecay(0.1, step_size=1), port_lr.StepDecay(0.1, step_size=1)
    jopt = paddle.optimizer.Lamb(learning_rate=jsched, parameters=jps)
    popt = port_opt.Lamb(learning_rate=psched, parameters=named)
    for opt in (jopt, popt):
        opt.set_lr(0.02)
        assert opt.get_lr() == 0.02 and isinstance(opt._learning_rate, float)
    for _ in range(2):
        jloss = (paddle.matmul(paddle.to_tensor(x), jps[0]) * jps[1]).sum()
        ploss = (torch.from_numpy(x) @ tps[0] * tps[1]).sum()
        jret, pret = jopt.minimize(jloss), popt.minimize(ploss)
        assert pret[0] is None and jret[0] is None
        assert [p for p, _ in pret[1]] == tps
        _close(pret[1][0][1], jret[1][0][1]._data)
        jopt.clear_gradients()
        popt.clear_gradients()
        assert all(p.grad is None for p in tps) and all(p.grad is None for p in jps)
        for jp, tp in zip(jps, tps):
            _close(tp.detach(), jp._data, NORM_RTOL)
    # the JAX optimizer's state, by its keys, into a fresh port optimizer
    sd = {k: (np.array(v._data) if hasattr(v, "_data") else v)
          for k, v in jopt.state_dict().items()}
    fresh = [torch.from_numpy(np.asarray(jp._data).copy()).requires_grad_() for jp in jps]
    popt2 = port_opt.Lamb(learning_rate=0.02, parameters=list(zip(["a", "b"], fresh)))
    popt2.set_dict(sd)
    assert popt2._step_count == 2
    _feed(rng, jps, fresh)
    jopt.step()
    popt2.step()
    for jp, tp in zip(jps, fresh):
        _close(tp.detach(), jp._data, NORM_RTOL)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_grad_norm_matches_jax(max_norm):
    from paddle_tpu.core.tensor import Tensor
    from paddle_tpu.nn.clip import clip_grad_norm_ as jax_clip_grad_norm_
    from paddle_tpu_torch.nn import clip_grad_norm_

    rng = np.random.RandomState(7)
    jps, tps, _ = _pair(rng)
    _feed(rng, jps, tps)
    third = torch.zeros(2, requires_grad=True)      # no grad: left out
    want = jax_clip_grad_norm_(jps, max_norm, norm_type=1.0, error_if_nonfinite=True)
    got = clip_grad_norm_(tps + [third], max_norm, norm_type=1.0, error_if_nonfinite=True)
    _close(got, want._data if isinstance(want, Tensor) else want)
    assert got.item() <= max_norm * (1 + 1e-6)
    for jp, tp in zip(jps, tps):
        _close(tp.grad, jp.grad._data)
    assert third.grad is None


def _scaler_grads(rng, jps, tps, scale, bad=False):
    from paddle_tpu.core.tensor import Tensor

    for i, (jp, tp) in enumerate(zip(jps, tps)):
        g = (rng.randn(*tp.shape) * scale).astype(np.float32)
        if bad and i == 0:
            g[0, 1] = np.inf
        jp.grad = Tensor(jnp.asarray(g))
        tp.grad = torch.from_numpy(g)


def test_grad_scaler_skips_an_inf_step_and_follows_update_as_jax():
    """Scaled grads into both packages' GradScaler around Adam: a step with
    an inf grad leaves parameters and state bit-unchanged and halves the
    scale; two good steps in a row double it; unscale_ then step unscales
    once."""
    from paddle_tpu.amp import GradScaler as JaxScaler
    from paddle_tpu_torch.amp import GradScaler

    rng = np.random.RandomState(8)
    jps, tps, named = _pair(rng)
    jopt = paddle.optimizer.Adam(learning_rate=0.01, parameters=jps)
    popt = port_opt.Adam(learning_rate=0.01, parameters=named)
    kw = dict(init_loss_scaling=1024.0, incr_every_n_steps=2, decr_every_n_nan_or_inf=1)
    js, ps = JaxScaler(**kw), GradScaler(**kw)
    scales = []
    for bad in (False, True, False, False, False):
        _scaler_grads(rng, jps, tps, ps._scale, bad)
        before = ([t.detach().clone() for t in tps],
                  {k: v.clone() for k, v in popt.state_dict().items()
                   if k.startswith("param")})
        if bad:
            ps.unscale_(popt)
            js.unscale_(jopt)
        js.step(jopt)
        ps.step(popt)
        js.update()
        ps.update()
        assert ps._found_inf == js._found_inf == bad
        if bad:
            assert all(torch.equal(a, b) for a, b in zip(before[0], tps))
            after = popt.state_dict()
            assert all(torch.equal(v, after[k]) for k, v in before[1].items())
        for jp, tp in zip(jps, tps):
            _close(tp.detach(), jp._data)
        scales.append(ps.get_loss_scaling().item())
        assert scales[-1] == js.get_loss_scaling().item()
    assert scales == [1024.0, 512.0, 512.0, 1024.0, 1024.0]
    assert ps.state_dict() == js.state_dict()
    fresh = GradScaler()
    fresh.load_state_dict(ps.state_dict())
    assert fresh._scale == 1024.0 and fresh._good_steps == ps._good_steps
    assert ps.is_enable() and ps.is_use_dynamic_loss_scaling()
    off = GradScaler(enable=False)
    assert off.scale(torch.tensor(3.0)).item() == 3.0 and off._scale == 1.0


def test_grad_scaler_minimize_matches_jax():
    from paddle_tpu.amp import GradScaler as JaxScaler
    from paddle_tpu_torch.amp import GradScaler

    rng = np.random.RandomState(9)
    jps, tps, named = _pair(rng)
    x = rng.randn(4).astype(np.float32)
    jopt = paddle.optimizer.SGD(learning_rate=0.1, parameters=jps)
    popt = port_opt.SGD(learning_rate=0.1, parameters=named)
    js, ps = JaxScaler(init_loss_scaling=64.0), GradScaler(init_loss_scaling=64.0)
    for _ in range(2):
        jloss = (paddle.matmul(paddle.to_tensor(x), jps[0]) * jps[1]).sum()
        ploss = (torch.from_numpy(x) @ tps[0] * tps[1]).sum()
        _close(ps.scale(ploss).detach(), js.scale(jloss)._data)
        js.minimize(jopt, js.scale(jloss))
        ps.minimize(popt, ps.scale(ploss))
        jopt.clear_grad()
        popt.clear_grad(set_to_zero=True)
        for jp, tp in zip(jps, tps):
            _close(tp.detach(), jp._data)


def test_decorate_o2_casts_in_place_and_keeps_f32_state_as_jax():
    """decorate(level="O2") casts floating parameters to bf16 in place: the
    optimizer's references stay valid, its state is f32, and the first
    AdamW step on bf16 parameters equals the JAX package's."""
    from paddle_tpu.amp import decorate as jax_decorate
    from paddle_tpu_torch.amp import decorate

    rng = np.random.RandomState(10)
    w = rng.randn(8, 4).astype(np.float32)
    jlin = paddle.nn.Linear(8, 4)
    jlin.weight.set_value(w)
    plin = torch.nn.Linear(8, 4)
    with torch.no_grad():
        plin.weight.copy_(torch.from_numpy(w.T))
        plin.bias.copy_(torch.from_numpy(np.array(jlin.bias._data)))
    idx = torch.nn.Embedding(3, 2)
    jopt = paddle.optimizer.AdamW(learning_rate=0.01, parameters=jlin.parameters())
    popt = port_opt.AdamW(learning_rate=0.01, parameters=plin.named_parameters())
    held = list(popt._parameter_list)
    assert decorate(plin, level="O1") is plin and plin.weight.dtype == torch.float32
    jm, _ = jax_decorate(jlin, jopt, level="O2")
    pm, popt_ = decorate([plin, idx], popt, level="O2")
    assert popt_ is popt and pm[0] is plin
    assert all(p.dtype == torch.bfloat16 for p in list(plin.parameters()) + list(idx.parameters()))
    assert [p is q for p, q in zip(popt._parameter_list, held)] == [True, True]
    g = rng.randn(8, 4).astype(np.float32)
    from paddle_tpu.core.tensor import Tensor

    jlin.weight.grad = Tensor(jnp.asarray(g).astype(jnp.bfloat16))
    jlin.bias.grad = Tensor(jnp.zeros((4,), jnp.bfloat16))
    plin.weight.grad = torch.from_numpy(g.T.copy()).to(torch.bfloat16)
    plin.bias.grad = torch.zeros(4, dtype=torch.bfloat16)
    jopt.step()
    popt.step()
    assert plin.weight.dtype == torch.bfloat16
    assert all(s.dtype == torch.float32 for s in popt._states["weight"])
    np.testing.assert_array_equal(plin.weight.detach().float().numpy().T,
                                  np.asarray(jlin.weight._data.astype(jnp.float32)))


def _is_layer_norm(name):
    return ".ln" in name


def test_gpt_tiny_lamb_through_both_engines_matches_jax():
    """gpt_tiny, ids [2, 128], Lamb(0.02) with the LayerNorm weights and
    biases excluded from its decay, 3 steps of each package's
    TrainStepEngine from the same weights (the JAX engine as
    tests/test_distributed.py runs Lamb, on a 1-device mesh). The JAX
    exclusion gets the parameter: its name, the same in both packages
    (models/convert.py), comes from the model's named_parameters. Losses
    rtol 1e-5; parameters under tests/test_torch_dp.py's rule (a gradient
    within rounding of 0 may take the other sign)."""
    import jax
    from paddle_tpu.distributed.engine import TrainStepEngine as JaxEngine
    from paddle_tpu.distributed.mesh import HybridCommunicateGroup
    from paddle_tpu_torch.distributed import TrainStepEngine
    from test_torch_dp import assert_params_close
    from test_torch_train import _batch, _jax_model, _jax_params, _numpy_state, _port_model

    lr = 0.02
    jm = _jax_model()
    names = {id(p): n for n, p in jm.named_parameters()}
    pm = _port_model(_numpy_state(jm))
    jopt = paddle.optimizer.Lamb(
        learning_rate=lr, parameters=jm.parameters(),
        exclude_from_weight_decay_fn=lambda p: _is_layer_norm(names[id(p)]))
    popt = port_opt.Lamb(learning_rate=lr, parameters=pm.named_parameters(),
                         exclude_from_weight_decay_fn=_is_layer_norm)
    jeng = JaxEngine(jm, jopt, hcg=HybridCommunicateGroup(dp_degree=1,
                                                          devices=jax.devices()[:1]))
    peng = TrainStepEngine(pm, popt)
    excluded = [n for n in peng.params if popt._rule_kwargs(n).get("exclude_from_decay")]
    assert excluded and all(_is_layer_norm(n) for n in excluded)
    ids, labels = _batch(seed=5)
    jl = [float(jeng.step(paddle.to_tensor(ids), paddle.to_tensor(labels)).item())
          for _ in range(3)]
    pl = [peng.step(ids, labels).item() for _ in range(3)]
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    assert pl[-1] < pl[0]
    assert_params_close({n: p.detach() for n, p in pm.named_parameters()},
                        _jax_params(jeng), lr=lr)
    assert len(popt._states[excluded[0]]) == 2
