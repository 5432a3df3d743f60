"""BASELINE config 2 on the port: paddle_tpu_torch.vision's ResNet, ResNeXt
and LeNet against the JAX package's on the same weights (carried by
models/convert.py) and numpy-seeded inputs, the engine's ``loss_fn`` step
with ``CrossEntropyLoss`` and ``Momentum``, its running statistics, and
one spawned world of 4 gloo ranks (tests/torch_vision_workers.py) that
holds ResNet at dp 4 and ERNIE at dp 2 x sharding 2 against the JAX
package's one-process steps on the global batch.

Tolerances: f32 logits and losses at 1e-4 x max(1, max|ref|); gradients,
parameters after steps and running statistics at 1e-4 relative to the
tensor's largest entry (``_rel_close``); AdamW parameters (the ERNIE
world) under tests/test_torch_dp.py's rule (atol 5 x lr, at most 0.1% of
the entries more than 1e-5 apart).

The ResNet engine steps run in f64 in both packages (the optimizers keep
their f32 state): at random init a ResNet's train-mode gradient is so
sensitive to rounding (batch norm over channels of tiny batch variance) that
two correct f32 runs differ by up to 1e-3 to 3e-1 of an entry, depending on
the weights; in f64 the packages agree to ~1e-7.

The running statistics after engine steps are held against the JAX
package's eager update (a train-mode forward of the JAX model, with the
JAX engine's parameters of that step, on the same global batch): the JAX
engine itself leaves them at their initial values (its functional_call
drops buffer updates; pinned below, and recorded in ROADMAP.md as a
deliberate difference).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import torch_vision_workers as W
from torch_numpy_init import numpy_init
from paddle_tpu.distributed.engine import TrainStepEngine as JaxEngine
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.distributed.mesh import (HybridCommunicateGroup,
                                         set_hybrid_communicate_group)
from paddle_tpu.jit import functional_call, functional_call_with_state
import paddle_tpu_torch as P
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch.distributed import TrainStepEngine, spawn
from paddle_tpu_torch.models import gather_to_jax, state_from_jax
from paddle_tpu_torch.vision import models as pvm

TOL = 1e-4
DEADLINE_S = 300     # the world of 4 ranks, both checks; it takes ~30 s

torch.set_num_threads(1)


def _close(got, want, tol=TOL, what=""):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), f"{what}: |err| {err}"


def _rel_close(got, want, what=""):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= TOL * scale + 1e-12, f"{what}: |err| {err} vs max|ref| {scale}"


def _np_state(jm):
    return {k: np.asarray(v._data) for k, v in jm.state_dict().items()}


def _jax_hcg():
    return HybridCommunicateGroup(dp_degree=1, devices=jax.devices()[:1])


# kind: (JAX factory, port factory, input shape, dtype). ResNeXt runs in f64:
# at random init its f32 train-mode gradients differ from its own f64 ones
# by up to 23% in an entry and 3% in a tensor's Frobenius norm (batch norm
# over a few samples of grouped convolutions' 4-channel groups amplifies
# f32 rounding), in the port as in the JAX package, so no f32 bar would
# tell a fault from rounding; in f64 the two packages agree to ~1e-7.
MODELS = {
    "resnet18": (lambda: paddle.vision.models.resnet18(num_classes=10),
                 lambda: pvm.resnet18(num_classes=10, device="cpu"), (4, 3, 96, 96),
                 np.float32),
    "resnext50_32x4d": (lambda: paddle.vision.models.resnext50_32x4d(num_classes=10),
                        lambda: pvm.resnext50_32x4d(num_classes=10, device="cpu"),
                        (4, 3, 32, 32), np.float64),
    "lenet": (lambda: paddle.vision.models.LeNet(), lambda: pvm.LeNet(device="cpu"),
              (2, 1, 28, 28), np.float32),
}


def _pair(kind, seed=0):
    jmk, pmk, shape, dtype = MODELS[kind]
    set_hybrid_communicate_group(None)
    with numpy_init(seed):
        jm = jmk()
    pm = pmk()
    pm.load_state_dict(state_from_jax(_np_state(jm)))
    return jm, pm.to(torch.float64) if dtype == np.float64 else pm, shape, dtype


def _jax_train_forward(jm, x, y):
    """The JAX model's train-mode forward, CrossEntropyLoss and gradients,
    and the buffers its eager forward would leave (functional_call_with_state),
    in one jitted program: (logits, loss, {name: grad}, {name: state})."""
    state = {k: v._data.astype(x.dtype) for k, v in jm.state_dict().items()}
    pnames = [n for n, _ in jm.named_parameters()]
    params = {n: state[n] for n in pnames}
    bufs = {n: a for n, a in state.items() if n not in params}

    def f(params, bufs, x, y):
        logits, new = functional_call_with_state(jm, {**bufs, **params}, Tensor(x))
        loss = paddle.nn.CrossEntropyLoss()(logits, Tensor(y))
        return loss._data, (logits._data, new)

    (loss, (logits, new)), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        params, bufs, x, y)
    return (np.asarray(logits), float(loss), {n: np.asarray(g) for n, g in grads.items()},
            {n: np.asarray(a) for n, a in new.items()})


def _jax_eval_logits(jm, state, x):
    jm.eval()
    return np.asarray(jax.jit(lambda st, x: functional_call(jm, st, Tensor(x))._data)(
        state, x))


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_forward_loss_gradients_and_running_stats_match_jax(kind):
    """Train mode: logits, the CrossEntropyLoss and every gradient, then the
    running statistics one forward moved; eval mode: the logits on them (in
    the model's dtype of MODELS)."""
    jm, pm, shape, dtype = _pair(kind)
    rng = np.random.RandomState(1)
    x = rng.randn(*shape).astype(dtype)
    y = np.array([3, -100] + [5] * (shape[0] - 2), np.int64)[:shape[0]]
    jlog, jloss, jgrads, jstate = _jax_train_forward(jm, x, y)
    plog = pm(torch.from_numpy(x))
    _close(plog, jlog, what=f"{kind} train logits")
    ploss = pnn.CrossEntropyLoss()(plog, torch.from_numpy(y))
    _close(ploss, jloss, what=f"{kind} loss")
    ploss.backward()
    jgrads = state_from_jax(jgrads)
    for n, p in pm.named_parameters():
        _rel_close(p.grad, jgrads[n].numpy(), what=f"{kind} grad {n}")
    bufs = dict(pm.named_buffers())
    assert (kind == "lenet") == (not bufs)
    pstate = state_from_jax(jstate)
    for n, b in bufs.items():
        _rel_close(b, pstate[n].numpy(), what=f"{kind} {n}")
    pm.eval()
    _close(pm(torch.from_numpy(x)), _jax_eval_logits(jm, jstate, x),
           what=f"{kind} eval logits")


# ------------------------------------------------------------- engine steps

_JAX = {}


def _jax_resnet_run():
    """The JAX engine's STEPS steps of resnet18 with loss_fn on the global
    batch, its parameters after each, its buffers after the steps, and the
    eager running statistics of each step's forward (the JAX model's
    train-mode forward with that step's parameters)."""
    if "resnet" in _JAX:
        return _JAX["resnet"]
    set_hybrid_communicate_group(None)
    with numpy_init(0):
        jm = paddle.vision.models.resnet18(num_classes=10)
    for t in list(jm.parameters()) + [b for _, b in jm.named_buffers()]:
        t._data = t._data.astype(jnp.float64)
    state0 = _np_state(jm)
    opt = paddle.optimizer.Momentum(learning_rate=W.RESNET_LR, momentum=W.RESNET_MOMENTUM,
                                    parameters=jm.parameters())
    eng = JaxEngine(jm, opt, loss_fn=paddle.nn.CrossEntropyLoss(), hcg=_jax_hcg())
    x, y = (t.numpy() for t in W.resnet_batch())
    params, losses = [dict(state0)], []
    for _ in range(W.STEPS):
        losses.append(float(eng.step(jnp.asarray(x), jnp.asarray(y)).item()))
        params.append({n: np.asarray(a) for n, a in eng.params.items()})
    engine_buffers = {n: np.asarray(a) for n, a in eng.buffers.items()}
    # the eager update: step i's forward runs on the parameters before it
    eager = jax.jit(lambda st, x: functional_call_with_state(jm, st, Tensor(x))[1])
    state = dict(state0)
    for i in range(W.STEPS):
        state.update(params[i])
        state = {n: np.asarray(a) for n, a in eager(state, x).items()}
    stats = {n: v for n, v in state.items() if n.endswith(("._mean", "._variance"))}
    _JAX["resnet"] = dict(state0=state0, losses=losses, params=params[-1], stats=stats,
                          engine_buffers=engine_buffers)
    return _JAX["resnet"]


def _check_resnet_state(got_state, want, what):
    want_params = state_from_jax(want["params"])
    for n, t in want_params.items():
        _rel_close(got_state[n], t.numpy(), what=f"{what} param {n}")
    for n, v in want["stats"].items():
        _rel_close(got_state[n], v, what=f"{what} running stat {n}")


def test_engine_loss_fn_steps_match_jax_with_eager_running_stats():
    """Two TrainStepEngine steps (loss_fn=CrossEntropyLoss(), Momentum) on one
    process: losses, parameters and the running statistics."""
    ref = _jax_resnet_run()
    m = pvm.resnet18(num_classes=10, device="cpu").double()
    m.load_state_dict(state_from_jax(ref["state0"]))
    opt = popt.Momentum(learning_rate=W.RESNET_LR, momentum=W.RESNET_MOMENTUM,
                        parameters=m.named_parameters())
    eng = TrainStepEngine(m, opt, loss_fn=pnn.CrossEntropyLoss())
    x, y = W.resnet_batch()
    losses = [eng.step(x, y).item() for _ in range(W.STEPS)]
    _close(losses, ref["losses"], what="dp1 losses")
    _check_resnet_state(eng.state_dict()["model"], ref, "dp1")


def test_the_jax_engine_leaves_running_stats_unchanged():
    """On record (ROADMAP.md, deliberate differences): the JAX engine's
    functional_call drops batch norm's updates, so after its steps the
    buffers are still the initial zeros and ones, where its eager forward
    (and the port's engine) moves them."""
    ref = _jax_resnet_run()
    assert ref["engine_buffers"]
    for n, v in ref["engine_buffers"].items():
        np.testing.assert_array_equal(v, ref["state0"][n], err_msg=n)
        assert not np.array_equal(ref["stats"][n], v), n


@pytest.fixture
def fleet_undone():
    """fleet.init in this process undone after the test: the process group,
    the port's hybrid topology and the fleet singleton (a later engine in
    the same process would otherwise pick the topology up)."""
    yield
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed import mesh as pmesh

    pmesh.set_hybrid_communicate_group(None)
    fleet.fleet.__init__()
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


def test_fleet_distributed_engine_takes_loss_fn_and_num_model_inputs(fleet_undone):
    """fleet.distributed_engine(model, opt, loss_fn=...) builds the engine (it
    raised before); num_model_inputs sends more batch tensors to the model."""
    from paddle_tpu_torch.distributed import fleet

    class TwoInputs(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.fc = pnn.Linear(4, 3, device="cpu")

        def forward(self, a, b):
            return self.fc(a + b)

    m = TwoInputs()
    opt = popt.SGD(learning_rate=0.1, parameters=m.named_parameters())
    fleet.init(is_collective=True, device="cpu")
    eng = fleet.distributed_engine(m, opt, loss_fn=pnn.CrossEntropyLoss(),
                                   num_model_inputs=2)
    a, b = torch.randn(4, 4), torch.randn(4, 4)
    y = torch.tensor([0, 1, 2, -100])
    want = pnn.CrossEntropyLoss()(m(a, b), y).item()
    assert eng.step(a, b, y).item() == pytest.approx(want, rel=1e-6)
    assert eng.loss_fn is not None and eng.num_model_inputs == 2


def _bn_net(pkg, device=None):
    """Conv (no bias: batch norm would leave it a gradient of 0) -> BatchNorm
    -> ReLU -> pool -> Linear, in either package."""
    kw = {} if device is None else {"device": device}
    nn = pkg
    return nn.Sequential(nn.Conv2D(3, 8, 3, padding=1, bias_attr=False, **kw),
                         nn.BatchNorm2D(8, **kw),
                         nn.ReLU(), nn.AdaptiveAvgPool2D(2), nn.Flatten(),
                         nn.Linear(32, 5, **kw))


def _bn_net_state(jstate):
    """The JAX state of _bn_net in the port's layout (the Linear is "5")."""
    return {k: torch.from_numpy(np.ascontiguousarray(v.T if k == "5.weight" else v))
            for k, v in jstate.items()}


def test_microbatches_match_the_jax_accumulation_step():
    """K = 2 microbatches on one process against the JAX engine's
    _accum_step: losses and parameters; the running statistics take one
    eager update per microbatch (each on its microbatch)."""
    set_hybrid_communicate_group(None)
    with numpy_init(2):
        jm = _bn_net(paddle.nn)
    state0 = _np_state(jm)
    rng = np.random.RandomState(4)
    x = rng.randn(8, 3, 6, 6).astype(np.float32)
    y = rng.randint(0, 5, (8,)).astype(np.int64)
    y[[0, 5, 6]] = -100
    jeng = JaxEngine(jm, paddle.optimizer.Momentum(learning_rate=0.1,
                                                   parameters=jm.parameters()),
                     loss_fn=paddle.nn.CrossEntropyLoss(), hcg=_jax_hcg(), microbatches=2)
    jloss = float(jeng.step(paddle.to_tensor(x), paddle.to_tensor(y)).item())
    pm = _bn_net(pnn, device="cpu")
    pm.load_state_dict(_bn_net_state(state0))
    peng = TrainStepEngine(pm, popt.Momentum(learning_rate=0.1,
                                             parameters=pm.named_parameters()),
                           loss_fn=pnn.CrossEntropyLoss(), microbatches=2)
    ploss = peng.step(torch.from_numpy(x), torch.from_numpy(y)).item()
    assert ploss == pytest.approx(jloss, rel=TOL)
    want = _bn_net_state({n: np.asarray(a) for n, a in jeng.params.items()})
    for n, p in pm.named_parameters():
        _rel_close(p, want[n].numpy(), what=n)
    eager = jax.jit(lambda st, x: functional_call_with_state(jm, st, Tensor(x))[1])
    state = dict(state0)
    for half in (x[:4], x[4:]):
        state = {n: np.asarray(a) for n, a in eager(state, half).items()}
    for n in ("1._mean", "1._variance"):
        _rel_close(pm.state_dict()[n], state[n], what=n)


def test_a_port_resnet18_checkpoint_loads_into_the_jax_model(tmp_path):
    """paddle_tpu_torch.save of a trained ResNet-18's state (parameters and
    running statistics, in the JAX layout by gather_to_jax) -> paddle.load ->
    the JAX model: the same eval logits."""
    m = pvm.resnet18(num_classes=10, device="cpu", seed=3)
    x, y = W.resnet_batch(dtype=np.float32)
    eng = TrainStepEngine(m, popt.Momentum(learning_rate=0.05,
                                           parameters=m.named_parameters()),
                          loss_fn=pnn.CrossEntropyLoss())
    eng.step(x, y)
    sd = eng.state_dict()["model"]
    path = str(tmp_path / "resnet18.pdparams")
    P.save({k: torch.from_numpy(v) for k, v in gather_to_jax([sd]).items()}, path)
    set_hybrid_communicate_group(None)
    with numpy_init(0):
        jm = paddle.vision.models.resnet18(num_classes=10)
    jm.set_state_dict(paddle.load(path))
    m.eval()
    xe = x[:2].numpy()
    state = {k: v._data for k, v in jm.state_dict().items()}
    _close(m(torch.from_numpy(xe)), _jax_eval_logits(jm, state, xe), what="eval logits")
    assert set(P.load(path, device="cpu")) == set(sd)


def test_models_need_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pvm.resnet50()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pvm.LeNet()
    m = pvm.resnet50(num_classes=7, device="cpu")
    assert m.device == torch.device("cpu") and m.fc.weight.shape == (7, 2048)
    assert sum(p.numel() for p in m.parameters()) == 23522375


# ------------------------------------------------------------- one world of 4 ranks

def _jax_ernie_state():
    from paddle_tpu.models.ernie import ErnieForPretraining, ernie_tiny

    set_hybrid_communicate_group(None)
    with numpy_init(0):
        jm = ErnieForPretraining(ernie_tiny())
    return jm, _np_state(jm)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("vision_world")
    ref = _jax_resnet_run()
    np.savez(d / "resnet.npz", **ref["state0"])
    np.savez(d / "ernie.npz", **_jax_ernie_state()[1])
    spawn(W.run_world, args=(str(d), str(d / "resnet.npz"), str(d / "ernie.npz")),
          nprocs=4, timeout=DEADLINE_S)
    return [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(4)]


def test_resnet_dp4_global_batch_norm_equals_the_jax_one_process_step(world):
    """dp 4 with BatchNorm's statistics over the 4 ranks' rows and the
    ranks' unequal counts of ignored labels: the JAX one-process steps on
    the global batch; every rank ends with the same running statistics."""
    ref = _jax_resnet_run()
    for r, res in enumerate(world):
        out = res["resnet_dp4"]
        _close(out["losses"], ref["losses"], what=f"rank {r} losses")
        _check_resnet_state(out["state"], ref, f"rank {r}")
    for n in ref["stats"]:
        for res in world[1:]:
            assert torch.equal(res["resnet_dp4"]["state"][n],
                               world[0]["resnet_dp4"]["state"][n]), n


def _jax_ernie_run():
    if "ernie" in _JAX:
        return _JAX["ernie"]
    jm, state0 = _jax_ernie_state()
    opt = paddle.optimizer.AdamW(learning_rate=W.ERNIE_LR, parameters=jm.parameters(),
                                 weight_decay=0.01)
    eng = JaxEngine(jm, opt, hcg=_jax_hcg())
    batch = [paddle.to_tensor(t.numpy()) for t in W.ernie_batch()]
    losses = [float(eng.step(*batch).item()) for _ in range(W.STEPS)]
    _JAX["ernie"] = dict(losses=losses, params={n: np.asarray(a)
                                                for n, a in eng.params.items()})
    return _JAX["ernie"]


def _adam_params_close(got, want, what):
    """tests/test_torch_accum.py's rule for Adam trajectories: atol 5 x lr,
    and at most 0.1% of all the entries more than 1e-5 apart (an entry whose
    exact gradient is 0, such as the key bias's, moves by lr x the sign of
    its rounding)."""
    apart = total = 0
    for n, t in want.items():
        g, w = got[n].numpy(), t.numpy()
        np.testing.assert_allclose(g, w, atol=5 * W.ERNIE_LR, rtol=0, err_msg=f"{what} {n}")
        apart += int(np.sum(np.abs(g - w) > 1e-5))
        total += w.size
    assert apart <= 1e-3 * total, (what, apart, total)


def test_ernie_dp2_sharding2_equals_the_jax_step_with_a_quarter_of_the_state(world):
    ref = _jax_ernie_run()
    for r, res in enumerate(world):
        out = res["ernie_dp2_sh2"]
        np.testing.assert_allclose(out["losses"], ref["losses"], rtol=TOL,
                                   err_msg=f"rank {r}")
        assert out["replicas"] == 4
        assert out["opt_elems_held"] <= out["opt_elems_replicated"] / 4 + 4096
    _adam_params_close(world[0]["ernie_dp2_sh2"]["state"], state_from_jax(ref["params"]),
                       "dp2 x sharding2")
