"""The training slice as a whole: paddle_tpu_torch's gpt_tiny loss, gradients
and TrainStepEngine trajectory against the JAX package's on the same weights.

gpt_tiny at seq 128 (so attention meets the flash route's shape gate on the
card; here the port's CPU path is the dense one), ids [2, 128] from numpy,
labels = roll(ids, -1) with a few ignored positions. JAX weights come from
``paddle.seed(0)`` and are carried into the port by models/convert.py.

Tolerances:
- loss at f32: rtol 1e-5; every parameter's gradient at f32: atol 2e-5
  (gradients of order 1e-2 to 1; two layers of f32 products in another
  order);
- the 5-step AdamW trajectory (lr 1e-3): losses rtol 1e-5; parameters atol
  5 x lr. Adam's first steps move a parameter by about lr x sign(g), so a
  gradient within rounding of 0 may take the other sign in the other
  package: the key bias is one (a constant added to every score of a row
  leaves the softmax as it is, so its exact gradient is 0). At most 0.1%
  of the entries may differ by more than 1e-5;
- one bf16-autocast step: loss rtol 1e-2; each parameter's gradient within
  3e-2 of JAX's bf16-autocast gradient, relative in the Frobenius norm (the
  two packages' bf16 gradients differ by about 1%, as much as bf16's own
  effect, about 0.7% from the f32 gradients, so the test also checks that
  the step's gradients are at least 1e-3 away from the f32 ones: the
  backward really ran at bf16; a missing or zero gradient is 1 away);
  parameters atol 5 x lr, with at most 1% of the entries more than 1e-5
  apart (sign flips of gradients within bf16 noise of 0).
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed.engine import TrainStepEngine as JaxEngine
from paddle_tpu.distributed.mesh import (HybridCommunicateGroup,
                                         set_hybrid_communicate_group)
from paddle_tpu.models import GPTForPretraining as JaxGPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu_torch.amp import auto_cast
from paddle_tpu_torch.distributed import TrainStepEngine
from paddle_tpu_torch.models import (GPTForPretraining, gpt_tiny, load_jax_state,
                                     state_from_jax)
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.serving import ServingEngine
from torch_api_util import jax_flags_restored  # noqa: F401

LR = 1e-3
GRAD_ATOL = 2e-5
BF16_GRAD_RTOL = 3e-2


def _batch(b=2, s=128, seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 1024, (b, s)).astype(np.int64)
    labels = np.roll(ids, -1, 1)
    labels[:, -1] = -100        # the wrapped position is ignored
    labels[0, :3] = -100
    return ids, labels


def _jax_model():
    set_hybrid_communicate_group(None)
    paddle.seed(0)
    return JaxGPT(jax_gpt_tiny())


def _numpy_state(jm):
    return {k: np.asarray(v._data) for k, v in jm.state_dict().items()}


def _port_model(state):
    return load_jax_state(GPTForPretraining(gpt_tiny(), device="cpu"), state)


def _as_port_layout(named_arrays):
    """JAX-layout arrays (Linear weights [in, out]) -> the port's layout."""
    return {k: v.numpy() for k, v in state_from_jax(named_arrays).items()}


def _port_state(pm):
    return {k: v.detach().numpy() for k, v in pm.state_dict().items()}


def test_loss_and_every_gradient_match_jax_at_f32():
    jm = _jax_model()
    state = _numpy_state(jm)
    pm = _port_model(state)
    ids, labels = _batch()

    jloss = jm(paddle.to_tensor(ids), paddle.to_tensor(labels))
    jloss.backward()
    jgrads = _as_port_layout({n: np.asarray(p.grad._data)
                              for n, p in jm.named_parameters()})

    ploss = pm(torch.from_numpy(ids), torch.from_numpy(labels))
    ploss.backward()
    pgrads = {n: p.grad.numpy() for n, p in pm.named_parameters()}

    np.testing.assert_allclose(ploss.item(), float(jloss.item()), rtol=1e-5)
    assert set(pgrads) == set(jgrads) == set(state)
    for n in sorted(pgrads):
        assert np.abs(pgrads[n]).max() > 0, n
        np.testing.assert_allclose(pgrads[n], jgrads[n], atol=GRAD_ATOL, rtol=0,
                                   err_msg=n)


def test_gradients_match_jax_through_its_flash_route(jax_flags_restored):
    """The JAX model through its interpreted Pallas flash forward and FA2
    backward kernels (use_flash_attention) against the port's CPU path."""
    jm = _jax_model()
    pm = _port_model(_numpy_state(jm))
    ids, labels = _batch(b=1, seed=1)
    paddle.set_flags({"use_flash_attention": True, "pallas_interpret_ok": True})
    jloss = jm(paddle.to_tensor(ids), paddle.to_tensor(labels))
    jloss.backward()
    jgrads = _as_port_layout({n: np.asarray(p.grad._data)
                              for n, p in jm.named_parameters()})
    ploss = pm(torch.from_numpy(ids), torch.from_numpy(labels))
    ploss.backward()
    np.testing.assert_allclose(ploss.item(), float(jloss.item()), rtol=1e-5)
    for n, p in pm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jgrads[n], atol=GRAD_ATOL, rtol=0,
                                   err_msg=n)


def _engines():
    """The JAX TrainStepEngine on a 1-device dp mesh and the port's, from the
    same weights, both AdamW(LR, weight_decay=0.01)."""
    jm = _jax_model()
    state = _numpy_state(jm)
    hcg = HybridCommunicateGroup(dp_degree=1, devices=jax.devices()[:1])
    jopt = paddle.optimizer.AdamW(learning_rate=LR, parameters=jm.parameters(),
                                  weight_decay=0.01)
    jeng = JaxEngine(jm, jopt, hcg=hcg)
    pm = _port_model(state)
    popt = AdamW(learning_rate=LR, parameters=pm.named_parameters(), weight_decay=0.01)
    return jeng, TrainStepEngine(pm, popt), pm


def _jax_params(jeng):
    return _as_port_layout({n: np.asarray(a) for n, a in jeng.params.items()})


def test_five_step_trajectory_matches_the_jax_engine():
    jeng, peng, pm = _engines()
    ids, labels = _batch(seed=2)
    jl, pl = [], []
    for _ in range(5):
        jl.append(float(jeng.step(paddle.to_tensor(ids), paddle.to_tensor(labels)).item()))
        pl.append(peng.step(ids, labels).item())
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    assert pl[-1] < pl[0]
    assert peng.optimizer._step_count == jeng.optimizer._step_count == 5
    want = _jax_params(jeng)
    got = _port_state(pm)
    apart = total = 0
    for n in sorted(want):
        np.testing.assert_allclose(got[n], want[n], atol=5 * LR, rtol=0, err_msg=n)
        apart += int((np.abs(got[n] - want[n]) > 1e-5).sum())
        total += want[n].size
    # the sign-flip allowance covers a few entries, not whole tensors
    assert apart <= 1e-3 * total, (apart, total)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_one_bf16_autocast_step_matches_the_jax_engine():
    ids, labels = _batch(seed=3)
    # JAX's gradients under bf16 autocast, on the weights both engines start from
    jm = _jax_model()
    with paddle.amp.auto_cast(dtype="bfloat16"):
        jm(paddle.to_tensor(ids), paddle.to_tensor(labels)).backward()
    jgrads = _as_port_layout({n: np.asarray(p.grad._data)
                              for n, p in jm.named_parameters()})
    # the port's f32 gradients on the same weights
    p32 = _port_model(_numpy_state(_jax_model()))
    p32(torch.from_numpy(ids), torch.from_numpy(labels)).backward()
    f32_grads = {n: p.grad.numpy() for n, p in p32.named_parameters()}

    jeng, peng, pm = _engines()
    with paddle.amp.auto_cast(dtype="bfloat16"):
        jl = float(jeng.step(paddle.to_tensor(ids), paddle.to_tensor(labels)).item())
    with auto_cast(dtype="bfloat16"):
        pl = peng.step(ids, labels).item()
    np.testing.assert_allclose(pl, jl, rtol=1e-2)

    # the engine leaves the step's (unclipped) gradients on the parameters
    pgrads = {n: p.grad.numpy() for n, p in pm.named_parameters()}
    assert set(pgrads) == set(jgrads)
    for n in sorted(pgrads):
        assert _rel(pgrads[n], jgrads[n]) <= BF16_GRAD_RTOL, n
    # ... and they are the bf16 backward's, not the f32 one's
    away = (sum(np.linalg.norm(pgrads[n] - f32_grads[n]) ** 2 for n in pgrads)
            / sum(np.linalg.norm(f32_grads[n]) ** 2 for n in pgrads)) ** 0.5
    assert away >= 1e-3, away

    want = _jax_params(jeng)
    got = _port_state(pm)
    apart = total = 0
    for n in sorted(want):
        assert got[n].dtype == np.float32
        np.testing.assert_allclose(got[n], want[n], atol=5 * LR, rtol=0, err_msg=n)
        apart += int((np.abs(got[n] - want[n]) > 1e-5).sum())
        total += want[n].size
    # a gradient within bf16 noise of 0 may take the other sign: 1% of entries
    assert apart <= 1e-2 * total, (apart, total)


def test_untied_lm_head_loss_and_gradients_match_jax():
    """gpt_tiny(tie_word_embeddings=False): the port sends the untied head
    through its fused f32 loss, the reference through ColumnParallelLinear
    (white-listed: bf16 logits under O1) and an f32 cross entropy. At f32:
    loss rtol 1e-5 and every gradient at GRAD_ATOL. Under bf16 O1: loss
    rtol 1e-2 and every gradient within BF16_GRAD_RTOL of JAX's
    paddle.amp.auto_cast gradient (relative, Frobenius; measured 1.1% at
    worst, on a bias of the second block's MLP)."""
    ids, labels = _batch(seed=3)

    def jax_model():
        set_hybrid_communicate_group(None)
        paddle.seed(0)
        return JaxGPT(jax_gpt_tiny(tie_word_embeddings=False))

    state = _numpy_state(jax_model())
    assert state["lm_head.weight"].shape == (128, 1024)       # [hidden, vocab]
    for amp in (None, "bfloat16"):
        jm = jax_model()
        if amp is None:
            jloss = jm(paddle.to_tensor(ids), paddle.to_tensor(labels))
        else:
            with paddle.amp.auto_cast(dtype=amp):
                jloss = jm(paddle.to_tensor(ids), paddle.to_tensor(labels))
        jloss.backward()
        jgrads = _as_port_layout({n: np.asarray(p.grad._data)
                                  for n, p in jm.named_parameters()})
        pm = load_jax_state(GPTForPretraining(gpt_tiny(tie_word_embeddings=False),
                                              device="cpu"), state)
        assert pm.lm_head is not None
        with auto_cast(enable=amp is not None, dtype=amp or "bfloat16"):
            ploss = pm(torch.from_numpy(ids), torch.from_numpy(labels))
        ploss.backward()
        pgrads = {n: p.grad.float().numpy() for n, p in pm.named_parameters()}
        assert set(pgrads) == set(jgrads) == set(state)
        np.testing.assert_allclose(ploss.item(), float(jloss.item()),
                                   rtol=1e-5 if amp is None else 1e-2)
        for n in sorted(pgrads):
            assert np.abs(pgrads[n]).max() > 0, n
            if amp is None:
                np.testing.assert_allclose(pgrads[n], jgrads[n], atol=GRAD_ATOL, rtol=0,
                                           err_msg=n)
            else:
                assert _rel(pgrads[n], jgrads[n]) <= BF16_GRAD_RTOL, n


def test_engine_refuses_a_parameter_the_optimizer_does_not_hold():
    pm = GPTForPretraining(gpt_tiny(), device="cpu")
    params = [p for n, p in pm.named_parameters() if n != "gpt.ln_f.bias"]
    with pytest.raises(ValueError, match="ln_f.bias"):
        TrainStepEngine(pm, AdamW(parameters=params))


def test_dropout_is_deterministic_from_the_seed_and_off_in_eval():
    ids, labels = _batch(seed=4)
    cfg = gpt_tiny(dropout=0.1, attention_dropout=0.1)
    a = GPTForPretraining(cfg, device="cpu", seed=5)
    b = GPTForPretraining(cfg, device="cpu", seed=5)
    la, lb = (m(torch.from_numpy(ids), torch.from_numpy(labels)) for m in (a, b))
    assert torch.equal(la, lb)
    la2 = a(torch.from_numpy(ids), torch.from_numpy(labels))
    assert not torch.equal(la, la2)               # the generator moved on
    a.eval()
    ref = GPTForPretraining(gpt_tiny(), device="cpu", seed=5).eval()
    with torch.no_grad():
        assert torch.equal(a(torch.from_numpy(ids), torch.from_numpy(labels)),
                           ref(torch.from_numpy(ids), torch.from_numpy(labels)))


def test_a_served_model_trains_with_its_dropout():
    """Serving snapshots the model in eval mode and leaves the caller's
    model in training mode: a step after serving draws the same dropout as
    a step of a model that was never served."""
    ids, labels = _batch(seed=6)
    cfg = gpt_tiny(dropout=0.1, attention_dropout=0.1)
    served, fresh = (GPTForPretraining(cfg, device="cpu", seed=5) for _ in range(2))
    eng = ServingEngine(served, slot_count=2, ladder=(8, 16, 32), max_new_cap=16)
    req = eng.submit(ids[0, :9], max_new_tokens=4)
    eng.run()
    assert req.done and served.training
    losses = [TrainStepEngine(m, AdamW(LR, parameters=m.named_parameters()))
              .step(ids, labels) for m in (served, fresh)]
    assert torch.equal(losses[0], losses[1])
    ref = GPTForPretraining(gpt_tiny(), device="cpu", seed=5).eval()
    with torch.no_grad():
        no_dropout = ref(torch.from_numpy(ids), torch.from_numpy(labels))
    assert not torch.equal(losses[0], no_dropout)

