"""Recompute (activation checkpointing): paddle_tpu_torch's
``GPTConfig(use_recompute=True, recompute_granularity=...)`` against the JAX
model's recompute and against the port's own step without it.

gpt_tiny, ids [2, 128] from numpy, weights from ``paddle.seed(0)`` carried
over by models/convert.py. Tolerances: every gradient within 2e-5 of JAX's
recompute gradient (tests/test_torch_train.py's f32 bar) and within 1e-6 of
the port's own gradient without recompute (the replay computes the same
products on the same inputs; only the order autograd accumulates a
parameter's gradient in may differ), also with dropout 0.1 (a replay that
drew other masks than the forward is off by O(1e-2)). Under bf16 auto_cast
the same 1e-6: a backward outside the ``with auto_cast`` block must replay
in bf16, as its forward ran.
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import paddle_tpu as paddle
from paddle_tpu.distributed.mesh import set_hybrid_communicate_group
from paddle_tpu.models import GPTForPretraining as JaxGPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu_torch.amp import auto_cast
from paddle_tpu_torch.distributed.fleet import recompute
from paddle_tpu_torch.distributed.fleet.utils import selective_policy
from paddle_tpu_torch.models import (GPTForPretraining, gpt_tiny, load_jax_state,
                                     state_from_jax)

GRAD_ATOL = 2e-5
SELF_ATOL = 1e-6
GRANULARITIES = ["full", "selective"]


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 1024, (2, 128)).astype(np.int64)
    labels = np.roll(ids, -1, 1)
    labels[:, -1] = -100
    return ids, labels


def _jax_state():
    set_hybrid_communicate_group(None)
    paddle.seed(0)
    return {n: np.asarray(v._data) for n, v in JaxGPT(jax_gpt_tiny()).state_dict().items()}


def _port_grads(cfg, ids, labels, amp=None, backward_outside=False, state=None, seed=0):
    pm = GPTForPretraining(cfg, device="cpu", seed=seed)
    if state is not None:
        load_jax_state(pm, state)
    with auto_cast(enable=amp is not None, dtype=amp or "bfloat16"):
        loss = pm(torch.from_numpy(ids), torch.from_numpy(labels))
        if not backward_outside:
            loss.backward()
    if backward_outside:
        loss.backward()
    return loss.item(), {n: p.grad.float().numpy() for n, p in pm.named_parameters()}


def _close(got, want, atol):
    assert set(got) == set(want)
    for n in sorted(want):
        assert np.abs(got[n]).max() > 0, n
        np.testing.assert_allclose(got[n], want[n], atol=atol, rtol=0, err_msg=n)


@pytest.mark.parametrize("granularity", GRANULARITIES)
def test_recompute_gradients_match_jax_recompute(granularity):
    state = _jax_state()
    ids, labels = _batch(1)
    set_hybrid_communicate_group(None)
    paddle.seed(0)
    jm = JaxGPT(jax_gpt_tiny(use_recompute=True, recompute_granularity=granularity))
    jm.set_state_dict({n: paddle.to_tensor(v) for n, v in state.items()})
    jloss = jm(paddle.to_tensor(ids), paddle.to_tensor(labels))
    jloss.backward()
    jgrads = {k: v.numpy() for k, v in state_from_jax(
        {n: np.asarray(p.grad._data) for n, p in jm.named_parameters()}).items()}
    cfg = gpt_tiny(use_recompute=True, recompute_granularity=granularity)
    loss, grads = _port_grads(cfg, ids, labels, state=state)
    np.testing.assert_allclose(loss, float(jloss.item()), rtol=1e-5)
    _close(grads, jgrads, GRAD_ATOL)


@pytest.mark.parametrize("dropout", [0.0, 0.1])
@pytest.mark.parametrize("granularity", GRANULARITIES)
def test_recompute_gradients_match_the_step_without_it(granularity, dropout):
    ids, labels = _batch(2)
    kw = dict(dropout=dropout, attention_dropout=dropout)
    loss0, want = _port_grads(gpt_tiny(**kw), ids, labels, seed=5)
    loss1, got = _port_grads(gpt_tiny(use_recompute=True,
                                      recompute_granularity=granularity, **kw),
                             ids, labels, seed=5)
    assert loss1 == loss0
    _close(got, want, SELF_ATOL)


@pytest.mark.parametrize("granularity", GRANULARITIES)
def test_bf16_replay_outside_the_autocast_block(granularity):
    ids, labels = _batch(3)
    cfg = gpt_tiny(use_recompute=True, recompute_granularity=granularity)
    _, inside = _port_grads(cfg, ids, labels, amp="bfloat16", seed=6)
    _, outside = _port_grads(cfg, ids, labels, amp="bfloat16", backward_outside=True,
                             seed=6)
    _, plain = _port_grads(gpt_tiny(), ids, labels, amp="bfloat16", seed=6)
    _close(outside, inside, SELF_ATOL)
    _close(outside, plain, SELF_ATOL)


def test_the_generator_moves_on_as_without_recompute():
    """After a recomputed step the model's dropout generator stands where a
    step without recompute leaves it: the replay puts its state back."""
    ids, labels = _batch(4)
    states = []
    for rc in (False, True):
        pm = GPTForPretraining(gpt_tiny(dropout=0.1, use_recompute=rc), device="cpu",
                               seed=7)
        pm(torch.from_numpy(ids), torch.from_numpy(labels)).backward()
        states.append(pm.generator.get_state())
    assert torch.equal(states[0], states[1])


class _OpCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func] = self.counts.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


def _backward_ops(granularity):
    ids, labels = _batch(5)
    cfg = gpt_tiny(use_recompute=granularity is not None,
                   recompute_granularity=granularity or "full")
    pm = GPTForPretraining(cfg, device="cpu", seed=8)
    loss = pm(torch.from_numpy(ids), torch.from_numpy(labels))
    with _OpCounter() as c:
        loss.backward()
    return c.counts


def test_selective_replays_no_linear_product_and_full_replays_them_all():
    aten = torch.ops.aten
    linear = (aten.mm.default, aten.addmm.default)
    none, full, sel = (_backward_ops(g) for g in (None, "full", "selective"))
    # qkv, out and fc1 a layer: nothing saves fc2's output, and the replay
    # stops once it has rebuilt what the backward needs
    n_linear = 3 * gpt_tiny().num_layers
    assert sum(sel.get(op, 0) for op in linear) == sum(none.get(op, 0) for op in linear)
    assert (sum(full.get(op, 0) for op in linear)
            == sum(none.get(op, 0) for op in linear) + n_linear)
    # attention's batched products are recomputed under both
    assert sel.get(aten.bmm.default, 0) == full.get(aten.bmm.default, 0) > none.get(
        aten.bmm.default, 0)


def test_selective_policy_saves_only_products_without_batch_dims():
    from torch.utils.checkpoint import CheckpointPolicy
    aten = torch.ops.aten
    save, again = CheckpointPolicy.MUST_SAVE, CheckpointPolicy.PREFER_RECOMPUTE
    for op, want in ((aten.mm.default, save), (aten.addmm.default, save),
                     (aten.bmm.default, again), (aten.baddbmm.default, again),
                     (aten.empty.memory_format, again),   # a kernel's output buffer
                     (aten.rand.default, again), (aten.gelu.default, again)):
        assert selective_policy(None, op) == want, op


def test_unknown_policy_raises_and_no_grad_runs_plainly():
    x = torch.ones(3, requires_grad=True)
    with pytest.raises(ValueError, match="unknown recompute policy"):
        recompute(torch.sin, x, policy="dots_saveable_typo")
    with torch.no_grad():
        assert torch.equal(recompute(torch.sin, x, policy="full"), torch.sin(x))
    cfg = gpt_tiny(use_recompute=True, recompute_granularity="everything")
    pm = GPTForPretraining(cfg, device="cpu")
    ids, labels = _batch(6)
    with pytest.raises(ValueError, match="unknown recompute policy"):
        pm(torch.from_numpy(ids), torch.from_numpy(labels))
