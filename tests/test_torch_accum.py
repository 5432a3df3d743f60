"""In-program microbatch accumulation: paddle_tpu_torch's
``TrainStepEngine(microbatches=K)`` against the JAX engine's (grad_comm's
accumulation step on a 1-device dp mesh) on the same weights and batch.

gpt_tiny, ids [4, 128] from numpy, AdamW(1e-3, weight_decay 0.01), 3 steps.
Tolerances as tests/test_torch_train.py's trajectory: losses rtol 1e-5,
parameters atol 5 x lr with at most 0.1% of the entries more than 1e-5
apart (Adam moves an entry by about lr x sign(g), and a gradient within
rounding of 0 may take the other sign in the other package).
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
from paddle_tpu_torch.distributed import TrainStepEngine
from paddle_tpu_torch.models import (GPTForPretraining, gpt_tiny, load_jax_state,
                                     state_from_jax)
from paddle_tpu_torch.optimizer import AdamW

LR = 1e-3


def _batch(b=4, s=128, seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 1024, (b, s)).astype(np.int64)
    labels = np.roll(ids, -1, 1)
    labels[:, -1] = -100
    labels[1, :5] = -100        # microbatches with unequal counts of labels
    return ids, labels


def _engines(k):
    set_hybrid_communicate_group(None)
    paddle.seed(0)
    jm = JaxGPT(jax_gpt_tiny())
    state = {n: np.asarray(v._data) for n, v in jm.state_dict().items()}
    hcg = HybridCommunicateGroup(dp_degree=1, devices=jax.devices()[:1])
    jopt = paddle.optimizer.AdamW(learning_rate=LR, parameters=jm.parameters(),
                                  weight_decay=0.01)
    jeng = JaxEngine(jm, jopt, hcg=hcg, microbatches=k)
    pm = load_jax_state(GPTForPretraining(gpt_tiny(), device="cpu"), state)
    popt = AdamW(learning_rate=LR, parameters=pm.named_parameters(), weight_decay=0.01)
    return jeng, TrainStepEngine(pm, popt, microbatches=k), pm


@pytest.mark.parametrize("k", [2, 4])
def test_accumulated_steps_match_the_jax_engine(k):
    jeng, peng, pm = _engines(k)
    ids, labels = _batch(seed=k)
    jl, pl = [], []
    for _ in range(3):
        jl.append(float(jeng.step(paddle.to_tensor(ids), paddle.to_tensor(labels)).item()))
        pl.append(peng.step(ids, labels).item())
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    assert pl[-1] < pl[0]
    want = {k2: v.numpy() for k2, v in state_from_jax(
        {n: np.asarray(a) for n, a in jeng.params.items()}).items()}
    got = {n: v.detach().numpy() for n, v in pm.state_dict().items()}
    apart = total = 0
    for n in sorted(want):
        np.testing.assert_allclose(got[n], want[n], atol=5 * LR, rtol=0, err_msg=n)
        apart += int((np.abs(got[n] - want[n]) > 1e-5).sum())
        total += want[n].size
    assert apart <= 1e-3 * total, (apart, total)


def _port_engine(k=None):
    """The port's engine with microbatches=k, or the plain one (no argument)."""
    pm = GPTForPretraining(gpt_tiny(), device="cpu", seed=2)
    opt = AdamW(LR, parameters=pm.named_parameters())
    if k is None:
        return TrainStepEngine(pm, opt), pm
    return TrainStepEngine(pm, opt, microbatches=k), pm


@pytest.fixture
def deterministic():
    """Deterministic CPU kernels: the embedding's backward accumulates its
    rows in a thread-dependent order otherwise."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


def test_one_microbatch_is_the_plain_step_bit_for_bit(deterministic, monkeypatch):
    ids, labels = _batch(seed=7)
    (e1, m1), (e0, m0) = _port_engine(1), _port_engine()
    # one process, no topology: the plain step (a hybrid topology left set by
    # an earlier fleet.init would give the engines a group)
    assert e1.group is None and e0.group is None, (
        f"the engines have a group ({e1.group!r}, {e0.group!r}): a hybrid topology is set "
        "in this process")
    # K = 1 never enters the accumulation loop
    monkeypatch.setattr(TrainStepEngine, "_accumulate", None)
    for _ in range(2):
        assert torch.equal(e1.step(ids, labels), e0.step(ids, labels))
    for (n, a), (_, b) in zip(m1.named_parameters(), m0.named_parameters()):
        assert torch.equal(a, b), n
        assert torch.equal(a.grad, b.grad), n


def test_microbatches_is_a_mutable_attribute_and_an_indivisible_batch_raises():
    ids, labels = _batch(b=6, seed=8)
    eng, _ = _port_engine()
    eng.microbatches = 4
    with pytest.raises(ValueError, match="not divisible by microbatches = 4"):
        eng.step(ids, labels)
    eng.microbatches = 3
    assert np.isfinite(eng.step(ids, labels).item())


def test_the_fleet_test_before_this_one_leaves_no_topology():
    """The vision test that calls fleet.init, then the one-microbatch test,
    in one process: both pass (the order of the test files no longer
    matters)."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    ids = ["tests/test_torch_vision.py::"
           "test_fleet_distributed_engine_takes_loss_fn_and_num_model_inputs",
           "tests/test_torch_accum.py::test_one_microbatch_is_the_plain_step_bit_for_bit"]
    res = subprocess.run([sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
                          "-p", "no:randomly", *ids], cwd=str(root), capture_output=True,
                         text=True, timeout=600, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert res.returncode == 0 and "2 passed" in res.stdout, res.stdout[-3000:] + res.stderr[-2000:]
