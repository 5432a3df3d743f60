"""paddle_tpu_torch.incubate (LookAhead, ModelAverage) against the JAX
package's on the same numpy weights and gradients, and the GradScaler
around a LookAhead.

The port writes parameters in place where the JAX package swaps immutable
arrays, so each test also checks that the slow weights and the backup are
copies: a snapshot that aliased the parameters would follow the fast
weights and fail the comparison. Tolerances: f32 rtol 1e-6, atol 1e-7 (the
same f32 arithmetic); ModelAverage's restore bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.incubate import LookAhead as JaxLookAhead
from paddle_tpu.incubate import ModelAverage as JaxModelAverage
from paddle_tpu_torch import optimizer as port_opt
from paddle_tpu_torch.amp import GradScaler
from paddle_tpu_torch.incubate import LookAhead, ModelAverage


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=1e-6, atol=1e-7)


def _params(seed):
    rng = np.random.RandomState(seed)
    vals = [rng.randn(4, 3).astype(np.float32), rng.randn(3).astype(np.float32)]
    jps = []
    for i, v in enumerate(vals):
        p = paddle.create_parameter(list(v.shape), dtype="float32", name=f"p{i}")
        p.set_value(v)
        jps.append(p)
    tps = [torch.from_numpy(v.copy()).requires_grad_() for v in vals]
    return rng, jps, tps


def _feed(rng, jps, tps):
    for jp, tp in zip(jps, tps):
        g = rng.randn(*tp.shape).astype(np.float32)
        jp.grad = Tensor(jnp.asarray(g))
        tp.grad = torch.from_numpy(g)


@pytest.mark.parametrize("inner,k", [("SGD", 2), ("AdamW", 3)])
def test_lookahead_matches_jax(inner, k):
    rng, jps, tps = _params(0)
    w0 = [t.detach().clone() for t in tps]
    jla = JaxLookAhead(getattr(paddle.optimizer, inner)(learning_rate=0.1, parameters=jps),
                       alpha=0.4, k=k)
    pla = LookAhead(getattr(port_opt, inner)(learning_rate=0.1, parameters=tps),
                    alpha=0.4, k=k)
    for step in range(1, 2 * k + 2):
        _feed(rng, jps, tps)
        jla.step()
        pla.step()
        for jp, tp in zip(jps, tps):
            _close(tp.detach(), jp._data)
        if step < k:   # the slow weights are still the start, not the fast weights
            assert all(torch.equal(s, w) for s, w in zip(pla._slow, w0))
        jla.clear_grad()
        pla.clear_grad()
        assert all(t.grad is None for t in tps)
    assert pla.get_lr() == jla.get_lr() == 0.1
    assert pla.state_dict()["lookahead_steps"] == jla.state_dict()["lookahead_steps"]
    assert pla._parameters is pla.inner_optimizer._parameter_list


def test_lookahead_minimize_matches_jax():
    rng, jps, tps = _params(1)
    x = rng.randn(4).astype(np.float32)
    jla = JaxLookAhead(paddle.optimizer.SGD(learning_rate=0.1, parameters=jps), k=2)
    pla = LookAhead(port_opt.SGD(learning_rate=0.1, parameters=tps), k=2)
    for _ in range(3):
        jla.minimize((paddle.matmul(paddle.to_tensor(x), jps[0]) * jps[1]).sum())
        pla.minimize((torch.from_numpy(x) @ tps[0] * tps[1]).sum())
        assert all(t.grad is None for t in tps)
        for jp, tp in zip(jps, tps):
            _close(tp.detach(), jp._data)


def test_model_average_matches_jax_and_restores_bit_for_bit():
    rng, jps, tps = _params(2)
    jopt = paddle.optimizer.Adam(learning_rate=0.05, parameters=jps)
    popt = port_opt.Adam(learning_rate=0.05, parameters=tps)
    jma = JaxModelAverage(0.15, parameters=jps, min_average_window=2, max_average_window=4)
    pma = ModelAverage(0.15, parameters=tps, min_average_window=2, max_average_window=4)
    with pytest.raises(RuntimeError):
        pma.apply()
    for _ in range(4):
        _feed(rng, jps, tps)
        jopt.step()
        popt.step()
        jma.step()
        pma.step()
    fast = [t.detach().clone() for t in tps]
    with pma.apply():
        with jma.apply():
            for jp, tp in zip(jps, tps):
                _close(tp.detach(), jp._data)
        assert not torch.equal(tps[0], fast[0])
    assert all(torch.equal(a, b) for a, b in zip(tps, fast))
    # apply without the context, a step of the optimizer on the averaged
    # weights, then restore: the backup is a copy, not the parameters
    assert pma.apply(need_restore=False) is None
    _feed(rng, jps, tps)
    popt.step()
    pma.restore()
    assert all(torch.equal(a, b) for a, b in zip(tps, fast))
    pma.restore()        # nothing to restore: no change
    assert all(torch.equal(a, b) for a, b in zip(tps, fast))


def test_model_average_takes_named_parameters():
    lin = torch.nn.Linear(3, 2)
    ma = ModelAverage(parameters=lin.named_parameters())
    ma.step()
    with torch.no_grad():
        lin.weight.add_(1.0)
    ma.step()
    w = lin.weight.detach().clone()
    with ma.apply():
        torch.testing.assert_close(lin.weight.detach(), w - 0.5)
    assert torch.equal(lin.weight.detach(), w)
    with pytest.raises(ValueError):
        ModelAverage()


def test_grad_scaler_around_lookahead():
    """Scaled grads, unscale_ on the inner optimizer (the scaler reads
    ``_parameter_list``, which a LookAhead does not have, in either
    package), then step(lookahead): the same weights as the LookAhead on
    the unscaled grads; an inf step is skipped and counts no LookAhead
    step."""
    rng, _, tps = _params(3)
    ref = [t.detach().clone().requires_grad_() for t in tps]
    inner = port_opt.AdamW(learning_rate=0.05, parameters=tps)
    la = LookAhead(inner, alpha=0.5, k=2)
    ref_la = LookAhead(port_opt.AdamW(learning_rate=0.05, parameters=ref), alpha=0.5, k=2)
    scaler = GradScaler(init_loss_scaling=2.0 ** 10)
    for bad in (False, False, True, False):
        grads = [torch.from_numpy(rng.randn(*t.shape).astype(np.float32)) for t in tps]
        for t, r, g in zip(tps, ref, grads):
            t.grad = g * scaler._scale
            r.grad = g.clone()
        if bad:
            tps[1].grad[0] = float("nan")
        before = [t.detach().clone() for t in tps]
        scaler.unscale_(inner)
        scaler.step(la)
        scaler.update()
        if bad:
            assert all(torch.equal(a, b) for a, b in zip(before, tps))
            assert la._steps == 2 and scaler._scale == 2.0 ** 9
        else:
            ref_la.step()
            for t, r in zip(tps, ref):
                torch.testing.assert_close(t.detach(), r.detach(), rtol=1e-6, atol=1e-7)
    assert la._steps == ref_la._steps == 3
