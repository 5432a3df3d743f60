"""paddle_tpu_torch.ops.fused.fused_linear_cross_entropy vs the JAX package's
paddle_tpu.ops.fused.fused_linear_cross_entropy on the same numpy inputs.

Covered: ignore_index rows, a row count that needs padding, a chunk smaller
than the rows (the JAX side through FLAGS_fused_ce_chunk, the port through
its ``chunk`` argument), ``transpose_y`` both ways, and bf16 inputs. The
loss and the gradients of hidden and weight (through ``.mean()``, as the
model reduces it) are compared. Tolerances: f32 atol 2e-5 on the loss and
1e-5 on gradients (one [rows, vocab] product and a logsumexp summed in
another order); bf16 atol 2e-2 x max|ref| (dl rounds to bf16 in both).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.ops.fused import fused_linear_cross_entropy as jax_flce
from paddle_tpu_torch.ops.fused import fused_linear_cross_entropy as port_flce
from torch_api_util import jax_flags_restored  # noqa: F401

LOSS_ATOL = 2e-5
GRAD_ATOL = 1e-5


def _data(b, s, v, hdim, seed, n_ignored=0):
    rng = np.random.RandomState(seed)
    h = rng.randn(b, s, hdim).astype(np.float32)
    w = (rng.randn(v, hdim) * 0.1).astype(np.float32)
    labels = rng.randint(0, v, (b, s)).astype(np.int64)
    labels.reshape(-1)[:n_ignored] = -100
    return h, w, labels


def _jax(h, w, labels, transpose_y, dtype="float32"):
    th = paddle.to_tensor(h).astype(dtype)
    tw = paddle.to_tensor(w).astype(dtype)
    th.stop_gradient = False
    tw.stop_gradient = False
    loss = jax_flce(th, tw, paddle.to_tensor(labels), transpose_y=transpose_y)
    loss.mean().backward()
    return [np.asarray(t._data, dtype=np.float32) for t in (loss, th.grad, tw.grad)]


def _port(h, w, labels, transpose_y, chunk=2048, dtype=torch.float32):
    th = torch.from_numpy(h).to(dtype).requires_grad_()
    tw = torch.from_numpy(w).to(dtype).requires_grad_()
    loss = port_flce(th, tw, torch.from_numpy(labels), transpose_y=transpose_y,
                     chunk=chunk)
    assert loss.dtype == torch.float32 and loss.shape == labels.shape
    loss.mean().backward()
    assert th.grad.dtype == dtype and tw.grad.dtype == dtype
    return [t.detach().float().numpy() for t in (loss, th.grad, tw.grad)]


def _close(got, want, loss_atol=LOSS_ATOL, grad_atol=GRAD_ATOL):
    for name, g, w, atol in zip(("loss", "dh", "dw"), got, want,
                                (loss_atol, grad_atol, grad_atol)):
        np.testing.assert_allclose(g, w, atol=atol, rtol=0, err_msg=name)


@pytest.mark.parametrize("shape,n_ignored", [
    ((2, 16, 32, 64), 0),
    ((1, 7, 32, 64), 0),       # 7 rows
    ((2, 16, 48, 32), 5),      # ignored rows
])
@pytest.mark.parametrize("transpose_y", [True, False])
def test_loss_and_grads_match_jax(shape, n_ignored, transpose_y):
    b, s, v, hdim = shape
    h, w, labels = _data(b, s, v, hdim, seed=0, n_ignored=n_ignored)
    if not transpose_y:
        w = np.ascontiguousarray(w.T)          # [H, V]
    _close(_port(h, w, labels, transpose_y), _jax(h, w, labels, transpose_y))


@pytest.mark.parametrize("chunk", [4, 6])
def test_chunk_smaller_than_rows_with_padding_matches_jax(chunk, jax_flags_restored):
    """30 rows in chunks of 4 or 6 (the last padded with ignore_index)."""
    h, w, labels = _data(2, 15, 40, 16, seed=1, n_ignored=3)
    paddle.set_flags({"fused_ce_chunk": chunk})
    want = _jax(h, w, labels, True)
    _close(_port(h, w, labels, True, chunk=chunk), want)
    # and the chunking changes nothing beyond summation order
    _close(_port(h, w, labels, True, chunk=chunk), _port(h, w, labels, True))


def test_ignored_rows_have_zero_loss_and_no_gradient():
    h, w, labels = _data(1, 8, 16, 8, seed=2, n_ignored=4)
    loss, dh, _ = _port(h, w, labels, True)
    assert (loss[0, :4] == 0).all() and (loss[0, 4:] > 0).all()
    assert np.abs(dh[0, :4]).max() == 0.0 and np.abs(dh[0, 4:]).max() > 0.0


def test_bf16_matches_jax_loosely():
    h, w, labels = _data(2, 16, 64, 32, seed=3, n_ignored=2)
    want = _jax(h, w, labels, True, dtype="bfloat16")
    got = _port(h, w, labels, True, dtype=torch.bfloat16)
    for name, g, wv in zip(("loss", "dh", "dw"), got, want):
        np.testing.assert_allclose(g, wv, atol=2e-2 * np.abs(wv).max(), rtol=0,
                                   err_msg=name)


def test_chunk_must_be_positive():
    h, w, labels = _data(1, 4, 8, 4, seed=4)
    with pytest.raises(ValueError):
        port_flce(torch.from_numpy(h), torch.from_numpy(w), torch.from_numpy(labels),
                  chunk=0)
