"""paddle_tpu_torch.ops.nn_functional vs paddle_tpu.ops on the same numpy inputs.

The ops of the GPT path: linear (the port's weight is the transpose of the
JAX one), embedding with padding_idx, layer_norm (f32 statistics, cast
before the affine), gelu, and scaled_dot_product_attention's dense path
with bool, additive and causal masks. Tolerances: f32 atol 1e-5 (one
reduction in another order); bf16 atol 2e-2 (one bf16 rounding of values of
order 1).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.ops import activation as jax_act
from paddle_tpu.ops import nn_functional as JF
from paddle_tpu_torch.ops import nn_functional as F

ATOL = 1e-5


def _t(a):
    return paddle.to_tensor(a)


def _np(t):
    return np.asarray(t._data, dtype=np.float32)


def test_linear_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 8).astype(np.float32)
    w = rng.randn(8, 6).astype(np.float32)      # JAX layout [in, out]
    b = rng.randn(6).astype(np.float32)
    want = _np(JF.linear(_t(x), _t(w), _t(b)))
    got = F.linear(torch.from_numpy(x), torch.from_numpy(w.T.copy()),
                   torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(
        F.linear(torch.from_numpy(x), torch.from_numpy(w.T.copy())).numpy(),
        _np(JF.linear(_t(x), _t(w))), atol=ATOL, rtol=0)


@pytest.mark.parametrize("padding_idx", [None, 3])
def test_embedding_matches_jax(padding_idx):
    rng = np.random.RandomState(1)
    w = rng.randn(10, 4).astype(np.float32)
    ids = np.array([[0, 3, 9], [3, 3, 1]], np.int64)
    want = _np(JF.embedding(_t(ids), _t(w), padding_idx=padding_idx))
    got = F.embedding(torch.from_numpy(ids), torch.from_numpy(w), padding_idx)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_jax(dtype):
    rng = np.random.RandomState(2)
    x = (rng.randn(3, 7, 16) * 3 + 1).astype(np.float32)
    g = rng.randn(16).astype(np.float32)
    b = rng.randn(16).astype(np.float32)
    jx = _t(x).astype(dtype)
    want = _np(JF.layer_norm(jx, 16, _t(g).astype(dtype), _t(b).astype(dtype)))
    tdt = getattr(torch, dtype)
    got = F.layer_norm(torch.from_numpy(x).to(tdt), 16, torch.from_numpy(g).to(tdt),
                       torch.from_numpy(b).to(tdt))
    assert got.dtype == tdt
    atol = ATOL if dtype == "float32" else 2e-2 * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol, rtol=0)


@pytest.mark.parametrize("approximate", [True, False])
def test_gelu_matches_jax(approximate):
    x = np.linspace(-6, 6, 101).astype(np.float32)
    want = _np(jax_act.gelu(_t(x), approximate=approximate))
    got = F.gelu(torch.from_numpy(x), approximate=approximate)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def _qkv(b, sq, sk, h, d, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, sq, h, d).astype(np.float32),
            rng.randn(b, sk, h, d).astype(np.float32),
            rng.randn(b, sk, h, d).astype(np.float32))


@pytest.mark.parametrize("kind", ["none", "causal", "causal_long", "bool", "additive",
                                  "bool_and_causal"])
def test_sdpa_dense_path_matches_jax(kind):
    s = 128 if kind == "causal_long" else 12
    q, k, v = _qkv(2, s, s, 3, 8, seed=3)
    rng = np.random.RandomState(4)
    mask = None
    if kind in ("bool", "bool_and_causal"):
        mask = rng.rand(2, 1, s, s) > 0.3
        mask[..., 0] = True
    elif kind == "additive":
        mask = (rng.randn(2, 1, s, s) * 2).astype(np.float32)
    causal = kind.startswith("causal") or kind == "bool_and_causal"
    want = _np(JF.scaled_dot_product_attention(
        _t(q), _t(k), _t(v), attn_mask=None if mask is None else _t(mask),
        is_causal=causal, training=False))
    got = F.scaled_dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        attn_mask=None if mask is None else torch.from_numpy(mask),
        is_causal=causal, training=False)
    assert got.shape == (2, s, 3, 8)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_cpu_attention_never_routes_to_the_kernel():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 256, 256, 2, 64, seed=5))
    assert not F._use_flash(q, k)


def test_attention_dropout_in_training_is_refused():
    """Attention dropout is refused by the flash route (as in JAX, flash is
    taken only without it): in training the dense path drops attention
    weights from the generator, deterministically; out of training it is
    the identity."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 8, 8, 1, 8, seed=6))
    ref = F.scaled_dot_product_attention(q, k, v, dropout_p=0.0)
    off = F.scaled_dot_product_attention(q, k, v, dropout_p=0.5, training=False)
    assert torch.equal(off, ref)
    a, b = (F.scaled_dot_product_attention(
        q, k, v, dropout_p=0.5, training=True,
        generator=torch.Generator().manual_seed(1)) for _ in range(2))
    assert torch.equal(a, b) and not torch.allclose(a, ref)
    # with every weight kept (p -> 0 scale) the result is the reference's
    kept = F.scaled_dot_product_attention(
        q, k, v, dropout_p=1e-12, training=True,
        generator=torch.Generator().manual_seed(1))
    np.testing.assert_allclose(kept.numpy(), ref.numpy(), atol=ATOL, rtol=0)


@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("p", [0.0, 1.0])
def test_dropout_deterministic_cases_match_jax(mode, training, p):
    """p = 0, p = 1 and inference draw no mask: exact against JAX."""
    x = np.random.RandomState(7).randn(3, 5).astype(np.float32)
    want = _np(JF.dropout(_t(x), p, training=training, mode=mode))
    got = F.dropout(torch.from_numpy(x), p, training=training, mode=mode)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-7, rtol=0)


def test_dropout_statistics_and_determinism():
    """Masks come from a torch.Generator, not JAX's threefry: held to the keep
    rate (4 sigma), the upscale, per-axis broadcast and reproducibility."""
    x = torch.ones(200, 500)
    p = 0.3
    y = F.dropout(x, p, generator=torch.Generator().manual_seed(0))
    kept = (y != 0).float().mean().item()
    sigma = (p * (1 - p) / x.numel()) ** 0.5
    assert abs(kept - (1 - p)) < 4 * sigma
    assert torch.allclose(y[y != 0], torch.full_like(y[y != 0], 1 / (1 - p)))
    y2 = F.dropout(x, p, generator=torch.Generator().manual_seed(0))
    assert torch.equal(y, y2)
    row = F.dropout(x, p, axis=0, generator=torch.Generator().manual_seed(1))
    assert all(len(set(r.tolist())) == 1 for r in row)     # one draw per row
    down = F.dropout(x, p, mode="downscale_in_infer",
                     generator=torch.Generator().manual_seed(0))
    assert set(down.unique().tolist()) <= {0.0, 1.0}
    assert torch.equal(down != 0, y != 0)
