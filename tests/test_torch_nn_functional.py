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


# ---------------------------------------------------------------------------
# The rest of nn.functional: the same numpy inputs through
# paddle_tpu.nn.functional.<op> and paddle_tpu_torch.nn.functional.<op>
# (tests/torch_api_util.run_case: dtype, shape and values; with grad, the
# gradients of sum(out * w) by paddle_tpu.grad and paddle_tpu_torch.grad).
# Tolerances: f32 values (rtol 1e-5, atol 1e-5): sums of a few products in
# another order; gradients (rtol 1e-4, atol 1e-5); ctc and the resize
# weights' f64 -> f32 products (atol 1e-4).
# ---------------------------------------------------------------------------

import paddle_tpu.nn.functional as JNF  # noqa: E402
import paddle_tpu_torch as tp  # noqa: E402
import paddle_tpu_torch.nn.functional as TNF  # noqa: E402
from torch_api_util import on_cpu, run_case  # noqa: E402,F401

torch.set_num_threads(1)
VAL = (1e-5, 1e-5)
GRAD = (1e-4, 1e-5)
I64 = np.int64


def _pair(name):
    return getattr(JNF, name), getattr(TNF, name)


def _labels(i, shape, hi):
    return i.rng.randint(0, hi, shape).astype(I64)


def _ties(i, shape):
    """Small integers as floats: windows with tied maxima."""
    return i.rng.randint(0, 4, shape).astype(np.float32)


# (name, build(Inputs), kwargs, grad, tol)
FUNCTIONAL_CASES = [
    ("conv1d_transpose", lambda i: [i.arr((2, 4, 7)), i.arr((4, 3, 3)), i.arr((3,))],
     {"stride": 2, "padding": 1, "output_padding": 1}, True, VAL),
    ("conv2d_transpose", lambda i: [i.arr((2, 4, 5, 5)), i.arr((4, 3, 3, 3)), i.arr((3,))],
     {"stride": 2, "padding": 1, "output_padding": 1}, True, VAL),
    ("conv2d_transpose", lambda i: [i.arr((2, 4, 5, 5)), i.arr((4, 2, 3, 3))],
     {"stride": 1, "padding": [1, 0, 2, 1], "groups": 2, "dilation": 2}, True, VAL),
    ("conv2d_transpose", lambda i: [i.arr((1, 2, 4, 4)), i.arr((2, 3, 2, 2))],
     {"stride": 3, "padding": 0, "output_padding": 2}, True, VAL),
    ("conv3d_transpose", lambda i: [i.arr((1, 2, 3, 4, 4)), i.arr((2, 2, 2, 2, 2)),
                                    i.arr((2,))], {"stride": 2, "padding": 1}, True, VAL),
    ("max_pool1d", lambda i: [_ties(i, (2, 3, 9))],
     {"kernel_size": 3, "stride": 2, "padding": 1, "return_mask": True}, True, VAL),
    ("max_pool2d", lambda i: [_ties(i, (2, 3, 7, 6))],
     {"kernel_size": 3, "stride": 1, "return_mask": True}, True, VAL),
    ("max_pool2d", lambda i: [i.arr((2, 3, 8, 8))],
     {"kernel_size": 2, "return_mask": True}, True, VAL),
    ("max_pool3d", lambda i: [_ties(i, (1, 2, 5, 5, 4))],
     {"kernel_size": 2, "stride": 1, "padding": 1, "return_mask": True}, True, VAL),
    ("group_norm", lambda i: [i.arr((2, 6, 4, 3)), 3, i.arr((6,)), i.arr((6,))], {}, True,
     VAL),
    ("group_norm", lambda i: [i.arr((2, 4, 3, 6)), 2, i.arr((6,)), i.arr((6,))],
     {"data_format": "NHWC"}, True, VAL),
    ("instance_norm", lambda i: [i.arr((2, 3, 5, 4))],
     {"weight": None, "eps": 1e-5}, True, VAL),
    ("local_response_norm", lambda i: [i.arr((2, 7, 3, 3)), 4], {"alpha": 0.1, "k": 2.0},
     True, VAL),
    ("rms_norm", lambda i: [i.arr((3, 5, 8)), i.arr((8,))], {}, True, VAL),
    ("normalize", lambda i: [i.arr((3, 5))], {}, True, VAL),
    ("normalize", lambda i: [i.arr((3, 5, 2))], {"p": 1, "axis": -1}, True, VAL),
    ("pixel_shuffle", lambda i: [i.arr((2, 8, 3, 3)), 2], {}, True, VAL),
    ("unfold", lambda i: [i.arr((2, 3, 6, 7)), 3], {"strides": 2, "paddings": 1}, True, VAL),
    ("unfold", lambda i: [i.arr((1, 2, 7, 7)), [2, 3]], {"dilations": 2}, True, VAL),
    ("fold", lambda i: [i.arr((2, 3 * 9, 12)), [6, 7], 3], {"strides": 2, "paddings": 1},
     True, VAL),
    ("affine_grid", lambda i: [i.arr((2, 2, 3)), [2, 1, 4, 5]], {}, True, VAL),
    ("affine_grid", lambda i: [i.arr((2, 2, 3)), [2, 1, 4, 5]], {"align_corners": False},
     True, VAL),
    ("temporal_shift", lambda i: [i.arr((6, 8, 2, 2)), 3], {"shift_ratio": 0.25}, True, VAL),
    ("zeropad2d", lambda i: [i.arr((2, 3, 4, 4)), [1, 2, 0, 3]], {}, True, VAL),
    ("zeropad2d", lambda i: [i.arr((2, 4, 4, 3)), 1], {"data_format": "NHWC"}, True, VAL),
    ("diag_embed", lambda i: [i.arr((2, 3))], {}, True, VAL),
    ("diag_embed", lambda i: [i.arr((2, 3, 4))], {"offset": 1, "dim1": 0, "dim2": 2}, True,
     VAL),
    ("diag_embed", lambda i: [i.arr((3,))], {"offset": -2}, True, VAL),
    ("sequence_mask", lambda i: [np.array([[3, 0], [5, 2]], I64)], {}, False, VAL),
    ("sequence_mask", lambda i: [np.array([1, 4, 2], I64)],
     {"maxlen": 6, "dtype": "float32"}, False, VAL),
    ("sigmoid_focal_loss", lambda i: [i.arr((4, 3)), (i.rng.rand(4, 3) > 0.5).astype(
        np.float32)], {}, True, VAL),
    ("sigmoid_focal_loss", lambda i: [i.arr((4, 3)), (i.rng.rand(4, 3) > 0.5).astype(
        np.float32), i.arr((1,), "pos")], {"reduction": "mean", "gamma": 1.5}, True, VAL),
    ("margin_ranking_loss", lambda i: [i.arr((5,)), i.arr((5,)), np.sign(i.arr((5,)))],
     {"margin": 0.2}, True, VAL),
    ("cosine_similarity", lambda i: [i.arr((4, 6)), i.arr((4, 6))], {}, True, VAL),
    ("cosine_similarity", lambda i: [i.arr((2, 3, 5)), i.arr((2, 3, 5))], {"axis": -1},
     True, VAL),
    ("cosine_embedding_loss", lambda i: [i.arr((4, 6)), i.arr((4, 6)),
                                         np.array([1, -1, 1, -1], I64)],
     {"margin": 0.1, "reduction": "sum"}, True, VAL),
    ("square_error_cost", lambda i: [i.arr((3, 4)), i.arr((3, 4))], {}, True, VAL),
    ("dice_loss", lambda i: [i.arr((3, 4, 5), "prob"), _labels(i, (3, 4, 1), 5)], {}, True,
     VAL),
    ("log_loss", lambda i: [i.arr((6, 1), "prob"), (i.rng.rand(6, 1) > 0.5).astype(
        np.float32)], {}, True, VAL),
    ("npair_loss", lambda i: [i.arr((5, 4)), i.arr((5, 4)), np.array([0, 1, 0, 2, 1], I64)],
     {}, True, VAL),
    ("hinge_embedding_loss", lambda i: [i.arr((3, 4)), np.where(
        i.rng.rand(3, 4) > 0.5, 1, -1).astype(I64)], {"margin": 0.5}, True, VAL),
    ("hsigmoid_loss", lambda i: [i.arr((4, 6)), _labels(i, (4,), 7), 7, i.arr((6, 6)),
                                 i.arr((6, 1))], {}, True, VAL),
    ("hsigmoid_loss", lambda i: [i.arr((3, 6)), _labels(i, (3,), 5), 5, i.arr((5, 6)), None,
                                 np.array([[0, 2, -1], [1, 3, 4], [0, -1, -1]], I64),
                                 np.array([[1, 0, 0], [0, 1, 1], [1, 0, 0]], I64)], {}, True,
     VAL),
    ("margin_cross_entropy", lambda i: [i.arr((4, 6), "unit"), _labels(i, (4,), 6)], {},
     True, (1e-5, 1e-4)),
    ("margin_cross_entropy", lambda i: [i.arr((4, 6), "unit"), _labels(i, (4, 1), 6)],
     {"margin1": 1.35, "margin2": 0.0, "margin3": 0.0, "scale": 8.0,
      "return_softmax": True, "reduction": "none"}, True, VAL),
    ("margin_cross_entropy", lambda i: [i.arr((4, 6), "unit"), _labels(i, (4,), 6)],
     {"margin1": 1.0, "margin2": 0.0, "margin3": 0.35, "scale": 16.0, "reduction": "sum"},
     True, VAL),
    ("ctc_loss", lambda i: [i.arr((12, 2, 5)), np.array([[1, 2, 2], [3, 4, 0]], I64),
                            np.array([12, 9], I64), np.array([3, 2], I64)],
     {"reduction": "none"}, True, (1e-5, 1e-4)),
    ("ctc_loss", lambda i: [i.arr((8, 3, 4)), np.array([[1, 1], [2, 3], [3, 0]], I64),
                            np.array([8, 8, 5], I64), np.array([2, 2, 0], I64)],
     {"reduction": "sum", "norm_by_times": True, "blank": 0}, True, (1e-5, 1e-4)),
    ("ctc_loss", lambda i: [i.arr((7, 2, 4)), np.array([[0, 1], [2, 2]], I64),
                            np.array([7, 6], I64), np.array([2, 2], I64)],
     {"reduction": "mean", "blank": 3}, True, (1e-5, 1e-4)),
    ("bilinear", lambda i: [i.arr((4, 3)), i.arr((4, 5)), i.arr((2, 3, 5)), i.arr((2,))], {},
     True, VAL),
]
for _mode, _size, _fmt, _shape in (
        ("nearest", [5, 12], "NCHW", (2, 3, 8, 5)), ("bilinear", [5, 12], "NCHW", (2, 3, 8, 5)),
        ("bilinear", [3, 7], "NHWC", (2, 8, 5, 3)), ("bicubic", [5, 12], "NCHW", (2, 3, 8, 5)),
        ("bicubic", [12, 3], "NHWC", (1, 5, 8, 2)), ("area", [4, 3], "NCHW", (1, 2, 8, 5)),
        ("nearest", [3, 12], "NHWC", (1, 8, 5, 2)), ("linear", [11], "NCW", (2, 3, 6)),
        ("trilinear", [3, 5, 2], "NCDHW", (1, 2, 4, 3, 5))):
    FUNCTIONAL_CASES.append(("interpolate", lambda i, s=_shape: [i.arr(s)],
                             {"size": _size, "mode": _mode, "data_format": _fmt},
                             _mode != "nearest", (1e-5, 1e-4)))
FUNCTIONAL_CASES.append(("upsample", lambda i: [i.arr((1, 2, 4, 4))],
                         {"scale_factor": 2, "mode": "bilinear"}, True, (1e-5, 1e-4)))
for _mode in ("bilinear", "nearest"):
    for _pad in ("zeros", "border", "reflection"):
        for _align in (True, False):
            FUNCTIONAL_CASES.append(
                ("grid_sample", lambda i: [i.arr((2, 3, 5, 4)),
                                           (i.rng.uniform(-1.3, 1.3, (2, 3, 6, 2))).astype(
                                               np.float32)],
                 {"mode": _mode, "padding_mode": _pad, "align_corners": _align},
                 _mode == "bilinear", VAL))


@pytest.mark.parametrize("case", FUNCTIONAL_CASES,
                         ids=[f"{c[0]}-{k}" for k, c in enumerate(FUNCTIONAL_CASES)])
def test_functional_op_matches_jax(case, on_cpu):
    name, build, kwargs, grad, tol = case
    run_case(_pair(name), build, kwargs, tol=tol, grad=grad, grad_tol=GRAD)


def _pooled(pool, x, **kw):
    """The JAX and port max pool with its mask on the same numpy input."""
    jv, ji = getattr(JNF, pool)(_t(x), return_mask=True, **kw)
    tv, ti = getattr(TNF, pool)(torch.from_numpy(x), return_mask=True, **kw)
    return (np.asarray(jv._data), np.asarray(ji._data)), (tv, ti)


@pytest.mark.parametrize("nd,kw", [(1, {"kernel_size": 3, "stride": 1}),
                                   (2, {"kernel_size": 3, "stride": 2, "padding": 1}),
                                   (2, {"kernel_size": 2}),
                                   (3, {"kernel_size": 2, "stride": 1})])
def test_max_unpool_matches_jax_with_overlapping_windows_and_ties(nd, kw):
    """Indices of tied and overlapping windows (the first maximum), then the
    unpool of those values: positions equal in both packages."""
    shape = {1: (2, 3, 9), 2: (2, 2, 7, 6), 3: (1, 2, 4, 5, 4)}[nd]
    x = np.random.RandomState(nd).randint(0, 3, shape).astype(np.float32)
    (jv, ji), (tv, ti) = _pooled(f"max_pool{nd}d", x, **kw)
    np.testing.assert_array_equal(ti.numpy(), ji)
    assert ti.dtype == torch.int64
    np.testing.assert_array_equal(tv.numpy(), jv)
    want = getattr(JNF, f"max_unpool{nd}d")(_t(jv), _t(ji), **kw)
    got = getattr(TNF, f"max_unpool{nd}d")(tv, ti, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want._data))
    out = [s + 2 for s in shape[2:]]
    want = getattr(JNF, f"max_unpool{nd}d")(_t(jv), _t(ji), output_size=out, **kw)
    got = getattr(TNF, f"max_unpool{nd}d")(tv, ti, output_size=out, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want._data))


def test_max_unpool_gradient_matches_jax(on_cpu):
    """Distinct indices (non-overlapping windows): the values' gradient."""
    x = np.random.RandomState(3).randn(2, 3, 6, 6).astype(np.float32)
    _, (tv, ti) = _pooled("max_pool2d", x, kernel_size=2)
    run_case((lambda v, i: JNF.max_unpool2d(v, i, 2), lambda v, i: TNF.max_unpool2d(v, i, 2)),
             lambda r: [tv.numpy(), ti.numpy()], grad=True, tol=VAL, grad_tol=GRAD)


def test_max_pool_mask_is_torchs_return_indices():
    """The JAX mask: flat positions within each plane, the same as torch's
    return_indices on this input (distinct values)."""
    x = np.random.RandomState(5).randn(2, 3, 8, 8).astype(np.float32)
    (_, ji), (_, ti) = _pooled("max_pool2d", x, kernel_size=3, stride=2, padding=1)
    _, ref = torch.nn.functional.max_pool2d(torch.from_numpy(x), 3, 2, 1, return_indices=True)
    np.testing.assert_array_equal(ti.numpy(), ji)
    assert torch.equal(ti, ref)


# ---- the semantics where a thin wrapper over torch would part from JAX ----

def _img(seed=0, shape=(1, 1, 8, 8)):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _interp(x, **kw):
    want = np.asarray(JNF.interpolate(_t(x), **kw)._data)
    got = TNF.interpolate(torch.from_numpy(x), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    return got


def test_interpolate_nearest_is_half_pixel_nearest_exact():
    x = _img()
    got = _interp(x, size=[12, 12], mode="nearest")
    t = torch.from_numpy(x)
    exact = torch.nn.functional.interpolate(t, size=[12, 12], mode="nearest-exact").numpy()
    plain = torch.nn.functional.interpolate(t, size=[12, 12], mode="nearest").numpy()
    assert np.abs(got - exact).max() == 0.0 and np.abs(got - plain).max() > 0.5


def test_interpolate_bilinear_downsample_is_antialiased():
    x = _img(1)
    got = _interp(x, size=[4, 4], mode="bilinear")
    plain = torch.nn.functional.interpolate(torch.from_numpy(x), size=[4, 4],
                                            mode="bilinear").numpy()
    aa = torch.nn.functional.interpolate(torch.from_numpy(x), size=[4, 4], mode="bilinear",
                                         antialias=True).numpy()
    assert np.abs(got - plain).max() > 0.05
    np.testing.assert_allclose(got, aa, atol=1e-5)


def test_interpolate_drops_align_corners_and_align_mode():
    x = _img(2)
    got = _interp(x, size=[12, 12], mode="bilinear", align_corners=True, align_mode=1)
    assert np.array_equal(got, TNF.interpolate(torch.from_numpy(x), size=[12, 12],
                                               mode="bilinear").numpy())
    aligned = torch.nn.functional.interpolate(torch.from_numpy(x), size=[12, 12],
                                              mode="bilinear", align_corners=True).numpy()
    assert np.abs(got - aligned).max() > 0.1


def test_interpolate_bicubic_is_keys_a_half():
    x = _img(3)
    got = _interp(x, size=[12, 12], mode="bicubic")
    torch_a75 = torch.nn.functional.interpolate(torch.from_numpy(x), size=[12, 12],
                                                mode="bicubic").numpy()
    assert np.abs(got - torch_a75).max() > 0.01


def test_interpolate_area_is_antialiased_linear():
    x = _img(4)
    got = _interp(x, size=[4, 4], mode="area")
    assert np.array_equal(got, TNF.interpolate(torch.from_numpy(x), size=[4, 4],
                                               mode="bilinear").numpy())
    adaptive = torch.nn.functional.interpolate(torch.from_numpy(x), size=[4, 4],
                                               mode="area").numpy()
    assert np.abs(got - adaptive).max() > 0.05


def test_interpolate_bilinear_upsample_is_torchs():
    x = _img(5)
    got = _interp(x, size=[16, 16], mode="bilinear")
    np.testing.assert_allclose(got, torch.nn.functional.interpolate(
        torch.from_numpy(x), size=[16, 16], mode="bilinear").numpy(), atol=1e-6)


def test_conv_transpose_drops_output_size():
    x, w = _img(6, (1, 2, 5, 5)), _img(7, (2, 3, 3, 3))
    want = JNF.conv2d_transpose(_t(x), _t(w), stride=2, padding=1, output_size=[10, 10])
    got = TNF.conv2d_transpose(torch.from_numpy(x), torch.from_numpy(w), stride=2, padding=1,
                               output_size=[10, 10])
    assert tuple(got.shape) == tuple(want.shape) == (1, 3, 9, 9)
    np.testing.assert_allclose(got.numpy(), np.asarray(want._data), atol=1e-5)


def test_conv_transpose_output_padding_is_torchs_layout():
    x, w, b = _img(8, (2, 4, 5, 5)), _img(9, (4, 3, 3, 3)), _img(10, (3,))
    got = TNF.conv2d_transpose(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                               stride=2, padding=1, output_padding=1)
    ref = torch.conv_transpose2d(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                                 2, 1, 1)
    want = JNF.conv2d_transpose(_t(x), _t(w), _t(b), stride=2, padding=1, output_padding=1)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want._data), atol=1e-5)


def test_conv_transpose_refuses_what_the_jax_op_refuses():
    x, w = torch.zeros(1, 5, 5, 2), torch.zeros(2, 3, 3, 3)
    with pytest.raises(ValueError):
        TNF.conv2d_transpose(x, w, data_format="NHWC")
    with pytest.raises(ValueError):
        TNF.conv2d_transpose(x.permute(0, 3, 1, 2), w, padding="SAME")


def _ctc_inputs():
    rng = np.random.RandomState(11)
    logits = rng.randn(12, 2, 5).astype(np.float32)
    labels = np.array([[1, 2, 2, 4], [3, 1, 0, 0]], I64)
    return logits, labels, np.array([12, 10], I64), np.array([4, 2], I64)


def test_ctc_mean_is_the_plain_mean_of_the_losses():
    args = _ctc_inputs()
    want = float(JNF.ctc_loss(*[_t(a) for a in args], reduction="mean").item())
    got = TNF.ctc_loss(*[torch.from_numpy(a) for a in args], reduction="mean").item()
    per = TNF.ctc_loss(*[torch.from_numpy(a) for a in args], reduction="none")
    lp = torch.log_softmax(torch.from_numpy(args[0]), -1)
    torch_mean = torch.nn.functional.ctc_loss(lp, *[torch.from_numpy(a) for a in args[1:]],
                                              reduction="mean").item()
    assert got == pytest.approx(want, rel=1e-5) and got == pytest.approx(per.mean().item())
    assert abs(got - torch_mean) > 1.0


@pytest.mark.parametrize("reduction", ["none", "sum"])
def test_ctc_none_and_sum_are_torchs(reduction):
    args = _ctc_inputs()
    got = TNF.ctc_loss(*[torch.from_numpy(a) for a in args], reduction=reduction)
    lp = torch.log_softmax(torch.from_numpy(args[0]), -1)
    ref = torch.nn.functional.ctc_loss(lp, *[torch.from_numpy(a) for a in args[1:]],
                                       reduction=reduction)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5)


def test_class_center_sample_keeps_every_positive_and_remaps(on_cpu):
    tp.seed(3)
    label = torch.tensor([7, 2, 7, 19, 2, 0])
    remapped, sampled = TNF.class_center_sample(label, 20, 8)
    s = sampled.tolist()
    assert len(s) == 8 and s == sorted(set(s)) and {0, 2, 7, 19} <= set(s)
    assert all(0 <= c < 20 for c in s) and remapped.dtype == torch.int64
    assert [s[r] for r in remapped.tolist()] == label.tolist()
    tp.seed(3)
    again = TNF.class_center_sample(label, 20, 8)
    assert torch.equal(again[1], sampled) and torch.equal(again[0], remapped)
    _, all_pos = TNF.class_center_sample(label, 20, 3)     # more positives than samples
    assert all_pos.tolist() == [0, 2, 7, 19]
    draws = {tuple(TNF.class_center_sample(label, 20, 8)[1].tolist()) for _ in range(6)}
    assert len(draws) > 1


@pytest.mark.parametrize("name,kw", [("dropout2d", {}), ("dropout3d", {}),
                                     ("alpha_dropout", {}),
                                     ("dropout2d", {"data_format": "NHWC"})])
def test_dropout_variants_by_determinism_and_moments(name, kw):
    """Masks from a torch.Generator (not JAX's threefry): the same draws from
    the same seed, the keep rate within 5 sigma, whole channels for the
    2-D and 3-D forms, the identity out of training (as the JAX op)."""
    p = 0.3
    shape = (40, 50, 3, 3) if name != "dropout3d" else (40, 50, 2, 2, 2)
    x = torch.ones(shape) if name != "alpha_dropout" else torch.randn(
        shape, generator=torch.Generator().manual_seed(0))
    fn = getattr(TNF, name)
    a = fn(x, p, generator=torch.Generator().manual_seed(1), **kw)
    b = fn(x, p, generator=torch.Generator().manual_seed(1), **kw)
    assert torch.equal(a, b) and a.dtype == x.dtype and a.shape == x.shape
    assert torch.equal(fn(x, p, training=False, **kw), x)
    np.testing.assert_array_equal(
        np.asarray(getattr(JNF, name)(_t(x.numpy()), p, training=False)._data), x.numpy())
    if name == "alpha_dropout":
        alpha_p = -1.6732632423543772 * 1.0507009873554805
        a_coef = (1.0 - p + p * alpha_p ** 2) ** -0.5
        dropped = torch.isclose(a, torch.full_like(a, a_coef * alpha_p - a_coef * p * alpha_p))
        rate = dropped.float().mean().item()
        # the JAX op's affine map: mean 0, variance a^2 (1 - p + p ap^2 - p^2 ap^2)
        var = a_coef ** 2 * (1 - p + p * alpha_p ** 2 - (p * alpha_p) ** 2)
        assert abs(a.mean().item()) < 0.05 and abs(a.var().item() / var - 1.0) < 0.05
    else:
        ch = 1 if kw.get("data_format", "NCHW").startswith("NC") else 3
        kept = (a != 0)
        per = kept.movedim(ch, 1).reshape(shape[0], shape[ch], -1)
        assert bool((per.all(-1) | (~per).any(-1)).all()) and bool(
            (per.all(-1) == per.any(-1)).all())        # whole channels
        rate = 1.0 - per.all(-1).float().mean().item()
        assert torch.allclose(a[kept], torch.full_like(a[kept], 1 / (1 - p)))
    n = shape[0] * shape[1] if name != "alpha_dropout" else x.numel()
    assert abs(rate - p) < 5 * (p * (1 - p) / n) ** 0.5


def test_sparse_attention_matches_jax_and_its_last_column_rule():
    """The JAX op's dense mask from the CSR pattern, its -1 slots wrapping to
    the last key (every row with columns attends key T - 1)."""
    rng = np.random.RandomState(12)
    b, h, T, d = 2, 2, 5, 8
    q, k, v = (rng.randn(b, h, T, d).astype(np.float32) for _ in range(3))
    offs = np.tile(np.array([0, 1, 3, 4, 6, 8], np.int32), (b, h, 1))
    cols = np.tile(np.array([0, 0, 1, 2, 1, 3, 0, 4], np.int32), (b, h, 1))
    run_case((JNF.sparse_attention, TNF.sparse_attention),
             lambda r: [q, k, v, offs, cols], tol=VAL)
    got = TNF.sparse_attention(*[torch.from_numpy(a) for a in (q, k, v, offs, cols)])
    s = torch.from_numpy(q) @ torch.from_numpy(k).transpose(-1, -2) / np.sqrt(d)
    mask = torch.zeros(T, T, dtype=torch.bool)
    for r in range(T):
        mask[r, cols[0, 0, offs[0, 0, r]:offs[0, 0, r + 1]]] = True
    mask[:, T - 1] = True
    ref = torch.softmax(s.masked_fill(~mask, -1e30), -1) @ torch.from_numpy(v)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-6)


def test_gather_tree_matches_jax():
    rng = np.random.RandomState(13)
    ids = rng.randint(0, 10, (5, 2, 3)).astype(I64)
    parents = rng.randint(0, 3, (5, 2, 3)).astype(I64)
    from paddle_tpu.nn.layers.decode import gather_tree as jgather

    want = np.asarray(jgather(_t(ids), _t(parents))._data)
    got = TNF.gather_tree(torch.from_numpy(ids), torch.from_numpy(parents))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int64


def test_builtins_max_is_the_jax_ones():
    assert TNF.builtins_max(2, 5) == JNF.builtins_max(2, 5) == 5
    assert TNF.builtins_max(3.5, -1) == JNF.builtins_max(3.5, -1) == 3.5
