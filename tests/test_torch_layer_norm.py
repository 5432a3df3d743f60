"""paddle_tpu_torch.ops.kernels.layer_norm vs the JAX package's Pallas
LayerNorm (paddle_tpu/ops/pallas/layer_norm.py, run in interpret mode on the
CPU as its own tests run it) on the same numpy inputs.

The port's CPU path is the kernels' plain versions, reached through the
public ``layer_norm`` and autograd. Covered: the shapes and cases of
tests/test_pallas_layernorm.py (values, gradients of x, weight and bias,
bf16 input with f32 statistics, the ``supported`` predicate), the widths
the card times (768, 1024, 2048) at both dtypes, the training
and inference forwards, and the plain versions against each other.

Tolerances: f32 values 1e-5 and gradients 2e-5, times max(1, max|ref|) (the
same f32 arithmetic, summed in another order); bf16 output 1e-2 x max|ref|
(both round one f32 result to bf16, which may land one bf16 step apart,
2^-8 relative, where the f32 results straddle a rounding boundary).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle  # noqa: F401  (x64 mode + platform init)
from paddle_tpu.ops.pallas.layer_norm import layer_norm as jax_ln
from paddle_tpu.ops.pallas.layer_norm import supported as jax_supported
from paddle_tpu_torch.ops.kernels import layer_norm as ln

F32_TOL = 1e-5
GRAD_TOL = 2e-5
BF16_TOL = 1e-2


def _data(shape, hidden, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape, hidden).astype(np.float32)
    g = rng.rand(hidden).astype(np.float32) + 0.5
    b = rng.randn(hidden).astype(np.float32)
    return x, g, b


def _close(got, want, tol):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=tol * max(1.0, np.abs(want).max()), rtol=0)


@pytest.mark.parametrize("shape,hidden", [((16,), 128), ((4, 8), 256),
                                          ((2, 3, 8), 128)])
def test_values_match_jax(shape, hidden):
    x, g, b = _data(shape, hidden)
    want = np.asarray(jax_ln(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b)))
    before = (ln.launches_fwd, ln.launches_infer, ln.launches_bwd)
    got = ln.layer_norm(torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(b))
    assert (ln.launches_fwd, ln.launches_infer, ln.launches_bwd) == before  # CPU: plain
    assert got.dtype == torch.float32 and tuple(got.shape) == x.shape
    _close(got.numpy(), want, F32_TOL)


@pytest.mark.parametrize("shape,hidden,seed", [((8,), 128, 3), ((4, 8), 256, 5),
                                               ((2, 3, 8), 384, 6)])
def test_grads_match_jax(shape, hidden, seed):
    """d/dx, d/dweight, d/dbias of sum(layer_norm(x) * w) through the Pallas
    custom_vjp (interpret mode) and through the port's autograd Function."""
    x, g, b = _data(shape, hidden, seed=seed)
    w = np.random.RandomState(seed + 1).randn(*shape, hidden).astype(np.float32)
    want = jax.grad(lambda a, c, d: (jax_ln(a, c, d) * jnp.asarray(w)).sum(),
                    argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    tx, tg, tb = (torch.from_numpy(a).requires_grad_() for a in (x, g, b))
    (ln.layer_norm(tx, tg, tb) * torch.from_numpy(w)).sum().backward()
    for got, ref in zip((tx.grad, tg.grad, tb.grad), want):
        assert got.dtype == torch.float32
        _close(got.numpy(), np.asarray(ref), GRAD_TOL)


def test_bf16_io_f32_stats():
    """bf16 in and out with f32 statistics: the output dtype follows the
    input in both packages and the values agree at bf16 rounding."""
    x, g, b = _data((4, 8), 256, seed=7)
    want = jax_ln(jnp.asarray(x, jnp.bfloat16), jnp.asarray(g), jnp.asarray(b))
    assert want.dtype == jnp.bfloat16
    got = ln.layer_norm(torch.from_numpy(x).bfloat16(), torch.from_numpy(g),
                        torch.from_numpy(b))
    assert got.dtype == torch.bfloat16
    _close(got.float().numpy(), np.asarray(want, np.float32), BF16_TOL)


def test_bf16_grads_match_jax():
    """bf16 x with f32 weight and bias: dx in bf16, dweight and dbias in f32
    (the weight's dtype), as the JAX custom_vjp returns them."""
    x, g, b = _data((4, 8), 128, seed=8)
    w = np.random.RandomState(9).randn(4, 8, 128).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = jax.grad(lambda a, c, d: (jax_ln(a, c, d).astype(jnp.float32)
                                     * jnp.asarray(w)).sum(),
                    argnums=(0, 1, 2))(xb, jnp.asarray(g), jnp.asarray(b))
    tx = torch.from_numpy(x).bfloat16().requires_grad_()
    tg, tb = (torch.from_numpy(a).requires_grad_() for a in (g, b))
    (ln.layer_norm(tx, tg, tb).float() * torch.from_numpy(w)).sum().backward()
    assert tx.grad.dtype == torch.bfloat16 and tg.grad.dtype == torch.float32
    for got, ref in zip((tx.grad, tg.grad, tb.grad), want):
        assert str(got.dtype).replace("torch.", "") == str(ref.dtype)
        _close(got.float().numpy(), np.asarray(ref, np.float32), BF16_TOL)


TIMED_WIDTHS = [(dtype, hidden) for hidden in (768, 1024, 2048)
                for dtype in ("float32", "bfloat16")]


def _as(x, dtype):
    """numpy f32 data as a JAX and a torch array of ``dtype``."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


@pytest.mark.parametrize("dtype,hidden", TIMED_WIDTHS)
def test_values_match_jax_at_the_timed_widths(dtype, hidden):
    """The widths the card times (GPT-2 124M, gpt_345m, gpt_1p3b) at a few
    rows: the plain forward, which the card holds the kernels to, against
    the Pallas kernel in interpret mode, f32 and bf16 x."""
    x, g, b = _data((3,), hidden, seed=hidden)
    jx, tx = _as(x, dtype)
    want = jax_ln(jx, jnp.asarray(g), jnp.asarray(b))
    got = ln.layer_norm(tx, torch.from_numpy(g), torch.from_numpy(b))
    assert str(got.dtype) == f"torch.{dtype}" and str(want.dtype) == dtype
    _close(got.float().numpy(), np.asarray(want, np.float32),
           F32_TOL if dtype == "float32" else BF16_TOL)


@pytest.mark.parametrize("dtype,hidden", TIMED_WIDTHS)
def test_grads_match_jax_at_the_timed_widths(dtype, hidden):
    """d/dx, d/dweight, d/dbias at the timed widths through the Pallas
    custom_vjp (interpret mode) and the port's autograd Function: dx in x's
    dtype, dweight and dbias f32."""
    x, g, b = _data((2, 2), hidden, seed=hidden + 1)
    w = np.random.RandomState(hidden + 2).randn(2, 2, hidden).astype(np.float32)
    jx, tx = _as(x, dtype)
    want = jax.grad(lambda a, c, d: (jax_ln(a, c, d).astype(jnp.float32)
                                     * jnp.asarray(w)).sum(),
                    argnums=(0, 1, 2))(jx, jnp.asarray(g), jnp.asarray(b))
    tx.requires_grad_()
    tg, tb = (torch.from_numpy(a).requires_grad_() for a in (g, b))
    (ln.layer_norm(tx, tg, tb).float() * torch.from_numpy(w)).sum().backward()
    tol = GRAD_TOL if dtype == "float32" else BF16_TOL
    for got, ref in zip((tx.grad, tg.grad, tb.grad), want):
        assert str(got.dtype).replace("torch.", "") == str(ref.dtype)
        _close(got.float().numpy(), np.asarray(ref, np.float32), tol)


@pytest.mark.parametrize("n,h", [(16384, 768), (16, 100), (1, 128), (0, 128),
                                 (8, 129), (3, 8192)])
def test_supported_predicate_is_the_jax_packages(n, h):
    assert ln.supported(n, h) == jax_supported(n, h)


def test_inference_forward_without_grad():
    """With no input needing a gradient the public op is the inference
    forward (no autograd node), equal to the training forward's output."""
    x, g, b = _data((3, 5), 256, seed=10)
    tx, tg, tb = (torch.from_numpy(a) for a in (x, g, b))
    out = ln.layer_norm(tx, tg, tb)
    assert out.grad_fn is None
    o, mu, rstd = ln.layer_norm_fwd(tx.reshape(15, 256), tg, tb, stats=True)
    assert torch.equal(out.reshape(15, 256), o)
    assert mu.dtype == rstd.dtype == torch.float32 and tuple(mu.shape) == (15,)
    with torch.no_grad():
        tg.requires_grad_()
        assert ln.layer_norm(tx, tg, tb).grad_fn is None


def test_plain_versions_match_the_formulas():
    """The plain forward against numpy's two-pass statistics, and the plain
    backward against autograd through the plain forward."""
    x, g, b = _data((6,), 256, seed=11)
    tx, tg, tb = (torch.from_numpy(a).double().requires_grad_() for a in (x, g, b))
    with torch.no_grad():
        o, mu, rstd = ln.layer_norm_fwd_plain(tx.float(), tg.float(), tb.float())
    np.testing.assert_allclose(mu.numpy(), x.mean(-1), atol=1e-6)
    np.testing.assert_allclose(rstd.numpy(), 1 / np.sqrt(x.var(-1) + 1e-5), rtol=1e-5)
    dy = torch.from_numpy(np.random.RandomState(12).randn(6, 256))
    ref = torch.nn.functional.layer_norm(tx, (256,), tg, tb, 1e-5)
    ref_grads = torch.autograd.grad((ref * dy).sum(), (tx, tg, tb))
    got = ln.layer_norm_bwd_plain(tx.float().detach(), tg.float().detach(),
                                  dy.float(), mu, rstd)
    for a, r in zip(got, ref_grads):
        _close(a.numpy(), r.float().numpy(), GRAD_TOL)
    _close(o.numpy(), ref.float().detach().numpy(), F32_TOL)


def test_variants_tool_edits_apply_to_the_kernel_source():
    """tools/layer_norm_variants.py, which times the backward's row walk
    alone and its in-launch column sums on the card, names edits that each
    match csrc/layer_norm.cu exactly once; an edit that no longer matches
    raises."""
    from paddle_tpu_torch.tools import layer_norm_variants as tool

    tool.check()
    sources = {tool.SRC: (tool.CSRC / tool.SRC).read_text()}
    no_tail = tool.edited("no_tail", sources, tool.VARIANTS)[tool.SRC]
    assert no_tail.count("store_dx<T, L, NV>(dx, last_row") == 2
    with pytest.raises(ValueError):
        tool.edited("no_final", tool.edited("no_final", sources, tool.VARIANTS),
                    tool.VARIANTS)
