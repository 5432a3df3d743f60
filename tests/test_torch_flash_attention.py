"""paddle_tpu_torch flash attention vs the JAX package's Pallas kernels,
forward and FA2 backward.

On the CPU the port's wrappers take their plain PyTorch versions; the JAX
side runs the Pallas kernels in interpret mode, as
tests/test_flash_attention.py does. Inputs come from numpy with a fixed
seed.

Tolerances: forward f32 atol 2e-5 (the Pallas tests' own bound: same math,
other summation order); forward bf16 2e-2 x max|o| (p is rounded to bf16
against the running max in the Pallas kernel and the final max in the
plain version); gradients as stated above the backward tests. The kernels
themselves are held against the plain versions on the card by
chip_smoke.py and tests/test_torch_cuda.py. Also here: the routing tables,
the checks of a forced route and of the tensor-core kernels' operand
alignment, and the numerics the 3xTF32 forward and backward pair rely on
(a plain emulation of their TF32 products against the Pallas forward and
backward: three terms reach the card's f32 limits, one pass does not).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import _common as jax_common
from paddle_tpu_torch.ops.kernels import _common as port_common
from paddle_tpu_torch.ops.kernels import flash_attention as port_fa
from tf32_emulation import GRAD_F32_FROB_TOL, tf32_product

# the pallas package re-exports the function under the module's name
jax_fa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")

F32_ATOL = 2e-5
BF16_REL = 2e-2

CASES = [  # (b, sq, sk, h, d, causal)
    (2, 128, 128, 2, 32, False),
    (2, 128, 128, 2, 32, True),
    (1, 32, 128, 2, 16, False),    # sq != sk
    (1, 64, 128, 2, 16, True),     # sq != sk, causal is top-left aligned
    (1, 256, 128, 1, 64, True),    # sq > sk
]


def _inputs(b, sq, sk, h, d, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, sq, h, d).astype(np.float32),
            rng.randn(b, sk, h, d).astype(np.float32),
            rng.randn(b, sk, h, d).astype(np.float32))


@pytest.mark.parametrize("case", CASES, ids=lambda c: "b%d_sq%d_sk%d_h%d_d%d_causal%d" % c)
def test_forward_f32_matches_pallas(case):
    b, sq, sk, h, d, causal = case
    q, k, v = _inputs(b, sq, sk, h, d, seed=0)
    want = np.asarray(jax_fa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                             jnp.asarray(v), causal=causal))
    got = port_fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal=causal)
    assert got.shape == (b, sq, h, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_with_lse_matches_pallas(causal):
    q, k, v = _inputs(2, 128, 128, 2, 32, seed=1)
    scale = 0.3
    jo, jlse = jax_fa.flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        sm_scale=scale)
    po, plse = port_fa.flash_attention_with_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, sm_scale=scale)
    assert plse.shape == (2, 2, 128) and plse.dtype == torch.float32
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), atol=F32_ATOL, rtol=0)
    np.testing.assert_allclose(plse.numpy(), np.asarray(jlse), atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_forward_bf16_matches_pallas_loosely(causal):
    q, k, v = _inputs(1, 128, 128, 2, 32, seed=2)
    jq, jk, jv = (jnp.asarray(x, dtype=jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(jax_fa.flash_attention(jq, jk, jv, causal=causal)
                      .astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    got = port_fa.flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=BF16_REL * np.abs(want).max(), rtol=0)


def test_cpu_tensors_take_the_plain_version():
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 128, 128, 2, 32, seed=3))
    before = port_fa.launches
    o, lse = port_fa.flash_attention_with_lse(q, k, v, causal=True)
    po, plse = port_fa.flash_attention_plain(q, k, v, causal=True)
    assert port_fa.launches == before      # a CPU call launches no kernel
    assert torch.equal(o, po) and torch.equal(lse, plse)


def test_supported_predicate_parity():
    for sq in (7, 8, 12, 16, 100, 128, 384, 512, 1000, 1024):
        for sk in (8, 64, 130, 1024):
            for d in (16, 32, 63, 64, 128):
                assert port_fa.supported(sq, sk, d) == jax_fa.supported(sq, sk, d), \
                    (sq, sk, d)


def test_common_parity():
    assert port_common.NEG_INF == jax_common.NEG_INF
    for n in range(1, 2100):
        for pref in (512, 256, 128, 64):
            assert port_common.pick_block(n, pref) == jax_common.pick_block(n, pref), \
                (n, pref)


# ------------------------------------------------------------------ backward
#
# dq, dk, dv of the port's Function (plain forward and backward on the CPU)
# against jax.vjp through the Pallas kernels in interpret mode, as
# tests/test_flash_attention.py:31-41 differentiates them. Tolerances: f32
# atol 5e-5 (the Pallas tests' own bound for gradients); bf16 3e-2 x max|g|
# (P and dS round to bf16 in both, but against sums taken in other orders).

GRAD_ATOL = 5e-5
BWD_CASES = [  # (b, sq, sk, h, d, causal)
    (1, 128, 128, 2, 32, False),
    (1, 128, 128, 2, 32, True),
    (1, 32, 128, 2, 16, False),    # sq != sk
    (1, 64, 128, 2, 16, True),     # sq != sk, causal is top-left aligned
    (1, 128, 64, 1, 32, True),     # sq > sk
]


def _jax_grads(q, k, v, cot, causal, dtype=None, with_lse=False, sm_scale=None):
    jq, jk, jv = (jnp.asarray(x, dtype=dtype) for x in (q, k, v))
    if with_lse:
        fn = lambda a, b, c: jax_fa.flash_attention_with_lse(  # noqa: E731
            a, b, c, causal=causal, sm_scale=sm_scale)
        cot = (jnp.asarray(cot[0], dtype=dtype), jnp.asarray(cot[1]))
    else:
        fn = lambda a, b, c: jax_fa.flash_attention(  # noqa: E731
            a, b, c, causal=causal, sm_scale=sm_scale)
        cot = jnp.asarray(cot, dtype=dtype)
    _, vjp = jax.vjp(fn, jq, jk, jv)
    return [np.asarray(g.astype(jnp.float32)) for g in vjp(cot)]


def _port_grads(q, k, v, cot, causal, dtype=torch.float32, with_lse=False,
                sm_scale=None):
    tq, tk, tv = (torch.from_numpy(x).to(dtype).requires_grad_() for x in (q, k, v))
    if with_lse:
        o, lse = port_fa.flash_attention_with_lse(tq, tk, tv, causal=causal,
                                                  sm_scale=sm_scale)
        outs, cots = (o, lse), (torch.from_numpy(cot[0]).to(dtype),
                                torch.from_numpy(cot[1]))
    else:
        outs = (port_fa.flash_attention(tq, tk, tv, causal=causal, sm_scale=sm_scale),)
        cots = (torch.from_numpy(cot).to(dtype),)
    grads = torch.autograd.grad(outs, (tq, tk, tv), cots)
    assert all(g.dtype == dtype for g in grads)
    return [g.float().numpy() for g in grads]


@pytest.mark.parametrize("case", BWD_CASES,
                         ids=lambda c: "b%d_sq%d_sk%d_h%d_d%d_causal%d" % c)
def test_backward_f32_matches_pallas(case):
    b, sq, sk, h, d, causal = case
    q, k, v = _inputs(b, sq, sk, h, d, seed=10)
    cot = np.random.RandomState(11).randn(b, sq, h, d).astype(np.float32)
    want = _jax_grads(q, k, v, cot, causal)
    got = _port_grads(q, k, v, cot, causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, atol=GRAD_ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
def test_backward_bf16_matches_pallas_loosely(causal):
    q, k, v = _inputs(1, 128, 128, 2, 32, seed=12)
    cot = np.random.RandomState(13).randn(1, 128, 2, 32).astype(np.float32)
    want = _jax_grads(q, k, v, cot, causal, dtype=jnp.bfloat16)
    got = _port_grads(q, k, v, cot, causal, dtype=torch.bfloat16)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, atol=3e-2 * np.abs(w).max(), rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
def test_with_lse_backward_carries_the_lse_cotangent(causal):
    """A nonzero cotangent on lse folds into delta (delta - g_lse), as the
    ring-attention merge needs; checked against the Pallas rule."""
    q, k, v = _inputs(1, 128, 128, 2, 32, seed=14)
    rng = np.random.RandomState(15)
    cot = (rng.randn(1, 128, 2, 32).astype(np.float32),
           rng.randn(1, 2, 128).astype(np.float32))
    want = _jax_grads(q, k, v, cot, causal, with_lse=True, sm_scale=0.3)
    got = _port_grads(q, k, v, cot, causal, with_lse=True, sm_scale=0.3)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, atol=GRAD_ATOL, rtol=0, err_msg=name)
    # and the fold is visible: without the lse cotangent the grads differ
    plain = _port_grads(q, k, v, cot[0], causal, sm_scale=0.3)
    assert max(np.abs(a - b).max() for a, b in zip(plain, got)) > 1e-3


def test_backward_wrappers_on_cpu_are_the_plain_version():
    """The per-kernel wrappers take the plain version for CPU tensors and
    launch nothing."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 128, 128, 2, 32, seed=16))
    do = torch.from_numpy(np.random.RandomState(17).randn(1, 128, 2, 32)
                          .astype(np.float32))
    o, lse = port_fa.flash_attention_plain(q, k, v, causal=True)
    delta = port_fa.attention_delta(o, do)
    before = (port_fa.launches_bwd("dkdv"), port_fa.launches_bwd("dq"))
    dk, dv = port_fa.flash_attention_bwd_dkdv(q, k, v, do, lse, delta, causal=True)
    dq = port_fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal=True)
    assert (port_fa.launches_bwd("dkdv"), port_fa.launches_bwd("dq")) == before
    want = port_fa.flash_attention_bwd_plain(q, k, v, do, lse, delta, causal=True)
    for g, w in zip((dq, dk, dv), want):
        assert torch.equal(g, w)


# ------------------------------------------------------------ forward route

@pytest.mark.parametrize("dtype,head_dim,route", [
    ("bfloat16", 32, "mma"), ("bfloat16", 64, "mma"), ("bfloat16", 128, "mma"),
    ("float32", 32, "tf32x3"), ("float32", 64, "tf32x3"), ("float32", 128, "tf32x3"),
])
def test_forward_route_table(dtype, head_dim, route):
    """bf16 takes the bf16 tensor-core forward, f32 the 3xTF32 one, at every
    head dim the kernels take (the training path is bf16, scoring and the
    f32 step f32); on the CPU both are the plain version and move no launch
    count of any route."""
    dt = getattr(torch, dtype)
    assert port_fa.forward_route(dt, head_dim) == route
    assert set(port_fa.launches_by_route) == {"mma", "tf32x3", "fma"}
    q, k, v = (torch.from_numpy(x).to(dt) for x in _inputs(1, 64, 64, 2, head_dim, seed=4))
    before = (port_fa.launches, dict(port_fa.launches_by_route))
    o, lse = port_fa.flash_attention_with_lse(q, k, v, causal=True)
    assert (port_fa.launches, port_fa.launches_by_route) == before
    po, plse = port_fa.flash_attention_plain(q, k, v, causal=True)
    assert torch.equal(o, po) and torch.equal(lse, plse)


def test_forward_route_refuses_what_no_kernel_takes():
    for d in (16, 48, 256):
        with pytest.raises(ValueError):
            port_fa.forward_route(torch.bfloat16, d)
    with pytest.raises(TypeError):
        port_fa.forward_route(torch.float16, 64)


def test_mma_operand_reads_aligned_views_in_place_and_copies_the_rest():
    """The tensor-core kernel copies 16-byte pieces: the fused qkv
    projection's bf16 views ([b, s, 3, h, d], row stride 3 h d, k and v
    starting 2 h d and 4 h d bytes in) are aligned and are read through
    their strides; a view starting off a 16-byte boundary, or with a seq
    stride that is not a multiple of 8 elements, becomes an aligned
    contiguous copy with the same values."""
    qkv = torch.zeros(2, 128, 3, 12, 64, dtype=torch.bfloat16).normal_()
    q, k, v = qkv.unbind(dim=2)
    assert q.stride() == (128 * 2304, 2304, 64, 1)
    for x in (q, k, v):
        assert port_fa._mma_operand(x) is x
    flat = torch.zeros(2 * 128 * 4 * 64 + 1, dtype=torch.bfloat16).normal_()
    shifted = flat[1:].view(2, 128, 4, 64)
    padded = torch.zeros(2, 128, 4 * 64 + 4, dtype=torch.bfloat16).normal_()[..., :256]
    padded = padded.view(2, 128, 4, 64)
    for x in (shifted, padded):
        y = port_fa._mma_operand(x)
        assert y is not x and y.is_contiguous() and y.data_ptr() % 16 == 0
        assert torch.equal(y, x)


def test_mma_operand_takes_the_f32_stride_rule():
    """f32 operands of the 3xTF32 pair: 16 bytes are 4 elements, so the
    fused projection's views and a seq stride of 4 h d + 4 are read in
    place; a view starting 4 bytes off a 16-byte boundary, or a seq stride
    of 4 h d + 2, becomes an aligned contiguous copy with the same values."""
    qkv = torch.zeros(2, 128, 3, 12, 64).normal_()
    for x in qkv.unbind(dim=2):
        assert port_fa._mma_operand(x) is x
    padded4 = torch.zeros(2, 128, 4 * 64 + 4).normal_()[..., :256].view(2, 128, 4, 64)
    assert padded4.stride(1) == 260 and port_fa._mma_operand(padded4) is padded4
    flat = torch.zeros(2 * 128 * 4 * 64 + 1).normal_()
    shifted = flat[1:].view(2, 128, 4, 64)
    padded2 = torch.zeros(2, 128, 4 * 64 + 2).normal_()[..., :256].view(2, 128, 4, 64)
    for x in (shifted, padded2):
        y = port_fa._mma_operand(x)
        assert y is not x and y.is_contiguous() and y.data_ptr() % 16 == 0
        assert torch.equal(y, x)


# ----------------------------------------------------------- backward route

@pytest.mark.parametrize("dtype,head_dim,route", [
    ("bfloat16", 32, "mma"), ("bfloat16", 64, "mma"), ("bfloat16", 128, "mma"),
    ("float32", 32, "tf32x3"), ("float32", 64, "tf32x3"), ("float32", 128, "tf32x3"),
])
def test_backward_route_table(dtype, head_dim, route):
    """bf16 takes the bf16 tensor-core backward pair, f32 the 3xTF32 pair,
    at every head dim the kernels take, d = 128 included (its dK/dV instance
    builds without spills, so no head dim is left on the FMA pair): the
    forward's table, stated by the backward too."""
    assert port_fa.backward_route(getattr(torch, dtype), head_dim) == route
    assert port_fa.forward_route(getattr(torch, dtype), head_dim) == route


@pytest.mark.parametrize("route,dtype,ok", [
    ("mma", "bfloat16", True), ("mma", "float32", False),
    ("tf32x3", "float32", True), ("tf32x3", "bfloat16", False),
    ("fma", "float32", True), ("fma", "bfloat16", True),
    ("wgmma", "bfloat16", False),
])
def test_forced_backward_route_rules(route, dtype, ok):
    """A route forced on the backward (chip_smoke.py and the card tests time
    the FMA predecessors with it): "fma" at either dtype, "mma" only at
    bf16, "tf32x3" only at f32, nothing else."""
    dt = getattr(torch, dtype)
    if ok:
        assert port_fa._forced(route, dt) == route
    else:
        with pytest.raises(ValueError):
            port_fa._forced(route, dt)


@pytest.mark.parametrize("route,dtype,ok", [
    ("mma", "bfloat16", True), ("mma", "float32", False),
    ("tf32x3", "float32", True), ("tf32x3", "bfloat16", False),
    ("fma", "float32", True), ("fma", "bfloat16", True),
    ("wgmma", "float32", False),
])
def test_forced_forward_route_rules(route, dtype, ok):
    """A route forced on the forward (chip_smoke.py and the card tests time
    the FMA predecessor with it): "tf32x3" only at f32, "mma" only at bf16,
    "fma" at both, nothing else. The forward's launch refuses a route its
    inputs' dtype does not take before it builds or launches anything."""
    dt = getattr(torch, dtype)
    if ok:
        assert port_fa._forced(route, dt) == route
    else:
        q, k, v = (torch.from_numpy(x).to(dt) for x in _inputs(1, 64, 64, 2, 64, seed=5))
        before = dict(port_fa.launches_by_route)
        with pytest.raises(ValueError):
            port_fa._launch(q, k, v, True, 0.125, route=route)
        assert port_fa.launches_by_route == before


def test_backward_route_refuses_what_no_kernel_takes():
    for d in (16, 48, 256):
        with pytest.raises(ValueError):
            port_fa.backward_route(torch.bfloat16, d)
    for dt in (torch.float16, torch.float64):
        with pytest.raises(TypeError):
            port_fa.backward_route(dt, 64)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cpu_backward_launches_no_kernel_of_either_route(dtype):
    """On CPU tensors autograd and the wrappers take the plain version, at
    either dtype: no count of launches_bwd_by_route moves, and the gradients
    are the plain version's bits."""
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(x).to(dt) for x in _inputs(1, 128, 128, 2, 32, seed=18))
    do = torch.from_numpy(np.random.RandomState(19).randn(1, 128, 2, 32)
                          .astype(np.float32)).to(dt)
    before = {r: dict(c) for r, c in port_fa.launches_bwd_by_route.items()}
    assert set(before) == {"mma", "tf32x3", "fma"}
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    o = port_fa.flash_attention(*leaves, causal=True)
    grads = torch.autograd.grad(o, leaves, do)
    po, lse = port_fa.flash_attention_plain(q, k, v, causal=True)
    delta = port_fa.attention_delta(po, do)
    dk, dv = port_fa.flash_attention_bwd_dkdv(q, k, v, do, lse, delta, causal=True)
    dq = port_fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal=True)
    assert port_fa.launches_bwd_by_route == before
    want = port_fa.flash_attention_bwd_plain(q, k, v, do, lse, delta, causal=True)
    for g, w in zip((dq, dk, dv), want):
        assert g.dtype == dt and torch.equal(g, w)
    for g, w in zip(grads, want):
        assert torch.equal(g, w)


# ------------------------------------------------- 3xTF32 backward numerics

def _head_rel_frob(got, want):
    """max over the (b, h) heads of ||got - want||_F / ||want||_F ([b, s, h, d]
    numpy arrays), as chip_smoke.py's head_rel_frob."""
    err = np.sqrt(np.square(got - want).sum(axis=(1, 3)))
    return float((err / np.sqrt(np.square(want).sum(axis=(1, 3)))).max())


def _tf32_flash_backward(q, k, v, do, lse, delta, causal, terms):
    """dq, dk, dv ([b, s, h, d]) as the 3xTF32 pair computes them, every
    product through ``tf32_product``: S = Q Kᵀ (dkdv takes Sᵀ = K Qᵀ, the
    same elementwise products) and dP = dO Vᵀ, P = exp(S scale − lse), dS =
    P (dP − delta) scale in f32, then dV = Pᵀ dO, dK = dSᵀ Q, dQ = dS K."""
    scale = 1.0 / np.sqrt(q.shape[-1])
    qh, kh, vh, doh = (x.transpose(1, 2) for x in (q, k, v, do))
    s = tf32_product(qh, kh.transpose(-1, -2), terms) * scale
    if causal:
        keep = torch.ones(s.shape[-2:], dtype=torch.bool).tril()
        s = s.masked_fill(~keep, port_common.NEG_INF)
    p = torch.exp(s - lse[..., None])
    dp = tf32_product(doh, vh.transpose(-1, -2), terms)
    ds = p * (dp - delta[..., None]) * scale
    grads = (tf32_product(ds, kh, terms), tf32_product(ds.transpose(-1, -2), qh, terms),
             tf32_product(p.transpose(-1, -2), doh, terms))
    return [g.transpose(1, 2).numpy() for g in grads]


@pytest.mark.parametrize("terms", [3, 1])
@pytest.mark.parametrize("causal", [False, True])
def test_tf32x3_backward_reaches_the_f32_limits_and_one_pass_does_not(causal, terms):
    """The numerics the 3xTF32 pair relies on, at [1, 128, 2, 64]: the
    emulated dq, dk, dv against jax.vjp through the Pallas kernels
    (interpret mode). Three terms come within the card's f32 limits,
    GRAD_F32_TOL x max(1, max|ref|) = 1e-4 x ... and GRAD_F32_FROB_TOL in
    each head's relative Frobenius norm (a quarter of it, as the plain
    version's own f32 rounding is in the reference too); one TF32 pass falls
    outside the Frobenius limit by more than 10x, so the card's limit tells
    them apart."""
    q, k, v = _inputs(1, 128, 128, 2, 64, seed=30)
    cot = np.random.RandomState(31).randn(1, 128, 2, 64).astype(np.float32)
    want = _jax_grads(q, k, v, cot, causal)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, cot))
    o, lse = port_fa.flash_attention_plain(tq, tk, tv, causal=causal)
    delta = port_fa.attention_delta(o, tdo)
    got = _tf32_flash_backward(tq, tk, tv, tdo, lse, delta, causal, terms)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        frob = _head_rel_frob(g, w)
        if terms == 3:
            np.testing.assert_allclose(g, w, atol=1e-4 * max(1.0, np.abs(w).max()), rtol=0,
                                       err_msg=name)
            assert frob <= GRAD_F32_FROB_TOL / 4, (name, frob)
        else:
            assert frob > 10 * GRAD_F32_FROB_TOL, (name, frob)


# -------------------------------------------------- 3xTF32 forward numerics

def _tf32_flash_forward(q, k, v, causal, terms):
    """o ([b, s, h, d] numpy) and lse ([b, h, s]) as the 3xTF32 forward
    computes them: S = Q Kᵀ and O = P V through ``tf32_product``, the
    online softmax's arithmetic in f32 (here over the whole row at once)."""
    scale = 1.0 / np.sqrt(q.shape[-1])
    qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
    s = tf32_product(qh, kh.transpose(-1, -2), terms) * scale
    if causal:
        keep = torch.ones(s.shape[-2:], dtype=torch.bool).tril()
        s = s.masked_fill(~keep, port_common.NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = tf32_product(p, vh, terms) / l
    return o.transpose(1, 2).numpy(), (m + torch.log(l))[..., 0].numpy()


@pytest.mark.parametrize("terms", [3, 1])
@pytest.mark.parametrize("causal", [False, True])
def test_tf32x3_forward_reaches_the_f32_limits_and_one_pass_does_not(causal, terms):
    """The numerics the 3xTF32 forward relies on, at [1, 128, 2, 64]: the
    emulated o and lse against the Pallas forward in interpret mode. Three
    terms come within the card's f32 limits: o and lse at F32_TOL = 1e-4,
    and o at GRAD_F32_FROB_TOL in each (b, h) head's relative Frobenius
    norm (within a quarter of it, as the reference's own f32 rounding is in
    the comparison too). One TF32 pass falls outside the Frobenius limit by
    more than 10x, so the card's limit tells them apart."""
    q, k, v = _inputs(1, 128, 128, 2, 64, seed=32)
    jo, jlse = jax_fa.flash_attention_with_lse(jnp.asarray(q), jnp.asarray(k),
                                               jnp.asarray(v), causal=causal)
    jo, jlse = np.asarray(jo), np.asarray(jlse)
    o, lse = _tf32_flash_forward(*(torch.from_numpy(x) for x in (q, k, v)), causal, terms)
    frob = _head_rel_frob(o, jo)
    if terms == 3:
        np.testing.assert_allclose(o, jo, atol=1e-4, rtol=0)
        np.testing.assert_allclose(lse, jlse, atol=1e-4, rtol=0)
        assert frob <= GRAD_F32_FROB_TOL / 4, frob
    else:
        assert frob > 10 * GRAD_F32_FROB_TOL, frob


def test_backward_variants_tool_edits_apply_to_the_kernel_sources():
    """tools/flash_bwd_variants.py, which checks and times the 3xTF32 pair's
    mutants on the card, names edits that each match the kernel sources
    exactly once: one pass and two terms drop two and one of mma_tf32x3's
    three passes, one accumulator sums dK, dV and dQ straight into their
    running accumulators (no fresh one a pass, no add_frags): an edit of
    mma_sync.cuh's tf32_product, which the backward pair calls."""
    from paddle_tpu_torch.tools import flash_bwd_variants as tool

    tool.check()
    sources = {f: (tool.CSRC / f).read_text() for f in tool.FILES}
    passes = sources["mma_sync.cuh"].count("  mma_tf32_all(d, ")
    assert passes == 3
    for name, dropped in (("two_term", 1), ("one_pass", 2)):
        out = tool.edited(name, sources, tool.VARIANTS)
        assert out["mma_sync.cuh"].count("  mma_tf32_all(d, ") == passes - dropped
    hdr = sources["mma_sync.cuh"]
    one = tool.edited("one_accumulator", sources, tool.VARIANTS)["mma_sync.cuh"]
    assert one.count("add_frags(") == hdr.count("add_frags(") - 1
    assert "mma_tf32x3(acc[g], " in one and "mma_tf32x3(acc[g], " not in hdr
    assert sources["flash_attention_bwd.cu"].count("tf32_product<D, NJ>(") == 3


def test_forward_variants_tool_edits_apply_to_the_flash_sources():
    """tools/tf32_fwd_variants.py, which checks and times the 3xTF32
    forwards' mutants and other designs on the card, names edits that each
    match the kernel sources exactly once. For the flash forward: one pass
    drops two of mma_tf32x3's three passes; one accumulator sums O straight
    into its running accumulator in tf32_product (which the forward calls);
    q_resident loads and splits the warp's Q fragments once, before the kv
    loop, in place of each tile; s_unrolled and pv16 change only the d =
    128 instance's unroll factor and pass width; an edit that no longer
    matches raises."""
    from paddle_tpu_torch.tools import tf32_fwd_variants as tool

    tool.check()
    sources = {f: (tool.CSRC / f).read_text() for f in tool.FILES}
    assert "tf32_product<D, PV / 8>(oacc, " in sources["flash_attention_fwd.cu"]
    out = tool.edited("one_pass", sources, tool.VARIANTS)["mma_sync.cuh"]
    assert out.count("  mma_tf32_all(d, ") == 1
    one = tool.edited("one_accumulator", sources, tool.VARIANTS)["mma_sync.cuh"]
    assert "mma_tf32x3(acc[g], " in one and "add_frags(acc[g], part)" not in one
    src = sources["flash_attention_fwd.cu"]
    res = tool.edited("q_resident", sources, tool.VARIANTS)["flash_attention_fwd.cu"]
    assert "mma_tf32x3(s, qb[ks], qs[ks], bb, bs);" in res
    assert res.count("ldsm_x4(qa + ks * 32, qr);") == src.count("ldsm_x4(qa + ks * 32, qr);") == 1
    assert res.index("ldsm_x4(qa + ks * 32, qr);") < res.rindex("for (int kt = 0; kt < n_kv;")
    both = tool.edited("s_unrolled_pv16", sources, tool.VARIANTS)["flash_attention_fwd.cu"]
    assert "constexpr int SU = KS;" in both and "constexpr int SU = KS;" not in src
    assert "constexpr int TF32_PV = D <= 64 ? 32 : 16;" in both
    with pytest.raises(ValueError):
        tool.edited("q_resident", tool.edited("q_resident", sources, tool.VARIANTS),
                    tool.VARIANTS)
