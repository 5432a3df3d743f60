"""paddle_tpu_torch on the card: kernels against their plain versions, and the
model and engine on CUDA against the same weights on the CPU.

Every test here needs a CUDA card and skips without one. The file imports
neither jax nor paddle_tpu, so on the card it runs without the repository's
conftest (which loads jax):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Inputs come from numpy with fixed seeds. Tolerances: f32 1e-4, times
max(1, max|ref|) for gradients (summation order; TF32 is turned off); bf16
2e-2 x max|ref| (p rounds to bf16 against the running max in the forward
kernel and the final max in the plain version; the backward rounds P and dS
to bf16 where both versions do, but sums in another order). The LayerNorm
and LM-loss kernels are held to the same two tolerances against their plain
versions (sums in another order; bf16 outputs round once in both; the
LayerNorm backward also to the same bits twice, and its bf16 instances to
128-bit global accesses with no spills), except
the f32 dW of bf16 h: 1e-3 x max|ref| (dl rounds to bf16 at the same point
in both, so only the sum order differs; at bf16 tolerance a dW without its
softmax term would pass wherever the labels' -h spikes set max|ref|). The
LM-loss backward's tensor-core kernels (bf16 h) are also held to their
plain versions with every label -100 (dh and dW the softmax term alone), to
giving the same bits twice, to their route's launch counts, and to HMMA in
their SASS with no spills. At f32 h the backward takes the 3xTF32 tensor
cores: its f32 dh and dW, and the FMA kernel's (its predecessor), are held
besides to 5e-6 in relative Frobenius norm (GRAD_F32_FROB_TOL): a TF32
product without its error compensation errs by ~2e-4 there while its dh
passes the max limit, f32 sums in another order by ~4e-7. Its instances
hold TF32 HMMA in their SASS. Past the one-CTA tiles (f32 H > 768, bf16 H
> 1536) both tensor-core backwards split the hidden dim across a
thread-block cluster: the same limits, the same bits twice, and a cluster
launch the C entry refuses raises rather than falling back.

The tensor-core forwards (flash attention and the LM loss at bf16) hold
their f32 outputs, lse and the per-row loss, at 1e-4 x max(1, max|ref|):
bf16 inputs are exact in f32 and both versions sum the products in f32, so
only the order differs (a dropped kv or vocab tile moves them by far more);
the flash o at 2e-2 x max|o|. At f32 both forwards take the TF32 tensor
cores in 3xTF32: loss, lse and o at 1e-4, and the flash o also at 5e-6 in
each (b, h) head's relative Frobenius norm (GRAD_F32_FROB_TOL; one TF32
pass errs by ~4e-4 there), with TF32 HMMA in their SASS and no spills.
Their FMA predecessors, reached with the private ``route="fma"``, are held
to the same limits on the same inputs. The f32 backward pair, whose
helpers the flash forward now shares from mma_sync.cuh, is held to the bits
it gave before they moved.
The FA2 backward pair at bf16 takes the tensor-core kernels; they and
their FMA predecessors are held to the plain version at 2e-2 x max|ref| and
at 1e-2 in each (b, h) head's relative Frobenius norm (causal P[0, 0] = 1
makes dV[0] = dO[0], so max|ref| is ~50x a typical entry, and the max limit
alone passes a q or kv tile dropped far from the diagonal), to their
route's launch counts, to the same bits twice, and to HMMA in their SASS
with no spills. At f32 the pair takes the TF32 tensor cores in 3xTF32; it
and its FMA predecessor are held to 1e-4 x max(1, max|ref|) and to 5e-6 in
each head's relative Frobenius norm (GRAD_F32_FROB_TOL; one TF32 pass errs
by ~1e-4 there), to their route's launch counts, to the same bits twice,
and to TF32 HMMA in their SASS with no spills.
Recompute on the card launches each layer's flash forward twice (the
forward and its replay) and the backward pair once, and keeps the bf16
gradients within 2e-2 x max|ref| of the step's without it; two
microbatches of an f32 step give the plain step's loss (rtol 1e-5) and
gradients (1e-4 x max(1, max|g|)) on the whole batch. FSDP on NCCL at 1, 2
and 4 ranks is the replicated step's bits up to 2 ranks (losses within 1e-5
past them), every prefetch depth gives the same bits, its payloads stay
within 2e-2 of f32, and its checkpoint resumes bit for bit; a bf16 step's
checkpoint resumes bit for bit and a corrupted one falls back.
"""
import os

import numpy as np
import pytest
import torch

from paddle_tpu_torch.amp import auto_cast
from paddle_tpu_torch.distributed import TrainStepEngine
from paddle_tpu_torch.models import GPTConfig, GPTForPretraining, gpt_tiny
from paddle_tpu_torch.ops.kernels import flash_attention as fa
from paddle_tpu_torch.ops.kernels import layer_norm as ln
from paddle_tpu_torch.ops.kernels import lm_loss as lm
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.serving import ServingEngine

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,causal,sq,sk,d", [
    ("float32", True, 200, 200, 64),     # ragged tiles
    ("bfloat16", True, 200, 200, 64),
    ("float32", False, 77, 300, 32),
    ("float32", True, 128, 1024, 128),   # top-left causal with sq < sk
    ("bfloat16", False, 256, 128, 128),
])
def test_flash_kernel_matches_plain(cuda, dtype, causal, sq, sk, d):
    dt = getattr(torch, dtype)
    rng = np.random.RandomState(4)
    q, k, v = (torch.from_numpy(rng.randn(2, s, 3, d).astype(np.float32)).to(cuda, dt)
               for s in (sq, sk, sk))
    before = fa.launches
    o, lse = fa.flash_attention_with_lse(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    po, plse = fa.flash_attention_plain(q, k, v, causal=causal)
    tol = 1e-4 if dt == torch.float32 else 2e-2 * po.float().abs().max().item()
    assert (o.float() - po.float()).abs().max().item() <= tol
    assert (lse - plse).abs().max().item() <= 1e-4


def _launch_counts():
    """Launches of the flash forward, dK/dV and dQ, each on either route."""
    return fa.launches, fa.launches_bwd("dkdv"), fa.launches_bwd("dq")


def _bwd_routes():
    return {r: dict(c) for r, c in fa.launches_bwd_by_route.items()}


def _bwd_moved(before):
    return {r: {n: fa.launches_bwd_by_route[r][n] - before[r][n] for n in ("dkdv", "dq")}
            for r in before}


def _head_rel_frob(got, ref):
    """max over the (b, h) heads of ||got - ref||_F / ||ref||_F ([b, s, h, d])."""
    g, r = got.float(), ref.float()
    err = (g - r).square().sum(dim=(1, 3)).sqrt()
    return (err / r.square().sum(dim=(1, 3)).sqrt().clamp_min(1e-30)).max().item()


BF16_GRAD_FROB_TOL = 1e-2
GRAD_F32_FROB_TOL = 5e-6


def _bwd_inputs(cuda, dt, b, sq, sk, h, d, causal, seed):
    """q, k, v, dO and the forward's lse and delta (from the plain version)."""
    rng = np.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy(rng.randn(b, s, h, d).astype(np.float32)).to(cuda, dt)
                   for s in (sq, sk, sk, sq))
    o, lse = fa.flash_attention_plain(q, k, v, causal=causal)
    return q, k, v, do, lse, fa.attention_delta(o, do)


@pytest.mark.parametrize("dtype,causal,sq,sk,d", [
    ("float32", True, 256, 256, 64),
    ("bfloat16", True, 256, 256, 64),
    ("float32", False, 256, 256, 64),
    ("bfloat16", False, 192, 192, 64),
    ("float32", True, 200, 200, 32),     # ragged tiles
    ("float32", False, 77, 300, 128),    # sq != sk, ragged
    ("float32", True, 128, 320, 64),     # top-left causal with sq < sk
    ("bfloat16", True, 300, 100, 128),   # sq > sk
])
def test_flash_bwd_kernels_match_plain(cuda, dtype, causal, sq, sk, d):
    """Each wrapper launches once, on the route of its dtype (bf16 the
    tensor-core kernels, f32 the 3xTF32 ones)."""
    dt = getattr(torch, dtype)
    q, k, v, do, lse, delta = _bwd_inputs(cuda, dt, 2, sq, sk, 3, d, causal, seed=7)
    route = fa.backward_route(dt, d)
    before = _bwd_routes()
    dk, dv = fa.flash_attention_bwd_dkdv(q, k, v, do, lse, delta, causal=causal)
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal=causal)
    torch.cuda.synchronize()
    assert _bwd_moved(before) == {r: {"dkdv": int(r == route), "dq": int(r == route)}
                                  for r in before}
    want = fa.flash_attention_bwd_plain(q, k, v, do, lse, delta, causal=causal)
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        scale = ref.float().abs().max().item()
        tol = 1e-4 * max(1.0, scale) if dt == torch.float32 else 2e-2 * scale
        err = (got.float() - ref.float()).abs().max().item()
        assert err <= tol, (name, err, tol)
        frob = _head_rel_frob(got, ref)
        assert frob <= (BF16_GRAD_FROB_TOL if dt == torch.bfloat16 else GRAD_F32_FROB_TOL), \
            (name, frob)


@pytest.mark.parametrize("causal,sq,sk,d", [
    (True, 256, 256, 64),
    (False, 256, 256, 64),
    (False, 192, 192, 64),
    (True, 200, 200, 32),       # ragged tiles
    (False, 77, 300, 128),      # sq != sk, ragged
    (True, 128, 320, 64),       # top-left causal with sq < sk
    (True, 300, 100, 128),      # sq > sk
    (True, 1000, 1000, 128),    # ragged, two passes a q tile in dK/dV
    (False, 130, 130, 32),
])
def test_flash_bwd_mma_kernels_and_their_predecessor_match_plain(cuda, causal, sq, sk, d):
    """bf16: the tensor-core pair (the default route) and the FMA pair
    (route="fma") against the plain version at 2e-2 x max|ref| and 1e-2 in
    each head's relative Frobenius norm; each wrapper launches once on its
    route."""
    q, k, v, do, lse, delta = _bwd_inputs(cuda, torch.bfloat16, 2, sq, sk, 3, d, causal,
                                          seed=23)
    want = fa.flash_attention_bwd_plain(q, k, v, do, lse, delta, causal=causal)
    for route in ("mma", "fma"):
        before = _bwd_routes()
        forced = None if route == "mma" else "fma"
        dk, dv = fa.flash_attention_bwd_dkdv(q, k, v, do, lse, delta, causal=causal,
                                             route=forced)
        dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal=causal, route=forced)
        torch.cuda.synchronize()
        one = {"dkdv": 1, "dq": 1}
        assert _bwd_moved(before) == {r: one if r == route else {"dkdv": 0, "dq": 0}
                                      for r in before}
        for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
            scale = ref.float().abs().max().item()
            assert _err(got, ref) <= 2e-2 * scale, (route, name, _err(got, ref), scale)
            frob = _head_rel_frob(got, ref)
            assert frob <= BF16_GRAD_FROB_TOL, (route, name, frob)


def test_flash_bwd_mma_kernels_are_deterministic(cuda):
    """No atomics and a fixed summation order: two calls of the tensor-core
    pair give the same bits, causal and not, at every head dim."""
    for causal, d in ((True, 64), (False, 32), (True, 128)):
        args = _bwd_inputs(cuda, torch.bfloat16, 2, 320, 320, 4, d, causal, seed=24)
        first = (*fa.flash_attention_bwd_dkdv(*args, causal=causal),
                 fa.flash_attention_bwd_dq(*args, causal=causal))
        second = (*fa.flash_attention_bwd_dkdv(*args, causal=causal),
                  fa.flash_attention_bwd_dq(*args, causal=causal))
        for a, b in zip(first, second):
            assert torch.equal(a, b), (causal, d)


def test_flash_bwd_routes_under_autograd(cuda):
    """Autograd through flash_attention reaches the bf16 tensor-core pair at
    bf16 and the 3xTF32 pair at f32, once each; each tensor-core pair forced
    at the other dtype raises."""
    rng = np.random.RandomState(25)
    base = rng.randn(2, 192, 3, 4, 64).astype(np.float32)
    for dt, route in ((torch.bfloat16, "mma"), (torch.float32, "tf32x3")):
        qkv = torch.from_numpy(base).to(cuda, dt).requires_grad_()
        q, k, v = qkv.unbind(dim=2)
        before = _bwd_routes()
        fa.flash_attention(q, k, v, causal=True).float().square().sum().backward()
        torch.cuda.synchronize()
        one = {"dkdv": 1, "dq": 1}
        assert _bwd_moved(before) == {r: one if r == route else {"dkdv": 0, "dq": 0}
                                      for r in before}
        assert bool(torch.isfinite(qkv.grad).all()) and bool(qkv.grad.any())
    for dt, route in ((torch.float32, "mma"), (torch.bfloat16, "tf32x3")):
        args = _bwd_inputs(cuda, dt, 1, 128, 128, 2, 64, True, seed=26)
        with pytest.raises(ValueError):
            fa.flash_attention_bwd_dkdv(*args, causal=True, route=route)
        with pytest.raises(ValueError):
            fa.flash_attention_bwd_dq(*args, causal=True, route=route)


@pytest.mark.parametrize("causal,sq,sk,d", [
    (True, 256, 256, 64),
    (False, 256, 256, 64),
    (True, 200, 200, 64),       # ragged tiles
    (True, 200, 200, 32),
    (False, 77, 300, 128),      # sq != sk, ragged
    (True, 128, 320, 64),       # top-left causal with sq < sk
    (True, 300, 100, 128),      # sq > sk
    (True, 1000, 1000, 128),
    (False, 130, 130, 32),
])
def test_flash_bwd_tf32_kernels_and_their_predecessor_match_plain(cuda, causal, sq, sk, d):
    """f32: the 3xTF32 pair (the default route) and the FMA pair
    (route="fma") against the plain version at 1e-4 x max(1, max|ref|) and
    GRAD_F32_FROB_TOL in each head's relative Frobenius norm; each wrapper
    launches once on its route; outputs are f32 of the inputs' shapes."""
    q, k, v, do, lse, delta = _bwd_inputs(cuda, torch.float32, 2, sq, sk, 3, d, causal,
                                          seed=27)
    assert fa.backward_route(torch.float32, d) == "tf32x3"
    want = fa.flash_attention_bwd_plain(q, k, v, do, lse, delta, causal=causal)
    for route in ("tf32x3", "fma"):
        before = _bwd_routes()
        forced = None if route == "tf32x3" else "fma"
        dk, dv = fa.flash_attention_bwd_dkdv(q, k, v, do, lse, delta, causal=causal,
                                             route=forced)
        dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal=causal, route=forced)
        torch.cuda.synchronize()
        one = {"dkdv": 1, "dq": 1}
        assert _bwd_moved(before) == {r: one if r == route else {"dkdv": 0, "dq": 0}
                                      for r in before}
        for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
            assert got.dtype == torch.float32 and got.shape == ref.shape
            tol = 1e-4 * max(1.0, ref.abs().max().item())
            assert _err(got, ref) <= tol, (route, name, _err(got, ref), tol)
            frob = _head_rel_frob(got, ref)
            assert frob <= GRAD_F32_FROB_TOL, (route, name, frob)


def test_flash_bwd_tf32_kernels_are_deterministic(cuda):
    """No atomics and a fixed summation order: two calls of the 3xTF32 pair
    give the same bits, causal and not, at every head dim."""
    for causal, d in ((True, 64), (False, 32), (True, 128)):
        args = _bwd_inputs(cuda, torch.float32, 2, 320, 320, 4, d, causal, seed=28)
        first = (*fa.flash_attention_bwd_dkdv(*args, causal=causal),
                 fa.flash_attention_bwd_dq(*args, causal=causal))
        second = (*fa.flash_attention_bwd_dkdv(*args, causal=causal),
                  fa.flash_attention_bwd_dq(*args, causal=causal))
        for a, b in zip(first, second):
            assert torch.equal(a, b), (causal, d)


#: sha256 (first 16 hex digits) of the f32 backward pair's dq, dk and dv bits
#: on _bwd_bits_inputs, as the build before the 3xTF32 helpers moved from
#: flash_attention_bwd.cu into mma_sync.cuh gave them on the H100 (the
#: forward now shares them); a change to the pair's arithmetic changes them
BWD_TF32_BITS = {"2x320x4x64_1": "8c7c1573db664da5", "2x200x3x32_0": "085f7d317da1b611",
                 "2x300x2x128_1": "6c7e633b53816c35", "1x1024x2x64_1": "8c2663996cad311b"}


def _bwd_bits_inputs(b, s, h, d, causal, seed):
    """q, k, v, dO and the forward's lse and delta as f32 numpy arrays: lse
    and delta from float64 einsums (numpy's own loops, no BLAS), so that
    they do not depend on a library's summation order."""
    rng = np.random.RandomState(seed)
    q, k, v, do = (rng.randn(b, s, h, d).astype(np.float32) for _ in range(4))
    sc = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), k.astype(np.float64)) / np.sqrt(d)
    if causal:
        sc = np.where(np.tril(np.ones((s, s), dtype=bool)), sc, -1e30)
    m = sc.max(axis=-1, keepdims=True)
    p = np.exp(sc - m)
    l = p.sum(axis=-1, keepdims=True)
    o = np.einsum("bhqk,bkhd->bqhd", p / l, v.astype(np.float64))
    lse = np.ascontiguousarray((m + np.log(l))[..., 0], dtype=np.float32)
    delta = np.ascontiguousarray(np.einsum("bqhd,bqhd->bhq", do.astype(np.float64), o),
                                 dtype=np.float32)
    return q, k, v, do, lse, delta


def _bwd_tf32_digests():
    """{case: digest} of the f32 backward pair's outputs (BWD_TF32_BITS)."""
    import hashlib

    out = {}
    for i, (b, s, h, d, causal) in enumerate(((2, 320, 4, 64, True), (2, 200, 3, 32, False),
                                              (2, 300, 2, 128, True), (1, 1024, 2, 64, True))):
        args = [torch.from_numpy(x).cuda() for x in _bwd_bits_inputs(b, s, h, d, causal, 40 + i)]
        dk, dv = fa.flash_attention_bwd_dkdv(*args, causal=causal)
        dq = fa.flash_attention_bwd_dq(*args, causal=causal)
        digest = hashlib.sha256()
        for g in (dq, dk, dv):
            digest.update(g.cpu().numpy().tobytes())
        out[f"{b}x{s}x{h}x{d}_{int(causal)}"] = digest.hexdigest()[:16]
    return out


def test_flash_bwd_tf32_bits_unchanged_by_the_shared_helpers(cuda):
    """The 3xTF32 backward pair gives the bits it gave before its TF32
    helpers (FPAD, TF32_GROUP, Tf32Acc, a_slot, tf32_product,
    store_rows_f32) moved into mma_sync.cuh for the forward to share: d 32,
    64 and 128, causal and not, ragged, s = 1024."""
    assert fa.backward_route(torch.float32, 64) == "tf32x3"
    assert _bwd_tf32_digests() == BWD_TF32_BITS


def test_flash_bwd_tf32_reads_strided_and_unaligned_views(cuda):
    """The fused qkv projection's f32 views are read in place; a q view
    starting 4 bytes off a 16-byte boundary is copied to an aligned one
    first. Both give the bits of fresh contiguous copies of the inputs."""
    rng = np.random.RandomState(29)
    qkv = torch.from_numpy(rng.randn(2, 192, 3, 4, 64).astype(np.float32)).to(cuda)
    q, k, v = qkv.unbind(dim=2)
    do = torch.from_numpy(rng.randn(2, 192, 4, 64).astype(np.float32)).to(cuda)
    o, lse = fa.flash_attention_plain(q, k, v, causal=True)
    delta = fa.attention_delta(o, do)
    flat = torch.from_numpy(rng.randn(2 * 192 * 4 * 64 + 1).astype(np.float32)).to(cuda)
    shifted = flat[1:].view(2, 192, 4, 64)
    assert fa._mma_operand(q) is q and fa._mma_operand(shifted) is not shifted
    def fresh(x):   # a new contiguous allocation (16-byte aligned)
        return x.clone(memory_format=torch.contiguous_format)

    for qq in (q, shifted):
        got = (fa.flash_attention_bwd_dq(qq, k, v, do, lse, delta, causal=True),
               *fa.flash_attention_bwd_dkdv(qq, k, v, do, lse, delta, causal=True))
        args = (fresh(qq), fresh(k), fresh(v), do, lse, delta)
        want = (fa.flash_attention_bwd_dq(*args, causal=True),
                *fa.flash_attention_bwd_dkdv(*args, causal=True))
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_flash_autograd_goes_through_the_kernels(cuda):
    """q, k, v views of one fused projection with requires_grad: the forward
    and both backward kernels launch once each, and the gradients (with an
    lse cotangent) match the same Function run on the CPU."""
    rng = np.random.RandomState(8)
    base = rng.randn(2, 192, 3, 4, 64).astype(np.float32)
    g_o = torch.from_numpy(rng.randn(2, 192, 4, 64).astype(np.float32))
    g_lse = torch.from_numpy(rng.randn(2, 4, 192).astype(np.float32))
    grads = []
    for dev in ("cuda", "cpu"):
        qkv = torch.from_numpy(base).to(dev).requires_grad_()
        q, k, v = qkv.unbind(dim=2)
        before = _launch_counts(), dict(fa.launches_by_route), _bwd_routes()
        o, lse = fa.flash_attention_with_lse(q, k, v, causal=True)
        ((o * g_o.to(dev)).sum() + (lse * g_lse.to(dev)).sum()).backward()
        after = _launch_counts()
        expect = 1 if dev == "cuda" else 0
        assert [a - b for a, b in zip(after, before[0])] == [expect] * 3
        assert {r: fa.launches_by_route[r] - before[1][r] for r in before[1]} == {
            r: expect * (r == "tf32x3") for r in before[1]}
        assert _bwd_moved(before[2]) == {r: {"dkdv": expect * (r == "tf32x3"),
                                             "dq": expect * (r == "tf32x3")}
                                         for r in before[2]}
        grads.append(qkv.grad.cpu())
    assert (grads[0] - grads[1]).abs().max().item() <= 1e-4


def _f32_tol(ref):
    """An f32 result of bf16 inputs (flash lse, LM-loss loss and lse)."""
    return 1e-4 * max(1.0, ref.abs().max().item())


@pytest.mark.parametrize("causal,sq,sk,d", [
    (True, 256, 256, 64),
    (False, 256, 256, 64),
    (True, 200, 200, 32),       # ragged tiles
    (False, 128, 1024, 32),     # sq != sk
    (True, 128, 1024, 128),     # top-left causal with sq < sk
    (False, 1000, 1000, 128),   # ragged, non-causal
    (True, 1000, 1000, 64),
    (True, 300, 100, 64),       # sq > sk
])
def test_flash_mma_kernel_and_its_predecessor_match_plain(cuda, causal, sq, sk, d):
    """bf16: the tensor-core forward (the default route) and the FMA kernel
    (route="fma") against the plain version, o at 2e-2 x max|o| and lse at
    1e-4 x max(1, max|lse|); each launches once on its route."""
    rng = np.random.RandomState(19)
    q, k, v = (torch.from_numpy(rng.randn(2, s, 3, d).astype(np.float32))
               .to(cuda, torch.bfloat16) for s in (sq, sk, sk))
    po, plse = fa.flash_attention_plain(q, k, v, causal=causal)
    for route in ("mma", "fma"):
        before = dict(fa.launches_by_route)
        o, lse = (fa.flash_attention_with_lse(q, k, v, causal=causal) if route == "mma"
                  else fa._launch(q, k, v, causal, 1.0 / d ** 0.5, route="fma"))
        torch.cuda.synchronize()
        assert {r: fa.launches_by_route[r] - before[r] for r in before} == {
            r: int(r == route) for r in before}
        assert o.dtype == torch.bfloat16 and lse.shape == plse.shape
        assert _err(o, po) <= 2e-2 * po.float().abs().max().item(), route
        assert _err(lse, plse) <= _f32_tol(plse), route


def test_flash_mma_kernel_reads_the_fused_qkv_views_in_place(cuda):
    """The model's q, k, v are bf16 views of one fused [b, s, 3, h, d]
    projection: 16-byte aligned, so the tensor-core kernel reads them
    through their strides (no copy) and gives the bits of contiguous
    inputs. A view shifted by one element is copied first, and agrees."""
    qkv = torch.randn(2, 256, 3, 4, 64, device=cuda).bfloat16()
    q, k, v = qkv.unbind(dim=2)
    assert all(fa._mma_operand(x) is x for x in (q, k, v))
    o = fa.flash_attention(q, k, v, causal=True)
    oc = fa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=True)
    assert torch.equal(o, oc)
    flat = torch.randn(2 * 256 * 4 * 64 + 1, device=cuda).bfloat16()
    shifted = flat[1:].view(2, 256, 4, 64)
    assert fa._mma_operand(shifted) is not shifted
    os = fa.flash_attention(shifted, k, v, causal=True)
    ref = fa.flash_attention(shifted.clone(), k, v, causal=True)
    assert torch.equal(os, ref)


def test_flash_forward_routes_and_determinism(cuda):
    """bf16 launches the bf16 tensor-core forward and f32 the 3xTF32 one,
    directly and under autograd, at every head dim; two calls give the same
    bits; each tensor-core route refuses the other dtype."""
    rng = np.random.RandomState(20)
    for d in fa.HEAD_DIMS:
        base = rng.randn(2, 192, 4, d).astype(np.float32)
        for dt, route in ((torch.bfloat16, "mma"), (torch.float32, "tf32x3")):
            x = torch.from_numpy(base).to(cuda, dt).requires_grad_()
            before = dict(fa.launches_by_route)
            o1, lse1 = fa.flash_attention_with_lse(x, x, x, causal=True)
            o1.float().sum().backward()
            o2, lse2 = fa.flash_attention_with_lse(x, x, x, causal=True)
            assert {r: fa.launches_by_route[r] - before[r] for r in before} == {
                r: 2 * (r == route) for r in before}
            assert torch.equal(o1, o2) and torch.equal(lse1, lse2)
    xb = x.detach().bfloat16()
    with pytest.raises(ValueError):
        fa._launch(x, x, x, True, 0.125, route="mma")     # f32 on the bf16 tensor cores
    with pytest.raises(ValueError):
        fa._launch(xb, xb, xb, True, 0.125, route="tf32x3")  # bf16 in 3xTF32


@pytest.mark.parametrize("causal,sq,sk,d", [
    (True, 256, 256, 64),
    (False, 256, 256, 64),
    (True, 200, 200, 32),       # ragged tiles
    (False, 77, 300, 128),      # sq != sk, ragged
    (True, 128, 1024, 128),     # top-left causal with sq < sk
    (True, 1000, 1000, 64),
    (False, 1000, 1000, 32),
    (True, 300, 100, 128),      # sq > sk
    (True, 1024, 1024, 128),
])
def test_flash_tf32_kernel_and_its_predecessor_match_plain(cuda, causal, sq, sk, d):
    """f32: the 3xTF32 forward (the default route) and the FMA kernel
    (route="fma") against the plain version, o and lse at 1e-4 and o at
    GRAD_F32_FROB_TOL in each (b, h) head's relative Frobenius norm; each
    launches once on its route; o is f32 of q's shape."""
    rng = np.random.RandomState(30)
    q, k, v = (torch.from_numpy(rng.randn(2, s, 3, d).astype(np.float32)).to(cuda)
               for s in (sq, sk, sk))
    assert fa.forward_route(torch.float32, d) == "tf32x3"
    po, plse = fa.flash_attention_plain(q, k, v, causal=causal)
    for route in ("tf32x3", "fma"):
        before = dict(fa.launches_by_route)
        o, lse = (fa.flash_attention_with_lse(q, k, v, causal=causal) if route == "tf32x3"
                  else fa._launch(q, k, v, causal, 1.0 / d ** 0.5, route="fma"))
        torch.cuda.synchronize()
        assert {r: fa.launches_by_route[r] - before[r] for r in before} == {
            r: int(r == route) for r in before}
        assert o.dtype == torch.float32 and o.shape == q.shape and lse.shape == plse.shape
        assert _err(o, po) <= 1e-4 and _err(lse, plse) <= 1e-4, route
        assert _head_rel_frob(o, po) <= GRAD_F32_FROB_TOL, (route, _head_rel_frob(o, po))


def test_flash_tf32_kernel_reads_strided_and_unaligned_views(cuda):
    """The fused qkv projection's f32 views are read in place by the 3xTF32
    forward, and a q view starting 4 bytes off a 16-byte boundary is copied
    to an aligned one first: both give the bits of fresh contiguous copies,
    at every head dim."""
    rng = np.random.RandomState(31)
    for d in fa.HEAD_DIMS:
        qkv = torch.from_numpy(rng.randn(2, 192, 3, 4, d).astype(np.float32)).to(cuda)
        q, k, v = qkv.unbind(dim=2)
        flat = torch.from_numpy(rng.randn(2 * 192 * 4 * d + 1).astype(np.float32)).to(cuda)
        shifted = flat[1:].view(2, 192, 4, d)
        assert all(fa._mma_operand(x) is x for x in (q, k, v))
        assert fa._mma_operand(shifted) is not shifted
        for qq in (q, shifted):
            got = fa.flash_attention_with_lse(qq, k, v, causal=True)
            want = fa.flash_attention_with_lse(*(x.clone(memory_format=torch.contiguous_format)
                                                 for x in (qq, k, v)), causal=True)
            assert all(torch.equal(g, w) for g, w in zip(got, want)), d


def test_flash_kernel_reads_strided_qkv_views(cuda):
    """The model hands the kernel q, k, v sliced out of one fused [b, s, 3,
    h, d] projection; the kernel reads them through their strides."""
    qkv = torch.randn(2, 256, 3, 4, 32, device=cuda)
    q, k, v = qkv.unbind(dim=2)
    o = fa.flash_attention(q, k, v, causal=True)
    po, _ = fa.flash_attention_plain(q.contiguous(), k.contiguous(), v.contiguous(),
                                     causal=True)
    assert (o - po).abs().max().item() <= 1e-4


def test_flash_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.randn(1, 128, 2, 48, device=cuda)
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q)                       # head_dim 48
    q16 = torch.randn(1, 128, 2, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        fa.flash_attention(q16, q16, q16)


def test_scoring_forward_launches_once_per_layer_and_matches_cpu(cuda):
    cfg = gpt_tiny()
    gpu = GPTForPretraining(cfg, seed=3)
    cpu = GPTForPretraining(cfg, device="cpu", seed=3)
    ids = torch.from_numpy(np.random.RandomState(5).randint(0, 1024, (2, 128)))
    fa.launches = 0
    before = dict(fa.launches_by_route)
    with torch.no_grad():
        got = gpu(ids.to(cuda))
    torch.cuda.synchronize()
    assert fa.launches == cfg.num_layers
    assert {r: fa.launches_by_route[r] - before[r] for r in before} == {
        r: cfg.num_layers * (r == "tf32x3") for r in before}
    with torch.no_grad():
        want = cpu(ids)
    assert (got.cpu() - want).abs().max().item() <= 1e-4


@pytest.mark.parametrize("layout", [{}, {"kv_layout": "paged", "kv_page_tokens": 8}],
                         ids=["contiguous", "paged"])
def test_engine_on_card_gives_the_cpu_engine_tokens(cuda, layout):
    """f32 gpt_tiny served on the card and on the CPU: the same tokens, greedy
    and sampled; paged, the repeated 16-token prompt is a full prefix hit."""
    cfg = gpt_tiny()
    rng = np.random.RandomState(6)
    prompts = [rng.randint(0, 1024, (n,)).astype(np.int64) for n in (5, 30, 9, 17, 3, 16)]
    prompts.append(prompts[-1])
    out = []
    for device in ("cuda", "cpu"):
        model = GPTForPretraining(cfg, device=device, seed=4)
        eng = ServingEngine(model, slot_count=3, ladder=(8, 16, 32), max_new_cap=16,
                            steps_per_dispatch=4, **layout)
        reqs = [eng.submit(p, max_new_tokens=8, temperature=0.0) for p in prompts]
        reqs.append(eng.submit(prompts[1], max_new_tokens=8, temperature=0.7,
                               top_k=20, seed=9))
        eng.run()
        assert all(r.done for r in reqs)
        assert reqs[6].prefix_hit == bool(layout)
        out.append([r.tokens for r in reqs])
    assert out[0] == out[1]


def test_router_over_two_engines_on_card_gives_one_engines_tokens(cuda):
    """GPT-2 124M's width (2 layers), f32: 8 greedy requests behind two
    shared 128-token prefixes, served by one paged engine of 8 slots and by
    a ReplicaRouter over two paged engines of 4 slots (placement by queue,
    occupancy and prefix locality; the second replica drains after half
    the traffic, its queued work re-placed). The slot counts and the
    prefix hits differ, so the GEMM shapes do: a request may part at a
    near-tie of its scoring forward's logits (at most SPEC_TIE_TOL apart,
    chip_smoke.py's LOGITS_TOL), and only there."""
    from paddle_tpu_torch.serving import ReplicaRouter

    cfg = GPTConfig(num_layers=2)
    model = GPTForPretraining(cfg, seed=3)
    rng = np.random.RandomState(8)
    prefixes = [rng.randint(0, cfg.vocab_size, (128,)) for _ in range(2)]
    prompts = [np.concatenate([prefixes[i % 2], rng.randint(0, cfg.vocab_size, (n,))])
               for i, n in enumerate((7, 20, 33, 46, 59, 72, 85, 98))]
    kw = dict(ladder=(64, 128, 256), max_new_cap=16, max_seq_len=512,
              kv_layout="paged", kv_page_tokens=64)
    one = ServingEngine(model, slot_count=8, **kw)
    want = [one.submit(p, max_new_tokens=16) for p in prompts]
    one.run()
    router = ReplicaRouter([ServingEngine(model, slot_count=4, **kw) for _ in range(2)])
    got = [router.submit(p, max_new_tokens=16) for p in prompts[:4]]
    router.step()
    got += [router.submit(p, max_new_tokens=16) for p in prompts[4:]]
    replaced = {tuple(r.prompt_ids): r for r in router.begin_drain("r1")}
    router.run()
    got = [r if r.done else replaced[tuple(r.prompt_ids)] for r in got]
    assert router.drained("r1") and router.stats()["prefix_routed"] > 0
    assert all(r.done and len(r.tokens) == 16 for r in got + want)
    for g, w in zip(got, want):
        if g.tokens == w.tokens:
            continue
        j = next(i for i, (a, b) in enumerate(zip(g.tokens, w.tokens)) if a != b)
        prefix = np.concatenate([w.prompt_ids, np.asarray(w.tokens[:j], np.int64)])
        with torch.no_grad():
            lg = model(torch.from_numpy(prefix)[None].cuda())[0, -1]
        assert abs(lg[g.tokens[j]] - lg[w.tokens[j]]).item() <= SPEC_TIE_TOL


SPEC_TIE_TOL = 2e-3   # chip_smoke.py's LOGITS_TOL: f32 logits, card vs CPU


@pytest.mark.parametrize("layout", [{}, {"kv_layout": "paged", "kv_page_tokens": 8}],
                         ids=["contiguous", "paged"])
def test_spec_engine_on_card_gives_the_cpu_spec_engine_tokens(cuda, layout):
    """f32 gpt_tiny with a 1-layer draft, speculating and plain requests
    mixed, on the card and on the CPU: the same greedy tokens and spec
    counts. The card's [slots, k + 1] verify window and [slots, 1] draft
    steps run other GEMM shapes than the CPU's, so a request may part at a
    near-tie: where the two logits of the CPU model's scoring forward of the
    common prefix are at most SPEC_TIE_TOL apart (chip_smoke.py's serve_spec
    allows the same), and only there; the tokens after it are not
    compared."""
    cfg = gpt_tiny()
    rng = np.random.RandomState(12)
    prompts = [rng.randint(0, 1024, (n,)).astype(np.int64) for n in (5, 30, 9, 17, 3, 16)]
    prompts.append(prompts[-1])
    out = []
    for device in ("cuda", "cpu"):
        model = GPTForPretraining(cfg, device=device, seed=4)
        draft = GPTForPretraining(GPTConfig(vocab_size=1024, hidden_size=128, num_layers=1,
                                            num_heads=4, max_seq_len=128),
                                  device=device, seed=5)
        eng = ServingEngine(model, slot_count=3, ladder=(8, 16, 32), max_new_cap=16,
                            steps_per_dispatch=4, draft_model=draft, spec_ladder=(4,),
                            **layout)
        reqs = [eng.submit(p, max_new_tokens=12, temperature=0.0,
                           speculate_k=4 if i % 2 == 0 else 0)
                for i, p in enumerate(prompts)]
        eng.run()
        assert all(r.done for r in reqs) and reqs[0].spec_proposed > 0
        assert reqs[6].prefix_hit == bool(layout)
        out.append(reqs)
    cpu_model = model
    for got, want in zip(*out):
        if got.tokens == want.tokens:
            assert (got.spec_proposed, got.spec_accepted, got.spec_bonus) == (
                want.spec_proposed, want.spec_accepted, want.spec_bonus)
            continue
        j = next(i for i, (a, b) in enumerate(zip(got.tokens, want.tokens)) if a != b)
        prefix = np.concatenate([want.prompt_ids, np.asarray(want.tokens[:j], np.int64)])
        with torch.no_grad():
            lg = cpu_model(torch.from_numpy(prefix)[None])[0, -1]
        assert abs(lg[got.tokens[j]] - lg[want.tokens[j]]).item() <= SPEC_TIE_TOL


def _train_step(device, ids, labels, amp_dtype=None):
    model = GPTForPretraining(gpt_tiny(), device=device, seed=6)
    eng = TrainStepEngine(model, AdamW(learning_rate=1e-3,
                                       parameters=model.named_parameters()))
    counts = _launch_counts()
    with auto_cast(enable=amp_dtype is not None, dtype=amp_dtype or "bfloat16"):
        loss = eng.step(ids, labels).item()
    if device == "cuda":
        torch.cuda.synchronize()
    launched = [a - b for a, b in zip(_launch_counts(), counts)]
    grads = {n: p.grad.float().cpu() for n, p in model.named_parameters()}
    params = {n: p.detach().float().cpu() for n, p in model.named_parameters()}
    return loss, launched, grads, params


@pytest.mark.parametrize("amp_dtype", [None, "bfloat16"])
def test_gpt_tiny_train_step_on_card_matches_cpu(cuda, amp_dtype):
    """One TrainStepEngine step of gpt_tiny ([2, 128]): on the card every
    attention call goes through the three kernels (one launch each per
    layer); loss, every gradient and the updated parameters match the CPU's
    plain path. f32: loss rtol 1e-5, gradients 1e-4 x max(1, max|g|). bf16
    autocast: loss rtol 1e-2, gradients 3e-2 relative in the Frobenius norm
    (bf16 rounding, met at other points of the sums, moves a gradient by
    about 1%; a missing or zero gradient is 1 away). Adam's first step moves
    each entry by about lr x sign(g), so a gradient within rounding of 0 may
    move it the other way: parameters within 2.5e-3, and at most 0.1% (f32)
    or 1% (bf16) of the entries more than 1e-5 apart."""
    rng = np.random.RandomState(9)
    ids = rng.randint(0, 1024, (2, 128)).astype(np.int64)
    labels = np.roll(ids, -1, 1)
    card = _train_step("cuda", ids, labels, amp_dtype)
    cpu = _train_step("cpu", ids, labels, amp_dtype)
    n = gpt_tiny().num_layers
    assert card[1] == [n, n, n] and cpu[1] == [0, 0, 0]
    f32 = amp_dtype is None
    assert card[0] == pytest.approx(cpu[0], rel=1e-5 if f32 else 1e-2)
    apart = total = 0
    for name in cpu[2]:
        g_card, g_cpu = card[2][name], cpu[2][name]
        if f32:
            tol = 1e-4 * max(1.0, g_cpu.abs().max().item())
            assert (g_card - g_cpu).abs().max().item() <= tol, name
        else:
            assert ((g_card - g_cpu).norm() / g_cpu.norm()).item() <= 3e-2, name
        diff = (card[3][name] - cpu[3][name]).abs()
        assert diff.max().item() <= 2.5e-3, name
        apart += int((diff > 1e-5).sum())
        total += diff.numel()
    assert apart <= (1e-3 if f32 else 1e-2) * total, (apart, total)


GRAD_F32_FROB_TOL = 5e-6


def _rel_frob(got, ref):
    return ((got.float() - ref.float()).norm() / ref.float().norm()).item()


def _tol(ref, dt):
    scale = ref.float().abs().max().item()
    return 1e-4 * max(1.0, scale) if dt == torch.float32 else 2e-2 * scale


def _grad_tol(got, ref, ht):
    """An LM-loss gradient's tolerance: a bf16 one as _tol's bf16; an f32 dW
    from bf16 h 1e-3 x max|ref|; from f32 h as _tol's f32."""
    if got.dtype == torch.float32 and ht == torch.bfloat16:
        return 1e-3 * ref.abs().max().item()
    return _tol(ref, got.dtype if got.dtype == torch.bfloat16 else ht)


def _err(got, ref):
    assert got.dtype == ref.dtype and got.shape == ref.shape, (got.dtype, ref.dtype)
    return (got.float() - ref.float()).abs().max().item()


@pytest.mark.parametrize("dtype,n,h", [
    ("float32", 37, 768),      # fewer rows than the persistent grid's groups
    ("bfloat16", 37, 768),
    ("float32", 1, 768),       # one row: one CTA, a cluster of one
    ("bfloat16", 1, 768),
    ("float32", 300, 128),
    ("bfloat16", 64, 256),
    ("bfloat16", 300, 128),    # half of each warp masked
    ("float32", 9, 2048),      # two warps a row
    ("bfloat16", 8192, 768),   # the timed widths: GPT-2 124M, gpt_345m, gpt_1p3b
    ("bfloat16", 8192, 1024),
    ("bfloat16", 8192, 2048),
    ("bfloat16", 65536, 768),  # every group walks many rows
    ("float32", 300, 8192),    # sixteen warps a row in the backward
    ("bfloat16", 300, 8192),   # eight warps a row
])
def test_layer_norm_kernels_match_plain(cuda, dtype, n, h):
    """The training forward, the inference forward and the backward (dx, dg,
    db) against their plain versions; each wrapper launches once (the
    backward's partial sums included)."""
    dt = getattr(torch, dtype)
    rng = np.random.RandomState(10)
    x = torch.from_numpy(rng.randn(n, h).astype(np.float32) * 2 + 0.5).to(cuda, dt)
    g = torch.from_numpy(rng.rand(h).astype(np.float32) + 0.5).to(cuda)
    b = torch.from_numpy(rng.randn(h).astype(np.float32)).to(cuda)
    dy = torch.from_numpy(rng.randn(n, h).astype(np.float32)).to(cuda, dt)
    before = (ln.launches_fwd, ln.launches_infer, ln.launches_bwd)
    o, mu, rstd = ln.layer_norm_fwd(x, g, b, stats=True)
    oi = ln.layer_norm_fwd(x, g, b, stats=False)
    dx, dg, db = ln.layer_norm_bwd(x, g, dy, mu, rstd)
    torch.cuda.synchronize()
    after = (ln.launches_fwd, ln.launches_infer, ln.launches_bwd)
    assert [a - c for a, c in zip(after, before)] == [1, 1, 1]
    po, pmu, prstd = ln.layer_norm_fwd_plain(x, g, b)
    assert _err(o, po) <= _tol(po, dt) and torch.equal(o, oi)
    assert _err(mu, pmu) <= 1e-4 and _err(rstd, prstd) <= 1e-4 * prstd.max().item()
    pdx, pdg, pdb = ln.layer_norm_bwd_plain(x, g, dy, pmu, prstd)
    for got, ref in ((dx, pdx), (dg, pdg), (db, pdb)):
        tol = _tol(ref, dt) if got.dtype == dt else 1e-4 * max(1.0, ref.abs().max().item())
        assert _err(got, ref) <= tol


@pytest.mark.parametrize("dtype,n,h", [("bfloat16", 8192, 768), ("float32", 8192, 1024),
                                     ("bfloat16", 300, 8192), ("float32", 5, 256)])
def test_layer_norm_backward_is_deterministic(cuda, dtype, n, h):
    """Two backward calls on the same inputs give the same bits of dx, dg and
    db (the clusters' partials are added in a fixed order; the ticket only
    picks the cluster that adds them), one launch each, and leave the
    ticket at zero."""
    dt = getattr(torch, dtype)
    rng = np.random.RandomState(12)
    x = torch.from_numpy(rng.randn(n, h).astype(np.float32)).to(cuda, dt)
    g = torch.from_numpy(rng.rand(h).astype(np.float32) + 0.5).to(cuda)
    b = torch.from_numpy(rng.randn(h).astype(np.float32)).to(cuda)
    dy = torch.from_numpy(rng.randn(n, h).astype(np.float32)).to(cuda, dt)
    _, mu, rstd = ln.layer_norm_fwd(x, g, b, stats=True)
    before = ln.launches_bwd
    first = ln.layer_norm_bwd(x, g, dy, mu, rstd)
    second = ln.layer_norm_bwd(x, g, dy, mu, rstd)
    torch.cuda.synchronize()
    assert ln.launches_bwd == before + 2
    for a, c in zip(first, second):
        assert torch.equal(a, c)
    assert not ln._ticket(x.device).any()


def test_layer_norm_autograd_goes_through_the_kernels(cuda):
    """x [2, 40, 256] with grad: the training forward and the backward launch
    once each and the gradients match the same op on the CPU; under no_grad
    the inference forward launches."""
    rng = np.random.RandomState(11)
    base = rng.randn(2, 40, 256).astype(np.float32)
    gy = torch.from_numpy(rng.randn(2, 40, 256).astype(np.float32))
    gw, bw = rng.rand(256).astype(np.float32) + 0.5, rng.randn(256).astype(np.float32)
    grads = []
    for dev in ("cuda", "cpu"):
        x, g, b = (torch.from_numpy(a).to(dev).requires_grad_() for a in (base, gw, bw))
        before = (ln.launches_fwd, ln.launches_infer, ln.launches_bwd)
        (ln.layer_norm(x, g, b) * gy.to(dev)).sum().backward()
        with torch.no_grad():
            ln.layer_norm(x, g, b)
        after = (ln.launches_fwd, ln.launches_infer, ln.launches_bwd)
        expect = [1, 1, 1] if dev == "cuda" else [0, 0, 0]
        assert [a - c for a, c in zip(after, before)] == expect
        grads.append([t.grad.cpu() for t in (x, g, b)])
    for got, want in zip(*grads):
        assert (got - want).abs().max().item() <= 1e-4 * max(1.0, want.abs().max().item())


@pytest.mark.parametrize("htype,wtype,n,v,hdim", [
    ("float32", "float32", 1024, 500, 128),       # ragged vocab edge
    ("bfloat16", "bfloat16", 1024, 640, 256),
    ("bfloat16", "float32", 2048, 384, 768),      # bf16 h, f32 master W
    ("float32", "float32", 1024, 300, 1280),      # a cluster of two in dh / dW
    ("float32", "bfloat16", 1000, 256, 128),      # ragged rows (the wrappers mask them)
    # bf16 h: the tensor-core backward, at the edges of its 32-row tiles
    ("bfloat16", "float32", 1024, 500, 128),      # ragged vocab
    ("bfloat16", "bfloat16", 1024, 50257, 768),   # GPT-2's vocab: a ragged last tile
    ("bfloat16", "float32", 1000, 256, 768),      # ragged rows
    ("bfloat16", "float32", 1024, 300, 1280),     # two hidden chunks, one other buffer
    ("bfloat16", "bfloat16", 1000, 500, 1280),
    # past the one-CTA tiles: the hidden dim split across a cluster
    ("float32", "float32", 1000, 500, 1024),      # 2 CTAs of 512; ragged rows and vocab
    ("float32", "bfloat16", 1000, 300, 2048),     # 4 CTAs of 512
    ("bfloat16", "float32", 1000, 500, 1664),     # 3 CTAs: 640 + 640 + 384
    ("bfloat16", "bfloat16", 1000, 700, 2048),    # 3 CTAs: gpt_1p3b's width
])
def test_lm_loss_kernels_match_plain(cuda, htype, wtype, n, v, hdim):
    """The forward (loss, lse), dh and dW against their plain versions, with
    a label of -100 and one at the last column; each wrapper launches once,
    on the route backward_plan gives (the tensor cores at both dtypes, in a
    cluster past the one-CTA tiles)."""
    ht, wt = getattr(torch, htype), getattr(torch, wtype)
    rng = np.random.RandomState(12)
    h = torch.from_numpy(rng.randn(n, hdim).astype(np.float32)).to(cuda, ht)
    w = torch.from_numpy(rng.randn(v, hdim).astype(np.float32) * 0.05).to(cuda, wt)
    labels = torch.from_numpy(rng.randint(0, v, (n,)).astype(np.int32)).to(cuda)
    labels[5], labels[6] = -100, v - 1
    g = torch.from_numpy(rng.rand(n).astype(np.float32)).to(cuda)
    route = lm.backward_plan(ht, hdim).route
    assert route == ("mma" if ht == torch.bfloat16 else "tf32x3")
    fwd_route = lm.forward_route(ht)

    def counts():
        return (lm.launches_fwd, lm.launches_dh, lm.launches_dw,
                lm.launches_by_route[fwd_route]["fwd"], lm.launches_by_route[route]["dh"],
                lm.launches_by_route[route]["dw"])

    before = counts()
    loss, lse = lm.lm_loss_fwd(h, w, labels)
    dh = lm.lm_loss_dh(h, w, labels, lse, g)
    dw = lm.lm_loss_dw(h, w, labels, lse, g)
    torch.cuda.synchronize()
    assert [a - c for a, c in zip(counts(), before)] == [1] * 6
    ploss, plse = lm.lm_loss_fwd_plain(h, w, labels)
    assert _err(lse, plse) <= _tol(plse, ht) and _err(loss, ploss) <= _tol(ploss, ht)
    assert abs(loss[5].item() - lse[5].item()) <= 1e-6 * abs(lse[5].item())
    pdh, pdw = lm.lm_loss_bwd_plain(h, w, labels, plse, g)
    assert dh.dtype == ht and dw.dtype == wt
    assert _err(dh, pdh) <= _grad_tol(dh, pdh, ht)
    assert _err(dw, pdw) <= _grad_tol(dw, pdw, ht)
    if ht == torch.float32:
        assert _rel_frob(dh, pdh) <= GRAD_F32_FROB_TOL
        if wt == torch.float32:
            assert _rel_frob(dw, pdw) <= GRAD_F32_FROB_TOL


@pytest.mark.parametrize("wtype,n,v,hdim,labels", [
    ("float32", 1024, 500, 128, "minus100"),    # ragged vocab tile; two other buffers
    ("float32", 1000, 50257, 768, "random"),    # ragged rows and GPT-2's vocab
    ("float32", 1024, 384, 512, "all_minus100"),
    ("float32", 2048, 1000, 640, "minus100"),   # one other buffer, 5 of 6 pairs
    ("bfloat16", 1024, 300, 768, "minus100"),   # bf16 W cast to f32; dW in bf16
    ("float32", 1024, 700, 256, "all_minus100"),
    # past H = 768: the hidden dim split across a cluster
    ("float32", 1000, 500, 1024, "minus100"),       # 2 CTAs of 512
    ("float32", 1000, 300, 1280, "all_minus100"),   # 3 CTAs: 512 + 512 + 256
    ("float32", 1000, 700, 2048, "minus100"),       # 4 CTAs of 512
    ("float32", 1000, 300, 4224, "minus100"),       # 6 CTAs of <= 768, in order
    ("bfloat16", 1000, 500, 2048, "all_minus100"),  # bf16 W cast to f32; dW in bf16
])
def test_lm_loss_tf32x3_backward_and_its_predecessor_match_plain(cuda, wtype, n, v, hdim,
                                                                 labels):
    """f32 h: the 3xTF32 backward (the default route) and the FMA backward
    (route="fma", its predecessor) against the plain f32 version, each
    launched once on its route: dh and dW within 1e-4 x max(1, max|ref|)
    and, where f32, within GRAD_F32_FROB_TOL in relative Frobenius norm."""
    wt = getattr(torch, wtype)
    rng = np.random.RandomState(24)
    h = torch.from_numpy(rng.randn(n, hdim).astype(np.float32)).to(cuda)
    w = torch.from_numpy(rng.randn(v, hdim).astype(np.float32) * 0.05).to(cuda, wt)
    lab = torch.from_numpy(rng.randint(0, v, (n,)).astype(np.int32)).to(cuda)
    if labels == "minus100":
        lab[::7] = -100
    elif labels == "all_minus100":
        lab.fill_(-100)
    g = torch.from_numpy(rng.rand(n).astype(np.float32)).to(cuda)
    assert lm.backward_plan(torch.float32, hdim).route == "tf32x3"
    _, lse = lm.lm_loss_fwd(h, w, lab)
    pdh, pdw = lm.lm_loss_bwd_plain(h, w, lab, lse, g)
    assert pdh.abs().max().item() > 0 and pdw.float().abs().max().item() > 0
    for route in ("tf32x3", "fma"):
        before = {r: dict(c) for r, c in lm.launches_by_route.items()}
        dh = lm._bwd_launch(h, w, lab, lse, g, False, route=None if route == "tf32x3" else route)
        dw = lm._bwd_launch(h, w, lab, lse, g, True, route=None if route == "tf32x3" else route)
        torch.cuda.synchronize()
        assert {r: (c["dh"] - before[r]["dh"], c["dw"] - before[r]["dw"])
                for r, c in lm.launches_by_route.items()} == {
            r: (int(r == route),) * 2 for r in before}
        assert dh.dtype == torch.float32 and dw.dtype == wt
        assert _err(dh, pdh) <= _grad_tol(dh, pdh, torch.float32), route
        assert _err(dw, pdw) <= _grad_tol(dw, pdw, torch.float32), route
        assert _rel_frob(dh, pdh) <= GRAD_F32_FROB_TOL, route
        if wt == torch.float32:
            assert _rel_frob(dw, pdw) <= GRAD_F32_FROB_TOL, route


def _lm_inputs(cuda, n, v, hdim, wt, seed):
    rng = np.random.RandomState(seed)
    h = torch.from_numpy(rng.randn(n, hdim).astype(np.float32)).to(cuda, torch.bfloat16)
    w = torch.from_numpy(rng.randn(v, hdim).astype(np.float32) * 0.05).to(cuda, wt)
    labels = torch.from_numpy(rng.randint(0, v, (n,)).astype(np.int32)).to(cuda)
    g = torch.from_numpy(rng.rand(n).astype(np.float32)).to(cuda)
    return h, w, labels, g


@pytest.mark.parametrize("route,wtype,v", [
    ("mma", "float32", 500), ("mma", "bfloat16", 640), ("fma", "float32", 500),
])
def test_lm_loss_bf16_backward_softmax_term_alone(cuda, route, wtype, v):
    """Every label -100: dh and dW are the softmax term alone, so max|ref|
    scales with it and the tolerances see it whole. The tensor-core kernels
    and the FMA kernel at the same bf16 h (its predecessor) against the
    plain version."""
    h, w, labels, g = _lm_inputs(cuda, 1024, v, 768, getattr(torch, wtype), seed=18)
    labels.fill_(-100)
    _, lse = lm.lm_loss_fwd(h, w, labels)
    dh = lm._bwd_launch(h, w, labels, lse, g, False, route=route)
    dw = lm._bwd_launch(h, w, labels, lse, g, True, route=route)
    pdh, pdw = lm.lm_loss_bwd_plain(h, w, labels, lse, g)
    assert pdh.abs().max().item() > 0 and pdw.abs().max().item() > 0
    assert _err(dh, pdh) <= _grad_tol(dh, pdh, h.dtype)
    assert _err(dw, pdw) <= _grad_tol(dw, pdw, h.dtype)


@pytest.mark.parametrize("wtype,n,v,hdim,labels", [
    ("float32", 1024, 500, 128, "random"),      # ragged vocab, f32 master W
    ("bfloat16", 1024, 640, 256, "random"),
    ("float32", 1000, 50257, 768, "minus100"),  # ragged rows, GPT-2's vocab
    ("bfloat16", 2048, 50304, 768, "random"),
    ("float32", 1024, 384, 1280, "all_minus100"),
    ("bfloat16", 1024, 257, 1536, "minus100"),  # one column past a tile
])
def test_lm_loss_mma_forward_and_its_predecessor_match_plain(cuda, wtype, n, v, hdim,
                                                            labels):
    """bf16 h: the tensor-core forward (the default route) and the FMA
    forward (route="fma") against the plain version, loss and lse at 1e-4 x
    max(1, max|ref|), each launched once on its route; a label of -100
    picks nothing."""
    h, w, lab, _ = _lm_inputs(cuda, n, v, hdim, getattr(torch, wtype), seed=21)
    if labels == "minus100":
        lab[::7] = -100
    elif labels == "all_minus100":
        lab.fill_(-100)
    ploss, plse = lm.lm_loss_fwd_plain(h, w, lab)
    for route in ("mma", "fma"):
        before = {r: dict(c) for r, c in lm.launches_by_route.items()}
        loss, lse = lm.lm_loss_fwd(h, w, lab, route=None if route == "mma" else "fma")
        torch.cuda.synchronize()
        assert {r: lm.launches_by_route[r]["fwd"] - before[r]["fwd"] for r in before} == {
            "mma": int(route == "mma"), "tf32x3": 0, "fma": int(route == "fma")}
        assert _err(lse, plse) <= _f32_tol(plse), route
        assert _err(loss, ploss) <= _f32_tol(ploss), route
        ignored = lab == -100
        assert torch.equal(loss[ignored], lse[ignored])


@pytest.mark.parametrize("wtype,n,v,hdim,labels", [
    ("float32", 1024, 500, 128, "random"),      # ragged vocab tile
    ("bfloat16", 1024, 640, 256, "minus100"),   # bf16 W cast to f32 in the call
    ("float32", 1000, 50257, 768, "minus100"),  # ragged rows, GPT-2's vocab
    ("float32", 2048, 50304, 768, "random"),
    ("float32", 1024, 384, 1024, "all_minus100"),  # gpt_345m's hidden
    ("bfloat16", 1024, 257, 1536, "minus100"),  # one column past a tile
])
def test_lm_loss_tf32x3_forward_and_its_predecessor_match_plain(cuda, wtype, n, v, hdim,
                                                               labels):
    """f32 h: the 3xTF32 forward (the default route, at every hidden: it
    streams the hidden dim) and the FMA forward (route="fma", its
    predecessor) against the plain f32 version, loss and lse at 1e-4, each
    launched once on its route; a label of -100 picks nothing; two calls
    give the same bits."""
    rng = np.random.RandomState(32)
    h = torch.from_numpy(rng.randn(n, hdim).astype(np.float32)).to(cuda)
    w = torch.from_numpy(rng.randn(v, hdim).astype(np.float32) * 0.05).to(cuda,
                                                                         getattr(torch, wtype))
    lab = torch.from_numpy(rng.randint(0, v, (n,)).astype(np.int32)).to(cuda)
    if labels == "minus100":
        lab[::7] = -100
    elif labels == "all_minus100":
        lab.fill_(-100)
    assert lm.forward_route(torch.float32) == "tf32x3"
    ploss, plse = lm.lm_loss_fwd_plain(h, w, lab)
    for route in ("tf32x3", "fma"):
        before = {r: dict(c) for r, c in lm.launches_by_route.items()}
        loss, lse = lm.lm_loss_fwd(h, w, lab, route=None if route == "tf32x3" else "fma")
        torch.cuda.synchronize()
        assert {r: lm.launches_by_route[r]["fwd"] - before[r]["fwd"] for r in before} == {
            r: int(r == route) for r in before}
        assert _err(lse, plse) <= 1e-4 and _err(loss, ploss) <= 1e-4, route
        ignored = lab == -100
        assert torch.equal(loss[ignored], lse[ignored])
    again = lm.lm_loss_fwd(h, w, lab)
    first = lm.lm_loss_fwd(h, w, lab)
    assert torch.equal(again[0], first[0]) and torch.equal(again[1], first[1])


def test_lm_loss_tf32x3_forward_reads_views_and_refuses_other_dtypes(cuda):
    """The 3xTF32 forward takes any h and W: a strided or 4-byte-shifted view
    is made contiguous and aligned first (the loss is the same bits as a
    fresh copy's); its C entry refuses unaligned operands
    (cudaErrorInvalidValue, 1) rather than reading them."""
    rng = np.random.RandomState(33)
    big = torch.from_numpy(rng.randn(1024, 2 * 256).astype(np.float32)).to(cuda)
    h = big[:, ::2]                                  # strided columns
    flat = torch.from_numpy(rng.randn(300 * 256 + 1).astype(np.float32) * 0.05).to(cuda)
    w = flat[1:].view(300, 256)                      # 4 bytes off a 16-byte boundary
    lab = torch.from_numpy(rng.randint(0, 300, (1024,)).astype(np.int32)).to(cuda)
    got = lm.lm_loss_fwd(h, w, lab)
    want = lm.lm_loss_fwd(h.contiguous(), w.clone(), lab)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    fn = lm._kernel("lm_loss_fwd_tf32")
    splits = lm._kernel("lm_loss_fwd_mma_splits")(1024, 300)
    part = torch.empty((3, splits, 1024), device=cuda)
    out = torch.empty(1024, device=cuda)
    hc = h.contiguous()
    err = fn(hc.data_ptr(), w.data_ptr(), lab.data_ptr(), out.data_ptr(), out.data_ptr(),
             part.data_ptr(), 1024, 300, 256, 300, splits,
             torch.cuda.current_stream().cuda_stream)
    assert err == 1


def test_lm_loss_forward_routes_and_determinism(cuda):
    """bf16 h launches the bf16 tensor-core forward, f32 h the 3xTF32 one,
    directly and under autograd; two calls give the same bits; the stripped
    variants are bf16 tensor-core instances only; each tensor-core route
    refuses the other dtype of h."""
    h, w, lab, _ = _lm_inputs(cuda, 2048, 1000, 768, torch.float32, seed=22)
    for hh, route in ((h, "mma"), (h.float(), "tf32x3")):
        before = {r: c["fwd"] for r, c in lm.launches_by_route.items()}
        first = lm.lm_loss_fwd(hh, w, lab)
        second = lm.lm_head_cross_entropy(hh.detach().requires_grad_(), w, lab)
        assert {r: c["fwd"] - before[r] for r, c in lm.launches_by_route.items()} == {
            r: 2 * (r == route) for r in before}
        assert torch.equal(first[0], second)
    with pytest.raises(ValueError):
        lm.lm_loss_fwd(h.float(), w, lab, variant="bare")
    with pytest.raises(ValueError):
        lm.lm_loss_fwd(h.float(), w, lab, route="mma")
    with pytest.raises(ValueError):
        lm.lm_loss_fwd(h, w, lab, route="tf32x3")


def test_lm_loss_mma_backward_is_deterministic(cuda):
    """No atomics and a fixed summation order: two calls on the same inputs
    give the same bits, for dh and for dW, at bf16 h (the bf16 tensor cores)
    and at f32 h (3xTF32)."""
    h, w, labels, g = _lm_inputs(cuda, 2048, 1000, 768, torch.float32, seed=16)
    for hh in (h, h.float()):
        _, lse = lm.lm_loss_fwd(hh, w, labels)
        first = (lm.lm_loss_dh(hh, w, labels, lse, g), lm.lm_loss_dw(hh, w, labels, lse, g))
        second = (lm.lm_loss_dh(hh, w, labels, lse, g), lm.lm_loss_dw(hh, w, labels, lse, g))
        for a, b in zip(first, second):
            assert torch.equal(a, b)


def test_lm_loss_backward_routes(cuda):
    """bf16 h launches the bf16 tensor-core kernels and f32 h the 3xTF32
    ones, past the one-CTA tiles in a cluster (f32 H = 1280, bf16 H = 2048),
    and the FMA ones past the cluster limit (H = 6272), through the direct
    calls and through autograd; the private route="fma" reaches the FMA
    kernel at bf16 and f32 h (for timing it) and gives the same result
    within the tolerances of the plain version; the tensor-core routes
    refuse the other dtype of h."""
    h, w, labels, g = _lm_inputs(cuda, 1024, 640, 256, torch.float32, seed=17)
    _, lse = lm.lm_loss_fwd(h, w, labels)
    routes = ("mma", "tf32x3", "fma")

    def counts():
        return {r: dict(c) for r, c in lm.launches_by_route.items()}

    def delta(before):
        return {r: {k: lm.launches_by_route[r][k] - before[r][k] for k in ("dh", "dw")}
                for r in routes}

    def only(route):
        return {r: {"dh": int(r == route), "dw": int(r == route)} for r in routes}

    h1280 = torch.randn(1024, 1280, device=cuda)
    w1280 = torch.randn(300, 1280, device=cuda) * 0.05
    h2048 = torch.randn(1024, 2048, device=cuda, dtype=torch.bfloat16)
    w2048 = torch.randn(300, 2048, device=cuda) * 0.05
    h6272 = torch.randn(1024, 6272, device=cuda)
    w6272 = torch.randn(300, 6272, device=cuda) * 0.02
    for hh, ww, route in ((h, w, "mma"), (h.float(), w, "tf32x3"),
                          (h1280, w1280, "tf32x3"), (h2048, w2048, "mma"),
                          (h6272, w6272, "fma")):
        _, lse_r = lm.lm_loss_fwd(hh, ww, labels % ww.shape[0])
        before = counts()
        lm.lm_loss_dh(hh, ww, labels % ww.shape[0], lse_r, g)
        lm.lm_loss_dw(hh, ww, labels % ww.shape[0], lse_r, g)
        assert delta(before) == only(route)
        before = counts()
        ha, wa = hh.detach().requires_grad_(), ww.detach().requires_grad_()
        lm.lm_head_cross_entropy(ha, wa, labels % ww.shape[0]).sum().backward()
        assert delta(before) == only(route)
    for hh in (h, h.float()):
        _, lse_h = lm.lm_loss_fwd(hh, w, labels)
        before = counts()
        dh_fma = lm._bwd_launch(hh, w, labels, lse_h, g, False, route="fma")
        dw_fma = lm._bwd_launch(hh, w, labels, lse_h, g, True, route="fma")
        assert delta(before) == only("fma")
        dh, dw = lm.lm_loss_dh(hh, w, labels, lse_h, g), lm.lm_loss_dw(hh, w, labels, lse_h, g)
        assert _err(dh, dh_fma) <= _grad_tol(dh, dh_fma, hh.dtype)
        assert _err(dw, dw_fma) <= _grad_tol(dw, dw_fma, hh.dtype)
    with pytest.raises(ValueError):
        lm._bwd_launch(h, w, labels, lse, g, False, route="tf32x3")
    with pytest.raises(ValueError):
        lm._bwd_launch(h.float(), w, labels, lse, g, False, route="mma")


def test_lm_loss_bwd_mma_refuses_plans_without_an_instance(cuda):
    """The C entry of the tensor-core backward returns cudaErrorInvalidValue
    (1) for a plan without an instance (f32 single-buffered: the 3xTF32
    kernel always double-buffers; bf16 HC 4 single-buffered; a bf16 cluster
    at HC 4; an f32 cluster at HC 4 in order), an output dtype dh cannot
    have, or a cluster it cannot take (9 CTAs; slices of 768 that do not
    split H = 768 in two), and launches nothing."""
    h, w, labels, g = _lm_inputs(cuda, 1024, 640, 768, torch.float32, seed=19)
    lse = torch.zeros(1024, device=cuda)
    fn = lm._kernel("lm_loss_bwd_mma")
    stream = torch.cuda.current_stream().cuda_stream
    for hh, itype, otype, dw, hc, stages, cluster in ((h.float(), 0, 0, 0, 6, 1, 1),
                                                      (h, 1, 1, 0, 4, 1, 1),
                                                      (h.float(), 0, 1, 0, 6, 2, 1),
                                                      (h, 1, 1, 0, 4, 2, 2),
                                                      (h.float(), 0, 0, 0, 4, 3, 9),
                                                      (h.float(), 0, 0, 0, 6, 2, 2),
                                                      (h.float(), 0, 0, 0, 4, 2, 2)):
        ww = w.to(hh.dtype)
        out = torch.empty(hh.shape, dtype=hh.dtype, device=cuda)
        err = fn(hh.data_ptr(), ww.data_ptr(), labels.data_ptr(), lse.data_ptr(),
                 g.data_ptr(), out.data_ptr(), itype, otype, 1024, 640, 768, dw, hc * 128, hc,
                 stages, cluster, stream)
        assert err == 1, (itype, otype, hc, stages, cluster)


def test_lm_loss_refused_cluster_launch_raises_and_counts_nothing(cuda, monkeypatch):
    """No fallback: where the C entry refuses a cluster plan (here one of 9
    CTAs, past the portable 8), the backward raises and no route's launch
    count moves."""
    h, w, labels, g = _lm_inputs(cuda, 1024, 640, 1024, torch.float32, seed=20)
    hh = h.float()
    _, lse = lm.lm_loss_fwd(hh, w, labels)
    monkeypatch.setattr(lm, "backward_plan",
                        lambda dtype, hidden: lm.BackwardPlan("tf32x3", 128, 4, 3, 9))
    before = {r: dict(c) for r, c in lm.launches_by_route.items()}
    with pytest.raises(RuntimeError):
        lm.lm_loss_dh(hh, w, labels, lse, g)
    assert lm.launches_by_route == before


@pytest.mark.parametrize("hdim", [1664, 2048])
def test_lm_loss_cluster_backward_softmax_term_alone(cuda, hdim):
    """bf16 h past H = 1536 (a cluster of 3) with every label -100: dh and
    dW are the softmax term alone; ragged rows and vocab; against the plain
    version at the bf16 limits (dW f32 at DW_F32_TOL's 1e-3 x max|ref|)."""
    h, w, labels, g = _lm_inputs(cuda, 1000, 500, hdim, torch.float32, seed=26)
    labels.fill_(-100)
    assert lm.backward_plan(h.dtype, hdim).cluster == 3
    _, lse = lm.lm_loss_fwd(h, w, labels)
    dh, dw = lm.lm_loss_dh(h, w, labels, lse, g), lm.lm_loss_dw(h, w, labels, lse, g)
    pdh, pdw = lm.lm_loss_bwd_plain(h, w, labels, lse, g)
    assert pdh.abs().max().item() > 0 and pdw.abs().max().item() > 0
    assert _err(dh, pdh) <= _grad_tol(dh, pdh, h.dtype)
    assert _err(dw, pdw) <= _grad_tol(dw, pdw, h.dtype)


@pytest.mark.parametrize("htype,hdim", [("float32", 1024), ("float32", 2048),
                                        ("bfloat16", 2048)])
def test_lm_loss_cluster_backward_is_deterministic(cuda, htype, hdim):
    """The cluster route sums the CTAs' partial S in rank order, with no
    atomics: two calls on the same inputs give the same bits, dh and dW."""
    h, w, labels, g = _lm_inputs(cuda, 1000, 700, hdim, torch.float32, seed=27)
    hh = h.to(getattr(torch, htype))
    assert lm.backward_plan(hh.dtype, hdim).cluster > 1
    _, lse = lm.lm_loss_fwd(hh, w, labels)
    first = (lm.lm_loss_dh(hh, w, labels, lse, g), lm.lm_loss_dw(hh, w, labels, lse, g))
    second = (lm.lm_loss_dh(hh, w, labels, lse, g), lm.lm_loss_dw(hh, w, labels, lse, g))
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def _cuobjdump():
    """cuobjdump from CUDA's bin/, else from Triton's package, else None."""
    import importlib.util
    import os

    from paddle_tpu_torch.ops.kernels import _build

    try:
        dirs = [os.path.dirname(_build.nvcc_path())]
    except RuntimeError:
        dirs = []
    spec = importlib.util.find_spec("triton")
    if spec is not None and spec.origin:
        dirs.append(os.path.join(os.path.dirname(spec.origin), "backends", "nvidia", "bin"))
    for d in dirs:
        path = os.path.join(d, "cuobjdump")
        if os.path.isfile(path):
            return path
    return None


def test_lm_loss_mma_kernels_use_tensor_cores_without_spills(cuda):
    """The built lm_loss library's tensor-core backward kernels (every
    instance: 15 of lm_grad_mma_kernel, bf16, 3 of them the cluster route's,
    pipelined; 15 of lm_grad_tf32_kernel, f32, 6 of them the cluster
    route's, 3 pipelined and 3 in order)
    hold HMMA instructions in their SASS, TF32 HMMA (HMMA.1688.F32.TF32) in
    the f32 ones only, and ptxas reports 0 spill bytes and at most 255
    registers for each."""
    import subprocess

    from paddle_tpu_torch.ops.kernels import _build

    _build.load("lm_loss")
    report = {k: r for k, r in _build.ptxas_report("lm_loss").items()
              if "lm_grad_mma_kernel" in k or "lm_grad_tf32_kernel" in k}
    assert len(report) == 30, sorted(report)
    assert sum("lm_grad_tf32_kernel" in k for k in report) == 15, sorted(report)
    for name, r in report.items():
        assert r.get("spill_stores") == 0 and r.get("spill_loads") == 0, (name, r)
        assert r.get("registers", 256) <= 255, (name, r)
    tool = _cuobjdump()
    if tool is None:
        pytest.skip("no cuobjdump under CUDA's bin/ or triton/backends/nvidia/bin/")
    sass = subprocess.run([tool, "-sass", str(_build.library_path("lm_loss"))],
                          capture_output=True, text=True, check=True).stdout
    funcs = {}
    for part in sass.split("Function : ")[1:]:
        name = part.split(None, 1)[0]
        funcs[name] = part
    mma = {k: body for k, body in funcs.items()
           if "lm_grad_mma_kernel" in k or "lm_grad_tf32_kernel" in k}
    assert len(mma) == 30, sorted(funcs)
    for name, body in mma.items():
        assert "HMMA" in body, name
        assert ("HMMA.1688.F32.TF32" in body) == ("lm_grad_tf32_kernel" in name), name
    fma = [body for k, body in funcs.items() if "lm_grad_kernel" in k]
    assert fma and not any("HMMA" in body for body in fma)


def test_layer_norm_bf16_kernels_move_16_bytes_an_access_without_spills(cuda):
    """Every bf16 instance of the LayerNorm kernels (20 of ln_fwd_kernel,
    training and inference, and 10 of ln_bwd_kernel) holds 128-bit global
    loads and stores in its SASS (LDG.E[.qualifiers].128, STG.E.128) and no
    64-bit ones (the 8-byte bf16 accesses of the kernels before), and
    ptxas reports 0 spill bytes for each."""
    import re
    import subprocess

    from paddle_tpu_torch.ops.kernels import _build

    _build.load("layer_norm")
    bf16 = {k: r for k, r in _build.ptxas_report("layer_norm").items()
            if "__nv_bfloat16" in k and ("ln_fwd_kernel" in k or "ln_bwd_kernel" in k)}
    assert len(bf16) == 30, sorted(bf16)
    for name, r in bf16.items():
        assert r.get("spill_stores") == 0 and r.get("spill_loads") == 0, (name, r)
    tool = _cuobjdump()
    if tool is None:
        pytest.skip("no cuobjdump under CUDA's bin/ or triton/backends/nvidia/bin/")
    sass = subprocess.run([tool, "-sass", str(_build.library_path("layer_norm"))],
                          capture_output=True, text=True, check=True).stdout
    funcs = {part.split(None, 1)[0]: part for part in sass.split("Function : ")[1:]}
    bodies = {k: body for k, body in funcs.items() if k in bf16}
    assert len(bodies) == 30, sorted(funcs)
    for name, body in bodies.items():
        assert re.search(r"LDG\.E(\.\w+)*\.128", body), name
        assert re.search(r"STG\.E(\.\w+)*\.128", body), name
        assert not re.search(r"(LDG|STG)\.E(\.\w+)*\.64\b", body), name


def test_forward_mma_kernels_use_tensor_cores_without_spills(cuda):
    """The tensor-core kernels of flash attention and the LM-loss forward,
    flash_fwd_mma_kernel, flash_bwd_dkdv_mma_kernel and
    flash_bwd_dq_mma_kernel (d 32, 64, 128 each) and lm_fwd_mma_* (full,
    bare, picked), and the 3xTF32 forwards flash_fwd_tf32_kernel (d 32, 64,
    128) and lm_fwd_tf32_full, hold HMMA instructions in their SASS (the
    3xTF32 ones TF32 HMMA, HMMA.1688.F32.TF32, the bf16 ones none), and
    ptxas reports 0 spill bytes and at most 255 registers for each; the FMA
    kernels beside them hold none."""
    import re
    import subprocess

    from paddle_tpu_torch.ops.kernels import _build

    tool = _cuobjdump()
    for lib, new, old, count in (("flash_attention_fwd", "flash_fwd_(mma|tf32)_kernel",
                                  "flash_fwd_kernel", 6),
                                 ("flash_attention_bwd", "flash_bwd_(dkdv|dq)_mma_kernel",
                                  "flash_bwd_(dkdv|dq)_kernel", 6),
                                 ("lm_loss", "lm_fwd_(mma_|tf32_full)", "lm_fwd_full_", 4)):
        _build.load(lib)
        report = {k: r for k, r in _build.ptxas_report(lib).items() if re.search(new, k)}
        assert len(report) == count, sorted(report)
        for name, r in report.items():
            assert r.get("spill_stores") == 0 and r.get("spill_loads") == 0, (name, r)
            assert r.get("registers", 256) <= 255, (name, r)
        if tool is None:
            continue
        sass = subprocess.run([tool, "-sass", str(_build.library_path(lib))],
                              capture_output=True, text=True, check=True).stdout
        funcs = {part.split(None, 1)[0]: part for part in sass.split("Function : ")[1:]}
        mma = {k: body for k, body in funcs.items() if re.search(new, k)}
        assert len(mma) == count and all("HMMA" in body for body in mma.values()), sorted(funcs)
        for k, body in mma.items():
            assert ("HMMA.1688.F32.TF32" in body) == ("tf32" in k), k
        fma = [body for k, body in funcs.items() if re.search(old, k)]
        assert fma and not any("HMMA" in body for body in fma)
    if tool is None:
        pytest.skip("no cuobjdump under CUDA's bin/ or triton/backends/nvidia/bin/")


def test_flash_bwd_tf32_kernels_use_tf32_tensor_cores_without_spills(cuda):
    """flash_bwd_dkdv_tf32_kernel and flash_bwd_dq_tf32_kernel, every
    instance (d 32, 64, 128), hold TF32 HMMA (HMMA.1688.F32.TF32) in their
    SASS, and ptxas reports 0 spill bytes and at most 255 registers for
    each; the bf16 pair holds no TF32 HMMA."""
    import re
    import subprocess

    from paddle_tpu_torch.ops.kernels import _build

    pat = "flash_bwd_(dkdv|dq)_tf32_kernel"
    _build.load("flash_attention_bwd")
    report = {k: r for k, r in _build.ptxas_report("flash_attention_bwd").items()
              if re.search(pat, k)}
    assert len(report) == 2 * len(fa.HEAD_DIMS), sorted(report)
    for name, r in report.items():
        assert r.get("spill_stores") == 0 and r.get("spill_loads") == 0, (name, r)
        assert r.get("registers", 256) <= 255, (name, r)
    tool = _cuobjdump()
    if tool is None:
        pytest.skip("no cuobjdump under CUDA's bin/ or triton/backends/nvidia/bin/")
    sass = subprocess.run([tool, "-sass", str(_build.library_path("flash_attention_bwd"))],
                          capture_output=True, text=True, check=True).stdout
    funcs = {part.split(None, 1)[0]: part for part in sass.split("Function : ")[1:]}
    tf32 = [body for k, body in funcs.items() if re.search(pat, k)]
    assert len(tf32) == len(report) and all("HMMA.1688.F32.TF32" in b for b in tf32)
    bf16 = [body for k, body in funcs.items() if re.search("flash_bwd_(dkdv|dq)_mma_kernel", k)]
    assert bf16 and not any("TF32" in b for b in bf16)


def test_lm_loss_autograd_goes_through_the_kernels(cuda):
    """lm_head_cross_entropy under autograd: forward, dh and dW launch once
    each, every valid block_n gives the same bits, and the gradients match
    the same Function on the CPU."""
    rng = np.random.RandomState(13)
    h_np = rng.randn(1024, 256).astype(np.float32)
    w_np = (rng.randn(700, 256) * 0.05).astype(np.float32)
    lab = torch.from_numpy(rng.randint(0, 700, (1024,)))
    out = []
    for dev in ("cuda", "cpu"):
        h, w = (torch.from_numpy(a).to(dev).requires_grad_() for a in (h_np, w_np))
        before = (lm.launches_fwd, lm.launches_dh, lm.launches_dw)
        loss = lm.lm_head_cross_entropy(h, w, lab.to(dev))
        loss.mean().backward()
        after = (lm.launches_fwd, lm.launches_dh, lm.launches_dw)
        assert [a - c for a, c in zip(after, before)] == ([1, 1, 1] if dev == "cuda"
                                                         else [0, 0, 0])
        if dev == "cuda":
            with torch.no_grad():
                for bn in (512, 1024):
                    assert torch.equal(lm.lm_head_cross_entropy(h, w, lab.to(dev), bn),
                                       loss)
        out.append([t.detach().cpu() for t in (loss, h.grad, w.grad)])
    for got, want in zip(*out):
        assert (got - want).abs().max().item() <= 1e-4 * max(1.0, want.abs().max().item())


def test_library_kernels_reject_what_they_do_not_take(cuda):
    x = torch.randn(4, 100, device=cuda)
    with pytest.raises(ValueError):
        ln.layer_norm(x, torch.ones(100, device=cuda), torch.zeros(100, device=cuda))
    x16 = torch.randn(4, 128, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        ln.layer_norm(x16, torch.ones(128, device=cuda), torch.zeros(128, device=cuda))
    h = torch.randn(1024, 100, device=cuda)
    with pytest.raises(ValueError):
        lm.lm_head_cross_entropy(h, torch.randn(256, 100, device=cuda),
                                 torch.zeros(1024, dtype=torch.long, device=cuda))


def _recompute_step(cuda, granularity, ids, labels):
    """One bf16-autocast forward and backward of gpt_tiny on the card (seed 6)
    with ``granularity`` recompute (None: without it); returns the launches
    by route and the gradients."""
    cfg = gpt_tiny(use_recompute=granularity is not None,
                   recompute_granularity=granularity or "full")
    model = GPTForPretraining(cfg, seed=6)
    before = (dict(fa.launches_by_route),
              {r: dict(c) for r, c in fa.launches_bwd_by_route.items()})
    with auto_cast(dtype="bfloat16"):
        loss = model(torch.from_numpy(ids).to(cuda), torch.from_numpy(labels).to(cuda))
    loss.backward()          # outside the block: the replay re-enters its context
    torch.cuda.synchronize()
    fwd = {r: n - before[0][r] for r, n in fa.launches_by_route.items()}
    bwd = {r: {k: n - before[1][r][k] for k, n in c.items()}
           for r, c in fa.launches_bwd_by_route.items()}
    return fwd, bwd, {n: p.grad.float().cpu() for n, p in model.named_parameters()}


@pytest.mark.parametrize("granularity", ["full", "selective"])
def test_recompute_replays_the_flash_forward_and_keeps_the_bf16_gradients(cuda,
                                                                          granularity):
    """Under recompute every layer's flash forward launches twice (the
    forward and its replay), the backward pair once; the gradients equal
    the step's without recompute within the bf16 limit, 2e-2 x max|ref|
    (the replay recomputes the same products on the same inputs)."""
    rng = np.random.RandomState(11)
    ids = rng.randint(0, 1024, (2, 128)).astype(np.int64)
    labels = np.roll(ids, -1, 1)
    n = gpt_tiny().num_layers
    fwd0, bwd0, want = _recompute_step(cuda, None, ids, labels)
    fwd1, bwd1, got = _recompute_step(cuda, granularity, ids, labels)
    none = {"dkdv": 0, "dq": 0}
    assert fwd0 == {"mma": n, "tf32x3": 0, "fma": 0}
    assert fwd1 == {"mma": 2 * n, "tf32x3": 0, "fma": 0}
    assert bwd0 == bwd1 == {"mma": {"dkdv": n, "dq": n}, "tf32x3": none, "fma": none}
    for name, ref in want.items():
        assert (got[name] - ref).abs().max().item() <= 2e-2 * ref.abs().max().item(), name


def test_two_microbatches_match_the_plain_step_on_the_card(cuda):
    """An f32 step of gpt_tiny with 2 microbatches of [2, 128] against the
    plain step on the [4, 128] batch (every position labelled, so the mean
    of the two means is the batch's mean): loss rtol 1e-5, gradients 1e-4 x
    max(1, max|g|), 2 x 12 launches of each kernel against 12."""
    rng = np.random.RandomState(12)
    ids = rng.randint(0, 1024, (4, 128)).astype(np.int64)
    labels = np.roll(ids, -1, 1)
    out = []
    for k in (1, 2):
        model = GPTForPretraining(gpt_tiny(), seed=7)
        eng = TrainStepEngine(model, AdamW(learning_rate=1e-3,
                                           parameters=model.named_parameters()),
                              microbatches=k)
        counts = _launch_counts()
        loss = eng.step(ids, labels).item()
        torch.cuda.synchronize()
        out.append((loss, [a - b for a, b in zip(_launch_counts(), counts)],
                    {n: p.grad.cpu() for n, p in model.named_parameters()}))
    n = gpt_tiny().num_layers
    assert out[0][1] == [n] * 3 and out[1][1] == [2 * n] * 3
    assert out[1][0] == pytest.approx(out[0][0], rel=1e-5)
    for name, ref in out[0][2].items():
        tol = 1e-4 * max(1.0, ref.abs().max().item())
        assert (out[1][2][name] - ref).abs().max().item() <= tol, name


def _dp_ranks(world, out_dir):
    """tests/torch_dp_workers.py's cuda_dp_case in ``world`` ranks on NCCL
    (one card each; NCCL refuses two ranks on one card)."""
    import torch_dp_workers as W
    from paddle_tpu_torch.distributed import spawn

    if torch.cuda.device_count() < world:
        pytest.skip(f"needs {world} cards")
    spawn(W.cuda_dp_case, args=(str(out_dir),), nprocs=world, timeout=300)
    return [torch.load(out_dir / f"rank{r}.pt", weights_only=False) for r in range(world)]


def _same_run(a, b):
    return a["losses"] == b["losses"] and all(
        torch.equal(a["params"][n], p) for n, p in b["params"].items())


def _check_low_precision(res):
    for name in ("bf16", "bf16_ef", "int8", "int8_ef"):
        ls = res[name]["losses"]
        assert ls[-1] < ls[0], name
        np.testing.assert_allclose(ls, res["f32"]["losses"], rtol=2e-2, err_msg=name)


def test_dp_one_rank_on_nccl_is_the_single_gpu_engine_bit_for_bit(cuda, tmp_path):
    (res,) = _dp_ranks(1, tmp_path)
    assert _same_run(res["f32"], res["plain"])
    assert _same_run(res["zero"], res["f32"])
    _check_low_precision(res)


def test_dp_two_ranks_on_nccl(cuda, tmp_path):
    """At 2 ranks a + b is one sum in any order: ZeRO is the replicated
    step bit for bit; every rank ends with the same weights."""
    ranks = _dp_ranks(2, tmp_path)
    for res in ranks:
        assert _same_run(res["zero"], res["f32"])
        _check_low_precision(res)
    for name in ranks[0]:
        assert _same_run(ranks[1][name], ranks[0][name]), name


def test_dp_four_ranks_on_nccl(cuda, tmp_path):
    """Past 2 ranks NCCL may sum the all_reduce and the reduce_scatter in
    other orders: ZeRO's losses within 1e-5 of the replicated ones."""
    ranks = _dp_ranks(4, tmp_path)
    for res in ranks:
        np.testing.assert_allclose(res["zero"]["losses"], res["f32"]["losses"], rtol=1e-5)
        _check_low_precision(res)
    for name in ranks[0]:
        assert ranks[1][name]["losses"] == ranks[0][name]["losses"], name


def _fsdp_ranks(world, out_dir):
    """tests/torch_fsdp_workers.py's cuda_fsdp_case in ``world`` ranks on
    NCCL (one card each)."""
    import torch_fsdp_workers as FW
    from paddle_tpu_torch.distributed import spawn

    if torch.cuda.device_count() < world:
        pytest.skip(f"needs {world} cards")
    spawn(FW.cuda_fsdp_case, args=(str(out_dir),), nprocs=world, timeout=300)
    return [torch.load(out_dir / f"rank{r}.pt", weights_only=False) for r in range(world)]


def _check_fsdp(res, bit_equal):
    for name in ("fsdp_pf0", "fsdp_pf2", "fsdp_bf16_ef", "fsdp_int8_ef", "fsdp_4"):
        assert res[name]["engaged"], name
    assert _same_run(res["fsdp_pf2"], res["fsdp_pf0"])   # every depth, the same bits
    if bit_equal:
        assert _same_run(res["fsdp_pf0"], res["f32"])
    else:
        np.testing.assert_allclose(res["fsdp_pf0"]["losses"], res["f32"]["losses"],
                                   rtol=1e-5)
    for name in ("fsdp_bf16_ef", "fsdp_int8_ef"):
        ls = res[name]["losses"]
        assert ls[-1] < ls[0], name
        np.testing.assert_allclose(ls, res["f32"]["losses"], rtol=2e-2, err_msg=name)
    # the checkpoint at step 2 resumes steps 3 and 4 of the uninterrupted run
    assert res["resumed_step"] == 2
    assert res["resumed"]["losses"] == res["fsdp_4"]["losses"][2:]
    assert all(torch.equal(res["resumed"]["params"][n], p)
               for n, p in res["fsdp_4"]["params"].items())


def test_fsdp_one_rank_on_nccl(cuda, tmp_path):
    (res,) = _fsdp_ranks(1, tmp_path)
    _check_fsdp(res, bit_equal=True)


def test_fsdp_two_ranks_on_nccl(cuda, tmp_path):
    ranks = _fsdp_ranks(2, tmp_path)
    for res in ranks:
        _check_fsdp(res, bit_equal=True)
    for name in ("f32", "fsdp_pf0", "fsdp_int8_ef", "resumed"):
        assert _same_run(ranks[1][name], ranks[0][name]), name


def test_fsdp_four_ranks_on_nccl(cuda, tmp_path):
    """Past 2 ranks the reduce-scatter sums each rank's loss column in an
    order of its own: the weights are every rank's the same, bit for bit,
    and the losses to rounding."""
    ranks = _fsdp_ranks(4, tmp_path)
    for res in ranks:
        _check_fsdp(res, bit_equal=False)
    for r in ranks[1:]:
        for name in ("fsdp_pf0", "resumed"):
            assert all(torch.equal(r[name]["params"][n], p)
                       for n, p in ranks[0][name]["params"].items()), name
            np.testing.assert_allclose(r[name]["losses"], ranks[0][name]["losses"],
                                       rtol=1e-6, err_msg=name)


def test_ckpt_on_card_resumes_bf16_training_bit_for_bit(cuda, tmp_path):
    """gpt_tiny under bf16 auto_cast on the card: an async save at step 2, a
    fresh engine restores and takes steps 3 and 4 with the uninterrupted
    run's losses and weights; a corrupted newest checkpoint falls back to
    the one before."""
    import warnings

    from paddle_tpu_torch.distributed import elastic

    ids = torch.randint(0, 1024, (4, 128), generator=torch.Generator().manual_seed(0))
    ids = ids.to(cuda)
    labels = torch.roll(ids, -1, 1)

    def engine():
        m = GPTForPretraining(gpt_tiny(), seed=3)
        return m, TrainStepEngine(m, AdamW(1e-3, parameters=m.named_parameters()))

    with auto_cast(dtype="bfloat16"):
        m0, e0 = engine()
        ref = [e0.step(ids, labels).item() for _ in range(4)]
        m1, e1 = engine()
        mgr = e1.enable_checkpointing(str(tmp_path), interval=1, keep=5, async_save=True)
        [e1.step(ids, labels) for _ in range(2)]
        e1.disable_checkpointing()
        m2, e2 = engine()
        assert elastic.restore_latest(e2, str(tmp_path)) == 2
        got = [e2.step(ids, labels).item() for _ in range(2)]
    assert got == ref[2:]
    for (n, p), q in zip(m0.named_parameters(), m2.parameters()):
        assert torch.equal(p, q), n
    steps = [s for s, _ in mgr.checkpoints()]
    assert steps == [1, 2]
    newest = mgr.checkpoints()[-1][1]
    payload = sorted(f for f in os.listdir(newest) if f.endswith(".npy"))[0]
    with open(os.path.join(newest, payload), "r+b") as f:
        f.seek(64)
        f.write(b"\xff\xff\xff\xff")
    _, e3 = engine()
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        assert elastic.restore_latest(e3, str(tmp_path)) == 1


# each new optimizer rule as chip_smoke.py's train_rules phase sets it (lr 1e-3
# but Adadelta's, whose step is lr x sqrt(eps) / sqrt(mean g^2) x g)
RULES_ON_CARD = {
    "Adamax": {},
    "Adagrad": {},
    "Adadelta": {"learning_rate": 0.5},
    "RMSProp": {"centered": True, "momentum": 0.9},
    "Lamb": {"exclude_from_weight_decay_fn": lambda n: ".ln" in n},
    "Lars": {"exclude_from_weight_decay": ["bias"]},
}


def _rule_step(device, rule, ids, labels):
    from paddle_tpu_torch import optimizer

    model = GPTForPretraining(gpt_tiny(), device=device, seed=6)
    opt = getattr(optimizer, rule)(parameters=model.named_parameters(),
                                   **{"learning_rate": 1e-3, **RULES_ON_CARD[rule]})
    counts = _launch_counts()
    loss = TrainStepEngine(model, opt).step(ids, labels).item()
    if device == "cuda":
        torch.cuda.synchronize()
    return {"loss": loss, "launched": [a - b for a, b in zip(_launch_counts(), counts)],
            "grads": {n: p.grad.cpu() for n, p in model.named_parameters()},
            "params": {n: p.detach().cpu() for n, p in model.named_parameters()},
            "states": {n: tuple(s.cpu() for s in st) for n, st in opt._states.items()},
            "lr": opt.get_lr()}


@pytest.mark.parametrize("rule", sorted(RULES_ON_CARD))
def test_each_new_rule_steps_gpt_tiny_on_card_as_on_cpu(cuda, rule):
    """One f32 TrainStepEngine step of gpt_tiny ([2, 128]) with ``rule`` on
    the card and on the CPU: the card's step goes through the three flash
    kernels; loss rtol 1e-5 and gradients 1e-4 x max(1, max|g|), as
    test_gpt_tiny_train_step_on_card_matches_cpu holds them. The card's new
    parameters and state against the CPU rule run on the card's own
    gradients from the same weights: 1e-6 x max(1, max|ref|) (the same f32
    elementwise arithmetic; Lamb's and Lars's norms sum in another order).
    Against the CPU's whole step, the parameters stay within 10 x lr of it
    and at most 0.1% of the entries more than 1e-5 apart: these rules
    divide by a root of the gradient's square (or by a norm), so an entry
    whose gradient is within rounding of 0 may take the other sign, and the
    largest first step of an entry is ~4.6 x lr (centered RMSProp at rho
    0.95: g / sqrt(0.0475 g^2))."""
    from paddle_tpu_torch import optimizer

    rng = np.random.RandomState(11)
    ids = rng.randint(0, 1024, (2, 128)).astype(np.int64)
    labels = np.roll(ids, -1, 1)
    card = _rule_step("cuda", rule, ids, labels)
    cpu = _rule_step("cpu", rule, ids, labels)
    n = gpt_tiny().num_layers
    assert card["launched"] == [n, n, n] and cpu["launched"] == [0, 0, 0]
    assert card["loss"] == pytest.approx(cpu["loss"], rel=1e-5)
    # the CPU rule on the card's gradients
    ref = GPTForPretraining(gpt_tiny(), device="cpu", seed=6)
    ref_opt = getattr(optimizer, rule)(parameters=ref.named_parameters(),
                                       **{"learning_rate": 1e-3, **RULES_ON_CARD[rule]})
    ref_opt._step_count = 1
    ref_opt._apply(dict(ref.named_parameters()), card["grads"], card["lr"], 1)
    apart = total = 0
    for name, g_cpu in cpu["grads"].items():
        tol = 1e-4 * max(1.0, g_cpu.abs().max().item())
        assert (card["grads"][name] - g_cpu).abs().max().item() <= tol, name
        want = dict(ref.named_parameters())[name].detach()
        got = card["params"][name]
        assert (got - want).abs().max().item() <= 1e-6 * max(1.0, want.abs().max().item())
        assert len(card["states"][name]) == len(ref_opt._states[name])
        for a, b in zip(card["states"][name], ref_opt._states[name]):
            assert a.dtype == torch.float32
            assert (a - b).abs().max().item() <= 1e-6 * max(1.0, b.abs().max().item()), name
        diff = (got - cpu["params"][name]).abs()
        assert diff.max().item() <= 10 * card["lr"], name
        apart += int((diff > 1e-5).sum())
        total += diff.numel()
    assert apart <= 1e-3 * total, (apart, total)


def test_grad_scaler_on_card_grads(cuda):
    """GradScaler on the card: a step with an inf gradient is skipped
    (parameters and state bit-unchanged, the scale halved, one host read of
    the flag); a good step equals the CPU's on the same unscaled gradients
    (1e-6 x max(1, max|p|))."""
    from paddle_tpu_torch.amp import GradScaler

    gen = torch.Generator().manual_seed(4)
    w0 = torch.randn(64, 32, generator=gen)
    grads = [torch.randn(64, 32, generator=gen) for _ in range(2)]
    runs = {}
    for device in ("cuda", "cpu"):
        w = w0.clone().to(device).requires_grad_()
        opt = AdamW(1e-2, parameters=[("w", w)])
        scaler = GradScaler(init_loss_scaling=2.0 ** 12)
        w.grad = grads[0].to(device) * scaler._scale
        w.grad[3, 4] = float("inf")
        before = w.detach().clone()
        scaler.step(opt)
        scaler.update()
        assert scaler._found_inf and torch.equal(w.detach(), before) and not opt._states
        assert scaler.get_loss_scaling().item() == 2.0 ** 11
        opt.clear_grad()
        loss = (w * grads[1].to(device)).sum()
        scaler.scale(loss).backward()
        assert w.grad.device.type == device
        scaler.step(opt)
        scaler.update()
        assert not scaler._found_inf
        runs[device] = w.detach().cpu()
    tol = 1e-6 * max(1.0, runs["cpu"].abs().max().item())
    assert (runs["cuda"] - runs["cpu"]).abs().max().item() <= tol


@pytest.mark.parametrize("rows", [8, 17, 1024])
def test_int8_projection_accumulator_on_card_is_the_cpus(cuda, rows):
    """A dynamic and a static int8 projection at GPT-2 124M's qkv shape
    ([rows, 768] x [768, 2304]; 8 rows is a decode step at 8 slots, below
    torch._int_mm's 17 on the card, so the rows are padded): the int8
    activations and the int32 accumulator bit for bit against the CPU's,
    and the f32 outputs within 1e-6 x max|ref|."""
    from paddle_tpu_torch.incubate import quantization as Q

    rng = np.random.RandomState(rows)
    x = torch.from_numpy(rng.randn(rows, 768).astype(np.float32))
    w = torch.from_numpy((rng.randn(2304, 768) * 0.02).astype(np.float32))
    b = torch.from_numpy((rng.randn(2304) * 0.1).astype(np.float32))
    q, s = Q.quantize_weight(w)
    qc, sc = Q.quantize_weight(w.cuda())
    assert torch.equal(qc.cpu(), q) and torch.equal(sc.cpu(), s)
    for quant in (Q._quantize_rows, lambda a: Q._quantize_static(a, torch.tensor(0.02))):
        x_q, _ = quant(x)
        x_qc, _ = quant(x.cuda())
        assert torch.equal(x_qc.cpu(), x_q)
        acc = Q._int8_mm(x_qc, qc)
        assert acc.dtype == torch.int32 and tuple(acc.shape) == (rows, 2304)
        assert torch.equal(acc.cpu(), Q._int8_mm(x_q, q))
    for fn, args in ((Q.dynamic_int8_matmul, ()), (Q.static_int8_matmul, (0.02,)),
                     (Q.weight_only_int8_matmul, ())):
        want = fn(x, q, s, *args, bias=b)
        got = fn(x.cuda(), qc, sc, *args, bias=b.cuda()).cpu()
        assert (got - want).abs().max().item() <= 1e-6 * want.abs().max().item(), fn


def test_prefetch_copies_on_a_side_stream_the_step_waits_for(cuda):
    """DevicePrefetcher on the card: host tensors (pageable and pinned) are
    copied on its side stream, a tensor already on the card passes through,
    and a batch read on the current stream right after it is handed out,
    with no synchronize, holds the host's values; the copied tensors are
    recorded on the current stream."""
    from paddle_tpu_torch.distributed.prefetcher import DevicePrefetcher

    rng = np.random.RandomState(3)
    host = [torch.from_numpy(rng.randint(0, 1 << 30, (8, 1 << 20)).astype(np.int64))
            for _ in range(3)]
    on_card = torch.arange(5, device="cuda")
    batches = [(host[0], on_card), (host[1].pin_memory(), on_card), (host[2], on_card)]
    pf = DevicePrefetcher("cuda", depth=2)
    got, depths = [], []
    for placed in pf.iterate(batches):
        assert placed[0].is_cuda and placed[1] is on_card
        got.append(placed[0] * 1)          # read on the current stream at once
        depths.append(pf.last_depth)
    assert pf._stream is not None and pf._stream != torch.cuda.current_stream()
    assert (pf.puts, pf.skipped_puts, pf.batches) == (3, 3, 3) and depths == [2, 2, 1]
    for g, h in zip(got, host):
        assert torch.equal(g.cpu(), h)


def test_observability_on_leaves_the_card_step_bit_equal(cuda, tmp_path):
    """gpt_tiny under bf16 O1 on the card: 3 steps with telemetry, the
    health monitor at interval 1, the flight recorder, the metrics registry
    and the tracer on give the losses and parameters of 3 steps with all of
    them off, bit for bit; the health record's grad norms are the gradients'
    (rtol 1e-4); the records carry the card's memory; run_steps and 3
    prefetched steps give the losses of step() on the same batches."""
    from paddle_tpu_torch.observability import flight_recorder, health, metrics, tracer

    rng = np.random.RandomState(13)
    batches = [(lambda ids: (ids, np.roll(ids, -1, 1)))(
        rng.randint(0, 1024, (4, 128)).astype(np.int64)) for _ in range(3)]
    models, losses = [], []
    try:
        for on in (False, True):
            model = GPTForPretraining(gpt_tiny(), seed=7)
            eng = TrainStepEngine(model, AdamW(learning_rate=1e-3,
                                               parameters=model.named_parameters()))
            if on:
                tele = eng.enable_telemetry()
                mon = eng.enable_health(interval=1)
                flight_recorder.enable(str(tmp_path))
                metrics.enable()
                tracer.get_tracer().enable()
            with auto_cast(dtype="bfloat16"):
                losses.append([eng.step(*b).item() for b in batches])
            models.append(model)
        rec = mon.recent()[-1]
        for n, p in models[1].named_parameters():
            want = p.grad.double().norm().item()
            assert rec["per_param"][n]["grad_norm"] == pytest.approx(want, rel=1e-4), n
        mem = tele.sink.records[-1]["device_memory"]
        assert 0 < mem["bytes_in_use"] <= mem["peak_bytes_in_use"] <= mem["bytes_limit"]
    finally:
        flight_recorder.disable()
        metrics.disable()
        tracer.get_tracer().disable()
        health.reset()
    assert losses[0] == losses[1]
    for (n, p), (_, q) in zip(models[0].named_parameters(), models[1].named_parameters()):
        assert torch.equal(p, q), n
    out = []
    for mode in ("step", "run_steps", "prefetch"):
        model = GPTForPretraining(gpt_tiny(), seed=7)
        eng = TrainStepEngine(model, AdamW(learning_rate=1e-3,
                                           parameters=model.named_parameters()))
        with auto_cast(dtype="bfloat16"):
            if mode == "step":
                out.append([eng.step(*batches[0]).item() for _ in range(3)])
            elif mode == "run_steps":
                out.append(eng.run_steps(*batches[0], steps=3).tolist())
            else:
                out.append([eng.step(*b).item() for b in eng.prefetch([batches[0]] * 3)])
    assert out[0] == out[1] == out[2]


RING_F32_FROB_TOL = 1e-5   # chip_smoke.py's: the ring sums its blocks in another order


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("P", [2, 4])
def test_ring_over_virtual_ranks_matches_flash_on_the_whole_sequence(cuda, P, dtype):
    """ring_attention_virtual at P ranks on one card, causal, forward and
    backward, against flash_attention over the whole sequence: o, dq, dk,
    dv within the kernel limits (2e-2 x max|ref| bf16; 1e-4, x max(1,
    max|ref|) for a gradient, f32) and each (b, h) head's relative
    Frobenius norm (1e-2 bf16, RING_F32_FROB_TOL f32); P (P + 1) / 2
    launches of the forward and of each backward kernel, on the dtype's
    route only."""
    from paddle_tpu_torch.distributed.meta_parallel import sequence_parallel as sp

    dt = getattr(torch, dtype)
    rng = np.random.RandomState(P)
    q, k, v, do = (torch.from_numpy(rng.randn(2, 512, 4, 64).astype(np.float32)).to(cuda, dt)
                   for _ in range(4))

    def run(fn):
        x = [t.clone().requires_grad_() for t in (q, k, v)]
        o = fn(*x)
        o.backward(do)
        return [o.detach()] + [t.grad for t in x]

    want = run(lambda a, b, c: fa.flash_attention(a, b, c, causal=True))
    f0, bwd0 = dict(fa.launches_by_route), _bwd_routes()
    got = run(lambda a, b, c: sp.ring_attention_virtual(a, b, c, P, causal=True))
    torch.cuda.synchronize()
    route = "mma" if dt == torch.bfloat16 else "tf32x3"
    n = P * (P + 1) // 2
    assert {r: fa.launches_by_route[r] - f0[r] for r in f0} == {
        r: n if r == route else 0 for r in f0}
    assert _bwd_moved(bwd0) == {r: {"dkdv": n if r == route else 0, "dq": n if r == route else 0}
                                for r in bwd0}
    for i, (g, w) in enumerate(zip(got, want)):
        scale = w.float().abs().max().item()
        tol = (2e-2 * scale if dt == torch.bfloat16
               else 1e-4 * (max(1.0, scale) if i else 1.0))
        assert (g.float() - w.float()).abs().max().item() <= tol, i
        frob = BF16_GRAD_FROB_TOL if dt == torch.bfloat16 else RING_F32_FROB_TOL
        assert _head_rel_frob(g, w) <= frob, i


def _rel_frob(got, want):
    return ((got.float() - want.float()).norm() / want.float().norm().clamp_min(1e-30)).item()


@pytest.mark.parametrize("V", [1, 2])
def test_pipeline_over_a_virtual_ring_on_card_matches_pp_one(cuda, V):
    """GPTForPretrainingPipe's two stages (V chunks each) through the
    schedule over a VirtualRing(2) on the card, 2 micro-batches, f32: the
    loss (rtol 1e-5) and every parameter's gradient (1e-5 relative
    Frobenius) of the same Pipe at pp = 1, and 2 x 4 launches of each
    3xTF32 flash kernel."""
    from paddle_tpu_torch.distributed.meta_parallel.sequence_parallel import VirtualRing
    from paddle_tpu_torch.models import GPTForPretrainingPipe

    cfg = GPTConfig(vocab_size=1024, hidden_size=128, num_layers=4, num_heads=4,
                    max_seq_len=256)
    m = GPTForPretrainingPipe(cfg, num_stages=2, num_microbatches=2, num_virtual_stages=V,
                              device=cuda, seed=1)
    rng = np.random.RandomState(V)
    ids = torch.from_numpy(rng.randint(0, 1024, (4, 256))).to(cuda)
    labels = torch.roll(ids, -1, 1)

    def run(ring):
        m.pipeline_ring = ring
        m.zero_grad(set_to_none=True)
        loss = m(ids, labels)
        loss.backward()
        torch.cuda.synchronize()
        return loss.item(), {n: p.grad.clone() for n, p in m.named_parameters()}

    want_loss, want = run(None)
    f0, bwd0 = dict(fa.launches_by_route), _bwd_routes()
    got_loss, got = run(VirtualRing(2))
    n = cfg.num_layers * 2
    assert {r: fa.launches_by_route[r] - f0[r] for r in f0} == {
        r: n if r == "tf32x3" else 0 for r in f0}
    assert _bwd_moved(bwd0) == {r: {"dkdv": n if r == "tf32x3" else 0,
                                    "dq": n if r == "tf32x3" else 0} for r in bwd0}
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
    for name, w in want.items():
        assert _rel_frob(got[name], w) <= 1e-5, name


def test_moe_layer_on_card_matches_the_cpu(cuda):
    """MoELayer (4 experts, top 2, capacity 1.25, so tokens overflow) on the
    card against the same layer on the CPU, f32: the output and every
    gradient of sum(y * dy) within 1e-5 relative Frobenius."""
    from paddle_tpu_torch.distributed.meta_parallel import MoELayer

    torch.manual_seed(0)
    cpu = MoELayer(64, 128, 4, top_k=2, capacity_factor=1.25)
    card = MoELayer(64, 128, 4, top_k=2, capacity_factor=1.25).to(cuda)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.RandomState(3)
    x, dy = (torch.from_numpy(rng.randn(2, 256, 64).astype(np.float32)) for _ in range(2))

    def grads(layer, x, dy):
        x = x.clone().requires_grad_()
        y = layer(x)
        y.backward(dy)
        return {"y": y.detach(), "x": x.grad, **{n: p.grad for n, p in layer.named_parameters()}}

    want = grads(cpu, x, dy)
    got = grads(card, x.to(cuda), dy.to(cuda))
    for name, w in want.items():
        assert torch.isfinite(got[name]).all(), name
        assert _rel_frob(got[name].cpu(), w) <= 1e-5, name


@pytest.mark.parametrize("case", ["conv_same_stride2", "conv_nhwc_groups", "max_pool_pads",
                                  "avg_pool_exclusive", "batch_norm_train", "cross_entropy"])
def test_vision_ops_on_card_match_the_cpu(cuda, case):
    """The vision path's ops (ops/nn_functional.py: cuDNN's convolutions, the
    pools, batch norm, cross entropy) on the card against the CPU, f32
    with TF32 off: output and input gradient within 1e-4 x max(1,
    max|ref|) (f32 sums in other orders)."""
    from paddle_tpu_torch.ops import nn_functional as F

    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(4, 8, 17, 15).astype(np.float32))
    w = torch.from_numpy((rng.randn(6, 8, 3, 3) * 0.2).astype(np.float32))
    wg = torch.from_numpy((rng.randn(3, 3, 4, 6) * 0.2).astype(np.float32))
    fns = {
        "conv_same_stride2": lambda x, dev: F.conv2d(x, w.to(dev), padding="SAME", stride=2),
        "conv_nhwc_groups": lambda x, dev: F.conv2d(x.permute(0, 2, 3, 1), wg.to(dev),
                                                    padding=[1, 0, 2, 1], groups=2,
                                                    data_format="NHWC"),
        "max_pool_pads": lambda x, dev: F.max_pool2d(x, 3, 2, padding=[0, 2, 1, 0]),
        "avg_pool_exclusive": lambda x, dev: F.avg_pool2d(x, 4, 3, padding="SAME"),
        "batch_norm_train": lambda x, dev: F.batch_norm(
            x, torch.zeros(8, device=dev), torch.ones(8, device=dev), training=True),
        "cross_entropy": lambda x, dev: F.cross_entropy(
            x.flatten(2).mean(-1), torch.tensor([1, -100, 7, 3], device=dev)),
    }
    out = {}
    for dev in ("cpu", cuda):
        xi = x.to(dev).clone().requires_grad_()
        y = fns[case](xi, dev)
        y.backward(torch.ones_like(y))
        out[str(dev)] = (y.detach().cpu(), xi.grad.cpu())
    for got, want in zip(out["cuda"], out["cpu"]):
        assert (got - want).abs().max() <= 1e-4 * max(1.0, want.abs().max().item()), case


def test_resnet18_engine_step_on_card_matches_the_cpu(cuda):
    """One f64 TrainStepEngine step of ResNet-18 (loss_fn=CrossEntropyLoss(),
    Momentum 0.1) at [8, 3, 64, 64] on the card (cuDNN's f64 convolutions)
    against the CPU from the same weights: the loss and each running
    statistic within 1e-6 of the CPU's largest entry, each parameter's
    update within that plus one f32 ulp at 1 (1.2e-7: the optimizer keeps
    its state in f32 and writes the parameters through it, so a weight
    near 1 may round one ulp apart). In f64 because at these weights and
    inputs the step's f32 updates differ from its own f64 ones by 1.7e-2 of
    an entry on the CPU alone (batch norm over channels of tiny batch
    variance; tests/test_torch_vision.py)."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed import TrainStepEngine
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import resnet18

    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(8, 3, 64, 64).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 10, (8,)).astype(np.int64))
    res = {}
    for dev in ("cpu", cuda):
        m = resnet18(num_classes=10, seed=0, device=dev).double()
        p0 = {n: p.detach().cpu().clone() for n, p in m.named_parameters()}
        eng = TrainStepEngine(m, Momentum(0.1, parameters=m.named_parameters()),
                              loss_fn=nn.CrossEntropyLoss())
        loss = eng.step(x.double(), y).item()
        res[str(dev)] = (loss, {n: p.detach().cpu() - p0[n] for n, p in m.named_parameters()},
                         {n: b.cpu() for n, b in m.named_buffers()})
    (lg, dg, sg), (lc, dc, sc) = res["cuda"], res["cpu"]
    assert abs(lg - lc) <= 1e-6 * abs(lc)
    for name, w in dc.items():
        assert (dg[name] - w).abs().max() <= 1e-6 * w.abs().max() + 1.2e-7, name
    for name, w in sc.items():
        assert (sg[name] - w).abs().max() <= 1e-6 * w.abs().max(), name


def test_ernie_noncausal_flash_on_card_matches_the_cpu(cuda):
    """ernie_tiny's f32 MLM + NSP loss and gradients at [2, 128] with token
    types and without a mask: on the
    card each layer launches the 3xTF32 flash forward and backward pair,
    non-causally; on the CPU the dense path. Loss at 1e-5, each gradient
    at 1e-3 of its largest entry (chip_smoke.py's ernie_vs_cpu bars)."""
    from paddle_tpu_torch.models import ErnieForPretraining, ernie_tiny
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    rng = np.random.RandomState(2)
    ids = torch.from_numpy(rng.randint(0, 1024, (2, 128)).astype(np.int64))
    labels = torch.where(torch.from_numpy(rng.rand(2, 128)) < 0.15, ids, -100)
    types = torch.from_numpy((np.arange(128)[None, :] >= 50).repeat(2, 0).astype(np.int64))
    nsp = torch.tensor([0, 1])
    res = {}
    for dev in ("cpu", cuda):
        m = ErnieForPretraining(ernie_tiny(), seed=1, device=dev)
        before = dict(fa.launches_by_route), {r: dict(c) for r, c in
                                              fa.launches_bwd_by_route.items()}
        loss = m(ids.to(dev), labels.to(dev), types.to(dev), None, nsp.to(dev))
        loss.backward()
        fwd = fa.launches_by_route["tf32x3"] - before[0]["tf32x3"]
        bwd = fa.launches_bwd_by_route["tf32x3"]["dq"] - before[1]["tf32x3"]["dq"]
        res[str(dev)] = (loss.item(), {n: p.grad.cpu() for n, p in m.named_parameters()},
                         fwd, bwd)
    (lg, gg, fg, bg), (lc, gc_, fc, bc) = res["cuda"], res["cpu"]
    assert (fg, bg, fc, bc) == (2, 2, 0, 0)
    assert abs(lg - lc) <= 1e-5 * abs(lc)
    for name, w in gc_.items():
        assert (gg[name] - w).abs().max() <= 1e-3 * w.abs().max(), name


def test_loader_pins_in_its_workers_and_moves_batches_to_the_card(cuda):
    """DataLoader(device=cuda, num_workers=2): the workers collate into pinned
    host tensors, the iterator hands out card tensors with the CPU loader's
    values, and close() ends the worker threads."""
    import threading

    from paddle_tpu_torch.io import DataLoader
    from paddle_tpu_torch.vision.datasets import MNIST

    ds = MNIST(size=256)
    batches = [[3, 1, 4, 1, 5], [9, 2, 6], [255, 0]]
    card = DataLoader(ds, batch_sampler=batches, num_workers=2, device=cuda, timeout=60)
    host = card._collate()([ds[i] for i in batches[0]])
    assert all(t.is_pinned() for t in host)
    it = iter(card)
    got = [[t for t in b] for b in it]
    it.close()
    want = list(DataLoader(ds, batch_sampler=batches, device="cpu"))
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.is_cuda and torch.equal(a.cpu(), b)
    assert not [t for t in threading.enumerate() if t.name.startswith("paddle_tpu_torch-io")]


def test_model_fit_on_card_gives_the_example_loops_losses(cuda):
    """LeNet (seed 0) on the card, cuDNN deterministic: hapi's Model.fit with
    Accuracy() over the example's batches gives the example loop's losses
    bit for bit; fit(accumulate_grad_batches=2) without metrics takes the
    engine route."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.examples import train_mnist_dygraph as ex
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.hapi.callbacks import Callback
    from paddle_tpu_torch.metric import Accuracy
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.vision.datasets import MNIST
    from paddle_tpu_torch.vision.models import LeNet

    batches = [list(range(i, i + 64)) for i in range(0, 256, 64)]
    ds = MNIST(size=256)

    class Losses(Callback):
        def __init__(self):
            super().__init__()
            self.losses = []

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(logs["loss"])

    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        want = []
        ex.train(LeNet(seed=0, device=cuda), ex.make_loader(ds, cuda, batches), 2, want)
        m = LeNet(seed=0, device=cuda)
        model = Model(m).prepare(Adam(learning_rate=ex.LR, parameters=m.named_parameters()),
                                 nn.CrossEntropyLoss(), Accuracy())
        rec = Losses()
        model.fit(ex.make_loader(ds, cuda, batches), epochs=2, verbose=0, callbacks=[rec])
        assert rec.losses == want and model._engine is None
        m = LeNet(seed=0, device=cuda)
        model = Model(m).prepare(Adam(learning_rate=ex.LR, parameters=m.named_parameters()),
                                 nn.CrossEntropyLoss())
        model.fit(ex.make_loader(ds, cuda, batches), epochs=2, verbose=0,
                  accumulate_grad_batches=2)
        assert model._engine is not None
    finally:
        torch.backends.cudnn.deterministic = prev


def test_a_resumed_resnet18_on_card_has_the_uninterrupted_buffers(cuda, tmp_path):
    """ResNet-18 on the card (cuDNN deterministic): 3 engine steps, a
    checkpoint, 2 more; a fresh engine restored from it takes the same 2
    with the same losses, buffers and eval logits, bit for bit."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed import TrainStepEngine
    from paddle_tpu_torch.distributed.elastic import CheckpointManager, restore_latest
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import resnet18

    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(16, 3, 32, 32).astype(np.float32)).to(cuda)
    y = torch.from_numpy(rng.randint(0, 10, (16,)).astype(np.int64)).to(cuda)

    def engine(seed):
        m = resnet18(num_classes=10, seed=seed, device=cuda)
        return TrainStepEngine(m, Momentum(0.01, parameters=m.named_parameters()),
                               loss_fn=nn.CrossEntropyLoss())

    def outcome(eng):
        losses = [eng.step(x, y).item() for _ in range(2)]
        eng.model.eval()
        with torch.no_grad():
            logits = eng.model(x)
        return losses, {n: b.clone() for n, b in eng.model.named_buffers()}, logits

    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        eng = engine(0)
        for _ in range(3):
            eng.step(x, y)
        CheckpointManager(str(tmp_path), async_save=False).save(eng, block=True)
        want = outcome(eng)
        fresh = engine(1)
        assert restore_latest(fresh, str(tmp_path)) == 3
        got = outcome(fresh)
    finally:
        torch.backends.cudnn.deterministic = prev
    assert got[0] == want[0]
    for n, b in want[1].items():
        assert torch.equal(got[1][n], b), n
    assert torch.equal(got[2], want[2])


def test_ps_lookup_with_rows_on_card_pushes_the_cpu_merged_gradient(cuda):
    """distributed_lookup_table with ids and rows on the card: the rows come
    up in one copy, and the backward pushes the merged gradient the CPU run
    pushes (the same cotangent, merged on the host in the same order), so
    the table rows after are the same bits."""
    from paddle_tpu_torch.distributed.ps import (PSClient, PSServer, SparseTableConfig,
                                                 distributed_lookup_table)

    rng = np.random.RandomState(0)
    ids = rng.randint(0, 50, (64, 5)).astype(np.int64)     # repeated ids
    w = rng.randn(64, 5, 8).astype(np.float32)
    uniq = np.unique(ids).astype(np.uint64)
    after = {}
    for dev in (cuda, torch.device("cpu")):
        server = PSServer(0, [SparseTableConfig(table_id=0, dim=8, learning_rate=0.5)])
        client = PSClient([f"127.0.0.1:{server.port}"])
        try:
            rows = distributed_lookup_table(torch.from_numpy(ids).to(dev), client, 0, 8)
            assert rows.device.type == dev.type and rows.is_leaf and rows.requires_grad
            (rows * torch.from_numpy(w).to(dev)).sum().backward()
            after[dev.type] = client.pull_sparse(0, uniq, 8)
        finally:
            client.close()
            server.stop()
    np.testing.assert_array_equal(after["cuda"], after["cpu"])


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def test_the_tensor_api_table_on_card_matches_the_cpu(cuda):
    """chip_smoke.py's tensor_api table: every function of the namespace on
    the card against the CPU (values by result dtype at chip_smoke.py's
    TENSOR_API_TOL, decompositions by reconstruction, random ops by dtype,
    device, moments and determinism under seed on the card's generator),
    with the nn cases: each nn.functional op, layer, initializer and
    nn.utils function."""
    cs = _chip_smoke()
    rec = cs.run_tensor_api_table()
    assert rec["cases"] >= len(cs.tensor_api_namespace_names() | cs.nn_api_names())


def test_transformer_encoder_on_card_runs_the_flash_kernels(cuda):
    """A 2-layer nn.TransformerEncoder (d_model 128, 2 heads of 64, seq 256)
    built on the CPU and copied to the card: without a mask each layer
    launches the flash forward and the FA2 pair (f32: the 3xTF32 route);
    output and gradients within 1e-4 relative Frobenius of the CPU's (the k
    projections' biases, whose exact gradient is 0, by their size)."""
    import copy

    import paddle_tpu_torch as P

    cs = _chip_smoke()
    place = P.get_place()
    P.set_device("cpu")
    try:
        torch.manual_seed(0)
        cpu = P.nn.TransformerEncoder(P.nn.TransformerEncoderLayer(128, 2, 256, dropout=0.0),
                                      2)
        card = copy.deepcopy(cpu).cuda()
        x = torch.randn(2, 256, 128)
        names, ref = cs._nn_small_run(cpu, [x], None)
        cs._reset_launch_counts()
        _, got = cs._nn_small_run(card, [x.cuda()], None)
        torch.cuda.synchronize()
        assert cs._launch_counts() == {"flash_attention_fwd": 2, "flash_attention_bwd_dkdv": 2,
                                       "flash_attention_bwd_dq": 2}
        assert fa.launches_by_route["tf32x3"] == 2
        errs = cs.nn_grad_errors(names, got, ref)   # the k biases by their size (exactly 0)
        assert max(errs.values()) <= 1e-4, errs
    finally:
        P.set_device(place)


def _text_small(cs):
    """chip_smoke.py's text phase cut to small widths for the card tests."""
    cs.TEXT_S2S = dict(src_vocab=500, trg_vocab=300, hidden=64, layers=2, dropout=0.2,
                       init=0.1)
    cs.TEXT_S2S_BATCH, cs.TEXT_S2S_LENS, cs.TEXT_S2S_STEPS = 16, (4, 12), (1, 2)
    cs.TEXT_BEAM, cs.TEXT_YARDSTICK = (4, 12), (16, 12, 64)
    cs.TEXT_TOK = dict(vocab=40000, sentences=64, rows=2, max_seq_len=128)
    return cs


def test_seq2seq_with_attention_on_card_matches_the_cpu(cuda):
    """Phase text (a) at hidden 64: the card copy against the CPU (loss 1e-5,
    gradients 1e-3 x max|g|, beam ids equal but at a near-tie), then its
    f32 steps, the bf16 O1 step (loss within 2e-2, f32 encoder outputs),
    the beam search and the loop LSTM against cuDNN's on the same weights."""
    import copy

    import paddle_tpu_torch as P

    cs = _text_small(_chip_smoke())
    cpu_model = cs.text_seq2seq(P)
    rec = cs.text_seq2seq_run(P, cpu_model, copy.deepcopy(cpu_model).to(cuda), cuda)
    assert rec["vs_cpu"]["loss_rel_err"] <= cs.TEXT_LOSS_RTOL
    assert rec["decode"]["steps"] >= 1 and rec["yardstick"]["max_abs_diff"] <= 1e-4


def test_bigru_tagger_and_viterbi_on_card_match_the_cpu(cuda):
    """Phase text (b): the Conll05st batch through the 2-layer bidirect GRU
    tagger on the card against the CPU (1e-5), Viterbi paths equal to the
    CPU's on the same emissions, scores within 1e-5."""
    import paddle_tpu_torch as P

    rec = _chip_smoke().text_tagger_run(P, cuda)
    assert rec["paths_equal"] and rec["batch"] == [256, 32]


def test_tokenizer_feeds_ernie_base_on_card(cuda):
    """Phase text (c) at 64 sentences and 2 rows of 128: the tokenizer's ids
    equal the Python oracle's; ERNIE-3.0-base's forward launches the flash
    forward once a layer on the 3xTF32 route at f32 and on the tensor cores
    at bf16 O1, the bf16 hidden states within 3e-2 of f32's."""
    import paddle_tpu_torch as P

    cs = _text_small(_chip_smoke())
    rec, launches = cs.text_tokenizer_run(P, cuda)
    assert rec["oracle_equal"]
    assert launches["bf16"]["flash_attention_fwd"] == launches["f32"]["flash_attention_fwd"] == 12
