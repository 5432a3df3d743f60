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
versions (sums in another order; bf16 outputs round once in both), except
the f32 dW of bf16 h: 1e-3 x max|ref| (dl rounds to bf16 at the same point
in both, so only the sum order differs; at bf16 tolerance a dW without its
softmax term would pass wherever the labels' -h spikes set max|ref|). The
LM-loss backward's tensor-core kernels (bf16 h) are also held to their
plain versions with every label -100 (dh and dW the softmax term alone), to
giving the same bits twice, to their route's launch counts, and to HMMA in
their SASS with no spills. At f32 h the backward takes the 3xTF32 tensor
cores up to H = 768: its f32 dh and dW, and the FMA kernel's (its
predecessor), are held besides to 5e-6 in relative Frobenius norm
(GRAD_F32_FROB_TOL): a TF32 product without its error compensation errs
by ~2e-4 there while its dh passes the max limit, f32 sums in another
order by ~4e-7. Its instances hold TF32 HMMA in their SASS.

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
gradients (1e-4 x max(1, max|g|)) on the whole batch.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.amp import auto_cast
from paddle_tpu_torch.distributed import TrainStepEngine
from paddle_tpu_torch.models import GPTForPretraining, gpt_tiny
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


def test_engine_on_card_gives_the_cpu_engine_tokens(cuda):
    cfg = gpt_tiny()
    rng = np.random.RandomState(6)
    prompts = [rng.randint(0, 1024, (n,)).astype(np.int64) for n in (5, 30, 9, 17, 3)]
    out = []
    for device in ("cuda", "cpu"):
        model = GPTForPretraining(cfg, device=device, seed=4)
        eng = ServingEngine(model, slot_count=3, ladder=(8, 16, 32), max_new_cap=16,
                            steps_per_dispatch=4)
        reqs = [eng.submit(p, max_new_tokens=8, temperature=0.0) for p in prompts]
        reqs.append(eng.submit(prompts[1], max_new_tokens=8, temperature=0.7,
                               top_k=20, seed=9))
        eng.run()
        assert all(r.done for r in reqs)
        out.append([r.tokens for r in reqs])
    assert out[0] == out[1]


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
    ("float32", 37, 768),      # ragged rows: 37 is no multiple of the 8 rows a CTA
    ("bfloat16", 37, 768),
    ("float32", 300, 128),
    ("bfloat16", 64, 256),
    ("float32", 9, 2048),      # two warps a row
])
def test_layer_norm_kernels_match_plain(cuda, dtype, n, h):
    """The training forward, the inference forward and the backward (dx, dg,
    db) against their plain versions; each wrapper launches once."""
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
    ("float32", "float32", 1024, 300, 1280),      # two hidden chunks in dh / dW
    ("float32", "bfloat16", 1000, 256, 128),      # ragged rows (the wrappers mask them)
    # bf16 h: the tensor-core backward, at the edges of its 32-row tiles
    ("bfloat16", "float32", 1024, 500, 128),      # ragged vocab
    ("bfloat16", "bfloat16", 1024, 50257, 768),   # GPT-2's vocab: a ragged last tile
    ("bfloat16", "float32", 1000, 256, 768),      # ragged rows
    ("bfloat16", "float32", 1024, 300, 1280),     # two hidden chunks, one other buffer
    ("bfloat16", "bfloat16", 1000, 500, 1280),
])
def test_lm_loss_kernels_match_plain(cuda, htype, wtype, n, v, hdim):
    """The forward (loss, lse), dh and dW against their plain versions, with
    a label of -100 and one at the last column; each wrapper launches once,
    on the route backward_plan gives (tensor cores for bf16 h)."""
    ht, wt = getattr(torch, htype), getattr(torch, wtype)
    rng = np.random.RandomState(12)
    h = torch.from_numpy(rng.randn(n, hdim).astype(np.float32)).to(cuda, ht)
    w = torch.from_numpy(rng.randn(v, hdim).astype(np.float32) * 0.05).to(cuda, wt)
    labels = torch.from_numpy(rng.randint(0, v, (n,)).astype(np.int32)).to(cuda)
    labels[5], labels[6] = -100, v - 1
    g = torch.from_numpy(rng.rand(n).astype(np.float32)).to(cuda)
    route = lm.backward_plan(ht, hdim).route
    assert route == ("mma" if ht == torch.bfloat16 else "tf32x3" if hdim <= 768 else "fma")
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
    """bf16 h launches the bf16 tensor-core kernels, f32 h the 3xTF32 ones up
    to H = 768 and the FMA ones past it, through the direct calls and
    through autograd; the private route="fma" reaches the FMA kernel at bf16
    and f32 h (for timing it) and gives the same result within the
    tolerances of the plain version; the tensor-core routes refuse the
    other dtype of h."""
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
    for hh, ww, route in ((h, w, "mma"), (h.float(), w, "tf32x3"),
                          (h1280, w1280, "fma")):
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
    kernel always double-buffers; bf16 HC 4 single-buffered) or an output
    dtype dh cannot have, and launches nothing."""
    h, w, labels, g = _lm_inputs(cuda, 1024, 640, 768, torch.float32, seed=19)
    lse = torch.zeros(1024, device=cuda)
    fn = lm._kernel("lm_loss_bwd_mma")
    stream = torch.cuda.current_stream().cuda_stream
    for hh, itype, otype, dw, hc, stages in ((h.float(), 0, 0, 0, 6, 1),
                                             (h, 1, 1, 0, 4, 1),
                                             (h.float(), 0, 1, 0, 6, 2)):
        ww = w.to(hh.dtype)
        out = torch.empty(hh.shape, dtype=hh.dtype, device=cuda)
        err = fn(hh.data_ptr(), ww.data_ptr(), labels.data_ptr(), lse.data_ptr(),
                 g.data_ptr(), out.data_ptr(), itype, otype, 1024, 640, 768, dw, hc * 128, hc,
                 stages, stream)
        assert err == 1, (itype, otype, hc, stages)


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
    instance: 12 of lm_grad_mma_kernel, bf16; 9 of lm_grad_tf32_kernel, f32)
    hold HMMA instructions in their SASS, TF32 HMMA (HMMA.1688.F32.TF32) in
    the f32 ones only, and ptxas reports 0 spill bytes and at most 255
    registers for each."""
    import subprocess

    from paddle_tpu_torch.ops.kernels import _build

    _build.load("lm_loss")
    report = {k: r for k, r in _build.ptxas_report("lm_loss").items()
              if "lm_grad_mma_kernel" in k or "lm_grad_tf32_kernel" in k}
    assert len(report) == 21, sorted(report)
    assert sum("lm_grad_tf32_kernel" in k for k in report) == 9, sorted(report)
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
    assert len(mma) == 21, sorted(funcs)
    for name, body in mma.items():
        assert "HMMA" in body, name
        assert ("HMMA.1688.F32.TF32" in body) == ("lm_grad_tf32_kernel" in name), name
    fma = [body for k, body in funcs.items() if "lm_grad_kernel" in k]
    assert fma and not any("HMMA" in body for body in fma)


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
