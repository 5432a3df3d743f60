"""paddle_tpu_torch.ops.kernels.lm_loss vs the JAX package's Pallas LM-head
cross entropy (paddle_tpu/ops/pallas/lm_loss.py, run in interpret mode on the
CPU as its own tests run it) on the same numpy inputs; then the slice as a
whole: GPT's final LayerNorm followed by the tied LM head and loss, through
both library ops, in both packages.

The port's CPU path is the kernels' plain versions, reached through the
public ``lm_head_cross_entropy`` and autograd. Covered: the cases of
tests/test_pallas_lm_loss.py (f32 and bf16 values, gradients, the
``supported`` predicate, unaligned vocab 500, bf16 h with an f32 W, block_n
256 and 512), the ``block_n`` check, a row count JAX refuses, a label of
-100 (no ignore_index: the row's loss is its logsumexp), the tensor-core
route's inputs (bf16 h, f32 W) at vocab 500 with -100 labels, the
backward's route and hidden-chunk plan (``backward_plan``), the forward's
route (``forward_route``), the compile probe's variants as instances of
the tensor-core forward, and the numerics the 3xTF32 forward and backward
rely on (a plain emulation of TF32 products: three terms reach the card's
f32 limit, fewer do not; also with S summed over a cluster's hidden
slices), with the edits of the tools that check their mutants on the
card.

Tolerances: f32 loss 2e-5 and gradients of the mean loss 1e-6 absolute (the
same f32 products and logsumexp in another order; gradients are ~1e-4);
bf16 loss 1e-4 (bf16 values are exact in f32, so only the sum order
differs); bf16 h with f32 W: dh 1e-2 x max|ref| (dh rounds to bf16 in both,
one bf16 step apart at most) and dW 1e-4 x max|ref| (f32, from dl rounded to
bf16 in both), the tensor-core route's case likewise. The composition: loss 2e-5 relative, gradients 1e-4 x max|g|
(two f32 ops and twelve 128-wide sums in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import GPTForPretraining as JaxGPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.ops.pallas import layer_norm as jax_pln
from paddle_tpu.ops.pallas import lm_loss as jax_lm
from paddle_tpu_torch.models import GPTForPretraining, gpt_tiny, load_jax_state
from paddle_tpu_torch.ops.kernels import layer_norm as ln
from paddle_tpu_torch.ops.kernels import lm_loss as lm
from tf32_emulation import GRAD_F32_FROB_TOL, tf32_product, tf32_sliced_product

LOSS_TOL = 2e-5
GRAD_TOL = 1e-6


def _data(n, v, h, seed, dtype=np.float32, w_scale=0.05):
    rng = np.random.RandomState(seed)
    hh = rng.randn(n, h).astype(np.float32)
    w = (rng.randn(v, h) * w_scale).astype(np.float32)
    lab = rng.randint(0, v, (n,)).astype(np.int32)
    return hh, w, lab


def _jax(h, w, lab, h_dtype=jnp.float32, w_dtype=jnp.float32, block_n=256):
    """JAX loss and the gradients of its mean, as float32 numpy, with the
    gradients' dtypes."""
    hj, wj = jnp.asarray(h, h_dtype), jnp.asarray(w, w_dtype)
    labj = jnp.asarray(lab)
    loss = jax_lm.lm_head_cross_entropy(hj, wj, labj, block_n=block_n)
    gh, gw = jax.grad(lambda a, b: jax_lm.lm_head_cross_entropy(
        a, b, labj, block_n=block_n).mean(), argnums=(0, 1))(hj, wj)
    return ([np.asarray(t, np.float32) for t in (loss, gh, gw)],
            (str(gh.dtype), str(gw.dtype)))


def _port(h, w, lab, h_dtype=torch.float32, w_dtype=torch.float32, block_n=256):
    th = torch.from_numpy(h).to(h_dtype).requires_grad_()
    tw = torch.from_numpy(w).to(w_dtype).requires_grad_()
    loss = lm.lm_head_cross_entropy(th, tw, torch.from_numpy(lab), block_n=block_n)
    assert loss.dtype == torch.float32 and tuple(loss.shape) == (h.shape[0],)
    loss.mean().backward()
    return ([t.detach().float().numpy() for t in (loss, th.grad, tw.grad)],
            (str(th.grad.dtype).replace("torch.", ""),
             str(tw.grad.dtype).replace("torch.", "")))


def _close(got, want, atol):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


@pytest.mark.parametrize("dtype,atol", [("float32", LOSS_TOL), ("bfloat16", 1e-4)])
def test_values_match_jax(dtype, atol):
    h, w, lab = _data(1024, 512, 128, seed=0)
    want, _ = _jax(h, w, lab, getattr(jnp, dtype), getattr(jnp, dtype))
    got, _ = _port(h, w, lab, getattr(torch, dtype), getattr(torch, dtype))
    _close(got[0], want[0], atol)


@pytest.mark.parametrize("n,v,seed", [(1024, 256, 1), (1024, 500, 5), (2048, 640, 7)])
def test_grads_match_jax(n, v, seed):
    """Loss and the gradients of its mean; vocab 500 is unaligned (JAX pads
    W to 512 and masks, the port masks by index): dW has exactly V rows."""
    h, w, lab = _data(n, v, 128, seed=seed)
    want, _ = _jax(h, w, lab)
    got, _ = _port(h, w, lab)
    assert got[2].shape == (v, 128)
    _close(got[0], want[0], LOSS_TOL)
    _close(got[1], want[1], GRAD_TOL)
    _close(got[2], want[2], GRAD_TOL)


def test_mixed_dtype_bf16_h_f32_w():
    """bf16 activations against an f32 master W: W is taken in bf16, dh
    comes back bf16 and dW f32, in both packages."""
    h, w, lab = _data(1024, 256, 128, seed=4)
    want, want_dt = _jax(h, w, lab, jnp.bfloat16, jnp.float32)
    got, got_dt = _port(h, w, lab, torch.bfloat16, torch.float32)
    assert got_dt == want_dt == ("bfloat16", "float32")
    _close(got[0], want[0], 1e-4)
    _close(got[1], want[1], 1e-2 * np.abs(want[1]).max())
    _close(got[2], want[2], 1e-4 * np.abs(want[2]).max())


@pytest.mark.parametrize("block_n", [256, 512])
def test_block_n_changes_no_bit(block_n):
    """block_n is a Mosaic compile knob: every valid value gives the port's
    same bits, and those match JAX at that block_n."""
    h, w, lab = _data(2048, 640, 128, seed=7)
    want, _ = _jax(h, w, lab, block_n=block_n)
    got, _ = _port(h, w, lab, block_n=block_n)
    base, _ = _port(h, w, lab, block_n=1024)
    for a, b in zip(got, base):
        np.testing.assert_array_equal(a, b)
    _close(got[0], want[0], LOSS_TOL)
    _close(got[1], want[1], GRAD_TOL)


def test_label_minus_100_picks_nothing():
    """A label of -100 (JAX's and paddle's ignore index, unmasked by the
    caller) picks no logit: its loss is the row's logsumexp, its gradient
    softmax * g, in both packages."""
    h, w, lab = _data(1024, 384, 128, seed=9)
    lab[[0, 17, 1000]] = -100
    want, _ = _jax(h, w, lab)
    got, _ = _port(h, w, lab)
    _close(got[0], want[0], LOSS_TOL)
    _close(got[1], want[1], GRAD_TOL)
    _close(got[2], want[2], GRAD_TOL)
    logits = h @ w.T
    m = logits.max(1)
    lse = m + np.log(np.exp(logits - m[:, None]).sum(1))
    _close(got[0][[0, 17, 1000]], lse[[0, 17, 1000]], LOSS_TOL)


@pytest.mark.parametrize("n,v,h", [(8192, 50304, 768), (16384, 50304, 768),
                                   (512, 50304, 768), (100, 512, 128),
                                   (1024, 500, 128), (1024, 512, 100),
                                   (1024, 127, 128), (0, 512, 128)])
def test_supported_predicate_is_the_jax_packages(n, v, h):
    assert lm.supported(n, v, h) == jax_lm.supported(n, v, h)
    assert lm._pick_rows(n) == jax_lm._pick_rows(n)


@pytest.mark.parametrize("block_n", [128, 255, 2048, 256, 512, 1024])
def test_block_n_check_is_the_jax_packages(block_n):
    try:
        want = jax_lm._check_block_n(block_n)
    except ValueError:
        with pytest.raises(ValueError):
            lm._check_block_n(block_n)
        h = torch.zeros(1024, 128)
        with pytest.raises(ValueError):
            lm.lm_head_cross_entropy(h, torch.zeros(256, 128),
                                     torch.zeros(1024, dtype=torch.long), block_n)
    else:
        assert lm._check_block_n(block_n) == want


def test_row_count_jax_refuses_is_refused():
    """Rows must be a multiple of 1024 in both packages (JAX asserts)."""
    h, w, lab = _data(512, 256, 128, seed=2)
    with pytest.raises(AssertionError):
        jax_lm.lm_head_cross_entropy(jnp.asarray(h), jnp.asarray(w), jnp.asarray(lab))
    with pytest.raises(ValueError):
        lm.lm_head_cross_entropy(torch.from_numpy(h), torch.from_numpy(w),
                                 torch.from_numpy(lab))


def test_probe_variants_plain():
    """The compile probe's stripped forwards on the plain path: bare is the
    logsumexp alone; masked drops the last 64 columns from it."""
    h, w, lab = _data(1024, 512, 128, seed=3)
    th, tw, tl = (torch.from_numpy(a) for a in (h, w, lab))
    loss_b, lse_b = lm.lm_loss_fwd(th, tw, tl, variant="bare")
    torch.testing.assert_close(loss_b, lse_b)
    logits = th @ tw.t()
    torch.testing.assert_close(lse_b, torch.logsumexp(logits, 1), atol=LOSS_TOL, rtol=0)
    loss_m, lse_m = lm.lm_loss_fwd(th, tw, tl, variant="full", v_true=448)
    torch.testing.assert_close(lse_m, torch.logsumexp(logits[:, :448], 1),
                               atol=LOSS_TOL, rtol=0)
    picked = torch.where(tl.long() < 448, logits.gather(1, tl.long()[:, None])[:, 0],
                         torch.tensor(-1e30))
    torch.testing.assert_close(loss_m, lse_m - picked, atol=LOSS_TOL, rtol=0)


def test_bf16_h_f32_w_backward_ragged_vocab_and_minus_100_match_jax():
    """The tensor-core route's inputs (bf16 h, f32 master W) at a vocab that
    is not a multiple of the kernels' 32-row tiles, with labels of -100:
    loss and both gradients against JAX's interpret-mode kernel, at the
    mixed-dtype limits (loss 1e-4, dh 1e-2 x max|ref|, dW 1e-4 x max|ref|);
    dh bf16 and dW f32 in both."""
    h, w, lab = _data(1024, 500, 128, seed=11)
    lab[[3, 500, 1023]] = -100
    want, want_dt = _jax(h, w, lab, jnp.bfloat16, jnp.float32)
    got, got_dt = _port(h, w, lab, torch.bfloat16, torch.float32)
    assert got_dt == want_dt == ("bfloat16", "float32")
    assert got[2].shape == (500, 128)
    _close(got[0], want[0], 1e-4)
    _close(got[1], want[1], 1e-2 * np.abs(want[1]).max())
    _close(got[2], want[2], 1e-4 * np.abs(want[2]).max())


@pytest.mark.parametrize("dtype,hidden,route,chunks,chunk,hc,stages", [
    ("bfloat16", 128, "mma", 1, 128, 2, 2),
    ("bfloat16", 768, "mma", 1, 768, 6, 2),
    ("bfloat16", 1024, "mma", 2, 512, 4, 2),
    ("bfloat16", 1280, "mma", 2, 640, 6, 1),     # two other tiles no longer fit
    ("float32", 128, "tf32x3", 1, 128, 2, 2),    # 3xTF32: 16-row other tiles,
    ("float32", 768, "tf32x3", 1, 768, 6, 2),    # double-buffered at every H
    # past the one-CTA tiles: "cN", a cluster of N CTAs, one hidden slice each;
    # f32 slices of <= 512 pipelined over three buffers up to H = 4096
    ("float32", 1024, "tf32x3", "c2", 512, 4, 3),   # gpt_345m: 512 + 512
    ("float32", 1280, "tf32x3", "c3", 512, 4, 3),   # 512 + 512 + 256
    ("float32", 896, "tf32x3", "c2", 512, 4, 3),    # 512 + 384
    ("float32", 2048, "tf32x3", "c4", 512, 4, 3),
    ("float32", 4096, "tf32x3", "c8", 512, 4, 3),
    ("float32", 4224, "tf32x3", "c6", 768, 6, 2),   # past it slices of <= 768, in order
    ("float32", 6144, "tf32x3", "c8", 768, 6, 2),   # the cluster limit
    ("float32", 6272, "fma", None, 0, 0, 0),        # past it: the FMA kernel picks its
    ("bfloat16", 6272, "fma", None, 0, 0, 0),       # own chunks
    ("bfloat16", 1664, "mma", "c3", 640, 6, 3),     # 640 + 640 + 384
    ("bfloat16", 2048, "mma", "c3", 768, 6, 3),     # gpt_1p3b: 768 + 768 + 512
    ("bfloat16", 2560, "mma", "c4", 640, 6, 3),
])
def test_backward_plan_table(dtype, hidden, route, chunks, chunk, hc, stages):
    """The backward's route and the plan lm_loss_bwd_mma is launched with:
    bf16 h takes the bf16 tensor cores, f32 h the TF32 ones (3xTF32), up to
    H = 6144; past it the FMA kernel. While the [32, H] own tile fits, one
    CTA holds it and the grid's y is ceil(H / chunk) hidden chunks (the C
    entry's grid, cluster 1); past that a cluster of ceil(H / chunk) CTAs
    shares it, each a slice of chunk columns (the last narrower), pipelined
    over three other buffers, or in order over two where three do not fit
    (f32 slices past 512). The tiles fit in the H100's 227 KB of shared
    memory."""
    plan = lm.backward_plan(getattr(torch, dtype), hidden)
    cluster = int(chunks[1:]) if isinstance(chunks, str) else int(route != "fma")
    assert plan == (route, chunk, hc, stages, cluster)
    if route != "fma":
        assert -(-hidden // plan.chunk) == (cluster if cluster > 1 else chunks)
        assert chunk <= hc * 128 and lm._plan_smem(plan, hidden) <= 232448
        assert lm._fits(route, hidden) == (cluster == 1)
        if cluster > 1:
            assert chunk * (cluster - 1) < hidden <= chunk * cluster


def test_backward_plan_limits():
    """Past H = 1536 the bf16 tiles, past H = 768 the f32 tiles do not fit
    in one CTA's shared memory, and h takes a cluster of 2 to 8 CTAs at
    every H up to 6144, with the plans below those sizes as they were; past
    6144 (and at other dtypes) the FMA kernel. Forcing a tensor-core route
    past the cluster limit or at the other dtype, or naming no route,
    raises."""
    assert lm.backward_plan(torch.bfloat16, 1536) == ("mma", 768, 6, 1, 1)
    assert lm.backward_plan(torch.bfloat16, 1664) == ("mma", 640, 6, 3, 3)
    assert lm.backward_plan(torch.float32, 768) == ("tf32x3", 768, 6, 2, 1)
    assert lm.backward_plan(torch.float32, 896) == ("tf32x3", 512, 4, 3, 2)
    assert lm.backward_plan(torch.float16, 768).route == "fma"
    assert lm._tf32_smem(768) <= 232448 < lm._tf32_smem(896)
    assert lm._mma_smem(1536, 1) <= 232448 < lm._mma_smem(1664, 1)
    for dtype, route, first in ((torch.float32, "tf32x3", 896), (torch.bfloat16, "mma", 1664)):
        for hidden in range(first, 6144 + 1, 128):
            plan = lm.backward_plan(dtype, hidden)
            assert plan.route == route and 2 <= plan.cluster <= 8, (hidden, plan)
            assert lm._plan_smem(plan, hidden) <= 232448, (hidden, plan)
            assert plan.stages == (2 if route == "tf32x3" and hidden > 4096 else 3), hidden
        for hidden in range(128, first, 128):
            assert lm.backward_plan(dtype, hidden).cluster == 1
        assert lm.backward_plan(dtype, 6272).route == "fma"
    assert lm._plan("fma", torch.bfloat16, 768).route == "fma"
    assert lm._plan("fma", torch.float32, 768).route == "fma"
    with pytest.raises(ValueError):
        lm._plan("mma", torch.bfloat16, 6272)
    with pytest.raises(ValueError):
        lm._plan("mma", torch.float32, 768)
    with pytest.raises(ValueError):
        lm._plan("tf32x3", torch.bfloat16, 768)
    with pytest.raises(ValueError):
        lm._plan("tf32x3", torch.float32, 6272)
    with pytest.raises(ValueError):
        lm._plan("wgmma", torch.bfloat16, 768)


def _tf32_backward(h, w, labels, lse, g, terms, slices=None):
    """dh and dW as the two kernels compute them: dh's S = h . Wᵀ (A = h),
    dW's Sᵀ = W . hᵀ (A = W), then dl in f32 and dl . W, dlᵀ . h (A = dl).
    ``slices`` (the cluster route's hidden slices) sums S's partials over
    them in rank order (``tf32_sliced_product``); the products by dl give
    each slice's own columns, so they are unchanged."""
    onehot = lm._onehot(labels, w.shape[0], torch.zeros(h.shape[0], w.shape[0]))

    def dl(s):
        return (torch.exp(s - lse[:, None]) - onehot) * g[:, None]

    def s_product(a, b):
        if slices is None:
            return tf32_product(a, b.t(), terms)
        return tf32_sliced_product(a, b.t(), slices, terms)

    dh = tf32_product(dl(s_product(h, w)), w, terms)
    dw = tf32_product(dl(s_product(w, h).t()).t(), h, terms)
    return dh, dw


@pytest.mark.parametrize("terms", [3, 2, 1])
def test_tf32x3_reaches_the_f32_limit_and_fewer_terms_do_not(terms):
    """The numerics the 3xTF32 backward relies on, at N = 256, V = 2048,
    H = 768 with GPT-2's scales (W ~ 0.02 N(0, 1), h ~ N(0, 1)): the
    emulated dh and dW against the plain f32 version (``lm_loss_bwd_plain``)
    in relative Frobenius norm. Three terms come within GRAD_F32_FROB_TOL
    (about 4e-7, the plain version's own f32 rounding); two terms (a_small
    b_big dropped, ~1.5e-4) and one pass (~2.5e-4) fall outside it, so the
    card's limit tells them apart."""
    rng = np.random.RandomState(23)
    n, v, hid = 256, 2048, 768
    h = torch.from_numpy(rng.randn(n, hid).astype(np.float32))
    w = torch.from_numpy((rng.randn(v, hid) * 0.02).astype(np.float32))
    labels = torch.from_numpy(rng.randint(0, v, (n,)).astype(np.int32))
    labels[::17] = -100
    g = torch.from_numpy(rng.rand(n).astype(np.float32))
    _, lse = lm.lm_loss_fwd_plain(h, w, labels)
    pdh, pdw = lm.lm_loss_bwd_plain(h, w, labels, lse, g)
    dh, dw = _tf32_backward(h, w, labels, lse, g, terms)
    for got, ref in ((dh, pdh), (dw, pdw)):
        err = ((got - ref).norm() / ref.norm()).item()
        if terms == 3:
            assert err <= GRAD_F32_FROB_TOL / 4, err
        else:
            assert err > 10 * GRAD_F32_FROB_TOL, err


@pytest.mark.parametrize("hid,cluster", [(1024, 2), (2048, 4)])
@pytest.mark.parametrize("terms", [3, 2])
def test_tf32x3_cluster_split_reaches_the_f32_limit_and_two_terms_do_not(terms, hid, cluster):
    """The numerics of the cluster route at f32 h (N = 256, V = 2048, H =
    1024 and 2048, GPT-2's scales): S's partials over the plan's hidden
    slices (c 2 and 4, of 512 columns each), each in 3xTF32, summed
    in f32 in rank order, then dl and the two products. Three terms come
    within GRAD_F32_FROB_TOL / 4 of the plain f32 version in relative
    Frobenius norm; the two-term mutant falls outside GRAD_F32_FROB_TOL
    tenfold."""
    plan = lm.backward_plan(torch.float32, hid)
    assert plan.route == "tf32x3" and plan.cluster == cluster
    slices = [(r * plan.chunk, min((r + 1) * plan.chunk, hid)) for r in range(cluster)]
    assert slices[-1][1] == hid and all(a < b for a, b in slices)
    rng = np.random.RandomState(29)
    n, v = 256, 2048
    h = torch.from_numpy(rng.randn(n, hid).astype(np.float32))
    w = torch.from_numpy((rng.randn(v, hid) * 0.02).astype(np.float32))
    labels = torch.from_numpy(rng.randint(0, v, (n,)).astype(np.int32))
    labels[::13] = -100
    g = torch.from_numpy(rng.rand(n).astype(np.float32))
    _, lse = lm.lm_loss_fwd_plain(h, w, labels)
    pdh, pdw = lm.lm_loss_bwd_plain(h, w, labels, lse, g)
    dh, dw = _tf32_backward(h, w, labels, lse, g, terms, slices)
    for got, ref in ((dh, pdh), (dw, pdw)):
        err = ((got - ref).norm() / ref.norm()).item()
        if terms == 3:
            assert err <= GRAD_F32_FROB_TOL / 4, err
        else:
            assert err > 10 * GRAD_F32_FROB_TOL, err


def test_backward_variants_tool_edits_apply_to_the_kernel_sources():
    """tools/lmloss_bwd_variants.py, which times and checks the 3xTF32
    backward's ablations and mutants on the card, names edits that each
    match the kernel sources exactly once: its two mutants drop one and two
    of mma_tf32x3's three passes, and an edit that no longer matches raises."""
    from paddle_tpu_torch.tools import lmloss_bwd_variants as tool

    tool.check()
    sources = {f: (tool.CSRC / f).read_text() for f in ("lm_loss.cu", "mma_sync.cuh")}
    passes = sources["mma_sync.cuh"].count("  mma_tf32_all(d, ")
    assert passes == 3
    for name, dropped in (("two_term", 1), ("one_pass", 2)):
        assert tool.edited(name, sources)["mma_sync.cuh"].count("  mma_tf32_all(d, ") == (
            passes - dropped)
    with pytest.raises(ValueError):
        tool.edited("one_pass", tool.edited("two_term", sources))


def test_forward_variants_tool_edits_apply_to_the_lm_loss_sources():
    """tools/tf32_fwd_variants.py, which checks and times the 3xTF32
    forwards' mutants and other designs on the card, names edits that each
    match the kernel sources exactly once. For the LM-loss forward: two
    terms drops one of mma_tf32x3's three passes; one_accumulator sums S
    straight into its running accumulator (no fresh one a slice, no
    add_frags); two_ctas does so too, splits the B fragments a pair of n8
    tiles at a time and gives the instance two CTAs an SM."""
    from paddle_tpu_torch.tools import tf32_fwd_variants as tool

    tool.check()
    sources = {f: (tool.CSRC / f).read_text() for f in tool.FILES}
    out = tool.edited("two_term", sources, tool.VARIANTS)["mma_sync.cuh"]
    assert out.count("  mma_tf32_all(d, ") == 2
    src = sources["lm_loss.cu"]
    assert "add_frags(acc, run);" in src and "__launch_bounds__(NT, 1) lm_fwd_tf32_full(" in src
    for name in ("one_accumulator", "two_ctas"):
        one = tool.edited(name, sources, tool.VARIANTS)["lm_loss.cu"]
        assert "add_frags(acc, run);" not in one and "float (&run)[2][8][4] = acc;" in one
    two = tool.edited("two_ctas", sources, tool.VARIANTS)["lm_loss.cu"]
    assert "__launch_bounds__(NT, 2) lm_fwd_tf32_full(" in two
    assert "mma_tf32x3(d, ab, as, bb, bs);" in two and "mma_tf32x3(run, " not in two


@pytest.mark.parametrize("dtype,route", [("bfloat16", "mma"), ("float32", "tf32x3")])
def test_forward_route_table(dtype, route):
    """The forward's route follows h2's dtype alone: bf16 h2 (with a bf16 or
    an f32 W) takes the bf16 tensor-core forward, f32 h2 the 3xTF32 one, at
    every hidden; on the CPU both are the plain version and move no launch
    count of any route."""
    assert lm.forward_route(getattr(torch, dtype)) == route
    h, w, lab = _data(1024, 300, 256, seed=13)
    th = torch.from_numpy(h).to(getattr(torch, dtype))
    before = ({r: dict(c) for r, c in lm.launches_by_route.items()}, lm.launches_fwd)
    loss, lse = lm.lm_loss_fwd(th, torch.from_numpy(w), torch.from_numpy(lab))
    want = lm.lm_loss_fwd_plain(th, torch.from_numpy(w), torch.from_numpy(lab))
    assert (lm.launches_by_route, lm.launches_fwd) == before
    assert torch.equal(loss, want[0]) and torch.equal(lse, want[1])


def _tf32_forward(h, w, labels, terms):
    """(loss, lse) as the 3xTF32 forward computes them: S = h . Wᵀ through
    ``tf32_product``, the logsumexp and the label's logit in f32 (a label
    outside [0, V) picks nothing)."""
    s = tf32_product(h, w.t(), terms)
    m = s.amax(dim=1)
    lse = m + torch.log(torch.exp(s - m[:, None]).sum(dim=1))
    picked = (s * lm._onehot(labels, w.shape[0], s)).sum(dim=1)
    return (lse - picked).numpy(), lse.numpy()


@pytest.mark.parametrize("terms", [3, 1])
def test_tf32x3_forward_reaches_the_f32_limit_and_one_pass_does_not(terms):
    """The numerics the 3xTF32 forward relies on, at N = 1024, V = 640, H =
    256 with labels of -100: the emulated loss and lse against the Pallas
    forward in interpret mode. Three terms come within the card's f32 limit
    (chip_smoke.py's F32_TOL = 1e-4 absolute, a tenth of it here, as the
    reference's own f32 rounding is in the comparison too); one TF32 pass
    errs by more than twice the limit on the loss (the label's logit
    carries a TF32 product's ~2^-11 relative error undamped), so the card's
    limit catches it."""
    h, w, lab = _data(1024, 640, 256, seed=25)
    lab[[1, 300, 1023]] = -100
    # the JAX forward as lm_head_cross_entropy calls it: W padded to a
    # multiple of 512 rows, the pad masked from v_true = 640 on
    wp = np.concatenate([w, np.zeros((384, 256), np.float32)])
    want = [np.asarray(x) for x in jax_lm._fwd(jnp.asarray(h), jnp.asarray(wp),
                                                jnp.asarray(lab), 256, 512, 640)]
    loss, lse = _tf32_forward(torch.from_numpy(h), torch.from_numpy(w), torch.from_numpy(lab),
                              terms)
    err = max(np.abs(loss - want[0]).max(), np.abs(lse - want[1]).max())
    if terms == 3:
        assert err <= 1e-5, err
        np.testing.assert_array_equal(loss[[1, 300, 1023]], lse[[1, 300, 1023]])
    else:
        assert err > 2e-4, err


def test_forward_route_refuses_other_dtypes():
    with pytest.raises(TypeError):
        lm.forward_route(torch.float16)


def test_probe_variants_name_entry_points_of_the_tensor_core_forward():
    """Every compile-probe variant names a kernel of csrc/lm_loss.cu that is
    an instance of the tensor-core forward (fwd_mma_body), with the PICK /
    MASK switches its variant strips."""
    import re
    from pathlib import Path

    from paddle_tpu_torch.tools import lmloss_compile_probe as probe

    src = (Path(lm.__file__).parent / "csrc" / "lm_loss.cu").read_text()
    instances = dict(re.findall(r"LM_FWD_MMA_KERNEL\((\w+), (true, \w+|false, \w+)\)", src))
    want = {"bare": "false, false", "picked": "true, false", "masked": "true, true",
            "full": "true, true"}
    assert [v[0] for v in probe.VARIANTS] == list(want)
    for name, entry, variant, masked in probe.VARIANTS:
        assert instances.get(entry) == want[name], (name, entry)
        assert (variant or "full") in lm._VARIANTS
        assert masked == (name == "masked")


# ------------------------------------------------- the slice as a whole

@pytest.fixture(scope="module")
def tiny_pair():
    from paddle_tpu.distributed.mesh import set_hybrid_communicate_group

    set_hybrid_communicate_group(None)
    paddle.seed(0)
    jm = JaxGPT(jax_gpt_tiny())
    state = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    pm = load_jax_state(GPTForPretraining(gpt_tiny(), device="cpu"), state)
    return jm, pm, state


def _hidden_before_ln_f(pm, ids):
    g = pm.gpt
    with torch.no_grad():
        x = g.wte(ids) + g.wpe(torch.arange(ids.shape[1]))
        for blk in g.blocks:
            x = blk(x)
    return x


def test_final_layer_norm_and_lm_loss_match_jax_and_the_model(tiny_pair):
    """gpt_tiny, ids [8, 128] (1024 rows): the hidden state before ln_f goes
    through the library LayerNorm with ln_f's weights, then the library LM
    loss with the tied embedding, mean over rows. Held against the same
    composition of the JAX package's Pallas ops (loss, and gradients of the
    hidden state, ln_f's weight and bias, and the embedding) and against the
    port model's own loss (chunked fused loss, plain LayerNorm)."""
    jm, pm, state = tiny_pair
    rng = np.random.RandomState(15)
    ids = rng.randint(0, 1024, (8, 128)).astype(np.int64)
    labels = np.roll(ids, -1, 1)
    x = _hidden_before_ln_f(pm, torch.from_numpy(ids)).numpy()
    g, b = state["gpt.ln_f.weight"], state["gpt.ln_f.bias"]
    wte = state["gpt.wte.weight"]
    lab32 = labels.reshape(-1).astype(np.int32)

    def jax_loss(xx, gg, bb, ww):
        hh = jax_pln.layer_norm(xx, gg, bb).reshape(-1, xx.shape[-1])
        return jax_lm.lm_head_cross_entropy(hh, ww, jnp.asarray(lab32)).mean()

    args = tuple(jnp.asarray(a) for a in (x, g, b, wte))
    j_loss = float(jax_loss(*args))
    j_grads = jax.grad(jax_loss, argnums=(0, 1, 2, 3))(*args)

    tx, tg, tb, tw = (torch.from_numpy(np.array(a)).requires_grad_()
                      for a in (x, g, b, wte))
    hh = ln.layer_norm(tx, tg, tb).reshape(-1, x.shape[-1])
    p_loss = lm.lm_head_cross_entropy(hh, tw, torch.from_numpy(lab32)).mean()
    p_loss.backward()
    assert p_loss.item() == pytest.approx(j_loss, rel=LOSS_TOL)
    for got, want in zip((tx.grad, tg.grad, tb.grad, tw.grad), j_grads):
        want = np.asarray(want)
        _close(got.numpy(), want, 1e-4 * np.abs(want).max())

    with torch.no_grad():
        model_loss = pm(torch.from_numpy(ids), torch.from_numpy(labels)).item()
    assert p_loss.item() == pytest.approx(model_loss, rel=LOSS_TOL)
