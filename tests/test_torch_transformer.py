"""paddle_tpu_torch.nn's transformer layers against the JAX package's: the
same weights (the JAX layers built under ``numpy_init``, carried over with
``models.layer_state_from_jax``), the same numpy inputs; outputs and every
gradient of sum(out * w) (inputs and parameters; the Linear weights'
gradients transposed back to the JAX layout).

Shapes: d_model 64, 4 heads, dim_feedforward 128, batch 2, seq 32 (the
encoder) and 24 (the decoder). Tolerances: f32 outputs rtol 1e-5 atol 2e-5;
gradients rtol 1e-4 atol 2e-5 (two layers of sums in another order).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu.nn as jnn
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.models import layer_state_from_jax
from torch_api_util import assert_same, on_cpu  # noqa: F401
from torch_numpy_init import numpy_init

torch.set_num_threads(1)
pytestmark = pytest.mark.usefixtures("on_cpu")
OUT = (1e-5, 2e-5)
GRAD = (1e-4, 2e-5)
D, H, FF, B, S, T = 64, 4, 128, 2, 32, 24


def _np(t):
    return np.asarray(t._data) if hasattr(t, "_data") else t.detach().cpu().numpy()


def _carry(j, p):
    return layer_state_from_jax(p, {k: _np(v) for k, v in j.state_dict().items()})


def _x(seed, *shape):
    return np.random.RandomState(seed).standard_normal(shape).astype(np.float32)


def _compare(j, p, jargs, pargs, float_inputs):
    """Outputs, then the gradients of sum(out * w) w.r.t. the inputs at
    ``float_inputs`` and every parameter."""
    jout, pout = j(*jargs), p(*pargs)
    assert_same(pout, jout, OUT)
    w = _x(99, *pout.shape)
    jl = jp.sum(jp.multiply(jout, jp.to_tensor(w)))
    pl = (pout * torch.from_numpy(w)).sum()
    jnamed = list(j.named_parameters())
    pnamed = dict(p.named_parameters())
    assert set(pnamed) == {n for n, _ in jnamed}
    jg = jp.grad(jl, [jargs[i] for i in float_inputs] + [q for _, q in jnamed])
    pg = torch.autograd.grad(pl, [pargs[i] for i in float_inputs]
                             + [pnamed[n] for n, _ in jnamed])
    linear_weights = {f"{n}.weight" for n, m in p.named_modules()
                      if isinstance(m, pnn.Linear)}
    names = [f"input{i}" for i in float_inputs] + [n for n, _ in jnamed]
    for name, g, want in zip(names, pg, jg):
        want = _np(want)
        got = g.numpy().T if name in linear_weights else g.numpy()
        np.testing.assert_allclose(got, want, rtol=GRAD[0], atol=GRAD[1], err_msg=name)


def _inputs(*arrays):
    j = []
    for a in arrays:
        t = jp.to_tensor(a)
        t.stop_gradient = False
        j.append(t)
    return j, [torch.from_numpy(a).requires_grad_(True) for a in arrays]


@pytest.mark.parametrize("activation,normalize_before", [("relu", False), ("gelu", False),
                                                         ("relu", True), ("gelu", True)])
def test_encoder_matches_jax(activation, normalize_before):
    args = (D, H, FF, 0.0, activation)
    kw = {"normalize_before": normalize_before}
    with numpy_init(1):
        j = jnn.TransformerEncoder(jnn.TransformerEncoderLayer(*args, **kw), 2,
                                   jnn.LayerNorm(D) if normalize_before else None)
    p = _carry(j, pnn.TransformerEncoder(pnn.TransformerEncoderLayer(*args, **kw), 2,
                                         pnn.LayerNorm(D) if normalize_before else None))
    jx, px = _inputs(_x(2, B, S, D))
    _compare(j, p, jx, px, [0])


@pytest.mark.parametrize("normalize_before", [False, True])
def test_transformer_with_the_square_subsequent_mask_matches_jax(normalize_before):
    kw = dict(d_model=D, nhead=H, num_encoder_layers=2, num_decoder_layers=2,
              dim_feedforward=FF, dropout=0.0, normalize_before=normalize_before)
    with numpy_init(3):
        j = jnn.Transformer(**kw)
    p = _carry(j, pnn.Transformer(**kw))
    jm, pm = jnn.Transformer.generate_square_subsequent_mask(T), \
        pnn.Transformer.generate_square_subsequent_mask(T)
    assert_same(pm, jm, (0, 0))
    (js, jt), (ps, pt) = _inputs(_x(4, B, S, D), _x(5, B, T, D))
    _compare(j, p, [js, jt, None, jm], [ps, pt, None, pm], [0, 1])


@pytest.mark.parametrize("mask", ["bool_key_padding", "float", "none"])
def test_multi_head_attention_masks_match_jax(mask):
    with numpy_init(6):
        j = jnn.MultiHeadAttention(D, H, kdim=32, vdim=48)
    p = _carry(j, pnn.MultiHeadAttention(D, H, kdim=32, vdim=48))
    (jq, jk, jv), (pq, pk, pv) = _inputs(_x(7, B, T, D), _x(8, B, S, 32), _x(9, B, S, 48))
    m = None
    if mask == "bool_key_padding":
        m = np.ones((B, 1, 1, S), bool)
        m[1, ..., 20:] = False
    elif mask == "float":
        m = _x(10, B, H, T, S)
    jm = None if m is None else jp.to_tensor(m)
    pm = None if m is None else torch.from_numpy(m)
    _compare(j, p, [jq, jk, jv, jm], [pq, pk, pv, pm], [0, 1, 2])


def test_incremental_and_static_caches_match_jax():
    """Self-attention growing its Cache one token at a time, and the
    decoder layer's cross attention from a StaticCache, step by step."""
    with numpy_init(11):
        j = jnn.MultiHeadAttention(D, H)
    p = _carry(j, pnn.MultiHeadAttention(D, H))
    x = _x(12, B, 4, D)
    jc, pc = j.gen_cache(jp.to_tensor(x)), p.gen_cache(torch.from_numpy(x))
    assert tuple(pc.k.shape) == tuple(jc.k.shape) == (B, 0, H, D // H)
    for t in range(4):
        step = x[:, t:t + 1]
        jo, jc = j(jp.to_tensor(step), cache=jc)
        po, pc = p(torch.from_numpy(step), cache=pc)
        assert_same(po, jo, OUT)
        assert_same(pc.k, jc.k, OUT)
        assert_same(pc.v, jc.v, OUT)
    # the whole sequence at once under a causal mask is the last steps' output
    mem = _x(13, B, S, D)
    js = j.gen_cache(jp.to_tensor(mem), type=jnn.MultiHeadAttention.StaticCache)
    ps = p.gen_cache(torch.from_numpy(mem), type=pnn.MultiHeadAttention.StaticCache)
    assert isinstance(ps, pnn.MultiHeadAttention.StaticCache)
    assert_same(p(torch.from_numpy(x), cache=ps), j(jp.to_tensor(x), cache=js), OUT)


def test_encoder_and_decoder_caches_match_jax():
    with numpy_init(14):
        je = jnn.TransformerEncoder(jnn.TransformerEncoderLayer(D, H, FF, 0.0), 2)
        jd = jnn.TransformerDecoderLayer(D, H, FF, 0.0, normalize_before=True)
    pe = _carry(je, pnn.TransformerEncoder(pnn.TransformerEncoderLayer(D, H, FF, 0.0), 2))
    pd = _carry(jd, pnn.TransformerDecoderLayer(D, H, FF, 0.0, normalize_before=True))
    x = _x(15, B, 3, D)
    jo, jcache = je(jp.to_tensor(x), None, je.gen_cache(jp.to_tensor(x)))
    po, pcache = pe(torch.from_numpy(x), None, pe.gen_cache(torch.from_numpy(x)))
    assert_same(po, jo, OUT)
    assert len(pcache) == len(jcache) == 2
    assert_same(pcache[1].k, jcache[1].k, OUT)
    mem = _x(16, B, S, D)
    jc = (jd.self_attn.gen_cache(jp.to_tensor(x)),)
    pc = (pd.self_attn.gen_cache(torch.from_numpy(x)),)
    for t in range(3):
        step = x[:, t:t + 1]
        jo, jc = jd(jp.to_tensor(step), jp.to_tensor(mem), None, None, jc)
        po, pc = pd(torch.from_numpy(step), torch.from_numpy(mem), None, None, pc)
        assert_same(po, jo, OUT)
    assert tuple(pc[0].k.shape) == (B, 3, H, D // H)


def test_the_stacks_copy_their_first_layer_and_dropout_is_deterministic():
    """Every layer of a stack starts as its first (as in the JAX package);
    in training the dropouts draw from their generators."""
    enc = pnn.TransformerEncoder(pnn.TransformerEncoderLayer(D, H, FF, dropout=0.2), 3)
    a, b = enc.layers[0], enc.layers[2]
    assert a is not b and torch.equal(a.linear1.weight, b.linear1.weight)
    assert a.linear1.weight.data_ptr() != b.linear1.weight.data_ptr()
    x = torch.from_numpy(_x(17, B, 8, D))

    def run(seed):
        for m in enc.modules():
            if hasattr(m, "generator"):
                m.generator = torch.Generator().manual_seed(seed)
        return enc(x)

    enc.train()
    assert torch.equal(run(1), run(1)) and not torch.equal(run(1), run(2))
    enc.eval()
    assert torch.equal(enc(x), enc(x))


def test_the_control_tool_edits_apply_to_the_flash_sources():
    """tools/nn_transformer_control.py, which reads chip_smoke.py's f32
    check of the encoder on the card with the flash kernels' 3xTF32 product
    cut down, names edits that each match mma_sync.cuh exactly once: base
    none, two_term drops one of mma_tf32x3's three passes, one_pass two."""
    from paddle_tpu_torch.tools import nn_transformer_control as tool

    tool.check()
    src = (tool.CSRC / "mma_sync.cuh").read_text()
    passes = src.count("  mma_tf32_all(d, ")
    assert passes == 3
    for name, dropped in (("base", 0), ("two_term", 1), ("one_pass", 2)):
        out = tool.edited(name, {"mma_sync.cuh": src}, tool.VARIANTS)["mma_sync.cuh"]
        assert out.count("  mma_tf32_all(d, ") == passes - dropped
