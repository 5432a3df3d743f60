"""The port's autograd API (``grad``, ``backward``, ``PyLayer``, the grad
modes), AMP through the namespace, and the slice as one piece, against the
JAX package on the CPU.

The whole slice: chip_smoke.py's decoder block (``tensor_api_block``, GPT-2's
pre-LN block written only in the namespace's functions) run through
``paddle_tpu`` and through ``paddle_tpu_torch`` at 2 heads, hidden 64,
sequence 32, from the same numpy weights, with an LM head on top: logits
and every gradient within 2e-5 / 2e-6 (rtol / atol, f32; sums in other
orders through two matmuls and a softmax) and 1e-4 / 1e-5 for the
gradients. The port's block is also held to GPTBlock.forward on the same
weights (the model's own route) within 1e-5 relative Frobenius error in the
output and every gradient.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from torch_api_util import assert_same, np_of, on_cpu, run_case  # noqa: F401

torch.set_num_threads(1)

pytestmark = pytest.mark.usefixtures("on_cpu")

ROOT = Path(__file__).resolve().parents[1]
F32 = (2e-5, 2e-6)
GRAD = (1e-4, 1e-5)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---- grad ----

def _both(fn, *arrays):
    """fn(P, *tensors) in both packages on tensors that require grad."""
    jx = [jp.to_tensor(a, stop_gradient=False) for a in arrays]
    tx = [tp.to_tensor(a, stop_gradient=False) for a in arrays]
    return fn(jp, *jx), fn(tp, *tx), jx, tx


def test_grad_of_a_composite_matches():
    a = np.random.RandomState(0).standard_normal((3, 4)).astype(np.float32)
    b = np.random.RandomState(1).standard_normal((4, 2)).astype(np.float32)

    def f(P, x, y):
        z = P.tanh(P.matmul(x, y))
        return P.grad(P.sum(P.multiply(z, z)), [x, y])

    jg, tg, _, _ = _both(f, a, b)
    assert_same(tg, jg, GRAD)


def test_grad_create_graph_gives_a_second_derivative():
    a = np.array([0.5, -1.0, 2.0], np.float32)

    def f(P, x):
        (g,) = P.grad(P.sum(P.multiply(P.multiply(x, x), x)), [x], create_graph=True)
        return P.grad(P.sum(g), [x])

    jg, tg, _, _ = _both(f, a)
    assert_same(tg, jg, GRAD)
    np.testing.assert_allclose(np_of(tg[0]), 6 * a, rtol=1e-6)


def test_grad_outputs_retain_graph_and_allow_unused():
    a = np.arange(3, dtype=np.float32)
    v = np.array([1.0, -2.0, 0.5], np.float32)
    for P in (jp, tp):
        x = P.to_tensor(a, stop_gradient=False)
        u = P.to_tensor(a, stop_gradient=False)
        y = P.multiply(x, 3.0)
        (g,) = P.grad([y], [x], grad_outputs=[P.to_tensor(v)], retain_graph=True)
        np.testing.assert_allclose(np_of(g), 3 * v)
        (g2,) = P.grad(y, x, grad_outputs=P.to_tensor(v))      # the graph was kept
        np.testing.assert_allclose(np_of(g2), 3 * v)
        with pytest.raises(RuntimeError):
            P.grad(P.sum(P.multiply(x, 2.0)), [x, u])
        gx, gu = P.grad(P.sum(P.multiply(x, 2.0)), [x, u], allow_unused=True)
        assert gu is None and np.allclose(np_of(gx), 2.0)


def test_grad_holds_no_grad_vars_constant():
    x = tp.to_tensor([1.0, 2.0], stop_gradient=False)
    y = tp.multiply(x, x)
    z = tp.sum(tp.multiply(y, x))                   # x^3, through y = x^2
    (g,) = tp.grad(z, [x], no_grad_vars=[y])        # y constant: dz/dx = y
    assert g.tolist() == [1.0, 4.0]
    (g,) = tp.grad(tp.sum(tp.multiply(tp.multiply(x, x), x)), [x])
    assert g.tolist() == [3.0, 12.0]
    # the JAX package holds a tensor constant by stop_gradient; the same numbers
    jx = jp.to_tensor([1.0, 2.0], stop_gradient=False)
    jy = jp.multiply(jx, jx).detach()
    (jg,) = jp.grad(jp.sum(jp.multiply(jy, jx)), [jx])
    assert np_of(jg).tolist() == [1.0, 4.0]


def test_backward_accumulates_into_grad():
    a = np.array([[1.0, -2.0], [0.5, 3.0]], np.float32)
    outs = []
    for P in (jp, tp):
        x = P.to_tensor(a, stop_gradient=False)
        P.autograd.backward([P.sum(P.exp(x))])
        P.autograd.backward(P.sum(P.multiply(x, 2.0)))
        outs.append(x.grad)
    assert_same(outs[1], outs[0], GRAD)
    y = tp.to_tensor([1.0, 2.0], stop_gradient=False)
    tp.autograd.backward([tp.multiply(y, 2.0)], [tp.to_tensor([1.0, 10.0])])
    assert y.grad.tolist() == [2.0, 20.0]
    with pytest.raises(RuntimeError):
        tp.autograd.backward(tp.to_tensor([1.0]))


def test_to_tensor_stop_gradient_maps_to_requires_grad():
    assert tp.to_tensor([1.0]).requires_grad is False
    assert tp.to_tensor([1.0], stop_gradient=False).requires_grad is True
    t = torch.ones(2, requires_grad=True)
    c = tp.to_tensor(t)
    assert c.requires_grad is False and c.data_ptr() != t.data_ptr()


def test_grad_modes():
    x = tp.to_tensor([1.0], stop_gradient=False)
    assert tp.is_grad_enabled()
    with tp.no_grad():
        assert not tp.is_grad_enabled() and not tp.multiply(x, 2.0).requires_grad
        with tp.enable_grad():
            assert tp.multiply(x, 2.0).requires_grad
        with tp.set_grad_enabled(True):
            assert tp.is_grad_enabled()
    with tp.set_grad_enabled(False):
        assert not tp.is_grad_enabled()

    @tp.no_grad()
    def f(v):
        return tp.multiply(v, 2.0)

    assert not f(x).requires_grad and tp.is_grad_enabled()
    for name in ("no_grad", "enable_grad", "set_grad_enabled", "is_grad_enabled", "grad",
                 "backward", "PyLayer", "PyLayerContext"):
        assert hasattr(tp.autograd, name), name
    with jp.no_grad():
        assert not jp.is_grad_enabled()


# ---- PyLayer ----

def _exp_layer(P):
    class Exp(P.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x, scale=1.0):
            y = P.exp(P.multiply(x, scale))
            ctx.save_for_backward(y)
            ctx.scale = scale
            return y

        @staticmethod
        def backward(ctx, dy):
            (y,) = ctx.saved_tensor      # the reference's is an attribute
            return P.multiply(P.multiply(dy, y), ctx.scale)

    return Exp


def test_pylayer_forward_and_backward_match():
    a = np.array([0.1, -0.3, 1.2], np.float32)

    def f(P, x):
        y = _exp_layer(P).apply(x, scale=2.0)
        return [y, *P.grad(P.sum(P.multiply(y, y)), [x])]

    jg, tg, _, _ = _both(f, a)
    assert_same(tg, jg, GRAD)


def test_pylayer_two_outputs_non_tensor_args_and_a_none_grad():
    class Split(tp.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x, k, w):
            ctx.save_for_backward(x, w)
            return tp.multiply(x, k), tp.multiply(w, x)

        @staticmethod
        def backward(ctx, da, db):
            x, w = ctx.saved_tensor()    # Paddle's method form, which the port takes too
            assert list(ctx.saved_tensors()) == [x, w]
            return tp.add(tp.multiply(da, 3.0), tp.multiply(db, w)), None

    x = tp.to_tensor([1.0, 2.0], stop_gradient=False)
    w = tp.to_tensor([5.0, 7.0], stop_gradient=False)
    a, b = Split.apply(x, 3.0, w)
    assert a.tolist() == [3.0, 6.0] and b.tolist() == [5.0, 14.0]
    gx, gw = tp.grad(tp.add(tp.sum(a), tp.sum(b)), [x, w], allow_unused=True)
    assert gx.tolist() == [8.0, 10.0] and gw is None
    with tp.no_grad():
        assert not Split.apply(x, 3.0, w)[0].requires_grad
    assert tp.autograd.LegacyPyLayer is tp.autograd.PyLayer


# ---- AMP through the namespace ----

AMP_CASES = [
    # (op, build, level, the JAX package's dtype, checked against it)
    ("matmul", lambda r: [r.arr((3, 4)), r.arr((4, 2))], "O1"),
    ("add", lambda r: [r.arr((3, 4)), r.arr((3, 4))], "O1"),
    ("add", lambda r: [r.arr((3, 4)), r.arr((3, 4))], "O2"),
    ("multiply", lambda r: [r.arr((3, 4)), 2.0], "O2"),
    ("exp", lambda r: [r.arr((3, 4), "bf16")], "O1"),
    ("softmax", lambda r: [r.arr((3, 4), "bf16")], "O1"),
    ("mean", lambda r: [r.arr((3, 4), "bf16")], "O2"),
    ("sum", lambda r: [r.arr((3, 4), "bf16")], "O1"),
    ("einsum", lambda r: ["ij,jk->ik", r.arr((3, 4)), r.arr((4, 2))], "O1"),
    ("relu", lambda r: [r.arr((3, 4))], "O2"),
    ("tanh", lambda r: [r.arr((3, 4))], "O1"),
    ("rsqrt", lambda r: [r.arr((3, 4), "pos")], "O2"),
    ("concat", lambda r: [__import__("torch_api_util").L([r.arr((2, 4)), r.arr((1, 4))])],
     "O2"),
]


@pytest.mark.parametrize("name,build,level", AMP_CASES,
                         ids=[f"{c[0]}-{c[2]}-{i}" for i, c in enumerate(AMP_CASES)])
def test_amp_dtypes_through_the_namespace(name, build, level):
    """Under auto_cast every op of the namespace looks itself up by its JAX
    name: matmul is bf16 at O1, a black-listed op f32, add bf16 at O2."""

    def jf(*a, **k):
        with jp.amp.auto_cast(dtype="bfloat16", level=level):
            return getattr(jp, name)(*a, **k)

    def tf(*a, **k):
        with tp.amp.auto_cast(dtype="bfloat16", level=level):
            return getattr(tp, name)(*a, **k)

    run_case((jf, tf), build, tol=(1e-2, 1e-2))


def test_amp_matmul_o1_is_bf16_and_add_o2_is_bf16():
    x = tp.ones([2, 2])
    with tp.amp.auto_cast(dtype="bfloat16"):
        assert tp.matmul(x, x).dtype == torch.bfloat16
        assert tp.add(x, x).dtype == torch.float32
        assert tp.exp(x.bfloat16()).dtype == torch.float32
    with tp.amp.auto_cast(dtype="bfloat16", level="O2"):
        assert tp.add(x, x).dtype == torch.bfloat16
        assert tp.mean(x.bfloat16()).dtype == torch.float32


# ---- the slice as one piece: the decoder block ----

HID, HEADS, SEQ, BATCH, VOCAB = 64, 2, 32, 2, 50


def _block_params(rng):
    def w(*shape, scale=0.05):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return {"ln1.weight": 1 + w(HID), "ln1.bias": w(HID),
            "attn.qkv_proj.weight": w(3 * HID, HID), "attn.qkv_proj.bias": w(3 * HID),
            "attn.out_proj.weight": w(HID, HID), "attn.out_proj.bias": w(HID),
            "ln2.weight": 1 + w(HID), "ln2.bias": w(HID),
            "mlp.fc1.weight": w(4 * HID, HID), "mlp.fc1.bias": w(4 * HID),
            "mlp.fc2.weight": w(HID, 4 * HID), "mlp.fc2.bias": w(HID)}


def _logits_and_grads(P, block, x, params, wte, cot):
    xt = P.to_tensor(x, stop_gradient=False)
    pt = {k: P.to_tensor(v, stop_gradient=False) for k, v in params.items()}
    et = P.to_tensor(wte, stop_gradient=False)
    logits = P.matmul(block(P, xt, pt, HEADS), et, transpose_y=True)
    loss = P.sum(P.multiply(logits, P.to_tensor(cot)))
    return logits, P.grad(loss, [xt, et, *pt.values()])


def test_the_decoder_block_in_both_namespaces():
    block = _chip_smoke().tensor_api_block
    rng = np.random.RandomState(0)
    params = _block_params(rng)
    x = rng.standard_normal((BATCH, SEQ, HID)).astype(np.float32)
    wte = (rng.standard_normal((VOCAB, HID)) * 0.05).astype(np.float32)
    cot = rng.standard_normal((BATCH, SEQ, VOCAB)).astype(np.float32)
    jl, jg = _logits_and_grads(jp, block, x, params, wte, cot)
    tl, tg = _logits_and_grads(tp, block, x, params, wte, cot)
    assert_same(tl, jl, F32, "logits")
    assert len(tg) == len(jg) == 14
    for name, g, want in zip(["x", "wte", *params], tg, jg):
        assert_same(g, want, GRAD, "d" + name)


def test_the_namespace_block_is_gptblock():
    """chip_smoke.py's block against the model's own GPTBlock.forward (f32
    plain attention on the CPU) on GPTBlock's weights."""
    from paddle_tpu_torch.models import GPTConfig, GPTForPretraining

    block_fn = _chip_smoke().tensor_api_block
    cfg = GPTConfig(vocab_size=VOCAB, hidden_size=HID, num_layers=1, num_heads=HEADS,
                    max_seq_len=SEQ)
    blk = GPTForPretraining(cfg, seed=0).gpt.blocks[0].eval()
    params = dict(blk.named_parameters())
    x = torch.from_numpy(np.random.RandomState(3).standard_normal(
        (BATCH, SEQ, HID)).astype(np.float32)).requires_grad_(True)
    w = torch.from_numpy(np.random.RandomState(4).standard_normal(
        (BATCH, SEQ, HID)).astype(np.float32))
    out = block_fn(tp, x, params, HEADS)
    ref = blk(x)
    grads = tp.grad(tp.sum(tp.multiply(out, w)), [x, *params.values()])
    ref_grads = torch.autograd.grad((ref * w).sum(), [x, *params.values()])
    rel = lambda a, b: ((a - b).norm() / b.norm()).item()   # noqa: E731
    assert rel(out, ref) < 1e-5
    for name, g, r in zip(["x", *params], grads, ref_grads):
        assert rel(g, r) < 1e-5, name


def test_the_chip_table_covers_every_function_of_the_namespace():
    cs = _chip_smoke()
    names = {c[0] for c in cs.tensor_api_cases()}
    assert cs.tensor_api_namespace_names() <= names
    assert {"svd", "qr", "eig", "eigh", "lu"} <= {c[0] for c in cs.tensor_api_cases()
                                                  if c[3] == "decomposition"}
    assert {"rand", "randn", "multinomial", "poisson"} <= {
        c[0] for c in cs.tensor_api_cases() if c[3] == "random"}
