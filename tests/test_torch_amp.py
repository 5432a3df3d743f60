"""paddle_tpu_torch.amp vs the JAX package's autocast (paddle_tpu/amp and
core/dispatch.py).

- the op lists are the JAX package's, and every op name resolves to the same
  compute dtype under O1, O2 and custom lists;
- each op of the port computes in the dtype its JAX counterpart computes in
  (compared by output dtype, and by value where the output dtype does not
  show it: the fused loss returns f32 either way);
- the gpt_tiny loss and logits under bf16 O1 and O2 match the JAX model's
  on the same weights.

Tolerances: op values under bf16 atol 2e-2 x max|ref| (bf16 rounding of
order-1 values, summed in other orders); the gpt_tiny loss rtol 1e-2 and
logits atol 5e-2 (two layers of bf16 GEMMs; XLA's CPU rounds bf16
elementwise chains, such as gelu, after each op, PyTorch once per op).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core import dispatch as jax_dispatch
from paddle_tpu.models import GPTForPretraining as JaxGPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.ops import activation as jax_act
from paddle_tpu.ops import linalg as JL
from paddle_tpu.ops import nn_functional as JF
from paddle_tpu.ops import reduction as JR
from paddle_tpu.ops.fused import fused_linear_cross_entropy as jax_flce
from paddle_tpu_torch import amp
from paddle_tpu_torch.models import GPTForPretraining, gpt_tiny, load_jax_state
from paddle_tpu_torch.ops import nn_functional as F
from paddle_tpu_torch.ops.fused import fused_linear_cross_entropy as port_flce

_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def test_op_lists_are_the_jax_packages():
    assert amp.AMP_WHITE == frozenset(jax_dispatch.AMP_WHITE)
    assert amp.AMP_BLACK == frozenset(jax_dispatch.AMP_BLACK)


@pytest.mark.parametrize("level", ["O1", "O2"])
@pytest.mark.parametrize("custom", [None, ("white", ["gelu", "mean"]),
                                    ("black", ["linear", "embedding"])])
def test_every_op_name_resolves_like_jax(level, custom):
    kw = {}
    if custom is not None:
        kw["custom_%s_list" % custom[0]] = custom[1]
    names = sorted(amp.AMP_WHITE | amp.AMP_BLACK
                   | {"gelu", "add", "embedding", "dropout",
                      "fused_linear_cross_entropy", "reshape"})
    with paddle.amp.auto_cast(level=level, dtype="bfloat16", **kw):
        want = {n: jax_dispatch._autocast_dtype_for(n, []) for n in names}
    with amp.auto_cast(level=level, dtype="bfloat16", **kw):
        got = {n: amp.autocast_dtype_for(n) for n in names}
    for n in names:
        w = None if want[n] is None else _TORCH[str(np.dtype(want[n]))]
        assert got[n] == w, n
    assert amp.autocast_dtype_for("linear") is None   # no context outside


def test_disabled_and_nested_contexts():
    with amp.auto_cast(dtype="bfloat16"):
        with amp.auto_cast(enable=False):
            assert amp.autocast_dtype_for("linear") is None
        assert amp.autocast_dtype_for("linear") == torch.bfloat16
    assert amp.amp_ctx() is None


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _ops():
    """(name, port fn, jax fn, numpy inputs): each op of the GPT path."""
    x, w, b = _rand(2, 8, 16, seed=1), _rand(12, 16, seed=2), _rand(12, seed=3)
    q, k, v = (_rand(2, 8, 2, 8, seed=s) for s in (4, 5, 6))
    g, bb = _rand(16, seed=7), _rand(16, seed=8)
    ids = np.random.RandomState(9).randint(0, 12, (2, 8))
    return [
        ("linear", lambda x, w, b: F.linear(x, w, b),
         lambda x, w, b: JF.linear(x, paddle.to_tensor(np.asarray(w._data).T), b),
         [x, w, b]),
        ("matmul", lambda x, w: F.matmul(x, w, transpose_y=True),
         lambda x, w: JL.matmul(x, w, transpose_y=True), [x, w]),
        ("attention", lambda q, k, v: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, training=False),
         lambda q, k, v: JF.scaled_dot_product_attention(
             q, k, v, is_causal=True, training=False), [q, k, v]),
        ("layer_norm", lambda x, g, b: F.layer_norm(x, 16, g, b),
         lambda x, g, b: JF.layer_norm(x, 16, g, b), [x, g, bb]),
        ("mean", F.mean, JR.mean, [x]),
        ("gelu", lambda x: F.gelu(x, approximate=True),
         lambda x: jax_act.gelu(x, approximate=True), [x]),
        ("embedding", lambda w: F.embedding(torch.from_numpy(ids), w),
         lambda w: JF.embedding(paddle.to_tensor(ids), w), [w]),
    ]


@pytest.mark.parametrize("level", ["O1", "O2"])
@pytest.mark.parametrize("op", [o[0] for o in _ops()])
def test_each_op_computes_in_the_jax_dtype(level, op):
    name, port_fn, jax_fn, inputs = next(o for o in _ops() if o[0] == op)
    with paddle.amp.auto_cast(level=level, dtype="bfloat16"):
        want = jax_fn(*[paddle.to_tensor(a) for a in inputs])
    with amp.auto_cast(level=level, dtype="bfloat16"):
        got = port_fn(*[torch.from_numpy(a) for a in inputs])
    want_np = np.asarray(want._data.astype("float32"))
    assert got.dtype == _TORCH[str(want._data.dtype)], (name, got.dtype)
    np.testing.assert_allclose(got.float().numpy(), want_np,
                               atol=2e-2 * max(1.0, np.abs(want_np).max()), rtol=0)


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_dropout_keeps_the_dtype_rule(level):
    x = torch.from_numpy(_rand(4, 16, seed=10))
    with paddle.amp.auto_cast(level=level, dtype="bfloat16"):
        want = JF.dropout(paddle.to_tensor(x.numpy()), 0.5, training=True)
    with amp.auto_cast(level=level, dtype="bfloat16"):
        got = F.dropout(x, 0.5, training=True,
                        generator=torch.Generator().manual_seed(0))
    assert got.dtype == _TORCH[str(want._data.dtype)]


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_fused_loss_is_uncast_at_o1_and_bf16_at_o2(level):
    """The JAX package leaves fused_linear_cross_entropy off both lists: at
    O1 it computes in its inputs' f32, at O2 on bf16-cast inputs."""
    h, w = _rand(2, 8, 16, seed=11), _rand(24, 16, seed=12) * 0.5
    labels = np.random.RandomState(13).randint(0, 24, (2, 8))
    with paddle.amp.auto_cast(level=level, dtype="bfloat16"):
        want = np.asarray(jax_flce(paddle.to_tensor(h), paddle.to_tensor(w),
                                   paddle.to_tensor(labels))._data)
    with amp.auto_cast(level=level, dtype="bfloat16"):
        got = port_flce(torch.from_numpy(h), torch.from_numpy(w),
                        torch.from_numpy(labels)).numpy()
    uncast = port_flce(torch.from_numpy(h), torch.from_numpy(w),
                       torch.from_numpy(labels)).numpy()
    if level == "O1":
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
        np.testing.assert_array_equal(got, uncast)
    else:
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
        assert np.abs(got - uncast).max() > 1e-4    # the cast shows


@pytest.fixture(scope="module")
def gpt_pair():
    from paddle_tpu.distributed.mesh import set_hybrid_communicate_group

    set_hybrid_communicate_group(None)
    paddle.seed(0)
    jm = JaxGPT(jax_gpt_tiny())
    state = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    pm = load_jax_state(GPTForPretraining(gpt_tiny(), device="cpu"), state)
    return jm, pm


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_gpt_tiny_under_bf16_matches_jax(gpt_pair, level):
    """At O2 the JAX package also casts the residual adds and reshapes (every
    op off the black list); the port's model leaves those in their input
    dtypes, which moves the loss by ~4e-5 relative on this input."""
    jm, pm = gpt_pair
    rng = np.random.RandomState(14)
    ids = rng.randint(0, 1024, (2, 128)).astype(np.int64)
    labels = np.roll(ids, -1, 1)
    with paddle.amp.auto_cast(level=level, dtype="bfloat16"):
        j_loss = float(jm(paddle.to_tensor(ids), paddle.to_tensor(labels)).item())
        j_logits = np.asarray(jm.logits(paddle.to_tensor(ids))._data
                              .astype("float32"))
    with torch.no_grad(), amp.auto_cast(level=level, dtype="bfloat16"):
        p_loss = pm(torch.from_numpy(ids), torch.from_numpy(labels))
        p_logits = pm.logits(torch.from_numpy(ids))
    assert p_loss.dtype == torch.float32 and p_logits.dtype == torch.bfloat16
    np.testing.assert_allclose(p_loss.item(), j_loss, rtol=1e-2)
    np.testing.assert_allclose(p_logits.float().numpy(), j_logits, atol=5e-2, rtol=0)
    # bf16 moved the loss: the comparison is not an f32 one in disguise
    with torch.no_grad():
        f32_loss = pm(torch.from_numpy(ids), torch.from_numpy(labels)).item()
    assert f32_loss != p_loss.item()


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_gpt_tiny_residual_stream_dtypes_match_jax(gpt_pair, level):
    """The dtype of the embedding sum (the first block's input), of each
    block's output and of the final hidden state, in both packages on the
    same weights. The port leaves the residual adds to PyTorch's promotion
    where the JAX dispatcher casts every op off the black list at O2; both
    give the same dtypes at each point (bf16 through the blocks at O2, f32
    at O1, the final LayerNorm f32)."""
    jm, pm = gpt_pair
    ids = np.random.RandomState(14).randint(0, 1024, (2, 128)).astype(np.int64)
    seen = {"jax": [], "port": []}

    def jax_dtype(t):
        return str(np.dtype(t._data.dtype))

    def port_dtype(t):
        return str(t.dtype).replace("torch.", "")

    hooks = [jm.gpt.blocks[0].register_forward_pre_hook(
        lambda layer, inputs: seen["jax"].append(jax_dtype(inputs[0])))]
    hooks += [b.register_forward_post_hook(
        lambda layer, inputs, out: seen["jax"].append(jax_dtype(out)))
        for b in list(jm.gpt.blocks) + [jm.gpt.ln_f]]
    handles = [pm.gpt.blocks[0].register_forward_pre_hook(
        lambda mod, inputs: seen["port"].append(port_dtype(inputs[0])))]
    handles += [b.register_forward_hook(
        lambda mod, inputs, out: seen["port"].append(port_dtype(out)))
        for b in list(pm.gpt.blocks) + [pm.gpt.ln_f]]
    try:
        with paddle.amp.auto_cast(level=level, dtype="bfloat16"):
            jm.logits(paddle.to_tensor(ids))
        with torch.no_grad(), amp.auto_cast(level=level, dtype="bfloat16"):
            pm.logits(torch.from_numpy(ids))
    finally:
        for h in hooks + handles:
            h.remove()
    inner = "bfloat16" if level == "O2" else "float32"
    n = len(pm.gpt.blocks)
    assert seen["port"] == seen["jax"] == [inner] * (1 + n) + ["float32"]
