"""paddle_tpu_torch GPT vs the JAX package's GPT on the same weights.

The JAX ``gpt_tiny`` model is built from ``paddle.seed(0)`` and its weights
are carried into the port by models/convert.py. Inputs come from numpy with
a fixed seed. Tolerance: f32 atol 1e-4 on logits and hidden states (two
layers of f32 matmuls summed in another order; observed ~2e-6).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.models import GPTForPretraining as JaxGPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu_torch.models import (GPTForPretraining, gpt_tiny, load_jax_state,
                                     state_from_jax)
from torch_api_util import jax_flags_restored  # noqa: F401

ATOL = 1e-4


@pytest.fixture(scope="module")
def models():
    from paddle_tpu.distributed.mesh import set_hybrid_communicate_group

    set_hybrid_communicate_group(None)
    paddle.seed(0)
    jm = JaxGPT(jax_gpt_tiny())
    jm.eval()
    state = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    pm = load_jax_state(GPTForPretraining(gpt_tiny(), device="cpu"), state)
    pm.requires_grad_(False)   # the parameters are trainable; these tests score
    return jm, pm, state


def _ids(b, s, seed=0):
    return np.random.RandomState(seed).randint(0, 1024, (b, s)).astype(np.int64)


def test_state_names_and_layouts(models):
    jm, pm, state = models
    port_state = pm.state_dict()
    assert set(port_state) == set(state)
    converted = state_from_jax(state)
    for name, arr in state.items():
        if name.endswith(("qkv_proj.weight", "out_proj.weight", "fc1.weight",
                          "fc2.weight")):
            assert tuple(converted[name].shape) == arr.shape[::-1]
            np.testing.assert_array_equal(converted[name].numpy(), arr.T)
        else:
            np.testing.assert_array_equal(converted[name].numpy(), arr)


def test_logits_match_jax_dense_route(models):
    jm, pm, _ = models
    ids = _ids(2, 128)
    want = np.asarray(jm(paddle.to_tensor(ids))._data)
    got = pm(torch.from_numpy(ids))
    assert got.shape == (2, 128, 1024)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(pm.logits(torch.from_numpy(ids)).numpy(), want,
                               atol=ATOL, rtol=0)


def test_logits_match_jax_flash_route(models, jax_flags_restored):
    """JAX routed through the interpreted Pallas flash kernel (s = 128 meets
    its routing rule) against the port's CPU path."""
    jm, pm, _ = models
    paddle.set_flags({"use_flash_attention": True, "pallas_interpret_ok": True})
    ids = _ids(1, 128, seed=1)
    want = np.asarray(jm(paddle.to_tensor(ids))._data)
    got = pm(torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def _jax_caches(kcs, vcs, off):
    import jax.numpy as jnp

    return [(Tensor(jnp.asarray(kc)), Tensor(jnp.asarray(vc)), Tensor(off))
            for kc, vc in zip(kcs, vcs)]


@pytest.mark.parametrize("mode,s", [("per_row", 1), ("per_row", 3), ("scalar", 4)])
def test_cached_step_matches_jax(models, mode, s):
    """One cached step over random cache contents: per-row offsets (the
    serving decode) and a scalar offset (the prefill), same hidden states
    and same updated caches."""
    import jax.numpy as jnp

    jm, pm, _ = models
    cfg = pm.config
    b, T = 2, 16
    nh, hd = cfg.num_heads, cfg.hidden_size // cfg.num_heads
    rng = np.random.RandomState(2)
    kcs = [rng.randn(b, T, nh, hd).astype(np.float32) for _ in range(cfg.num_layers)]
    vcs = [rng.randn(b, T, nh, hd).astype(np.float32) for _ in range(cfg.num_layers)]
    ids = _ids(b, s, seed=3)
    if mode == "per_row":
        off = np.array([3, 11], np.int32)
        j_off, p_off = jnp.asarray(off), torch.from_numpy(off.astype(np.int64))
    else:
        off = 5
        j_off, p_off = jnp.int32(off), off

    jh, jc = jm.gpt(paddle.to_tensor(ids), caches=_jax_caches(kcs, vcs, j_off))
    pc = [(torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy()), p_off)
          for kc, vc in zip(kcs, vcs)]
    with torch.no_grad():
        ph, pc_new = pm.gpt(torch.from_numpy(ids), caches=pc)
    np.testing.assert_allclose(ph.numpy(), np.asarray(jh._data), atol=ATOL, rtol=0)
    for (jk, jv, joff), (pk, pv, poff) in zip(jc, pc_new):
        np.testing.assert_allclose(pk.numpy(), np.asarray(jk._data), atol=ATOL, rtol=0)
        np.testing.assert_allclose(pv.numpy(), np.asarray(jv._data), atol=ATOL, rtol=0)
        np.testing.assert_array_equal(np.asarray(poff), np.asarray(joff._data))


def test_labels_path_is_not_ported(models):
    """The labels path is ported now (it was refused in the first slice):
    forward(ids, labels) is the mean fused LM loss, equal to JAX's and to
    the cross entropy of the logits, ignored positions counting as 0."""
    import torch.nn.functional as TF

    jm, pm, _ = models
    ids = _ids(2, 16, seed=4)
    labels = np.roll(ids, -1, 1)
    labels[:, -1] = -100
    want = float(jm(paddle.to_tensor(ids), paddle.to_tensor(labels)).item())
    with torch.no_grad():
        got = pm(torch.from_numpy(ids), torch.from_numpy(labels))
        logits = pm(torch.from_numpy(ids))
    assert got.shape == () and got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), want, rtol=1e-5)
    ce = TF.cross_entropy(logits.reshape(-1, 1024), torch.from_numpy(labels).reshape(-1),
                          ignore_index=-100, reduction="sum") / labels.size
    np.testing.assert_allclose(got.item(), ce.item(), rtol=1e-5)


def test_seeded_init_is_deterministic():
    a = GPTForPretraining(gpt_tiny(), device="cpu", seed=7)
    b = GPTForPretraining(gpt_tiny(), device="cpu", seed=7)
    c = GPTForPretraining(gpt_tiny(), device="cpu", seed=8)
    wa, wb, wc = (m.gpt.blocks[0].attn.qkv_proj.weight for m in (a, b, c))
    assert torch.equal(wa, wb) and not torch.equal(wa, wc)
    assert all(p.requires_grad for p in a.parameters())   # trainable
    assert torch.equal(a.gpt.ln_f.weight, torch.ones(128))
    assert torch.equal(a.gpt.ln_f.bias, torch.zeros(128))


def test_initial_draws_depend_on_the_shapes_and_seed_alone():
    """draw_normals: the same values on one thread and on four, and drawn
    into a given tensor; every block of DRAW_BLOCK entries of rows has its
    own generator; N(0, 0.02)."""
    from paddle_tpu_torch.models.gpt import DRAW_BLOCK, draw_normals

    rows = DRAW_BLOCK // 64
    shapes = [(2 * rows + 5, 64), (7, 3)]
    threads = torch.get_num_threads()
    try:
        torch.set_num_threads(1)
        one = draw_normals(shapes, 3)
        torch.set_num_threads(4)
        into = torch.empty(shapes[0])
        four = draw_normals(shapes, 3, out=[into, None])
    finally:
        torch.set_num_threads(threads)
    assert four[0] is into
    assert all(torch.equal(a, b) for a, b in zip(one, four))
    assert not torch.equal(draw_normals(shapes, 4)[1], one[1])
    blocks = one[0].split(rows)
    assert [b.shape[0] for b in blocks] == [rows, rows, 5]
    assert not torch.equal(blocks[0][:5], blocks[1][:5])
    assert abs(one[0].std().item() - 0.02) < 1e-4 and abs(one[0].mean().item()) < 1e-4
