"""paddle_tpu_torch flash attention vs the JAX package's Pallas kernel.

On the CPU the port's wrapper takes its plain PyTorch version; the JAX side
runs the Pallas kernel in interpret mode, as tests/test_flash_attention.py
does. Inputs come from numpy with a fixed seed.

Tolerances: f32 atol 2e-5 (the Pallas tests' own bound: same math, other
summation order); bf16 2e-2 x max|o| (p is rounded to bf16 against the
running max in the Pallas kernel and the final max in the plain version).
The kernel itself is held against the plain version on the card by
chip_smoke.py and tests/test_torch_cuda.py.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import _common as jax_common
from paddle_tpu_torch.ops.kernels import _common as port_common
from paddle_tpu_torch.ops.kernels import flash_attention as port_fa

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
