"""paddle_tpu_torch on the card: kernels against their plain versions, and the
model and engine on CUDA against the same weights on the CPU.

Every test here needs a CUDA card and skips without one. The file imports
neither jax nor paddle_tpu, so on the card it runs without the repository's
conftest (which loads jax):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Inputs come from numpy with fixed seeds. Tolerances: f32 1e-4 (summation
order; TF32 is turned off), bf16 2e-2 x max|o| (p rounds to bf16 against the
running max in the kernel and the final max in the plain version).
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.models import GPTForPretraining, gpt_tiny
from paddle_tpu_torch.ops.kernels import flash_attention as fa
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
    with torch.no_grad():
        got = gpu(ids.to(cuda))
    torch.cuda.synchronize()
    assert fa.launches == cfg.num_layers
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
