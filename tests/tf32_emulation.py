"""Plain emulation of the port's 3xTF32 tensor-core products, shared by the
CPU tests of the kernels that use them (tests/test_torch_lm_loss.py, the
LM-loss forward and backward at f32 h; tests/test_torch_flash_attention.py,
the flash forward and the FA2 backward pair at f32): what each kernel's f32
results rest on, checked against the JAX package's f32 results without a
card."""
import torch

# The card holds a 3xTF32 kernel's f32 gradients, and the f32 flash
# forward's o, to this limit on ||got - ref||_F / ||ref||_F against the plain
# f32 version (chip_smoke.py and tests/test_torch_cuda.py:
# GRAD_F32_FROB_TOL; the flash kernels' per (b, h) head).
GRAD_F32_FROB_TOL = 5e-6


def tf32_split(x):
    """x = big + small as the kernels hand them to the TF32 tensor cores
    (``split_tf32`` in csrc/mma_sync.cuh), emulated by bit operations on the
    int32 view: big is x rounded to TF32 at mantissa bit 13, to nearest with
    ties away from zero (0x1000 added to the bits, the low 13 dropped, as
    cvt.rna.tf32.f32 rounds); small = x - big exactly, with its low 13 bits
    dropped as the tensor core drops them. (Ties to even would differ on one
    value in 8192, by one TF32 step.)"""
    bits = x.contiguous().view(torch.int32)
    big = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    small = ((x - big).contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)
    return big, small


def tf32_product(a, b, terms):
    """a @ b (batched as torch.matmul) as the kernels' TF32 mma.sync passes
    give it: each operand split by ``tf32_split``; ``terms`` 3 sums a_small
    b_big + a_big b_small + a_big b_big (3xTF32), 2 drops a_small b_big, 1
    is a_big b_big alone. A TF32 product is exact in f32; the sums here are
    f32 matmuls (the kernels add short tensor-core sums in f32 too)."""
    a_big, a_small = tf32_split(a)
    b_big, b_small = tf32_split(b)
    out = torch.zeros(())
    if terms == 3:
        out = out + a_small @ b_big
    if terms >= 2:
        out = out + a_big @ b_small
    return out + a_big @ b_big


def tf32_sliced_product(a, b, slices, terms):
    """a @ b as the cluster route of the LM-loss backward gives it: the
    contraction dim cut into ``slices`` ([(start, end)], one a CTA of the
    cluster), each slice's product by ``tf32_product``, and the partials
    added in f32 in rank order (the first, then each next one)."""
    out = None
    for lo, hi in slices:
        part = tf32_product(a[..., lo:hi], b[..., lo:hi, :], terms)
        out = part if out is None else out + part
    return out
