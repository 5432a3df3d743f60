"""Flash-attention forward (counterpart of paddle_tpu/ops/pallas/flash_attention.py).

``flash_attention`` / ``flash_attention_with_lse`` take paddle's
``[b, s, h, d]`` layout, as the JAX entry points do. On a CUDA tensor they
launch the hand-written kernel ``csrc/flash_attention_fwd.cu`` (or raise);
on a CPU tensor they take ``flash_attention_plain``, the same arithmetic in
plain PyTorch. ``launches`` counts kernel launches.

Forward only: the FA2 backward kernels come with the training slice. Blocks
are fixed by the kernel (64 x 64 tiles); the TPU package's block autotune
has no counterpart.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ._common import NEG_INF, pick_block

#: kernel launches since import (chip_smoke.py resets and reads it)
launches = 0

HEAD_DIMS = (32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def supported(seq_q: int, seq_k: int, head_dim: int) -> bool:
    """The routing predicate of the JAX package, kept so both packages send
    the same shapes to the kernel: at least 8 rows, 8-aligned tiles and
    head_dim. The CUDA kernel itself masks ragged lengths; it takes the
    head dims in ``HEAD_DIMS``."""
    return (
        seq_q >= 8
        and seq_k >= 8
        and pick_block(seq_q) % 8 == 0
        and pick_block(seq_k) % 8 == 0
        and head_dim % 8 == 0
    )


def flash_attention_plain(q, k, v, causal: bool = False,
                          sm_scale: float | None = None):
    """The kernel's arithmetic in plain PyTorch, on any device.
    q, k, v: [b, s, h, d]. Returns (o [b, sq, h, d] in q's dtype,
    lse [b, h, sq] f32)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf = (x.transpose(1, 2).float() for x in (q, k, v))
    s = torch.matmul(qf, kf.transpose(-1, -2)) * sm_scale
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        keep = torch.ones(sq, sk, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    l = l.masked_fill(l == 0, 1.0)  # a fully masked row gives 0, not NaN
    o = torch.matmul(p.to(v.dtype).float(), vf) / l
    lse = (m + torch.log(l))[..., 0]
    return o.to(q.dtype).transpose(1, 2).contiguous(), lse


def _kernel():
    global _fn
    if _fn is None:
        from . import _build

        fn = _build.load("flash_attention_fwd").flash_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.c_longlong] * 12
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(q, k, v):
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("q, k and v must be on one device")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q, k, v of "
                        f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4:
        raise ValueError(f"q must be [b, s, h, d], got {tuple(q.shape)}")
    b, _, h, d = q.shape
    sk = k.shape[1]
    if tuple(k.shape) != (b, sk, h, d) or tuple(v.shape) != (b, sk, h, d):
        raise ValueError(f"k and v must be [{b}, sk, {h}, {d}], got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"the CUDA kernel takes head_dim in {HEAD_DIMS}, got {d}")
    if sk == 0:
        raise ValueError("flash_attention needs at least one key")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in its last dim")


def _launch(q, k, v, causal, sm_scale):
    global launches
    _check(q, k, v)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), _DTYPE_CODES[q.dtype], d, b, h, sq, sk,
                 q.stride(0), q.stride(1), q.stride(2),
                 k.stride(0), k.stride(1), k.stride(2),
                 v.stride(0), v.stride(1), v.stride(2),
                 o.stride(0), o.stride(1), o.stride(2),
                 float(sm_scale), int(bool(causal)), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed with CUDA "
                           f"error {err}")
    launches += 1
    return o, lse


def flash_attention_with_lse(q, k, v, causal: bool = False,
                             sm_scale: float | None = None):
    """q, k, v: [b, s, h, d]. Returns (out [b, sq, h, d], lse [b, h, sq] f32).
    The causal mask is top-left aligned (query i sees keys 0..i)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.is_cuda:
        return _launch(q, k, v, causal, sm_scale)
    return flash_attention_plain(q, k, v, causal, sm_scale)


def flash_attention(q, k, v, causal: bool = False,
                    sm_scale: float | None = None):
    """q, k, v: [b, s, h, d] (paddle layout). Returns [b, sq, h, d]."""
    return flash_attention_with_lse(q, k, v, causal, sm_scale)[0]
