"""NN functional ops of the GPT path (counterpart of paddle_tpu/ops/nn_functional.py
and the ``gelu`` of paddle_tpu/ops/activation.py).

Same numerics as the JAX ops: LayerNorm statistics in f32 with the result
cast back before the affine; attention softmax in f32 cast to q's dtype
before P.V; a bool mask fills -1e9, the dense causal mask fills the dtype's
most negative value. Linear weights use ``nn.Linear``'s ``[out, in]``
layout (the JAX package stores ``[in, out]``; models/convert.py transposes).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as TF

from .kernels import flash_attention as _fa


def linear(x, weight, bias=None):
    """``x @ weight.T + bias`` with an ``[out, in]`` weight."""
    return TF.linear(x, weight, bias)


def embedding(ids, weight, padding_idx=None):
    """Row gather; rows whose id is ``padding_idx`` come out as zeros (the JAX
    op's forward semantics, unlike torch's gradient-only padding_idx)."""
    out = weight[ids]
    if padding_idx is not None:
        out = out.masked_fill((ids == padding_idx).unsqueeze(-1), 0.0)
    return out


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    dims = tuple(range(x.dim() - len(tuple(normalized_shape)), x.dim()))
    xf = x.float()
    mean = xf.mean(dim=dims, keepdim=True)
    var = (xf - mean).square().mean(dim=dims, keepdim=True)
    out = ((xf - mean) * torch.rsqrt(var + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out


def gelu(x, approximate=False):
    return TF.gelu(x, approximate="tanh" if approximate else "none")


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True):
    """Inputs [batch, seq, heads, head_dim] (paddle convention).

    Mask-free attention on a CUDA tensor goes to the flash kernel when
    ``_use_flash`` allows; everything else takes the dense path. Attention
    dropout belongs to training, which is not ported yet."""
    if training and dropout_p > 0.0:
        raise NotImplementedError(
            "attention dropout is a training feature; the port serves and "
            "scores only (call with training=False or dropout_p=0)")
    q, k, v = query, key, value
    scale = 1.0 / math.sqrt(q.shape[-1])
    if attn_mask is None and _use_flash(q, k):
        return _fa.flash_attention(q, k, v, causal=is_causal, sm_scale=scale)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    scores = torch.matmul(qt, kt.transpose(-1, -2)) * scale   # [b, h, sq, sk]
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            scores = scores.masked_fill(~attn_mask, -1e9)
        else:
            scores = scores + attn_mask
    if is_causal:
        sq, sk = scores.shape[-2], scores.shape[-1]
        keep = torch.ones(sq, sk, dtype=torch.bool,
                          device=scores.device).tril()
        scores = scores.masked_fill(~keep, torch.finfo(scores.dtype).min)
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.matmul(probs, vt).transpose(1, 2)


def _use_flash(q, k) -> bool:
    """Route to the flash kernel: CUDA tensors only (the JAX package's
    TPU-backend check), long-enough sequences, the supported tiling, a head
    dim the kernel is built for, f32 or bf16."""
    sq, sk, d = q.shape[1], k.shape[1], q.shape[-1]
    return (q.is_cuda and sq >= 128 and sk >= 128
            and _fa.supported(sq, sk, d) and d in _fa.HEAD_DIMS
            and q.dtype in (torch.float32, torch.bfloat16))
