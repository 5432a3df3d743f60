"""NN functional ops of the GPT path (counterpart of paddle_tpu/ops/nn_functional.py,
the ``gelu`` of paddle_tpu/ops/activation.py and the ``matmul`` / ``mean`` of
paddle_tpu/ops/linalg.py and reduction.py).

Same numerics as the JAX ops: LayerNorm statistics in f32 with the result
cast back before the affine; attention softmax in f32 cast to q's dtype
before P.V; a bool mask fills -1e9, the dense causal mask fills the dtype's
most negative value. Linear weights use ``nn.Linear``'s ``[out, in]``
layout (the JAX package stores ``[in, out]``; models/convert.py transposes).

Each op looks itself up under ``amp.auto_cast`` by the JAX op name and casts
its float inputs as the JAX dispatcher does. Dropout draws its keep mask
from an explicit ``torch.Generator`` (on the tensor's device): the masks
differ from the JAX package's threefry bits by design, and are held to
their statistics and to determinism instead.
"""
from __future__ import annotations

import contextlib
import math
import threading

import torch
import torch.nn.functional as TF

from ..amp import cast_inputs
from .kernels import flash_attention as _fa


def linear(x, weight, bias=None):
    """``x @ weight.T + bias`` with an ``[out, in]`` weight."""
    x, weight, bias = cast_inputs("linear", x, weight, bias)
    return TF.linear(x, weight, bias)


def matmul(x, y, transpose_y=False):
    x, y = cast_inputs("matmul", x, y)
    if transpose_y:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


def mean(x):
    """Mean over every element (``paddle.mean`` with no axis)."""
    (x,) = cast_inputs("mean", x)
    return x.mean()


def embedding(ids, weight, padding_idx=None):
    """Row gather; rows whose id is ``padding_idx`` come out as zeros (the JAX
    op's forward semantics, unlike torch's gradient-only padding_idx)."""
    (weight,) = cast_inputs("embedding", weight)
    out = weight[ids]
    if padding_idx is not None:
        out = out.masked_fill((ids == padding_idx).unsqueeze(-1), 0.0)
    return out


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
    x, weight, bias = cast_inputs("layer_norm", x, weight, bias)
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
    (x,) = cast_inputs("gelu", x)
    return TF.gelu(x, approximate="tanh" if approximate else "none")


_draw = threading.local()


@contextlib.contextmanager
def draw_source(state):
    """Dropout inside the block draws from ``state.generator(device)`` in
    preference to the generator its caller passes (the RNG tracker's
    ``rng_state``, distributed/meta_parallel/parallel_layers.py)."""
    prev = getattr(_draw, "state", None)
    _draw.state = state
    try:
        yield
    finally:
        _draw.state = prev


def current_draw_source():
    """The draw source ``draw_source`` installed, or None."""
    return getattr(_draw, "state", None)


def _keep_mask(shape, keep, device, generator):
    """Bernoulli(keep) as ``uniform < keep`` (jax.random.bernoulli's form)."""
    state = getattr(_draw, "state", None)
    if state is not None:
        generator = state.generator(device)
    return torch.rand(shape, generator=generator, device=device) < keep


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            generator=None):
    """paddle's dropout. ``upscale_in_train`` scales kept values by 1/(1-p) in
    training and is the identity otherwise; ``downscale_in_infer`` keeps
    values as they are in training and scales by (1-p) otherwise. ``axis``
    draws one keep decision per index of those axes (broadcast over the
    rest). ``generator``: the torch.Generator the mask comes from (torch's
    default one when None)."""
    if mode not in ("upscale_in_train", "downscale_in_infer"):
        raise ValueError(f"unknown dropout mode {mode!r}")
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            (x,) = cast_inputs("dropout_scale", x)
            return x * (1 - p)
        return x
    (x,) = cast_inputs("dropout", x)
    if p == 1.0:
        return torch.zeros_like(x)
    shape = list(x.shape)
    if axis is not None:
        axes = [axis] if isinstance(axis, int) else list(axis)
        shape = [s if i in axes else 1 for i, s in enumerate(shape)]
    keep = _keep_mask(shape, 1.0 - p, x.device, generator)
    if mode == "upscale_in_train":
        return torch.where(keep, x / (1.0 - p), 0.0).to(x.dtype)
    return torch.where(keep, x, 0.0).to(x.dtype)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, generator=None):
    """Inputs [batch, seq, heads, head_dim] (paddle convention).

    Inside a sequence-parallel scope (distributed/meta_parallel/
    sequence_parallel.py) mask-free attention without dropout goes to the
    scope's ring or Ulysses attention over the ranks' sequence shards, as
    in the JAX package; a mask or dropout there raises (each rank holds
    only its own positions). Otherwise mask-free attention without dropout
    goes to the flash kernels when ``_use_flash`` allows (CUDA tensors);
    everything else takes the dense path. Attention dropout (training only)
    drops attention weights, as paddle does, from ``generator``."""
    q, k, v, attn_mask = cast_inputs("attention", query, key, value, attn_mask)
    attn_dropout = dropout_p if training else 0.0
    from ..distributed.meta_parallel import sequence_parallel as _sp

    if _sp.active():
        if attn_mask is not None or attn_dropout != 0.0:
            raise NotImplementedError(
                "attention with a mask or dropout under sequence parallelism: each "
                "rank holds only its positions and the ring and Ulysses kernels take "
                "neither (ROADMAP.md Queue 1 item 9)")
        return _sp.apply_ring_attention(q, k, v, causal=is_causal)
    scale = 1.0 / math.sqrt(q.shape[-1])
    if attn_mask is None and attn_dropout == 0.0 and _use_flash(q, k):
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
    if attn_dropout > 0.0:
        keep = 1.0 - attn_dropout
        mask = _keep_mask(probs.shape, keep, probs.device, generator)
        probs = torch.where(mask, probs / keep, 0.0).to(probs.dtype)
    return torch.matmul(probs, vt).transpose(1, 2)


def _use_flash(q, k) -> bool:
    """Route to the flash kernel: CUDA tensors only (the JAX package's
    TPU-backend check), long-enough sequences, the supported tiling, a head
    dim the kernel is built for, f32 or bf16."""
    sq, sk, d = q.shape[1], k.shape[1], q.shape[-1]
    return (q.is_cuda and sq >= 128 and sk >= 128
            and _fa.supported(sq, sk, d) and d in _fa.HEAD_DIMS
            and q.dtype in (torch.float32, torch.bfloat16))
