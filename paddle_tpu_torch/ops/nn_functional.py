"""NN functional ops (counterpart of paddle_tpu/ops/nn_functional.py, the
``matmul`` / ``mean`` of paddle_tpu/ops/linalg.py and reduction.py and the
``flatten`` of manipulation.py; the activations are ops/activation.py's):
the GPT path's, and the vision and encoder path's convolutions, pools,
batch norm and losses (Paddle's semantics as the JAX ops compute them,
PyTorch inside; convolutions, pools and batch norm run as PyTorch's own
calls, as the JAX package lowers them to XLA's, outside any Pallas kernel).

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

The pools take ``ceil_mode`` and ignore it, as the JAX op does (its
``reduce_window`` gives floor's output length); ``divisor_override`` too.
Paddle's ``exclusive=True`` is torch's ``count_include_pad=False``.
Convolutions at a channel-last ``data_format`` take the JAX op's HWIO
weight. The port sets no TF32 policy of its own: PyTorch's defaults hold
on the card, f32 matrix products in full f32 and f32 convolutions through
cuDNN in TF32 (``torch.backends.cudnn.allow_tf32``); chip_smoke.py turns
both off for its card-vs-CPU checks and times the f32 ResNet both ways. Reductions over the batch axis are global inside a
``batch_group_scope`` (the engine's data-parallel step).
"""
from __future__ import annotations

import contextlib
import itertools
import math
import threading

import numpy as np

import torch
import torch.nn.functional as TF

from ..amp import cast_inputs
from .activation import softmax, tanh  # noqa: F401 (tanh: paddle F.tanh, for the models)
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


# ---------------------------------------------------------------------------
# The vision and encoder ops (counterpart of paddle_tpu/ops/nn_functional.py
# :33-350, :529-803, :1056-1095 and paddle_tpu/ops/manipulation.py's flatten)
# ---------------------------------------------------------------------------

_CHANNEL_LAST = ("NHWC", "NWC", "NDHWC", "NLC")


def flatten(x, start_axis=0, stop_axis=-1):
    nd = max(x.dim(), 1)
    return x.flatten(start_axis % nd, stop_axis % nd) if x.dim() else x.reshape(1)


# ---------- batch-axis reductions over the replicas ----------

_batch = threading.local()


@contextlib.contextmanager
def batch_group_scope(group):
    """Inside the block, reductions over the batch axis run over ``group``'s
    ranks, each holding its rows of the global batch: ``batch_norm``'s
    batch statistics (and the running statistics it updates), and the
    data-dependent denominators of ``cross_entropy`` and ``nll_loss``'s
    means (the valid labels, the label weights), so that the mean over the
    ranks of each rank's loss is the global batch's loss. The JAX engine
    gets this from running the model on the global batch under pjit; the
    port's engine enters the scope over its replica group."""
    prev = getattr(_batch, "group", None)
    _batch.group = group if group is not None and group.nranks > 1 else None
    try:
        yield
    finally:
        _batch.group = prev


def batch_group():
    """The group ``batch_group_scope`` installed (None outside one, or for
    a group of one rank)."""
    return getattr(_batch, "group", None)


class _AllReduceSum(torch.autograd.Function):
    """Sum over ``group`` forward; the gradient summed over it backward (each
    rank's sum feeds every rank's loss)."""

    @staticmethod
    def forward(ctx, x, group):
        from ..distributed import collective

        ctx.group = group
        return collective.all_reduce(x.clone(memory_format=torch.contiguous_format),
                                     group=group)

    @staticmethod
    def backward(ctx, g):
        from ..distributed import collective

        return collective.all_reduce(g.clone(memory_format=torch.contiguous_format),
                                     group=ctx.group), None


def _global_sum(x):
    """``x`` summed over the batch group (autograd-aware), or ``x``."""
    group = batch_group()
    return x if group is None else _AllReduceSum.apply(x, group)


def _global_denominator(denom, guard=None):
    """A rank's denominator of a mean over the batch as the global one over
    the ranks' count: summed over the batch group, ``guard`` applied (the
    op's guard against an empty batch: to the global count, never to a
    rank's), divided by the group's size (no gradient), so that the ranks'
    mean of ``local_sum / denominator`` is the global mean."""
    group = batch_group()
    if group is None:
        return denom if guard is None else guard(denom)
    from ..distributed import collective

    d = collective.all_reduce(denom.detach().clone(memory_format=torch.contiguous_format),
                              group=group)
    return (d if guard is None else guard(d)) / group.nranks


def _at_least_one(d):
    return torch.clamp(d, min=1)


def _zero_to_one(d):
    return d + (d == 0).to(d.dtype)


# ---------- convolution ----------

def _ntuple(v, n):
    if isinstance(v, (int, float)):
        return (int(v),) * n
    v = tuple(int(x) for x in v)
    return v * n if len(v) == 1 else v


def _pads(padding, nd, spatial, window, stride, dilation):
    """Paddle's padding forms as [(lo, hi)] per spatial dim: an int, one int
    a dim, 2 nd ints (each dim's lo and hi), (lo, hi) pairs, or "SAME" /
    "VALID" (XLA's SAME: out = ceil(in / stride), the odd pad on the high
    side)."""
    if isinstance(padding, str):
        mode = padding.upper()
        if mode == "VALID":
            return [(0, 0)] * nd
        if mode != "SAME":
            raise ValueError(f"unknown padding {padding!r}")
        out = []
        for i in range(nd):
            n_out = -(-spatial[i] // stride[i])
            eff = (window[i] - 1) * dilation[i] + 1
            total = max((n_out - 1) * stride[i] + eff - spatial[i], 0)
            out.append((total // 2, total - total // 2))
        return out
    if isinstance(padding, int):
        return [(padding, padding)] * nd
    padding = list(padding)
    if len(padding) == nd and all(isinstance(p, int) for p in padding):
        return [(p, p) for p in padding]
    if len(padding) == 2 * nd and all(isinstance(p, int) for p in padding):
        return [(padding[2 * i], padding[2 * i + 1]) for i in range(nd)]
    return [tuple(int(q) for q in p) for p in padding]


def _torch_pad(pads):
    """[(lo, hi)] per spatial dim -> F.pad's order (last dim first)."""
    flat = []
    for lo, hi in reversed(pads):
        flat += [lo, hi]
    return flat


_CONV = {1: TF.conv1d, 2: TF.conv2d, 3: TF.conv3d}


def _convnd(name, nd, x, weight, bias, stride, padding, dilation, groups, data_format):
    x, weight, bias = cast_inputs(name, x, weight, bias)
    channel_last = data_format in _CHANNEL_LAST
    if channel_last:
        # the JAX op's layouts at channel-last: NHWC input and HWIO weight
        x = x.movedim(-1, 1)
        weight = weight.permute(nd + 1, nd, *range(nd))
    stride, dilation = _ntuple(stride, nd), _ntuple(dilation, nd)
    pads = _pads(padding, nd, x.shape[2:], weight.shape[2:], stride, dilation)
    if all(lo == hi for lo, hi in pads):
        out = _CONV[nd](x, weight, bias, stride, [lo for lo, _ in pads], dilation, groups)
    else:
        out = _CONV[nd](TF.pad(x, _torch_pad(pads)), weight, bias, stride, 0, dilation,
                        groups)
    return out.movedim(1, -1) if channel_last else out


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL"):
    return _convnd("conv1d", 1, x, weight, bias, stride, padding, dilation, groups,
                   "NWC" if data_format == "NLC" else "NCW")


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW"):
    """Paddle's conv2d: ``x`` NCHW with an OIHW ``weight`` ([out, in / groups,
    kh, kw]), or NHWC with the JAX op's HWIO weight."""
    return _convnd("conv2d", 2, x, weight, bias, stride, padding, dilation, groups,
                   data_format)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW"):
    return _convnd("conv3d", 3, x, weight, bias, stride, padding, dilation, groups,
                   data_format)


_CONV_T = {1: TF.conv_transpose1d, 2: TF.conv_transpose2d, 3: TF.conv_transpose3d}


def _conv_transpose(name, nd, x, weight, bias, stride, padding, output_padding, dilation,
                    groups, data_format):
    """The JAX op's transposed convolution: weight ``[in, out / groups, *k]``
    (torch's layout too), ``padding`` cut from the full result at the low
    end and ``padding - output_padding`` at the high end (a negative cut
    pads zeros), the bias added after. The JAX op takes neither a
    channel-last ``data_format`` nor a string padding (its lax call
    refuses both), so neither does this one."""
    if data_format in _CHANNEL_LAST:
        raise ValueError(f"{name}: data_format {data_format!r} is not supported (the JAX "
                         "op builds an OIHW kernel for an HWIO convolution)")
    if isinstance(padding, str):
        raise ValueError(f"{name}: string padding {padding!r} is not supported")
    x, weight, bias = cast_inputs(name, x, weight, bias)
    stride, dilation = _ntuple(stride, nd), _ntuple(dilation, nd)
    out_pad = _ntuple(output_padding or 0, nd)
    pads = _pads(padding, nd, x.shape[2:], weight.shape[2:], stride, dilation)
    full = _CONV_T[nd](x, weight, None, stride, 0, 0, groups, dilation)
    cut = []
    for i, (lo, hi) in enumerate(pads):
        size = full.shape[2 + i]
        cut.append((lo, size - hi + out_pad[i]))
    extra = [(max(-a, 0), max(b - full.shape[2 + i], 0)) for i, (a, b) in enumerate(cut)]
    if any(e != (0, 0) for e in extra):
        full = TF.pad(full, _torch_pad(extra))
        cut = [(a + lo, b + lo) for (a, b), (lo, _) in zip(cut, extra)]
    out = full[(slice(None), slice(None)) + tuple(slice(a, b) for a, b in cut)]
    return out if bias is None else out + bias.reshape((1, -1) + (1,) * nd)


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0, output_padding=0, groups=1,
                     dilation=1, output_size=None, data_format="NCL"):
    """``output_size`` is accepted and not read, as in the JAX op."""
    return _conv_transpose("conv1d_transpose", 1, x, weight, bias, stride, padding,
                           output_padding, dilation, groups,
                           "NWC" if data_format == "NLC" else "NCW")


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0, output_padding=0, groups=1,
                     dilation=1, output_size=None, data_format="NCHW"):
    """``output_size`` is accepted and not read, as in the JAX op."""
    return _conv_transpose("conv2d_transpose", 2, x, weight, bias, stride, padding,
                           output_padding, dilation, groups, data_format)


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0, output_padding=0, groups=1,
                     dilation=1, output_size=None, data_format="NCDHW"):
    """``output_size`` is accepted and not read, as in the JAX op."""
    return _conv_transpose("conv3d_transpose", 3, x, weight, bias, stride, padding,
                           output_padding, dilation, groups, data_format)


# ---------- pooling ----------

_MAX_POOL = {1: TF.max_pool1d, 2: TF.max_pool2d, 3: TF.max_pool3d}
_AVG_POOL = {1: TF.avg_pool1d, 2: TF.avg_pool2d, 3: TF.avg_pool3d}


def _pool(name, x, kernel_size, stride, padding, nd, reducer, data_format,
          exclusive=True):
    """Max or average over windows, as the JAX package's ``_pool`` (its
    ``reduce_window``): padded positions never win a max and, with
    ``exclusive``, do not count in an average. ``ceil_mode`` and
    ``divisor_override`` are accepted by the callers and ignored, as the
    JAX op ignores them (the output length is floor's)."""
    (x,) = cast_inputs(name, x)
    channel_last = data_format in _CHANNEL_LAST
    if channel_last:
        x = x.movedim(-1, 1)
    ks = _ntuple(kernel_size, nd)
    st = _ntuple(stride if stride is not None else kernel_size, nd)
    pads = _pads(padding, nd, x.shape[2:], ks, st, (1,) * nd)
    symmetric = all(lo == hi and lo <= k // 2 for (lo, hi), k in zip(pads, ks))
    if reducer == "max":
        if symmetric:
            out = _MAX_POOL[nd](x, ks, st, [lo for lo, _ in pads])
        else:
            out = _MAX_POOL[nd](TF.pad(x, _torch_pad(pads), value=-math.inf), ks, st)
    elif symmetric:
        out = _AVG_POOL[nd](x, ks, st, [lo for lo, _ in pads],
                            count_include_pad=not exclusive)
    else:
        window = math.prod(ks)
        s = _AVG_POOL[nd](TF.pad(x, _torch_pad(pads)), ks, st) * window
        if exclusive:
            ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype, device=x.device)
            out = s / (_AVG_POOL[nd](TF.pad(ones, _torch_pad(pads)), ks, st) * window)
        else:
            out = s / window
    return out.movedim(1, -1) if channel_last else out


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False, ceil_mode=False,
               data_format="NCL"):
    if return_mask:
        return _max_pool_with_indices("max_pool1d_with_index", x, kernel_size, stride,
                                      padding, 1)
    return _pool("max_pool1d", x, kernel_size, stride, padding, 1, "max",
                 "NWC" if data_format == "NLC" else "NCW")


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False, ceil_mode=False,
               data_format="NCHW"):
    if return_mask:
        return _max_pool_with_indices("max_pool2d_with_index", x, kernel_size, stride,
                                      padding, 2)
    return _pool("max_pool2d", x, kernel_size, stride, padding, 2, "max", data_format)


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False, ceil_mode=False,
               data_format="NCDHW"):
    if return_mask:
        return _max_pool_with_indices("max_pool3d_with_index", x, kernel_size, stride,
                                      padding, 3)
    return _pool("max_pool3d", x, kernel_size, stride, padding, 3, "max", data_format)


def _max_pool_with_indices(name, x, kernel_size, stride, padding, nd):
    """(max, index) of each window of an NC... tensor, as the JAX op: the
    index is the flat position in the unpadded spatial plane of the window's
    first maximum; the input is padded by ``padding`` before and
    ``padding + kernel`` after with the lowest value (``data_format`` and
    ``ceil_mode`` are not read). The gradient of a window's max is shared by
    its tied maxima (``amax``, as ``jnp.max``)."""
    (x,) = cast_inputs(name, x)
    ks = _ntuple(kernel_size, nd)
    st = _ntuple(stride if stride is not None else kernel_size, nd)
    pd = _ntuple(padding, nd)
    in_sz = x.shape[2:]
    out_sz = [(in_sz[i] + 2 * pd[i] - ks[i]) // st[i] + 1 for i in range(nd)]
    low = -math.inf if x.is_floating_point() else torch.iinfo(x.dtype).min
    xp = TF.pad(x, _torch_pad([(p, p + k) for p, k in zip(pd, ks)]), value=low)
    offsets = list(itertools.product(*[range(k) for k in ks]))
    patches = [xp[(slice(None), slice(None))
                  + tuple(slice(o[i], o[i] + out_sz[i] * st[i], st[i]) for i in range(nd))]
               for o in offsets]
    stacked = torch.stack(patches, -1)                      # [N, C, *out, K]
    vals = stacked.amax(-1)
    karg = stacked.argmax(-1)                               # the first maximum
    off = torch.tensor(offsets, dtype=torch.int64, device=x.device)     # [K, nd]
    flat = torch.zeros(karg.shape, dtype=torch.int64, device=x.device)
    mult = 1
    for i in range(nd - 1, -1, -1):
        shape = [1] * nd
        shape[i] = out_sz[i]
        pos = torch.arange(out_sz[i], device=x.device).reshape(shape) * st[i]
        flat = flat + (pos + off[:, i][karg] - pd[i]) * mult
        mult *= in_sz[i]
    return vals, flat


def _max_unpool(name, x, indices, kernel_size, stride, padding, output_size, nd):
    """Each value of ``x`` written at its flat ``indices`` of a zero plane
    ``output_size`` (by default ``(in - 1) stride - 2 padding + kernel``);
    an index past the plane is dropped, as the JAX op's scatter drops it."""
    (x,) = cast_inputs(name, x)
    ks = _ntuple(kernel_size, nd)
    st = _ntuple(stride if stride is not None else kernel_size, nd)
    pd = _ntuple(padding, nd)
    in_sz = x.shape[2:]
    if output_size is None:
        out_sz = [(in_sz[i] - 1) * st[i] - 2 * pd[i] + ks[i] for i in range(nd)]
    else:
        out_sz = [int(s) for s in list(output_size)[-nd:]]
    n, c, size = x.shape[0], x.shape[1], math.prod(out_sz)
    idx = indices.reshape(n, c, -1).to(device=x.device, dtype=torch.int64)
    idx = torch.where((idx >= 0) & (idx < size), idx, size)    # past the plane: dropped
    out = torch.zeros((n, c, size + 1), dtype=x.dtype, device=x.device)
    out = out.scatter(2, idx, x.reshape(n, c, -1))[..., :size]
    return out.reshape([n, c] + out_sz)


def max_unpool1d(x, indices, kernel_size, stride=None, padding=0, data_format="NCL",
                 output_size=None):
    return _max_unpool("max_unpool1d", x, indices, kernel_size, stride, padding,
                       output_size, 1)


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0, data_format="NCHW",
                 output_size=None):
    return _max_unpool("max_unpool2d", x, indices, kernel_size, stride, padding,
                       output_size, 2)


def max_unpool3d(x, indices, kernel_size, stride=None, padding=0, data_format="NCDHW",
                 output_size=None):
    return _max_unpool("max_unpool3d", x, indices, kernel_size, stride, padding,
                       output_size, 3)


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True, ceil_mode=False,
               data_format="NCL"):
    return _pool("avg_pool1d", x, kernel_size, stride, padding, 1, "avg",
                 "NWC" if data_format == "NLC" else "NCW", exclusive)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False, exclusive=True,
               divisor_override=None, data_format="NCHW"):
    return _pool("avg_pool2d", x, kernel_size, stride, padding, 2, "avg", data_format,
                 exclusive)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False, exclusive=True,
               divisor_override=None, data_format="NCDHW"):
    return _pool("avg_pool3d", x, kernel_size, stride, padding, 3, "avg", data_format,
                 exclusive)


def _adaptive(name, x, output_size, nd, reducer, channel_last=False):
    """Adaptive pooling over the last nd spatial dims: window i of an axis
    spans [floor(i in / out), ceil((i + 1) in / out)), as in the JAX op; an
    output size of None keeps the input's."""
    (x,) = cast_inputs(name, x)
    if channel_last:
        x = x.movedim(-1, 1)
    if output_size is None or isinstance(output_size, int):
        out_sz = (output_size,) * nd
    else:
        out_sz = tuple(output_size)
        out_sz = out_sz * nd if len(out_sz) == 1 else out_sz
    spatial = x.shape[-nd:]
    out_sz = tuple(spatial[i] if out_sz[i] is None else int(out_sz[i]) for i in range(nd))
    fn = {("avg", 1): TF.adaptive_avg_pool1d, ("avg", 2): TF.adaptive_avg_pool2d,
          ("avg", 3): TF.adaptive_avg_pool3d, ("max", 1): TF.adaptive_max_pool1d,
          ("max", 2): TF.adaptive_max_pool2d, ("max", 3): TF.adaptive_max_pool3d}
    out = fn[(reducer, nd)](x, out_sz)
    return out.movedim(1, -1) if channel_last else out


def adaptive_avg_pool1d(x, output_size):
    return _adaptive("adaptive_avg_pool1d", x, output_size, 1, "avg")


def adaptive_avg_pool2d(x, output_size, data_format="NCHW"):
    return _adaptive("adaptive_avg_pool2d", x, output_size, 2, "avg",
                     data_format == "NHWC")


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW"):
    return _adaptive("adaptive_avg_pool3d", x, output_size, 3, "avg")


def adaptive_max_pool1d(x, output_size, return_mask=False):
    out = _adaptive("adaptive_max_pool1d", x, output_size, 1, "max")
    return (out, None) if return_mask else out


def adaptive_max_pool2d(x, output_size, return_mask=False):
    out = _adaptive("adaptive_max_pool2d", x, output_size, 2, "max")
    return (out, None) if return_mask else out


def adaptive_max_pool3d(x, output_size, return_mask=False):
    out = _adaptive("adaptive_max_pool3d", x, output_size, 3, "max")
    return (out, None) if return_mask else out


# ---------- normalization ----------

def batch_norm(x, running_mean, running_var, weight=None, bias=None, training=False,
               momentum=0.9, epsilon=1e-5, data_format="NCHW", use_global_stats=None):
    """Paddle's batch_norm, as the JAX package's eager op: in training (and
    not ``use_global_stats``) x is normalized by its batch mean and biased
    variance, and the running statistics are updated in place, ``momentum``
    being the share kept (Paddle's 0.9 is torch's 0.1): ``running = m
    running + (1 - m) batch``, with the unbiased batch variance. Otherwise
    the running statistics normalize and nothing is updated. Inside a
    ``batch_group_scope`` the batch statistics are those of the ranks'
    whole batch (autograd-aware all-reduces of the per-rank sums, then of
    the squared deviations), so every rank updates the same running
    statistics. Black-listed under amp: f32 statistics and output."""
    x, weight, bias = cast_inputs("batch_norm", x, weight, bias)
    ch = x.dim() - 1 if data_format in _CHANNEL_LAST else (1 if x.dim() > 1 else 0)
    axes = tuple(i for i in range(x.dim()) if i != ch)
    shape = [1] * x.dim()
    shape[ch] = x.shape[ch]
    if training and not use_global_stats:
        n = x.numel() // x.shape[ch]
        group = batch_group()
        if group is None:
            mean = x.mean(dim=axes)
            var = (x - mean.reshape(shape)).square().mean(dim=axes)
        else:
            n *= group.nranks      # the engine hands every rank equal rows
            mean = _global_sum(x.sum(dim=axes)) / n
            var = _global_sum((x - mean.reshape(shape)).square().sum(dim=axes)) / n
        with torch.no_grad():
            if running_mean is not None:
                running_mean.mul_(momentum).add_((1 - momentum) * mean.detach())
            if running_var is not None:
                unbiased = var.detach() * (n / max(n - 1, 1))
                running_var.mul_(momentum).add_((1 - momentum) * unbiased)
    else:
        mean, var = running_mean, running_var
    out = (x - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape) + epsilon)
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out


# ---------- losses ----------

def _reduce_loss(loss, reduction):
    if reduction == "mean":
        return mean(loss)
    if reduction == "sum":
        (loss,) = cast_inputs("sum", loss)
        return loss.sum()
    return loss


def _sum(x):
    (x,) = cast_inputs("sum", x)
    return x.sum()


def one_hot(x, num_classes):
    """f32 one-hot rows (an id outside [0, num_classes) gives a row of
    zeros, as jax.nn.one_hot does)."""
    return (x.unsqueeze(-1) == torch.arange(num_classes, device=x.device)).float()


def label_smooth(label, prior_dist=None, epsilon=0.1):
    if prior_dist is not None:
        return (1 - epsilon) * label + epsilon * prior_dist
    return (1 - epsilon) * label + epsilon / label.shape[-1]


def softmax_with_cross_entropy(logits, label, soft_label=False, ignore_index=-100,
                               numeric_stable_mode=True, return_softmax=False, axis=-1):
    """Per-position loss, kept dim at ``axis``: log-softmax in f32, 0 at
    ``ignore_index``; cast back to the logits' dtype (f32 under amp, where
    the op is black-listed)."""
    lg, label = cast_inputs("softmax_with_cross_entropy", logits, label)
    lsm = torch.log_softmax(lg.float(), dim=axis)
    if soft_label:
        loss = -(label * lsm).sum(dim=axis, keepdim=True)
    else:
        lb = label.to(device=lg.device, dtype=torch.long)
        if lb.dim() == lg.dim():
            lb = lb.squeeze(axis)
        ignored = (lb == ignore_index).unsqueeze(axis)
        picked = lsm.gather(axis, lb.masked_fill(ignored.squeeze(axis), 0).unsqueeze(axis))
        loss = (-picked).masked_fill(ignored, 0.0)
    loss = loss.to(lg.dtype)
    if return_softmax:
        return loss, softmax(logits, axis=axis)
    return loss


def cross_entropy(input, label, weight=None, ignore_index=-100, reduction="mean",
                  soft_label=False, axis=-1, use_softmax=True, label_smoothing=0.0):
    """Paddle's cross_entropy, as the JAX op computes it: hard or soft labels,
    ``weight`` per class, ``label_smoothing`` (padding rows stay out of the
    loss and of the mean), ``use_softmax=False`` for probabilities, and a
    "mean" over the valid labels (hard labels; over the label weights when
    ``weight`` is given). Inside a ``batch_group_scope`` those denominators
    are the global ones."""
    nd = input.dim()
    ax = axis % nd
    smoothed_ignore = None
    if label_smoothing > 0.0 and not soft_label:
        if label.dim() == nd and label.shape[ax] == 1:
            label = label.squeeze(ax)
        smoothed_ignore = (label == ignore_index).float()
        label = label_smooth(one_hot(label, input.shape[axis]), epsilon=label_smoothing)
        if ax != nd - 1:
            label = label.movedim(-1, ax)
        soft_label = True

    if not use_softmax:
        p, lb = cast_inputs("cross_entropy_prob", input, label)
        logp = torch.log(torch.clamp(p, 1e-10, 1.0))
        if soft_label:
            loss = -(lb * logp).sum(dim=axis, keepdim=True)
        else:
            lb = lb.to(torch.long)
            lb = lb if lb.dim() < nd else lb.squeeze(axis)
            ignored = (lb == ignore_index).unsqueeze(axis)
            loss = -logp.gather(axis, lb.masked_fill(ignored.squeeze(axis), 0).unsqueeze(axis))
            loss = loss.masked_fill(ignored, 0.0)
    else:
        loss = softmax_with_cross_entropy(input, label, soft_label=soft_label,
                                          ignore_index=ignore_index, axis=axis)

    if weight is not None and soft_label:
        shape = [1] * label.dim()
        shape[axis % label.dim()] = label.shape[axis % label.dim()]
        wg = (label * weight.reshape(shape)).sum(dim=axis, keepdim=True)
        if smoothed_ignore is not None:
            wg = wg * (1.0 - smoothed_ignore).reshape(wg.shape)
        loss = loss * wg
        if reduction == "mean":
            return _sum(loss) / _global_denominator(_sum(wg), _zero_to_one)
        return _reduce_loss(loss, reduction)

    if smoothed_ignore is not None:
        keep = 1.0 - smoothed_ignore
        loss = loss * keep.reshape(loss.shape)
        if reduction == "mean":
            return _sum(loss) / _global_denominator(_sum(keep), _zero_to_one)
        return _reduce_loss(loss, reduction)

    lbl = None
    if not soft_label:
        lbl = label.to(device=loss.device, dtype=torch.long)
        lbl = lbl if lbl.dim() < nd else lbl.squeeze(axis)
    if weight is not None:
        w = weight.to(loss.device)[lbl.masked_fill(lbl == ignore_index, 0)][..., None]
        loss = loss * w
        if reduction == "mean":
            valid = (lbl != ignore_index).to(loss.dtype)[..., None]
            return _sum(loss) / _global_denominator(_sum(w * valid))

    if reduction == "mean" and not soft_label:
        denom = (lbl != ignore_index).sum().to(loss.dtype)
        return _sum(loss) / _global_denominator(denom, _at_least_one)
    return _reduce_loss(loss, reduction)


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean"):
    """Negative log-likelihood of log-probabilities ``[N, C, ...]`` at the
    labels ``[N, ...]``; 0 at ``ignore_index``. "mean" is over every
    position without ``weight`` (the JAX op's), over the valid labels'
    weights with it."""
    lp, weight = cast_inputs("nll_loss", input, weight)
    lb = label.to(device=lp.device, dtype=torch.long)
    ignored = lb == ignore_index
    safe = lb.masked_fill(ignored, 0)
    picked = -lp.gather(1, safe.unsqueeze(1)).squeeze(1)
    if weight is not None:
        picked = picked * weight[safe]
    loss = picked.masked_fill(ignored, 0.0)
    if reduction == "mean" and weight is not None:
        return _sum(loss) / _global_denominator(_sum(weight[safe] * ~ignored))
    return _reduce_loss(loss, reduction)


def mse_loss(input, label, reduction="mean"):
    a, b = cast_inputs("mse_loss", input, label)
    return _reduce_loss((a - b).square(), reduction)


def l1_loss(input, label, reduction="mean"):
    a, b = cast_inputs("l1_loss", input, label)
    return _reduce_loss((a - b).abs(), reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0):
    a, b = cast_inputs("smooth_l1_loss", input, label)
    d = (a - b).abs()
    return _reduce_loss(torch.where(d < delta, 0.5 * d * d / delta, d - 0.5 * delta),
                        reduction)


def binary_cross_entropy(input, label, weight=None, reduction="mean"):
    p, lb, weight = cast_inputs("binary_cross_entropy", input, label, weight)
    p = torch.clamp(p, 1e-12, 1.0 - 1e-12)
    loss = -(lb * torch.log(p) + (1 - lb) * torch.log1p(-p))
    if weight is not None:
        loss = loss * weight
    return _reduce_loss(loss, reduction)


def binary_cross_entropy_with_logits(logit, label, weight=None, reduction="mean",
                                     pos_weight=None):
    z, lb, weight, pos_weight = cast_inputs("bce_with_logits", logit, label, weight,
                                            pos_weight)
    if pos_weight is not None:
        log_w = (pos_weight - 1) * lb + 1
        loss = (1 - lb) * z + log_w * (torch.log1p(torch.exp(-z.abs()))
                                       + torch.clamp(-z, min=0))
    else:
        loss = torch.clamp(z, min=0) - z * lb + torch.log1p(torch.exp(-z.abs()))
    if weight is not None:
        loss = loss * weight
    return _reduce_loss(loss, reduction)


def kl_div(input, label, reduction="mean"):
    lp, t = cast_inputs("kl_div", input, label)
    loss = t * (torch.log(torch.clamp(t, min=1e-12)) - lp)
    if reduction == "batchmean":
        return _sum(loss) / input.shape[0]
    return _reduce_loss(loss, reduction)


def builtins_max(a, b):
    return a if a > b else b


# ---------------------------------------------------------------------------
# The rest of the JAX module (paddle_tpu/ops/nn_functional.py:386-475,
# :501-526, :803-850, :941-1051, :1182-1565): norms, dropouts, resizing and
# the spatial ops, the remaining losses and sparse attention
# ---------------------------------------------------------------------------

# ---------- normalization ----------

def rms_norm(x, weight=None, epsilon=1e-6):
    """x / sqrt(mean(x^2) + eps) over the last axis, in f32 and cast back
    before the weight."""
    x, weight = cast_inputs("rms_norm", x, weight)
    xf = x.float()
    out = (xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + epsilon)).to(x.dtype)
    return out if weight is None else out * weight


def group_norm(x, num_groups, weight=None, bias=None, epsilon=1e-5, data_format="NCHW"):
    x, weight, bias = cast_inputs("group_norm", x, weight, bias)
    channel_last = data_format in _CHANNEL_LAST
    a = x.movedim(-1, 1) if channel_last else x
    n, c = a.shape[0], a.shape[1]
    g = a.reshape((n, num_groups, c // num_groups) + tuple(a.shape[2:]))
    axes = tuple(range(2, g.dim()))
    m = g.mean(axes, keepdim=True)
    v = (g - m).square().mean(axes, keepdim=True)
    out = ((g - m) * torch.rsqrt(v + epsilon)).reshape(a.shape)
    shape = [1, c] + [1] * (a.dim() - 2)
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out.movedim(1, -1) if channel_last else out


def instance_norm(x, running_mean=None, running_var=None, weight=None, bias=None,
                  use_input_stats=True, momentum=0.9, eps=1e-5, data_format="NCHW"):
    """Each (sample, channel) plane by its own statistics; the running
    statistics, ``use_input_stats``, ``momentum`` and ``data_format`` are
    not read, as in the JAX op."""
    x, weight, bias = cast_inputs("instance_norm", x, weight, bias)
    axes = tuple(range(2, x.dim()))
    m = x.mean(axes, keepdim=True)
    v = (x - m).square().mean(axes, keepdim=True)
    out = (x - m) * torch.rsqrt(v + eps)
    shape = [1, x.shape[1]] + [1] * (x.dim() - 2)
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0, data_format="NCHW"):
    """x / (k + alpha * sum of x^2 over the ``size`` channels around)^beta
    (channels on axis 1 whatever ``data_format``; alpha is not divided by
    size), as in the JAX op."""
    (x,) = cast_inputs("local_response_norm", x)
    half = size // 2
    pads = [0, 0] * (x.dim() - 2) + [half, size - half - 1]
    sq = TF.pad(x.square(), pads)
    win = sum(sq.narrow(1, i, x.shape[1]) for i in range(size))
    return x / torch.pow(k + alpha * win, beta)


def normalize(x, p=2, axis=1, epsilon=1e-12):
    (x,) = cast_inputs("normalize", x)
    n = torch.pow(torch.pow(x.abs(), p).sum(axis, keepdim=True), 1.0 / p)
    return x / torch.clamp(n, min=epsilon)


# ---------- dropouts ----------

def dropout2d(x, p=0.5, training=True, data_format="NCHW", generator=None):
    """One keep decision a (sample, channel)."""
    return dropout(x, p, axis=[0, 1 if data_format == "NCHW" else 3], training=training,
                   generator=generator)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", generator=None):
    return dropout(x, p, axis=[0, 1 if data_format == "NCDHW" else 4], training=training,
                   generator=generator)


def alpha_dropout(x, p=0.5, training=True, generator=None):
    """SELU-preserving dropout: dropped values become -alpha scale, then an
    affine map keeps the mean and variance; the mask from ``generator``."""
    if not training or p == 0.0:
        return x
    (x,) = cast_inputs("alpha_dropout", x)
    alpha_p = -1.6732632423543772 * 1.0507009873554805
    keep = _keep_mask(tuple(x.shape), 1.0 - p, x.device, generator)
    a_coef = (1.0 - p + p * alpha_p ** 2) ** -0.5
    b_coef = -a_coef * p * alpha_p
    return (a_coef * torch.where(keep, x, alpha_p) + b_coef).to(x.dtype)


# ---------- resizing and the spatial ops ----------

def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


_RESIZE_KERNELS = {"linear": lambda x: np.maximum(0.0, 1.0 - np.abs(x)), "cubic": _keys_cubic}


def _resize_weights(n_in, n_out, method):
    """jax.image.resize's [n_in, n_out] f64 weights of one axis (its
    scale_and_translate at scale n_out / n_in, no translation): half-pixel
    sample points, the kernel widened by 1 / scale when shrinking
    (antialiasing), each column normalized, samples outside the input
    zeroed."""
    inv = 1.0 / (n_out / n_in) if n_out else 1.0
    sample = (np.arange(n_out, dtype=np.float64) + 0.5) * inv - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float64)[:, None]) / max(inv, 1.0)
    w = _RESIZE_KERNELS[method](x)
    total = w.sum(0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0)


_INTERP_METHOD = {"nearest": "nearest", "bilinear": "linear", "linear": "linear",
                  "trilinear": "linear", "bicubic": "cubic", "area": "linear"}


def interpolate(x, size=None, scale_factor=None, mode="nearest", align_corners=False,
                align_mode=0, data_format="NCHW"):
    """The JAX op: ``jax.image.resize`` of the spatial axes. "nearest" takes
    input index floor((i + 0.5) in / out) (half-pixel centres: torch's
    "nearest-exact"); the others are separable weighted sums with
    jax.image's weights (``_resize_weights``): triangle for
    "linear" / "bilinear" / "trilinear" and for "area", Keys cubic (a =
    -0.5) for "bicubic", antialiased when shrinking. ``align_corners`` and
    ``align_mode`` are accepted and not read."""
    (x,) = cast_inputs("interpolate", x)
    nd = x.dim() - 2
    axes = list(range(1, 1 + nd)) if data_format in _CHANNEL_LAST else list(range(2, 2 + nd))
    in_sizes = [x.shape[a] for a in axes]
    if size is not None:
        if torch.is_tensor(size):
            size = size.reshape(-1).tolist()
        size = size if isinstance(size, (list, tuple)) else [size]
        out_sizes = [int(s.item()) if torch.is_tensor(s) else int(s) for s in size]
    else:
        sf = scale_factor if isinstance(scale_factor, (list, tuple)) else [scale_factor] * nd
        out_sizes = [int(s * f) for s, f in zip(in_sizes, sf)]
    method = _INTERP_METHOD[mode]
    if method != "nearest" and not (x.is_floating_point() or x.is_complex()):
        x = x.to(torch.float64 if x.dtype == torch.int64 else torch.float32)
    for ax, n_in, n_out in zip(axes, in_sizes, out_sizes):
        if n_in == n_out:
            continue
        if method == "nearest":
            idx = np.floor((np.arange(n_out, dtype=np.float32) + np.float32(0.5))
                           * np.float32(n_in) / np.float32(n_out)).astype(np.int64)
            x = x.index_select(ax, torch.from_numpy(idx).to(x.device))
        else:
            w = torch.from_numpy(_resize_weights(n_in, n_out, method)).to(x.device, x.dtype)
            x = torch.matmul(x.movedim(ax, -1), w).movedim(-1, ax)
    return x


def upsample(x, size=None, scale_factor=None, mode="nearest", align_corners=False,
             align_mode=0, data_format="NCHW"):
    return interpolate(x, size, scale_factor, mode, align_corners, align_mode, data_format)


def pixel_shuffle(x, upscale_factor, data_format="NCHW"):
    """NCHW: [n, c r^2, h, w] -> [n, c, h r, w r] (``data_format`` is not
    read, as in the JAX op)."""
    (x,) = cast_inputs("pixel_shuffle", x)
    r = upscale_factor
    n, c, h, w = x.shape
    a = x.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
    return a.reshape(n, c // (r * r), h * r, w * r)


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1):
    """im2col of NCHW: [n, c kh kw, oh ow] (channel outer, kernel position
    inner); ``paddings`` is one value a spatial axis (its first two entries
    when four are given, as the JAX op reads them)."""
    (x,) = cast_inputs("unfold", x)
    pd = _ntuple(paddings, 2)
    return TF.unfold(x, _ntuple(kernel_sizes, 2), dilation=_ntuple(dilations, 2),
                     padding=(pd[0], pd[1]), stride=_ntuple(strides, 2))


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1):
    """col2im, unfold's adjoint: the columns summed back into the image."""
    (x,) = cast_inputs("fold", x)
    pd = _ntuple(paddings, 2)
    return TF.fold(x, _ntuple(output_sizes, 2), _ntuple(kernel_sizes, 2),
                   dilation=_ntuple(dilations, 2), padding=(pd[0], pd[1]),
                   stride=_ntuple(strides, 2))


def affine_grid(theta, out_shape, align_corners=True):
    """[N, H, W, 2] sampling points: theta [N, 2, 3] applied to the
    normalized (x, y, 1) of each output pixel. The grid is f64, as the JAX
    op's (its linspace and arange are f64 under x64, and promote theta)."""
    (theta,) = cast_inputs("affine_grid", theta)
    _, _, h, w = [int(s) for s in out_shape]
    kw = {"dtype": torch.float64, "device": theta.device}
    if align_corners:
        ys, xs = torch.linspace(-1.0, 1.0, h, **kw), torch.linspace(-1.0, 1.0, w, **kw)
    else:
        ys = (torch.arange(h, **kw) * 2 + 1) / h - 1.0
        xs = (torch.arange(w, **kw) * 2 + 1) / w - 1.0
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], -1)           # [H, W, 3]
    return torch.einsum("hwk,nck->nhwc", base, theta.to(torch.float64))


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros", align_corners=True):
    """NCHW sampled at the [N, Hg, Wg, 2] points of ``grid`` in [-1, 1], as
    the JAX op: bilinear or nearest (round half to even); "zeros" reads 0
    outside, every other ``padding_mode`` ("border", and "reflection" too)
    clamps to the border."""
    x, grid = cast_inputs("grid_sample", x, grid)
    n, _, h, w = x.shape

    def unnormalize(coord, size):
        if align_corners:
            return (coord + 1.0) / 2.0 * (size - 1)
        return ((coord + 1.0) * size - 1.0) / 2.0

    fx, fy = unnormalize(grid[..., 0], w), unnormalize(grid[..., 1], h)
    bi = torch.arange(n, device=x.device)[:, None, None]

    def get(ix, iy):
        v = x[bi, :, iy.clamp(0, h - 1), ix.clamp(0, w - 1)]         # [N, Hg, Wg, C]
        if padding_mode == "zeros":
            inside = (ix >= 0) & (ix <= w - 1) & (iy >= 0) & (iy <= h - 1)
            v = v * inside[..., None].to(v.dtype)
        return v

    if mode == "nearest":
        out = get(torch.round(fx).long(), torch.round(fy).long())
    else:
        x0, y0 = torch.floor(fx).long(), torch.floor(fy).long()
        wx, wy = (fx - x0)[..., None], (fy - y0)[..., None]
        out = (get(x0, y0) * (1 - wx) * (1 - wy) + get(x0 + 1, y0) * wx * (1 - wy)
               + get(x0, y0 + 1) * (1 - wx) * wy + get(x0 + 1, y0 + 1) * wx * wy)
    return out.permute(0, 3, 1, 2)


def temporal_shift(x, seg_num, shift_ratio=0.25, data_format="NCHW"):
    """A ``shift_ratio`` share of the channels moved one segment back, the
    next share one forward, zeros at the ends ([N T, C, H, W])."""
    (x,) = cast_inputs("temporal_shift", x)
    nt, c, h, w = x.shape
    a = x.reshape(nt // seg_num, seg_num, c, h, w)
    f = int(c * shift_ratio)
    left = torch.cat([a[:, 1:, :f], torch.zeros_like(a[:, :1, :f])], 1)
    right = torch.cat([torch.zeros_like(a[:, :1, f:2 * f]), a[:, :-1, f:2 * f]], 1)
    return torch.cat([left, right, a[:, :, 2 * f:]], 2).reshape(nt, c, h, w)


def zeropad2d(x, padding, data_format="NCHW"):
    """``padding`` (left, right, top, bottom) of zeros."""
    (x,) = cast_inputs("zeropad2d", x)
    p = _ntuple(padding, 4)
    if data_format == "NHWC":
        return TF.pad(x, [0, 0, p[0], p[1], p[2], p[3]])
    return TF.pad(x, [p[0], p[1], p[2], p[3]])


def diag_embed(input, offset=0, dim1=-2, dim2=-1):
    (x,) = cast_inputs("diag_embed", input)
    return torch.diag_embed(x, int(offset), int(dim1), int(dim2))


def sequence_mask(x, maxlen=None, dtype="int64"):
    """[..., maxlen]: position j < length (``maxlen`` defaults to the
    largest length)."""
    from ..core import dtype as dtypes

    if maxlen is None:
        maxlen = int(x.max().item()) if x.numel() else 0
    mask = torch.arange(int(maxlen), device=x.device) < x.unsqueeze(-1)
    return mask.to(dtypes.convert_dtype(dtype))


# ---------- the remaining losses ----------

def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum"):
    z, lb = cast_inputs("sigmoid_focal_loss", logit, label)
    p = torch.sigmoid(z)
    ce = torch.clamp(z, min=0) - z * lb + torch.log1p(torch.exp(-z.abs()))
    p_t = p * lb + (1 - p) * (1 - lb)
    loss = (alpha * lb + (1 - alpha) * (1 - lb)) * torch.pow(1 - p_t, gamma) * ce
    if normalizer is not None:
        loss = loss / normalizer
    return _reduce_loss(loss, reduction)


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean"):
    a, b, lb = cast_inputs("margin_ranking_loss", input, other, label)
    return _reduce_loss(torch.clamp(-lb * (a - b) + margin, min=0), reduction)


def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    a, b = cast_inputs("cosine_similarity", x1, x2)
    num = (a * b).sum(axis)
    den = torch.sqrt((a * a).sum(axis)) * torch.sqrt((b * b).sum(axis))
    return num / torch.clamp(den, min=eps)


def cosine_embedding_loss(input1, input2, label, margin=0.0, reduction="mean"):
    sim = cosine_similarity(input1, input2, axis=1)
    (s,) = cast_inputs("cosine_embedding_loss", sim)
    loss = torch.where(label.to(s.device) > 0, 1 - s, torch.clamp(s - margin, min=0))
    return _reduce_loss(loss, reduction)


def square_error_cost(input, label):
    a, b = cast_inputs("square_error_cost", input, label)
    return (a - b).square()


def dice_loss(input, label, epsilon=1e-5):
    """1 - (2 |X and Y| + eps) / (|X| + |Y| + eps) per sample, meaned;
    ``label`` [..., 1] class ids."""
    (p,) = cast_inputs("dice_loss", input)
    lf = one_hot(label.squeeze(-1).to(p.device), p.shape[-1]).to(p.dtype)
    dims = tuple(range(1, p.dim()))
    inter = (p * lf).sum(dims)
    denom = p.sum(dims) + lf.sum(dims)
    return (1.0 - (2.0 * inter + epsilon) / (denom + epsilon)).mean()


def log_loss(input, label, epsilon=1e-4):
    p, lb = cast_inputs("log_loss", input, label)
    return -lb * torch.log(p + epsilon) - (1.0 - lb) * torch.log(1.0 - p + epsilon)


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    a, p, lb = cast_inputs("npair_loss", anchor, positive, labels)
    lb = lb.reshape(-1, 1).to(a.dtype)
    same = (lb == lb.T).to(a.dtype)
    targets = same / same.sum(1, keepdim=True)
    ce = (-targets * torch.log_softmax(a @ p.T, dim=1)).sum(1).mean()
    reg = l2_reg * ((a * a).sum(1).mean() + (p * p).sum(1).mean()) / 2
    return ce + reg


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean"):
    x, y = cast_inputs("hinge_embedding_loss", input, label)
    return _reduce_loss(torch.where(y == 1.0, x, torch.clamp(margin - x, min=0.0)),
                        reduction)


def _default_tree(labels, num_classes):
    """The complete binary tree's paths (node ids, code bits, mask) of each
    label, built on the host as the JAX op does."""
    codes = [int(c) + num_classes for c in labels]
    max_len = max((c.bit_length() - 1 for c in codes), default=0)
    tbl = np.zeros((len(codes), max_len), np.int64)
    cod = np.zeros((len(codes), max_len), np.float32)
    msk = np.zeros((len(codes), max_len), np.float32)
    for r, c in enumerate(codes):
        length = c.bit_length() - 1
        for j in range(length):
            tbl[r, j] = (c >> (length - j)) - 1
            cod[r, j] = float((c >> (length - 1 - j)) & 1)
            msk[r, j] = 1.0
    return tbl, cod, msk


def hsigmoid_loss(input, label, num_classes, weight, bias=None, path_table=None,
                  path_code=None, is_sparse=False):
    """Hierarchical sigmoid: the mean over samples of the summed
    sigmoid cross-entropies along each label's path, over the default
    complete binary tree or the given ``path_table`` / ``path_code`` (a
    negative node id ends a path)."""
    x, weight, bias = cast_inputs("hsigmoid_loss", input, weight, bias)
    dev = x.device
    if path_table is None:
        tbl, cod, msk = (torch.from_numpy(a).to(dev) for a in _default_tree(
            label.detach().cpu().numpy().reshape(-1), num_classes))
    else:
        pt = path_table.to(dev)
        msk = (pt >= 0).to(torch.float32)
        tbl, cod = torch.clamp(pt, min=0).long(), path_code.to(dev)
    pre = torch.einsum("nld,nd->nl", weight[tbl], x)
    if bias is not None:
        pre = pre + bias.reshape(-1)[tbl]
    cod, msk = cod.to(pre.dtype), msk.to(pre.dtype)
    loss = torch.clamp(pre, min=0) - pre * cod + torch.log1p(torch.exp(-pre.abs()))
    return (loss * msk).sum(1).mean()


def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5, margin3=0.0, scale=64.0,
                         group=None, return_softmax=False, reduction="mean"):
    """ArcFace-family loss on cosine logits: the target's cos(m1 theta +
    m2) - m3, scaled, then softmax cross-entropy ([N, 1] per sample before
    the reduction). ``group`` is not read (one card)."""
    (cosv,) = cast_inputs("margin_cross_entropy", logits)
    onehot = one_hot(label.reshape(-1).to(cosv.device), cosv.shape[-1]).to(cosv.dtype)
    theta = torch.arccos(torch.clamp(cosv, -1.0 + 1e-7, 1.0 - 1e-7))
    target = torch.cos(margin1 * theta + margin2) - margin3
    z = (onehot * target + (1.0 - onehot) * cosv) * scale
    loss = _reduce_loss(-(onehot * torch.log_softmax(z, -1)).sum(-1, keepdim=True), reduction)
    return (loss, torch.softmax(z, -1)) if return_softmax else loss


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0, reduction="mean",
             norm_by_times=False):
    """CTC by the forward algorithm over time, as the JAX op: ``log_probs``
    [T, N, C] are logits (log-softmax taken here), labels [N, L]; a row's
    recursion stops at its input length. "mean" is the plain mean of the
    per-sample losses (not divided by the label lengths); ``norm_by_times``
    divides each by its input length first."""
    (logits,) = cast_inputs("ctc_loss", log_probs)
    lp = torch.log_softmax(logits, -1)
    T, N, _ = lp.shape
    dev = lp.device
    lab = labels.to(device=dev, dtype=torch.int64)
    in_len = input_lengths.to(device=dev, dtype=torch.int64)
    lab_len = label_lengths.to(device=dev, dtype=torch.int64)
    S = 2 * lab.shape[1] + 1
    NEG = -1e30
    ext = torch.full((N, S), blank, dtype=torch.int64, device=dev)
    ext[:, 1::2] = lab
    prev2 = torch.cat([torch.full((N, 2), -1, dtype=torch.int64, device=dev), ext[:, :-2]], 1)
    can_skip = (ext != blank) & (ext != prev2)
    rows = torch.arange(N, device=dev)
    neg = torch.full((N, S), NEG, dtype=lp.dtype, device=dev)
    first = torch.stack([lp[0, rows, ext[:, 0]],
                         torch.where(lab_len > 0, lp[0, rows, ext[:, 1]], NEG)], 1)
    alpha = torch.cat([first, neg[:, 2:]], 1)
    for t in range(1, T):
        p1 = torch.cat([neg[:, :1], alpha[:, :-1]], 1)
        p2 = torch.where(can_skip, torch.cat([neg[:, :2], alpha[:, :-2]], 1), neg)
        new = torch.logaddexp(torch.logaddexp(alpha, p1), p2) + lp[t].gather(1, ext)
        alpha = torch.where((t < in_len)[:, None], new, alpha)
    last = 2 * lab_len
    a_last = alpha.gather(1, last[:, None])[:, 0]
    a_prev = torch.where(lab_len > 0,
                         alpha.gather(1, torch.clamp(last - 1, min=0)[:, None])[:, 0], NEG)
    nll = -torch.logaddexp(a_last, a_prev)
    if norm_by_times:
        nll = nll / in_len.to(nll.dtype)
    return _reduce_loss(nll, reduction)


def class_center_sample(label, num_classes, num_samples, group=None):
    """Every positive class of ``label`` and, up to ``num_samples`` in all,
    negatives drawn without replacement from the port's default CPU
    generator; returns (label remapped to the sampled set's order, the
    sorted sampled classes). Host-side, as in the JAX op, whose draws
    differ (numpy's)."""
    from ..core import random as random_mod

    lab = label.detach().cpu().numpy().reshape(-1)
    pos = np.unique(lab)
    if len(pos) >= num_samples:
        sampled = pos
    else:
        rest = np.setdiff1d(np.arange(num_classes), pos)
        pick = torch.randperm(len(rest), generator=random_mod.generator("cpu"))
        extra = rest[pick[:num_samples - len(pos)].numpy()]
        sampled = np.sort(np.concatenate([pos, extra]))
    remap = -np.ones(num_classes, np.int64)
    remap[sampled] = np.arange(len(sampled))
    return (torch.from_numpy(remap[lab]).to(label.device),
            torch.from_numpy(sampled.astype(np.int64)).to(label.device))


def bilinear(x1, x2, weight, bias=None):
    """out[n, k] = x1[n] W[k] x2[n] + b[k], weight [out, in1, in2]."""
    a, b, w, bias = cast_inputs("bilinear", x1, x2, weight, bias)
    out = torch.einsum("ni,kij,nj->nk", a, w, b)
    return out if bias is None else out + bias


# ---------- sparse attention ----------

def sparse_attention(query, key, value, sparse_csr_offset, sparse_csr_columns,
                     key_padding_mask=None, attn_mask=None):
    """[b, h, T, d] attention through a dense mask built from the CSR
    pattern (offsets [b, h, T + 1], columns [b, h, nnz]), as the JAX op
    builds it: a row's unselected column slots are written at index -1,
    which wraps to the last key, so every row with at least one column also
    attends key T - 1 (when nnz exceeds its own count). The masks given are
    not read, as there. Softmax in the inputs' dtype."""
    q, k, v = cast_inputs("sparse_attention", query, key, value)
    b, h, T, d = q.shape
    offs = sparse_csr_offset.to(device=q.device, dtype=torch.int64)
    cols = sparse_csr_columns.to(device=q.device, dtype=torch.int64)
    idx = torch.arange(cols.shape[-1], device=q.device)
    sel = (idx >= offs[..., :-1, None]) & (idx < offs[..., 1:, None])     # [b, h, T, nnz]
    row_cols = torch.where(sel, cols[..., None, :], -1)
    mask = torch.zeros((b, h, T, T), dtype=torch.bool, device=q.device)
    mask.scatter_(-1, row_cols % T, True)
    mask &= (row_cols >= 0).any(-1, keepdim=True)
    scores = torch.matmul(q, k.transpose(-1, -2)) / torch.tensor(math.sqrt(d), dtype=q.dtype)
    probs = torch.softmax(scores.masked_fill(~mask, -1e30), -1)
    return torch.matmul(probs, v)
