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
import math
import threading

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
    _no_mask(return_mask)
    return _pool("max_pool1d", x, kernel_size, stride, padding, 1, "max",
                 "NWC" if data_format == "NLC" else "NCW")


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False, ceil_mode=False,
               data_format="NCHW"):
    _no_mask(return_mask)
    return _pool("max_pool2d", x, kernel_size, stride, padding, 2, "max", data_format)


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False, ceil_mode=False,
               data_format="NCDHW"):
    _no_mask(return_mask)
    return _pool("max_pool3d", x, kernel_size, stride, padding, 3, "max", data_format)


def _no_mask(return_mask):
    if return_mask:
        raise NotImplementedError("max pooling with return_mask (the unpool contract) is "
                                  "not ported (ROADMAP.md Queue 1 item 11)")


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
