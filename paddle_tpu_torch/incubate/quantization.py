"""Int8 quantization (counterpart of paddle_tpu/incubate/quantization.py).

Three inference modes of ``QuantizedLinear``, swapped in for every Linear
by ``quantize_model``:

- ``weight_only_int8``: the weight stored int8 with an f32 scale per output
  channel (abs-max / 127), dequantized in the activation's dtype before the
  product; activations unchanged.
- ``dynamic_int8``: each activation row quantized at run time by its own
  abs-max, an s8 x s8 -> s32 product, rescaled by row scale x channel
  scale.
- ``static_int8``: the activation quantized with one fixed per-layer scale
  recorded by ``PostTrainingQuantization``, then the same s8 x s8 -> s32
  product.

Quantization-aware training: ``fake_quant`` (quantize-dequantize with a
straight-through gradient), ``QATLinear`` and ``ImperativeQuantAware``
(swap Linears for QATLinear, train, ``convert`` to int8 layers).

**Layout.** ``QuantizedLinear._w_int8`` is ``[out, in]``, the port's
``nn.Linear`` layout (the JAX package stores ``[in, out]``;
models/convert.py transposes it as it transposes Linear weights), and
``_scale`` is ``[out]``, one entry a row. ``quantize_weight`` takes an
``[out, in]`` weight. ``QATLinear`` fake-quantizes its inner Linear's weight
per row, the same grid.

Every matmul takes its inputs through ``amp.cast_inputs("linear", ...)``,
as the JAX package dispatches them under op ``"linear"``: under
``auto_cast`` the activation, the scales and the bias are cast to the low
dtype first, and each step then follows the reference's dtype order (the
dequantized weight in the activation's dtype; the int32 accumulator rescaled
in f32 and cast to the activation's dtype before the bias). ``torch.round``
rounds half to even, as ``jnp.round`` does.

The s8 x s8 -> s32 product is ``torch._int_mm`` with the weight's transpose
(a column-major ``[in, out]`` view): the JAX package computes it with
``jax.lax.dot_general`` outside any Pallas kernel, so it is a plain matrix
product here. On the card ``torch._int_mm`` needs more than 16 rows and k, n
multiples of 8; rows, k and n are padded with zeros there and the padded
results dropped, which leaves the real rows' int32 sums unchanged.

The modes' buffers are buffers, not parameters, under the reference's names
(``_w_int8``, ``_scale``, ``_bias``, ``_act_scale``): ``state_dict``,
``framework.io.save`` / ``load`` and the decode snapshot carry them, and
``parameters()`` does not. QATLinear's moving-average activation scale
moves only in a training call outside ``jit.in_jit_trace()``, as in the JAX
package, whose engine, ``generate`` and serving engine trace the model: it
stays frozen inside ``TrainStepEngine.step``; 0 means a dynamic abs-max a
call. The JAX package's tensor-parallel layers are not ported, so the
Linear kinds are ``torch.nn.Linear`` (the port's ``Linear`` among them).
"""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ..amp import cast_inputs
from ..ops import nn_functional as F

__all__ = ["quantize_weight", "weight_only_int8_matmul",
           "dynamic_int8_matmul", "static_int8_matmul", "QuantizedLinear",
           "quantize_model", "fake_quant", "fake_quant_array", "QATLinear",
           "ImperativeQuantAware", "PostTrainingQuantization"]


def _t(x):
    return x if torch.is_tensor(x) else torch.as_tensor(x)


_DIVISORS = {}


def _div(a, d):
    """``a / d`` for a Python number ``d``, correctly rounded on every
    device: the card's kernel multiplies by the reciprocal of a host scalar
    divisor, so ``d`` goes as a cached 0-dim f32 tensor on ``a``'s device."""
    key = (a.device, float(d))
    if key not in _DIVISORS:
        _DIVISORS[key] = torch.tensor(float(d), dtype=torch.float32, device=a.device)
    return a / _DIVISORS[key]


def quantize_weight(w):
    """``[out, in]`` float weight -> (int8 ``[out, in]``, ``[out]`` f32 scale),
    abs-max per output channel (quantization_pass.py's channel_wise_abs_max).
    A zero channel takes scale 0 and divides by 1."""
    w = _t(w).detach()
    scale = _div(w.abs().amax(dim=1), 127.0)
    safe = torch.where(scale == 0, 1.0, scale)
    q = torch.clamp(torch.round(w / safe[:, None]), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def _int8_mm(x_q, w_int8):
    """[m, k] int8 x [out, k] int8 -> [m, out] int32 (``torch._int_mm`` on
    the weight's transpose; on the card rows padded to more than 16 and k,
    out to multiples of 8 with zeros)."""
    m, k = x_q.shape
    n = w_int8.shape[0]
    if not x_q.is_cuda:
        return torch._int_mm(x_q, w_int8.t())
    mp, kp, np_ = max(m + (-m) % 8, 24), k + (-k) % 8, n + (-n) % 8
    if (mp, kp) != (m, k):
        x_q = TF.pad(x_q, (0, kp - k, 0, mp - m))
    if (np_, kp) != (n, k):
        w_int8 = TF.pad(w_int8, (0, kp - k, 0, np_ - n))
    return torch._int_mm(x_q, w_int8.t())[:m, :n]


def _quantize_rows(x2):
    """Per-row dynamic quantization of [m, k] x: (int8 x_q, [m, 1] scale in
    x's dtype)."""
    x_scale = _div(x2.abs().amax(dim=1, keepdim=True), 127.0)
    safe = torch.where(x_scale == 0, 1.0, x_scale)
    return torch.clamp(torch.round(x2 / safe), -127, 127).to(torch.int8), x_scale


def _quantize_static(x2, act_s):
    """Quantization of [m, k] x with the fixed scale ``act_s`` (0 reads as
    1): (int8 x_q, the f32 scale)."""
    act_s = act_s.to(x2.device)
    sc = torch.where(act_s == 0, 1.0, act_s).to(torch.float32)
    return torch.clamp(torch.round(x2 / sc.to(x2.dtype)), -127, 127).to(torch.int8), sc


def _epilogue(acc, x_scale, scale, dtype, lead, bias):
    out = (acc.float() * x_scale.float() * scale.float()[None, :]).to(dtype)
    out = out.reshape(*lead, out.shape[-1])
    return out if bias is None else out + bias.to(out.dtype)


def weight_only_int8_matmul(x, w_int8, scale, bias=None):
    """x ``[.., in]`` @ dequant(w_int8 ``[out, in]``)ᵀ + bias, the weight
    dequantized in x's dtype (after the autocast cast) before the product."""
    x, w_int8, scale, bias = cast_inputs("linear", x, w_int8, scale, bias)
    # int8 x scale in x's dtype: the int8 values are exact there, so one
    # promoting multiply gives the bits of the cast and then the multiply
    wd = w_int8 * scale.to(x.dtype)[:, None]
    out = TF.linear(x, wd)
    return out if bias is None else out + bias.to(out.dtype)


def dynamic_int8_matmul(x, w_int8, scale, bias=None):
    """Per-row dynamic activation quantization + s8 x s8 -> s32 product:
    (x_q @ w_qᵀ) * x_scale[:, None] * w_scale[None, :] (+ bias)."""
    x, w_int8, scale, bias = cast_inputs("linear", x, w_int8, scale, bias)
    lead = x.shape[:-1]
    x_q, x_scale = _quantize_rows(x.reshape(-1, x.shape[-1]))
    return _epilogue(_int8_mm(x_q, w_int8), x_scale, scale, x.dtype, lead, bias)


def static_int8_matmul(x, w_int8, scale, act_scale, bias=None):
    """Static activation quantization with the calibrated per-layer
    ``act_scale`` (the reference's out_threshold), then s8 x s8 -> s32."""
    x, w_int8, scale, act_scale, bias = cast_inputs("linear", x, w_int8, scale,
                                                    _t(act_scale), bias)
    lead = x.shape[:-1]
    x_q, sc = _quantize_static(x.reshape(-1, x.shape[-1]), act_scale)
    return _epilogue(_int8_mm(x_q, w_int8), sc, scale, x.dtype, lead, bias)


class QuantizedLinear(torch.nn.Module):
    """Drop-in for a Linear, built from a trained layer's weights."""

    MODES = ("weight_only_int8", "dynamic_int8", "static_int8")

    def __init__(self, w_int8, scale, bias=None, mode="weight_only_int8",
                 act_scale=None):
        super().__init__()
        if mode not in self.MODES:
            raise ValueError(f"mode must be one of {self.MODES}, got {mode!r}")
        if mode == "static_int8" and act_scale is None:
            raise ValueError(
                "static_int8 needs the calibrated act_scale "
                "(PostTrainingQuantization.collect records it)")
        self.mode = mode
        w_int8 = _t(w_int8)
        self.register_buffer("_w_int8", w_int8)
        self.register_buffer("_scale", _t(scale).to(w_int8.device))
        self._bias_none = bias is None
        if bias is not None:
            self.register_buffer("_bias", _t(bias).detach().clone().to(w_int8.device))
        if act_scale is not None:
            self.register_buffer("_act_scale", torch.as_tensor(
                act_scale, dtype=torch.float32).to(w_int8.device))

    @classmethod
    def from_linear(cls, linear, mode="weight_only_int8", act_scale=None):
        q, scale = quantize_weight(linear.weight)
        return cls(q, scale, bias=linear.bias, mode=mode, act_scale=act_scale)

    def forward(self, x):
        bias = None if self._bias_none else self._bias
        if self.mode == "static_int8":
            return static_int8_matmul(x, self._w_int8, self._scale,
                                      self._act_scale, bias=bias)
        fn = (weight_only_int8_matmul if self.mode == "weight_only_int8"
              else dynamic_int8_matmul)
        return fn(x, self._w_int8, self._scale, bias=bias)


def _linear_kinds():
    """Module classes the quantization swaps take: ``torch.nn.Linear``, the
    port's tensor-parallel layers among them (dense Linears at mp = 1; a
    layer sharded over mp > 1 ranks raises in ``_swap_sublayers``)."""
    return (torch.nn.Linear,)


def _swap_sublayers(layer, match, make):
    """Replace each submodule matching ``match`` by ``make(submodule, name)``,
    never descending into an already wrapped layer (a QATLinear's inner
    Linear must not be swapped out from under it). Returns the (possibly
    replaced) root, which is addressed as ""."""
    if match(layer):
        return make(layer, "")
    for name, sub in list(layer.named_modules())[1:]:
        parts = name.split(".")
        parent = layer
        skip = False
        for pth in parts[:-1]:
            parent = getattr(parent, pth)
            if isinstance(parent, (QATLinear, QuantizedLinear)):
                skip = True
                break
        if skip or not match(sub):
            continue
        if getattr(sub, "mp_size", 1) > 1:
            raise NotImplementedError(
                f"{name}: quantizing a layer sharded over {sub.mp_size} model-parallel "
                "ranks; quantization runs on single-replica models (ROADMAP.md Queue 1 "
                "item 9)")
        setattr(parent, parts[-1], make(sub, name))
    return layer


def quantize_model(layer, mode="weight_only_int8", act_scales=None):
    """Swap every Linear (and every QATLinear, through its trained inner
    Linear) for a QuantizedLinear in place and return the layer.
    ``act_scales`` (name -> float, from PostTrainingQuantization) feeds
    static_int8."""
    if mode == "static_int8" and not act_scales:
        raise ValueError(
            "static_int8 needs act_scales from a calibration pass "
            "(use PostTrainingQuantization)")
    kinds = _linear_kinds()

    def match(sub):
        return isinstance(sub, kinds + (QATLinear,))

    def make(sub, name):
        inner = sub.inner if isinstance(sub, QATLinear) else sub
        act = None if act_scales is None else act_scales.get(name)
        return QuantizedLinear.from_linear(inner, mode, act_scale=act)

    return _swap_sublayers(layer, match, make)


# --------------------------------------------------------------------- QAT ---

def fake_quant_array(a, bits=8, scale=None, channel_axis=None):
    """Quantize-dequantize of a tensor with a straight-through gradient:
    abs-max over the tensor, or per index of ``channel_axis``, unless
    ``scale`` holds a value above 0."""
    qmax = float(2 ** (bits - 1) - 1)
    if channel_axis is None:
        dyn = _div(a.abs().amax(), qmax)
    else:
        axes = tuple(i for i in range(a.dim()) if i != channel_axis % a.dim())
        dyn = _div(a.abs().amax(dim=axes, keepdim=True), qmax)
    if scale is None:
        sc = dyn
    else:
        dt = torch.promote_types(scale.dtype, dyn.dtype)   # jnp.where's promotion
        sc = torch.where(scale > 0, scale.to(dt), dyn.to(dt))
    sc = torch.where(sc == 0, 1.0, sc).to(a.dtype)
    q = torch.clamp(torch.round(a / sc), -qmax, qmax) * sc
    return a + (q - a).detach()


def fake_quant(x, bits=8, scale=None, channel_axis=None):
    """``fake_quant_array`` as op ``"fake_quant"`` (the reference's
    fake_quantize_dequantize_abs_max). ``scale`` None, or a scale holding 0
    (never calibrated), takes the dynamic abs-max."""
    x, scale = cast_inputs("fake_quant", _t(x), None if scale is None else _t(scale))
    return fake_quant_array(x, bits, scale=scale, channel_axis=channel_axis)


class QATLinear(torch.nn.Module):
    """A Linear with fake-quantized weight (per output channel, the
    deployment grid) and activation (a moving average of abs-max;
    0 in the persisted ``_act_scale`` buffer means never calibrated)."""

    def __init__(self, linear, weight_bits=8, activation_bits=8,
                 moving_rate=0.9):
        super().__init__()
        self.inner = linear
        self.weight_bits = weight_bits
        self.activation_bits = activation_bits
        self.moving_rate = moving_rate
        self.register_buffer("_act_scale", torch.zeros(
            (), dtype=torch.float32, device=linear.weight.device))

    def forward(self, x):
        from ..jit import in_jit_trace

        qmax = float(2 ** (self.activation_bits - 1) - 1)
        if self.training and not in_jit_trace():
            # the moving average on the host, outside any traced call
            cur = float(x.detach().abs().max()) / qmax
            prev = float(self._act_scale)
            new = cur if prev == 0 else \
                self.moving_rate * prev + (1 - self.moving_rate) * cur
            with torch.no_grad():
                self._act_scale.fill_(new)
        xq = fake_quant(x, self.activation_bits, scale=self._act_scale)
        wq = fake_quant(self.inner.weight, self.weight_bits, channel_axis=0)
        return F.linear(xq, wq, self.inner.bias)


class ImperativeQuantAware:
    """The QAT entry point (reference imperative/qat.py:42): ``quantize(model)`` swaps
    Linears for QATLinear in place; after training, ``convert(model, mode)``
    makes true int8 QuantizedLinear layers (static_int8 takes each layer's
    trained activation scale)."""

    def __init__(self, weight_bits=8, activation_bits=8, moving_rate=0.9):
        self.weight_bits = weight_bits
        self.activation_bits = activation_bits
        self.moving_rate = moving_rate

    def quantize(self, model):
        kinds = _linear_kinds()
        return _swap_sublayers(
            model, lambda sub: isinstance(sub, kinds),
            lambda lin, name: QATLinear(lin, self.weight_bits,
                                        self.activation_bits,
                                        self.moving_rate))

    def convert(self, model, mode="weight_only_int8"):
        def make(q, name):
            act = float(q._act_scale) if mode == "static_int8" else None
            return QuantizedLinear.from_linear(q.inner, mode, act_scale=act)

        return _swap_sublayers(
            model, lambda sub: isinstance(sub, QATLinear), make)


class PostTrainingQuantization:
    """Calibration-based PTQ (reference post_training_quantization.py)::

        ptq = PostTrainingQuantization(model)
        for batch in calib_batches: ptq.collect(batch)
        qmodel = ptq.convert(mode="static_int8")

    A forward pre-hook on every Linear records max(abs-max / 127) of its
    input over the batches in ``ptq.scales`` (name -> float);
    ``convert`` removes the hooks and swaps with ``quantize_model``."""

    def __init__(self, model):
        self.model = model
        self.scales = {}
        self._hooks = []
        kinds = _linear_kinds()
        for name, sub in model.named_modules():
            if isinstance(sub, kinds):
                self._hooks.append(sub.register_forward_pre_hook(
                    self._recorder(name)))

    def _recorder(self, name):
        def hook(layer, inputs):
            cur = float(inputs[0].detach().abs().max()) / 127.0
            self.scales[name] = max(self.scales.get(name, 0.0), cur)

        return hook

    def collect(self, *batch):
        """One calibration forward in eval mode without grad; each
        submodule's own training flag is restored after it."""
        modes = [(sub, sub.training) for sub in self.model.modules()]
        self.model.eval()
        try:
            with torch.no_grad():
                self.model(*batch)
        finally:
            for sub, training in modes:
                sub.training = training

    def convert(self, mode="weight_only_int8"):
        for h in self._hooks:
            h.remove()
        self._hooks = []
        return quantize_model(self.model, mode, act_scales=self.scales)
