"""Activations (counterpart of paddle_tpu/ops/activation.py).

Paddle's semantics and defaults, PyTorch inside. Each op looks itself up
under ``amp.auto_cast`` by the JAX op name (``cast_inputs``): ``softmax``
and ``log_softmax`` are black-listed (f32 under O1), the rest keep their
input dtype at O1. ``rrelu`` in training draws its slopes from an explicit
``torch.Generator`` (torch's default one when None), and
``gumbel_softmax`` its noise from the device's generator of
``core/random.py``, where the JAX ops draw from the global key: the draws
differ by design. The in-place ops (``relu_``, ``elu_``, ``tanh_``,
``softmax_``) write into their input through torch's in-place ops, which
raise on a leaf that requires grad (the reference rebinds its buffer there).
"""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ..amp import cast_inputs
from ..core import random as random_mod

_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "bfloat16": torch.bfloat16, "float16": torch.float16}


def _unary(name, fn):
    def op(x, name=None):
        (x,) = cast_inputs(op_name, x)
        return fn(x)

    op_name = name
    op.__name__ = name
    return op


relu = _unary("relu", torch.relu)
relu6 = _unary("relu6", lambda x: torch.clamp(x, 0.0, 6.0))
sigmoid = _unary("sigmoid", torch.sigmoid)
silu = _unary("silu", TF.silu)
tanh = _unary("tanh", torch.tanh)
softsign = _unary("softsign", lambda x: x / (1 + x.abs()))
tanhshrink = _unary("tanhshrink", lambda x: x - torch.tanh(x))
mish = _unary("mish", lambda x: x * torch.tanh(TF.softplus(x)))
hardswish = _unary("hardswish", lambda x: x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0)
hardsigmoid = _unary("hardsigmoid", lambda x: torch.clamp(x / 6.0 + 0.5, 0.0, 1.0))
log_sigmoid = _unary("log_sigmoid", TF.logsigmoid)


def gelu(x, approximate=False, name=None):
    (x,) = cast_inputs("gelu", x)
    return TF.gelu(x, approximate="tanh" if approximate else "none")


def swish(x, name=None):
    return silu(x)


def leaky_relu(x, negative_slope=0.01, name=None):
    (x,) = cast_inputs("leaky_relu", x)
    return TF.leaky_relu(x, negative_slope)


def elu(x, alpha=1.0, name=None):
    (x,) = cast_inputs("elu", x)
    return TF.elu(x, alpha)


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    (x,) = cast_inputs("selu", x)
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


def celu(x, alpha=1.0, name=None):
    (x,) = cast_inputs("celu", x)
    return TF.celu(x, alpha)


def prelu(x, weight, data_format="NCHW", name=None):
    x, weight = cast_inputs("prelu", x, weight)
    if weight.numel() > 1:
        shape = [1] * x.dim()
        shape[1 if data_format.startswith("NC") else x.dim() - 1] = weight.numel()
        weight = weight.reshape(shape)
    return torch.where(x > 0, x, weight * x)


def rrelu(x, lower=0.125, upper=0.3333333333333333, training=False, name=None,
          generator=None):
    (x,) = cast_inputs("rrelu", x)
    if training:
        slope = torch.rand(x.shape, generator=generator, device=x.device,
                           dtype=x.dtype) * (upper - lower) + lower
    else:
        slope = (lower + upper) / 2.0
    return torch.where(x >= 0, x, slope * x)


def hardtanh(x, min=-1.0, max=1.0, name=None):
    (x,) = cast_inputs("hardtanh", x)
    return torch.clamp(x, min, max)


def hardshrink(x, threshold=0.5, name=None):
    (x,) = cast_inputs("hardshrink", x)
    return torch.where(x.abs() > threshold, x, 0.0).to(x.dtype)


def softshrink(x, threshold=0.5, name=None):
    (x,) = cast_inputs("softshrink", x)
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, 0.0)).to(x.dtype)


def thresholded_relu(x, threshold=1.0, name=None):
    (x,) = cast_inputs("thresholded_relu", x)
    return torch.where(x > threshold, x, 0.0).to(x.dtype)


def softplus(x, beta=1.0, threshold=20.0, name=None):
    (x,) = cast_inputs("softplus", x)
    return torch.where(beta * x > threshold, x, TF.softplus(beta * x) / beta)


def softmax(x, axis=-1, dtype=None, name=None):
    (x,) = cast_inputs("softmax", x)
    if dtype is not None:
        x = x.to(_DTYPES.get(dtype, dtype))
    return torch.softmax(x, dim=axis)


def log_softmax(x, axis=-1, dtype=None, name=None):
    (x,) = cast_inputs("log_softmax", x)
    if dtype is not None:
        x = x.to(_DTYPES.get(dtype, dtype))
    return torch.log_softmax(x, dim=axis)


def maxout(x, groups, axis=1, name=None):
    """Consecutive channels form a group: out[c] = max_g in[c groups + g]."""
    (x,) = cast_inputs("maxout", x)
    axis = axis % x.dim()
    shape = list(x.shape)
    shape[axis:axis + 1] = [shape[axis] // groups, groups]
    return x.reshape(shape).amax(dim=axis + 1)


def glu(x, axis=-1, name=None):
    (x,) = cast_inputs("glu", x)
    return TF.glu(x, dim=axis)


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    (x,) = cast_inputs("gumbel_softmax", x)
    u = torch.empty_like(x).uniform_(1e-20, 1.0, generator=random_mod.generator(x.device))
    y = torch.softmax((x - torch.log(-torch.log(u))) / temperature, dim=axis)
    if hard:
        y_hard = (y == y.amax(dim=axis, keepdim=True)).to(y.dtype)
        y = (y_hard - y).detach() + y
    return y


def swiglu(x, y=None, name=None):
    """silu(x) * y, or of the two halves of x's last axis without y."""
    if y is None:
        (x,) = cast_inputs("swiglu", x)
        x, y = torch.chunk(x, 2, dim=-1)
    else:
        x, y = cast_inputs("swiglu", x, y)
    return TF.silu(x) * y


def relu_(x, name=None):
    return x.relu_()


def elu_(x, alpha=1.0, name=None):
    return TF.elu_(x, alpha)


def tanh_(x, name=None):
    return x.tanh_()


def softmax_(x, axis=-1, dtype=None, name=None):
    return x.copy_(softmax(x, axis, dtype))
