"""Weight initializers (counterpart of paddle_tpu/nn/initializer.py).

An initializer is called with a shape and a dtype and returns a new CPU
tensor of that shape. The shape is the JAX package's layout of the
parameter: a Linear weight is ``[in, out]`` there (the port's ``Linear``
stores ``[out, in]`` and transposes what its initializer returns), a
convolution weight ``[out, in / groups, *k]`` in both packages. So
``_fan_in_out`` reads the same fans as the JAX initializer: fan_in is
``shape[0]`` of a 2-D shape.

Random initializers draw on the CPU from the port's ``"init"`` stream
(``core/random.named_generator("init", "cpu")``, reseeded by
``paddle_tpu_torch.seed``); the caller copies the result to the
parameter's device. The values differ from the JAX package's threefry
draws by design (ROADMAP, "Sampling decision"): only their distributions
are the same. ``Constant``, ``Assign``, ``Dirac`` and ``Bilinear`` give the
JAX package's values.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core import dtype as dtypes
from ..core import random as random_mod

__all__ = ["Initializer", "Constant", "Normal", "TruncatedNormal", "Uniform", "XavierNormal",
           "XavierUniform", "KaimingNormal", "KaimingUniform", "Assign", "Orthogonal", "Dirac",
           "Bilinear", "constant", "normal", "uniform", "calculate_gain",
           "set_global_initializer"]


def _fan_in_out(shape):
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    # conv kernels, layout [out_c, in_c, *k]
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


def calculate_gain(nonlinearity, param=None):
    gains = {
        "sigmoid": 1.0, "linear": 1.0, "conv1d": 1.0, "conv2d": 1.0, "conv3d": 1.0,
        "tanh": 5.0 / 3, "relu": math.sqrt(2.0), "selu": 3.0 / 4,
    }
    if nonlinearity == "leaky_relu":
        a = 0.01 if param is None else param
        return math.sqrt(2.0 / (1 + a**2))
    return gains.get(nonlinearity, 1.0)


def _gen():
    return random_mod.named_generator("init", "cpu")


def _dtype(dtype):
    return dtypes.convert_dtype(dtype or "float32")


def _draw_dtype(dtype):
    """Draws in f64 for an f64 parameter, else in f32 (then cast)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _normal(shape, dtype):
    dtype = _dtype(dtype)
    t = torch.empty(tuple(shape), dtype=_draw_dtype(dtype))
    return t.normal_(generator=_gen()), dtype


def _uniform(shape, dtype, low, high):
    dtype = _dtype(dtype)
    t = torch.empty(tuple(shape), dtype=_draw_dtype(dtype))
    return t.uniform_(low, high, generator=_gen()).to(dtype)


class Initializer:
    def __call__(self, shape, dtype="float32"):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype="float32"):
        return torch.full(tuple(shape), self.value, dtype=_dtype(dtype))


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype="float32"):
        t, dtype = _normal(shape, dtype)
        return (t * self.std + self.mean).to(dtype)


class TruncatedNormal(Initializer):
    """N(mean, std) cut at two standard deviations (the JAX package's
    ``truncated_normal(-2, 2) * std + mean``)."""

    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype="float32"):
        dtype = _dtype(dtype)
        t = torch.empty(tuple(shape), dtype=_draw_dtype(dtype))
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=_gen())
        return (t * self.std + self.mean).to(dtype)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def __call__(self, shape, dtype="float32"):
        return _uniform(shape, dtype, self.low, self.high)


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype="float32"):
        fi, fo = _fan_in_out(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        t, dtype = _normal(shape, dtype)
        return (t * (self.gain * math.sqrt(2.0 / (fi + fo)))).to(dtype)


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype="float32"):
        fi, fo = _fan_in_out(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return _uniform(shape, dtype, -limit, limit)


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype="float32"):
        fi, _ = _fan_in_out(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        std = calculate_gain(self.nonlinearity, self.negative_slope) / math.sqrt(fi)
        t, dtype = _normal(shape, dtype)
        return (t * std).to(dtype)


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype="float32"):
        fi, _ = _fan_in_out(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        limit = calculate_gain(self.nonlinearity, self.negative_slope) * math.sqrt(3.0 / fi)
        return _uniform(shape, dtype, -limit, limit)


class Assign(Initializer):
    """The given values (a numpy array, list or tensor), reshaped to the
    parameter's shape in the JAX layout."""

    def __init__(self, value):
        if torch.is_tensor(value):
            value = value.detach().cpu().numpy()
        self.value = np.asarray(value)

    def __call__(self, shape, dtype="float32"):
        return torch.from_numpy(np.array(self.value.reshape(tuple(shape)))).to(_dtype(dtype))


class Orthogonal(Initializer):
    def __init__(self, gain=1.0):
        self.gain = gain

    def __call__(self, shape, dtype="float32"):
        rows = shape[0]
        cols = int(np.prod(shape[1:])) if len(shape) > 1 else 1
        flat = (rows, cols) if rows >= cols else (cols, rows)
        a = torch.empty(flat, dtype=torch.float32).normal_(generator=_gen())
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))
        if rows < cols:
            q = q.T
        return (self.gain * q.reshape(tuple(shape))).to(_dtype(dtype))


class Dirac(Initializer):
    def __init__(self, groups=1):
        self.groups = groups

    def __call__(self, shape, dtype="float32"):
        out = np.zeros(shape, np.float32)
        oc, ic = shape[0], shape[1]
        mid = tuple(s // 2 for s in shape[2:])
        for g in range(self.groups):
            for i in range(min(oc // self.groups, ic)):
                out[(g * (oc // self.groups) + i, i) + mid] = 1.0
        return torch.from_numpy(out).to(_dtype(dtype))


# lowercase aliases (paddle.nn.initializer exports both in places)
constant = Constant
normal = Normal
uniform = Uniform


class Bilinear(Initializer):
    """Bilinear upsampling kernel for transposed convolutions: weight
    ``[C_out, C_in, k, k]``."""

    def __call__(self, shape, dtype="float32"):
        w = np.zeros(shape, dtype=np.float32)
        k = shape[-1]
        f = int(np.ceil(k / 2.0))
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        for i in range(int(np.prod(shape))):
            x = i % k
            y = (i // k) % k
            w.flat[i] = (1 - abs(x / f - c)) * (1 - abs(y / f - c))
        return torch.from_numpy(w).to(_dtype(dtype))


_global_initializer = {}


def set_global_initializer(weight_init, bias_init=None):
    """Default initializers of the parameters created from now on that get
    no initializer of their own (``ParamAttr``) or of their layer. Pass
    None to reset."""
    _global_initializer["weight"] = weight_init
    _global_initializer["bias"] = bias_init


def _global_default(is_bias):
    return _global_initializer.get("bias" if is_bias else "weight")
