"""Elementwise, binary and scalar math ops (counterpart of paddle_tpu/ops/math.py).

Each op is the torch op of the same function, behind the two rules of
``_helpers``: the AMP lookup under its JAX op name and the JAX package's
result dtype (x64, weakly typed Python scalars). Where jnp promotes an
integer input to an inexact op (``exp``, ``sin``, ``divide``, ...) the
integer is computed in float64 here too. Comparison, bitwise, rounding-
division and other ops the reference marks non-differentiable record no
graph.
"""
from __future__ import annotations

import torch

from ..amp import cast_inputs
from ..core import dtype as dtypes
from ._helpers import binary, operands, public, t_, to_inexact, unary, value

# ---- binary arithmetic ----
add = binary("add", torch.add)
subtract = binary("subtract", torch.sub)
multiply = binary("multiply", torch.mul)
divide = binary("divide", torch.true_divide, inexact=True)
floor_divide = binary("floor_divide", torch.floor_divide, differentiable=False)
remainder = binary("remainder", torch.remainder)
mod = remainder
floor_mod = remainder
pow = binary("pow", torch.pow)
maximum = binary("maximum", torch.maximum, tensors=True)
minimum = binary("minimum", torch.minimum, tensors=True)
fmax = binary("fmax", torch.fmax, tensors=True)
fmin = binary("fmin", torch.fmin, tensors=True)
atan2 = binary("atan2", torch.atan2, tensors=True, inexact=True)
hypot = binary("hypot", torch.hypot, tensors=True, inexact=True)
copysign = binary("copysign", torch.copysign, tensors=True, inexact=True)
nextafter = binary("nextafter", torch.nextafter, tensors=True, differentiable=False,
                   inexact=True)
logaddexp = binary("logaddexp", torch.logaddexp, tensors=True, inexact=True)
# its derivative is zero almost everywhere; torch has none, so it records no graph
heaviside = binary("heaviside", torch.heaviside, tensors=True, differentiable=False,
                   inexact=True)
gcd = binary("gcd", torch.gcd, tensors=True, differentiable=False)
lcm = binary("lcm", torch.lcm, tensors=True, differentiable=False)
kron = binary("kron", torch.kron, tensors=True)
inner = binary("inner", torch.inner, tensors=True)
outer = binary("outer", lambda a, b: torch.outer(a.reshape(-1), b.reshape(-1)), tensors=True)

# ---- comparisons (never differentiable) ----
equal = binary("equal", torch.eq, differentiable=False)
not_equal = binary("not_equal", torch.ne, differentiable=False)
less_than = binary("less_than", torch.lt, differentiable=False)
less_equal = binary("less_equal", torch.le, differentiable=False)
greater_than = binary("greater_than", torch.gt, differentiable=False)
greater_equal = binary("greater_equal", torch.ge, differentiable=False)
logical_and = binary("logical_and", torch.logical_and, tensors=True, differentiable=False)
logical_or = binary("logical_or", torch.logical_or, tensors=True, differentiable=False)
logical_xor = binary("logical_xor", torch.logical_xor, tensors=True, differentiable=False)
bitwise_and = binary("bitwise_and", torch.bitwise_and, differentiable=False)
bitwise_or = binary("bitwise_or", torch.bitwise_or, differentiable=False)
bitwise_xor = binary("bitwise_xor", torch.bitwise_xor, differentiable=False)
bitwise_left_shift = binary("bitwise_left_shift", torch.bitwise_left_shift,
                            differentiable=False)
bitwise_right_shift = binary("bitwise_right_shift", torch.bitwise_right_shift,
                             differentiable=False)

logical_not = unary("logical_not", torch.logical_not, differentiable=False)
bitwise_not = unary("bitwise_not", torch.bitwise_not, differentiable=False)


def ldexp(x, y, name=None):
    """x * 2 ** y for an integer y; an integer x computes in its inexact dtype."""
    x, y = cast_inputs("ldexp", t_(x), t_(y, x))
    return torch.ldexp(to_inexact(x), y)


def _as_f64(x):
    """An integer or bool input as float64 (jnp's 1.0 / x and angle)."""
    return x if x.is_floating_point() or x.is_complex() else x.to(torch.float64)


def _imag(x):
    return x.imag if x.is_complex() else torch.zeros_like(x)


# ---- unary ----
exp = unary("exp", torch.exp, inexact=True)
expm1 = unary("expm1", torch.expm1, inexact=True)
log = unary("log", torch.log, inexact=True)
log2 = unary("log2", torch.log2, inexact=True)
log10 = unary("log10", torch.log10, inexact=True)
log1p = unary("log1p", torch.log1p, inexact=True)
sqrt = unary("sqrt", torch.sqrt, inexact=True)
rsqrt = unary("rsqrt", torch.rsqrt, inexact=True)
square = unary("square", torch.square)
reciprocal = unary("reciprocal", torch.reciprocal, inexact=_as_f64)
abs = unary("abs", lambda x: x.clone() if x.dtype == torch.bool else torch.abs(x))
neg = unary("neg", torch.neg)
sin = unary("sin", torch.sin, inexact=True)
cos = unary("cos", torch.cos, inexact=True)
tan = unary("tan", torch.tan, inexact=True)
asin = unary("asin", torch.asin, inexact=True)
acos = unary("acos", torch.acos, inexact=True)
atan = unary("atan", torch.atan, inexact=True)
sinh = unary("sinh", torch.sinh, inexact=True)
cosh = unary("cosh", torch.cosh, inexact=True)
tanh = unary("tanh", torch.tanh, inexact=True)
asinh = unary("asinh", torch.asinh, inexact=True)
acosh = unary("acosh", torch.acosh, inexact=True)
atanh = unary("atanh", torch.atanh, inexact=True)
erf = unary("erf", torch.erf, inexact=True)
erfinv = unary("erfinv", torch.erfinv, inexact=True)
floor = unary("floor", torch.floor)
ceil = unary("ceil", torch.ceil)
round = unary("round", torch.round)
trunc = unary("trunc", torch.trunc)
frac = unary("frac", lambda x: x - torch.trunc(x))
sign = unary("sign", torch.sign)
sgn = sign
digamma = unary("digamma", torch.digamma, inexact=True)
lgamma = unary("lgamma", torch.lgamma, inexact=True)
sigmoid = unary("sigmoid", torch.sigmoid, inexact=True)
logit = unary("logit", lambda x: torch.log(x) - torch.log1p(-x), inexact=True)
i0 = unary("i0", torch.special.i0, inexact=True)
i1 = unary("i1", torch.special.i1, inexact=True)
isnan = unary("isnan", torch.isnan, differentiable=False)
isinf = unary("isinf", torch.isinf, differentiable=False)
isfinite = unary("isfinite", torch.isfinite, differentiable=False)
conj = unary("conj", torch.conj_physical)
real = unary("real", torch.real)
imag = unary("imag", _imag)
angle = unary("angle", torch.angle, inexact=_as_f64)
deg2rad = unary("deg2rad", torch.deg2rad, inexact=True)
rad2deg = unary("rad2deg", torch.rad2deg, inexact=True)
exponent = unary("exponent", lambda x: torch.frexp(x).exponent.to(torch.int32),
                 differentiable=False, inexact=True)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    s, b = float(value(scale)), float(bias)
    (x, _, _) = operands("scale", x, s, b)
    out = x * s + b if bias_after_scale else (x + b) * s
    if act:
        from . import activation as _act

        out = getattr(_act, act)(out)
    return out


def increment(x, value=1.0, name=None):
    """x += value in place (no graph, as the reference's set_value)."""
    with torch.no_grad():
        x.copy_(x + value)
    return x


def clip(x, min=None, max=None, name=None):
    lo, hi = value(min), value(max)
    x, lo, hi = operands("clip", x, lo, hi)
    return torch.clamp(x, lo, hi)


def lerp(x, y, weight, name=None):
    x, y, w = operands("lerp", x, y, weight)
    return x + w * (y - x)


def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    (x,) = cast_inputs("nan_to_num", t_(x))
    return torch.nan_to_num(x, nan=nan, posinf=posinf, neginf=neginf)


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    x, _, _ = operands("stanh", x, scale_a, scale_b)
    return scale_b * torch.tanh(scale_a * x)


def multiplex(inputs, index, name=None):
    stacked = torch.stack([t_(i) for i in inputs], 1)     # [N, num_ins, ...]
    idx = t_(index, stacked).reshape(-1).long()
    idx = idx.reshape(-1, 1, *([1] * (stacked.dim() - 2))).expand(
        -1, 1, *stacked.shape[2:])
    return torch.gather(stacked, 1, idx).squeeze(1)


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    x, y = operands("allclose", x, y, tensors=True)
    return torch.tensor(torch.allclose(x, y, rtol=rtol, atol=atol, equal_nan=equal_nan),
                        device=x.device)


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    x, y = operands("isclose", x, y, tensors=True)
    return torch.isclose(x, y, rtol=rtol, atol=atol, equal_nan=equal_nan)


def equal_all(x, y, name=None):
    x, y = operands("equal_all", x, y, tensors=True)
    return torch.tensor(x.shape == y.shape and torch.equal(x, y), device=x.device)


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    i, a, b = operands("addmm", input, x, y)
    return beta * i + alpha * (a @ b)


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    (x,) = cast_inputs("trace", t_(x))
    d = torch.diagonal(x, offset, axis1, axis2)
    return d.sum(-1, dtype=_sum_dtype(x.dtype))


def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    (x,) = cast_inputs("diagonal", t_(x))
    return torch.diagonal(x, offset, axis1, axis2)


def _sum_dtype(d):
    """jnp.sum's and jnp.prod's dtype under x64: bool and the integers
    narrower than 64 bits sum in int64 (uint in uint64)."""
    if d == torch.bool or d in (torch.int8, torch.int16, torch.int32):
        return torch.int64
    if d in (torch.uint8, torch.uint16, torch.uint32):
        return torch.uint64
    return d


def _cum_dtype(d):
    """jnp.cumsum's and jnp.cumprod's dtype: bool counts in int64, every
    other dtype keeps itself (torch would widen the integers to int64)."""
    return torch.int64 if d == torch.bool else d


def cumsum(x, axis=None, dtype=None, name=None):
    (x,) = cast_inputs("cumsum", t_(x))
    if axis is None:
        x, axis = x.reshape(-1), 0
    d = dtypes.convert_dtype(dtype) if dtype else _cum_dtype(x.dtype)
    return torch.cumsum(x, int(axis), dtype=d)


def cumprod(x, dim=None, dtype=None, name=None):
    (x,) = cast_inputs("cumprod", t_(x))
    if dim is None:
        x, dim = x.reshape(-1), 0
    d = dtypes.convert_dtype(dtype) if dtype else _cum_dtype(x.dtype)
    return torch.cumprod(x, int(dim), dtype=d)


def _cum_ext(fn, x, axis, dtype):
    x = t_(x)
    if axis is None:
        x, axis = x.reshape(-1), 0
    vals, inds = fn(x, int(axis))
    return vals, inds.to(dtypes.convert_dtype(dtype))


def cummax(x, axis=None, dtype="int64", name=None):
    """Running max and the index of its last occurrence."""
    return _cum_ext(torch.cummax, x, axis, dtype)


def cummin(x, axis=None, dtype="int64", name=None):
    return _cum_ext(torch.cummin, x, axis, dtype)


def logcumsumexp(x, axis=None, dtype=None, name=None):
    (x,) = cast_inputs("logcumsumexp", t_(x))
    if axis is None:
        x, axis = x.reshape(-1), 0
    return torch.logcumsumexp(to_inexact(x), int(axis))


def rsqrt_(x):
    return x.rsqrt_()


def add_n(inputs, name=None):
    """Elementwise sum of a list of tensors; of one tensor, a new tensor."""
    if torch.is_tensor(inputs):
        (inputs,) = cast_inputs("add_n", inputs)
        return inputs.clone()
    xs = operands("add_n", *inputs)
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return out


def renorm(x, p, axis, max_norm, name=None):
    """Clamp the p-norm of every slice along ``axis`` to at most max_norm."""
    (x,) = cast_inputs("renorm", t_(x))
    axis = axis + x.dim() if axis < 0 else axis
    other = tuple(i for i in range(x.dim()) if i != axis)
    p = float(p)
    norms = torch.sum(torch.abs(x) ** p, dim=other, keepdim=True) ** (1.0 / p)
    factor = torch.where(norms > max_norm, max_norm / (norms + 1e-7),
                         torch.ones((), dtype=norms.dtype, device=norms.device))
    return x * factor


def complex(real, imag, name=None):
    re, im = operands("complex", real, imag, tensors=True)
    return torch.complex(re, im)


__all__ = public(globals())
