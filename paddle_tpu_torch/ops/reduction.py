"""Reduction ops (counterpart of paddle_tpu/ops/reduction.py).

The JAX package's semantics where torch's differ: ``mean``, ``var``,
``std`` and the other inexact reductions of an integer tensor give float64
(torch raises); ``sum`` and ``prod`` of a narrow integer or bool tensor
give int64; ``median`` averages the two middle values of an even count
(``mode="avg"``, torch gives the lower); ``kthvalue`` and ``mode`` break
ties by the stable ascending order, as the reference's ``argsort`` does.
"""
from __future__ import annotations

import torch

from ..core import dtype as dtypes
from ._helpers import axes, inputs, normalize_axis, public, to_inexact
from .math import _sum_dtype


def _dims(x, axis):
    """torch's ``dim`` for a reference axis: every dim for None."""
    axis = axes(axis)
    return tuple(range(x.dim())) if axis is None else axis


def sum(x, axis=None, dtype=None, keepdim=False, name=None):
    x = inputs("sum", x)
    d = dtypes.convert_dtype(dtype) if dtype else _sum_dtype(x.dtype)
    return torch.sum(x, dim=_dims(x, axis), keepdim=bool(keepdim), dtype=d)


def mean(x, axis=None, keepdim=False, name=None):
    x = to_inexact(inputs("mean", x))
    return torch.mean(x, dim=_dims(x, axis), keepdim=bool(keepdim))


def max(x, axis=None, keepdim=False, name=None):
    x = inputs("max", x)
    return torch.amax(x, dim=_dims(x, axis), keepdim=bool(keepdim))


def min(x, axis=None, keepdim=False, name=None):
    x = inputs("min", x)
    return torch.amin(x, dim=_dims(x, axis), keepdim=bool(keepdim))


amax = max
amin = min


def prod(x, axis=None, keepdim=False, dtype=None, name=None):
    x = inputs("prod", x)
    d = dtypes.convert_dtype(dtype) if dtype else _sum_dtype(x.dtype)
    x = x.to(d)
    dims = _dims(x, axis)
    dims = dims if isinstance(dims, tuple) else (dims,)
    for ax in sorted((normalize_axis(a, x.dim()) for a in dims), reverse=True):
        x = torch.prod(x, dim=ax, keepdim=bool(keepdim))
    return x


def all(x, axis=None, keepdim=False, name=None):
    x = inputs("all", x)
    with torch.no_grad():
        return torch.all(x, dim=_dims(x, axis), keepdim=bool(keepdim))


def any(x, axis=None, keepdim=False, name=None):
    x = inputs("any", x)
    with torch.no_grad():
        return torch.any(x, dim=_dims(x, axis), keepdim=bool(keepdim))


def _arg(fn, name, x, axis, keepdim, dtype):
    x = inputs(name, x)
    with torch.no_grad():
        if axis is None:
            out = fn(x.reshape(-1), 0)
        else:
            out = fn(x, int(axes(axis)), keepdim=bool(keepdim))
    return out.to(dtypes.convert_dtype(dtype))


def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg(torch.argmax, "argmax", x, axis, keepdim, dtype)


def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg(torch.argmin, "argmin", x, axis, keepdim, dtype)


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    x = to_inexact(inputs("std", x))
    return torch.std(x, dim=_dims(x, axis), correction=1 if unbiased else 0,
                     keepdim=bool(keepdim))


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    x = to_inexact(inputs("var", x))
    return torch.var(x, dim=_dims(x, axis), correction=1 if unbiased else 0,
                     keepdim=bool(keepdim))


def logsumexp(x, axis=None, keepdim=False, name=None):
    x = to_inexact(inputs("logsumexp", x))
    return torch.logsumexp(x, dim=_dims(x, axis), keepdim=bool(keepdim))


def _moved(x, axis):
    """``x`` with the reduced axes flattened into the last one, and the
    shape a keepdim result takes."""
    dims = _dims(x, axis)
    dims = tuple(normalize_axis(d, x.dim()) for d in (dims if isinstance(dims, tuple)
                                                      else (dims,)))
    keep_shape = [1 if i in dims else s for i, s in enumerate(x.shape)]
    rest = [i for i in range(x.dim()) if i not in dims]
    y = x.permute(*rest, *dims).reshape(*[x.shape[i] for i in rest], -1)
    return y, keep_shape


def _middle(srt, n):
    """The mean of the two middle entries (one, for an odd count) of the
    sorted last axis whose first ``n`` entries are valid."""
    lo = torch.div(n - 1, 2, rounding_mode="floor").clamp_min(0)
    hi = torch.div(n, 2, rounding_mode="floor").clamp_max(srt.shape[-1] - 1)
    a = torch.take_along_dim(srt, lo.unsqueeze(-1), -1).squeeze(-1)
    b = torch.take_along_dim(srt, hi.unsqueeze(-1), -1).squeeze(-1)
    out = (a + b) / 2
    return torch.where(n > 0, out, torch.full_like(out, float("nan")))


def median(x, axis=None, keepdim=False, mode="avg", name=None):
    x = inputs("median", x)
    if mode == "min":
        ax = 0 if axis is None else int(axis)
        srt = torch.sort(x.reshape(-1) if axis is None else x, dim=ax, stable=True).values
        n = srt.shape[ax]
        return torch.select(srt, ax, (n - 1) // 2)
    x = to_inexact(x)
    y, keep_shape = _moved(x, axis)
    srt = torch.sort(y, dim=-1, stable=True).values
    n = torch.full(srt.shape[:-1], srt.shape[-1], dtype=torch.int64, device=x.device)
    out = _middle(srt, n)
    return out.reshape(keep_shape) if keepdim else out


def nanmedian(x, axis=None, keepdim=False, name=None):
    x = to_inexact(inputs("nanmedian", x))
    y, keep_shape = _moved(x, axis)
    srt = torch.sort(y, dim=-1, stable=True).values      # NaN sorts last
    out = _middle(srt, (~torch.isnan(y)).sum(-1))
    return out.reshape(keep_shape) if keepdim else out


def nansum(x, axis=None, dtype=None, keepdim=False, name=None):
    x = inputs("nansum", x)
    d = dtypes.convert_dtype(dtype) if dtype else _sum_dtype(x.dtype)
    return torch.nansum(x.to(d), dim=_dims(x, axis), keepdim=bool(keepdim))


def nanmean(x, axis=None, keepdim=False, name=None):
    x = to_inexact(inputs("nanmean", x))
    return torch.nanmean(x, dim=_dims(x, axis), keepdim=bool(keepdim))


def count_nonzero(x, axis=None, keepdim=False, name=None):
    x = inputs("count_nonzero", x)
    with torch.no_grad():
        out = torch.count_nonzero(x, dim=_dims(x, axis))
        if keepdim:
            out = out.reshape([1 if i in tuple(normalize_axis(a, x.dim()) for a in _dims(
                x, axis)) else s for i, s in enumerate(x.shape)])
    return out.to(torch.int64)


def _quantile(fn, name, x, q, axis, keepdim, interpolation):
    x = to_inexact(inputs(name, x))
    qt = torch.as_tensor(q, dtype=x.dtype, device=x.device)
    if axis is None or isinstance(axes(axis), int):
        return fn(x, qt, dim=None if axis is None else int(axes(axis)),
                  keepdim=bool(keepdim), interpolation=interpolation)
    y, keep_shape = _moved(x, axis)
    out = fn(y, qt, dim=-1, keepdim=False, interpolation=interpolation)
    if keepdim:
        out = out.reshape(*qt.shape, *keep_shape)
    return out


def quantile(x, q, axis=None, keepdim=False, interpolation="linear", name=None):
    return _quantile(torch.quantile, "quantile", x, q, axis, keepdim, interpolation)


def nanquantile(x, q, axis=None, keepdim=False, name=None):
    return _quantile(torch.nanquantile, "nanquantile", x, q, axis, keepdim, "linear")


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    """The k-th smallest along ``axis`` and its index, ties in stable order."""
    x = inputs("kthvalue", x)
    ax = normalize_axis(axis, x.dim())
    idx = torch.narrow(torch.argsort(x, dim=ax, stable=True), ax, k - 1, 1)
    vals = torch.take_along_dim(x, idx, ax)
    if keepdim:
        return vals, idx
    return vals.squeeze(ax), idx.squeeze(ax)


def mode(x, axis=-1, keepdim=False, name=None):
    """Most frequent value along ``axis`` and an index of it: among equally
    frequent values the smallest wins, and the index is that value's last
    occurrence (reference: its stable sort's run ends)."""
    x = inputs("mode", x)
    ax = normalize_axis(axis, x.dim())
    data = torch.movedim(x.detach(), ax, -1)
    n = data.shape[-1]
    order = torch.argsort(data, dim=-1, stable=True)
    svals = torch.take_along_dim(data, order, -1)
    pos = torch.arange(n, device=x.device).expand(data.shape)
    differ = svals[..., 1:] != svals[..., :-1]
    ones = torch.ones(data.shape[:-1] + (1,), dtype=torch.bool, device=x.device)
    is_start = torch.cat([ones, differ], -1)
    last_start = torch.cummax(torch.where(is_start, pos, torch.zeros_like(pos)), -1).values
    is_end = torch.cat([differ, ones], -1)
    freq = torch.where(is_end, pos - last_start + 1, torch.zeros_like(pos))
    best = torch.argmax(freq, -1, keepdim=True)    # first max: the smallest value
    mi = torch.movedim(torch.take_along_dim(order, best, -1), -1, ax)
    mv = torch.take_along_dim(x, mi, ax)
    if keepdim:
        return mv, mi
    return mv.squeeze(ax), mi.squeeze(ax)


__all__ = public(globals())
