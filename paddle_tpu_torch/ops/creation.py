"""Tensor creation ops (counterpart of paddle_tpu/ops/creation.py).

Every creation op takes ``place=`` (a Place, "cpu", "gpu:0", a
``torch.device``) and otherwise creates on the current place
(``set_device``), which is the card unless set otherwise: without a card
they raise rather than create on the CPU. Ops of an input tensor
(``zeros_like``, ``bernoulli``, ...) create on that tensor's device.

Dtypes follow the JAX package under x64: Python ints give int64, floats the
default float dtype, a float64 numpy array the default float dtype too.
Random ops draw from the device's generator (``core/random.py``); their
draws differ from the JAX package's by design, so the tests hold their
shapes, dtypes, ranges, moments and determinism under ``seed``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..amp import cast_inputs
from ..core import dtype as dtypes
from ..core import random as random_mod
from ..device import resolve_device
from ._helpers import public, result_dtype, t_, to_torch, value


def _device(place):
    return resolve_device(place)


def _shape(shape):
    if torch.is_tensor(shape):
        return tuple(int(s) for s in shape.reshape(-1).tolist())
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(value(s)) for s in shape)


def _float(dtype):
    return dtypes.convert_dtype(dtype) if dtype else dtypes.get_default_dtype()


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    """A new tensor of ``data``; ``stop_gradient=False`` makes it require grad."""
    d = dtypes.convert_dtype(dtype)
    if torch.is_tensor(data):
        out = data.detach().to(device=_device(place) if place is not None else data.device,
                               dtype=d, copy=True)
    else:
        out = to_torch(data, dtype=d, device=_device(place))
    if not stop_gradient:
        out.requires_grad_(True)
    return out


def zeros(shape, dtype=None, name=None, place=None):
    return torch.zeros(_shape(shape), dtype=_float(dtype), device=_device(place))


def ones(shape, dtype=None, name=None, place=None):
    return torch.ones(_shape(shape), dtype=_float(dtype), device=_device(place))


def full(shape, fill_value, dtype=None, name=None, place=None):
    fill_value = value(fill_value)
    if dtype is not None:
        d = dtypes.convert_dtype(dtype)
    elif isinstance(fill_value, float):
        d = dtypes.get_default_dtype()
    else:
        d = result_dtype(fill_value)
    return torch.full(_shape(shape), fill_value, dtype=d, device=_device(place))


def empty(shape, dtype=None, name=None, place=None):
    return zeros(shape, dtype, place=place)


def zeros_like(x, dtype=None, name=None):
    x = t_(x)
    return torch.zeros_like(x, dtype=dtypes.convert_dtype(dtype))


def ones_like(x, dtype=None, name=None):
    x = t_(x)
    return torch.ones_like(x, dtype=dtypes.convert_dtype(dtype))


def full_like(x, fill_value, dtype=None, name=None):
    x = t_(x)
    return torch.full_like(x, value(fill_value), dtype=dtypes.convert_dtype(dtype))


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype)


def arange(start=0, end=None, step=1, dtype=None, name=None, place=None):
    start, end, step = value(start), value(end), value(step)
    if end is None:
        start, end = 0, start
    if dtype is None:
        dtype = (dtypes.get_default_dtype()
                 if any(isinstance(v, float) for v in (start, end, step)) else torch.int64)
    return torch.arange(start, end, step, dtype=dtypes.convert_dtype(dtype),
                        device=_device(place))


def linspace(start, stop, num, dtype=None, name=None, place=None):
    return torch.linspace(value(start), value(stop), int(value(num)), dtype=_float(dtype),
                          device=_device(place))


def logspace(start, stop, num, base=10.0, dtype=None, name=None, place=None):
    return torch.logspace(value(start), value(stop), int(value(num)), base=base,
                          dtype=_float(dtype), device=_device(place))


def eye(num_rows, num_columns=None, dtype=None, name=None, place=None):
    n = int(num_rows)
    m = n if num_columns is None else int(num_columns)
    return torch.eye(n, m, dtype=_float(dtype), device=_device(place))


def tril(x, diagonal=0, name=None):
    (x,) = cast_inputs("tril", t_(x))
    return torch.tril(x, int(diagonal))


def triu(x, diagonal=0, name=None):
    (x,) = cast_inputs("triu", t_(x))
    return torch.triu(x, int(diagonal))


def diag(x, offset=0, padding_value=0, name=None):
    (x,) = cast_inputs("diag", t_(x))
    out = torch.diag(x, int(offset))
    if x.dim() == 1 and padding_value != 0:
        on = torch.diag(torch.ones_like(x, dtype=torch.bool), int(offset))
        out = torch.where(on, out, torch.tensor(padding_value, dtype=x.dtype, device=x.device))
    return out


def diagflat(x, offset=0, name=None):
    (x,) = cast_inputs("diagflat", t_(x))
    return torch.diagflat(x, int(offset))


def _diag_rc(n, offset, device):
    """(row, col) index tensors of an n-element diagonal at ``offset``."""
    idx = torch.arange(n, device=device)
    if offset >= 0:
        return idx, idx + offset
    return idx - offset, idx


def diag_embed(input, offset=0, dim1=-2, dim2=-1, name=None):
    """The last dim of ``input`` becomes the (offset) diagonal of a new
    matrix spanned by dims (dim1, dim2) of the output."""
    (x,) = cast_inputs("diag_embed", t_(input))
    return torch.diag_embed(x, int(offset), int(dim1), int(dim2))


def fill_diagonal_tensor(x, y, offset=0, dim1=0, dim2=1, name=None):
    """Write ``y`` onto the (offset) diagonal spanned by (dim1, dim2) of a
    copy of ``x``."""
    x, y = cast_inputs("fill_diagonal_tensor", t_(x), t_(y, x))
    d1, d2 = dim1 % x.dim(), dim2 % x.dim()
    m = torch.movedim(x, (d1, d2), (-2, -1)).clone()
    nr, nc = m.shape[-2], m.shape[-1]
    dlen = min(nr, nc - offset) if offset >= 0 else min(nr + offset, nc)
    r, c = _diag_rc(dlen, offset, x.device)
    m[..., r, c] = y.to(x.dtype)
    return torch.movedim(m, (-2, -1), (d1, d2))


def meshgrid(*args, **kwargs):
    """"ij" grids of 1-D tensors; each keeps its own dtype, as in jnp."""
    seq = args[0] if len(args) == 1 and isinstance(args[0], (list, tuple)) else args
    xs = [t_(a).reshape(-1) for a in seq]
    shape = [x.shape[0] for x in xs]
    return [x.reshape([-1 if j == i else 1 for j in range(len(xs))]).expand(shape)
            for i, x in enumerate(xs)]


def assign(x, output=None):
    x = t_(x)
    (x,) = cast_inputs("assign", x)
    out = x.clone()
    if output is not None:
        with torch.no_grad():
            output.copy_(out)
        return output
    return out


def clone(x, name=None):
    (x,) = cast_inputs("clone", t_(x))
    return x.clone()


def numel(x, name=None):
    x = t_(x)
    return torch.tensor(x.numel(), dtype=torch.int64, device=x.device)


def tril_indices(row, col, offset=0, dtype=None, place=None):
    return torch.tril_indices(int(row), int(col), int(offset), device=_device(place),
                              dtype=dtypes.convert_dtype(dtype or "int64"))


def triu_indices(row, col=None, offset=0, dtype=None, place=None):
    col = row if col is None else col
    return torch.triu_indices(int(row), int(col), int(offset), device=_device(place),
                              dtype=dtypes.convert_dtype(dtype or "int64"))


def clone_detached(x):
    return t_(x).detach().clone()


# ---- random creation: each device's generator (core/random.py) ----

def rand(shape, dtype=None, name=None, place=None):
    dev = _device(place)
    return torch.rand(_shape(shape), dtype=_float(dtype), device=dev,
                      generator=random_mod.generator(dev))


def randn(shape, dtype=None, name=None, place=None):
    dev = _device(place)
    return torch.randn(_shape(shape), dtype=_float(dtype), device=dev,
                       generator=random_mod.generator(dev))


def normal(mean=0.0, std=1.0, shape=None, name=None, place=None):
    like = next((t for t in (mean, std) if torch.is_tensor(t)), None)
    dev = like.device if like is not None and place is None else _device(place)
    out = torch.randn(() if shape is None else _shape(shape), dtype=dtypes.get_default_dtype(),
                      device=dev, generator=random_mod.generator(dev))
    return out * std + mean


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None, place=None):
    """Draws from the device's generator, or with ``seed`` from a fresh
    generator seeded with it."""
    dev = _device(place)
    gen = (torch.Generator(device=dev).manual_seed(int(seed)) if seed
           else random_mod.generator(dev))
    out = torch.empty(_shape(shape), dtype=_float(dtype), device=dev)
    return out.uniform_(value(min), value(max), generator=gen)


def randint(low=0, high=None, shape=(1,), dtype=None, name=None, place=None):
    if high is None:
        low, high = 0, low
    dev = _device(place)
    return torch.randint(int(low), int(high), _shape(shape), device=dev,
                         dtype=dtypes.convert_dtype(dtype) if dtype else torch.int64,
                         generator=random_mod.generator(dev))


def randint_like(x, low=0, high=None, dtype=None, name=None):
    x = t_(x)
    return randint(low, high, tuple(x.shape), dtype or x.dtype, place=x.device)


def randperm(n, dtype=None, name=None, place=None):
    dev = _device(place)
    out = torch.randperm(int(n), device=dev, generator=random_mod.generator(dev))
    return out.to(dtypes.convert_dtype(dtype) if dtype else torch.int64)


def bernoulli(x, name=None):
    x = t_(x)
    return torch.bernoulli(x.detach(), generator=random_mod.generator(x.device))


def multinomial(x, num_samples=1, replacement=False, name=None):
    x = t_(x)
    return torch.multinomial(x.detach(), int(num_samples), replacement,
                             generator=random_mod.generator(x.device))


def standard_normal(shape, dtype=None, name=None, place=None):
    return randn(shape, dtype, place=place)


def poisson(x, name=None):
    x = t_(x)
    return torch.poisson(x.detach(), generator=random_mod.generator(x.device))


__all__ = public(globals())
