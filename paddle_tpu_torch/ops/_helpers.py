"""Op-definition helpers (counterpart of paddle_tpu/ops/_helpers.py).

Two rules of the JAX package hold for every op of the namespace:

- **The dtype rule.** The JAX package runs with x64 on, and a Python scalar
  beside a tensor is weakly typed: it takes the tensor's dtype unless its
  kind is higher (``int`` tensor times ``2.5`` is float64, a ``bool`` tensor
  plus ``1`` is int64, float32 times ``2.5`` stays float32). Two tensors
  promote by dtype alone, whatever their ranks (torch would let a 0-d tensor
  take the other's dtype). ``result_dtype`` computes this; the ops cast their
  tensors to it before the torch call.
- **The AMP lookup.** Every op looks itself up under ``amp.auto_cast`` by
  its JAX op name (``cast_inputs``) before the dtype rule, as the
  reference's dispatcher does for every op (``core/dispatch.py:441``).
"""
from __future__ import annotations

import types

import numpy as np
import torch

from ..amp import cast_inputs
from ..core import dtype as dtypes
from ..device import resolve_device

_SCALARS = (bool, int, float, complex)
_WEAK_RANK = {bool: 0, int: 1, float: 2, complex: 3}


def is_scalar(v) -> bool:
    return isinstance(v, _SCALARS)


def _weak_kind(v):
    for kind in (bool, int, float, complex):   # bool before int: bool is an int
        if isinstance(v, kind):
            return kind
    return None


def result_dtype(*operands):
    """The JAX package's result dtype of ``operands`` (tensors, Python
    scalars; None ignored) under x64 with weakly typed scalars."""
    strong = None
    weak = None
    for o in operands:
        if torch.is_tensor(o):
            strong = o.dtype if strong is None else torch.promote_types(strong, o.dtype)
        elif o is not None:
            k = _weak_kind(o)
            if k is not None and (weak is None or _WEAK_RANK[k] > _WEAK_RANK[weak]):
                weak = k
    if strong is None:
        return {bool: torch.bool, int: torch.int64, float: torch.float64,
                complex: torch.complex128, None: dtypes.get_default_dtype()}[weak]
    if weak is None or weak is bool:
        return strong
    if weak is int:
        return torch.int64 if strong == torch.bool else strong
    if weak is float:
        return strong if (strong.is_floating_point or strong.is_complex) else torch.float64
    if strong.is_complex:
        return strong
    return torch.complex64 if strong in (torch.float32, torch.float16, torch.bfloat16) \
        else torch.complex128


def to_torch(data, dtype=None, device=None):
    """A new tensor of ``data`` (scalar, list, numpy array): a float64 array
    goes to the default float dtype unless ``dtype`` is given, as the JAX
    package's ``as_tensor`` and ``to_tensor`` do."""
    if torch.is_tensor(data):
        return data.to(device=device, dtype=dtype)
    if isinstance(data, (list, tuple)) and any(torch.is_tensor(d) for d in data):
        data = [d.detach().cpu().numpy() if torch.is_tensor(d) else d for d in data]
    a = np.asarray(data)
    if dtype is None and a.dtype == np.float64:
        dtype = dtypes.get_default_dtype()
    if a.dtype.kind == "U" or a.dtype == object:
        raise TypeError(f"cannot make a tensor of {type(data).__name__} {data!r}")
    t = torch.from_numpy(np.array(a, copy=True, order="C"))
    return t.to(device=resolve_device(device), dtype=dtype)


def t_(x, like=None):
    """Op operand: a tensor passes through; anything else becomes a tensor
    on ``like``'s device (the current place without one)."""
    if torch.is_tensor(x):
        return x
    device = like.device if torch.is_tensor(like) else None
    if is_scalar(x):
        return torch.tensor(x, dtype=result_dtype(x), device=resolve_device(device))
    return to_torch(x, device=device)


def inputs(name, *xs):
    """``xs`` as tensors (on the first tensor's device) after the AMP lookup
    of op ``name``, each keeping its dtype otherwise; one alone unpacked."""
    like = next((x for x in xs if torch.is_tensor(x)), None)
    out = cast_inputs(name, *(t_(x, like) for x in xs))
    return out if len(out) > 1 else out[0]


def operands(name, *xs, tensors=False, dtype=None):
    """``xs`` (tensors, Python scalars, lists) after the AMP lookup of op
    ``name`` and the dtype rule: every tensor cast to the common dtype (or
    ``dtype``), every scalar left as a Python number, or made a 0-d tensor
    of that dtype when ``tensors``. Lists and arrays become tensors."""
    like = next((x for x in xs if torch.is_tensor(x)), None)
    xs = [x if x is None or torch.is_tensor(x) or is_scalar(x) else t_(x, like) for x in xs]
    if like is None:
        xs[0] = t_(xs[0])
        like = xs[0]
    idx = [i for i, x in enumerate(xs) if torch.is_tensor(x)]
    cast = cast_inputs(name, *(xs[i] for i in idx))
    for i, c in zip(idx, cast):
        xs[i] = c
    d = result_dtype(*xs) if dtype is None else dtype
    out = []
    for x in xs:
        if torch.is_tensor(x):
            out.append(x if x.dtype == d else x.to(d))
        elif x is not None and tensors:
            out.append(torch.tensor(x, dtype=d, device=like.device))
        else:
            out.append(x)
    return out


def _detached(fn):
    def run(*args, **kwargs):
        with torch.no_grad():
            return fn(*args, **kwargs)

    return run


def inexact_dtype(d):
    """jnp's dtype for an integer input to an inexact op under x64: int64
    and uint64 compute in float64, narrower integers and bool in float32."""
    if d.is_floating_point or d.is_complex:
        return d
    return torch.float64 if d in (torch.int64, torch.uint64) else torch.float32


def to_inexact(x):
    """An integer or bool tensor in its ``inexact_dtype``; others unchanged."""
    d = inexact_dtype(x.dtype)
    return x if d == x.dtype else x.to(d)


def unary(name, fn, differentiable=True, inexact=False):
    """Op ``name``: ``fn(x)`` after the AMP lookup; ``inexact`` ops take an
    integer input in its ``inexact_dtype`` (or through ``inexact`` when it
    is a function); a non-differentiable op records no graph."""
    run = fn if differentiable else _detached(fn)

    def op(x, name=None):
        (x,) = cast_inputs(op_name, t_(x))
        if inexact:
            x = inexact(x) if callable(inexact) else to_inexact(x)
        return run(x)

    op_name = name
    op.__name__ = name
    return op


def binary(name, fn, differentiable=True, tensors=False, inexact=False):
    """Op ``name``: ``fn(x, y)`` on the operands of the dtype rule
    (``operands``); ``inexact`` ops compute an integer result in its
    ``inexact_dtype`` (``true_divide``); ``tensors`` makes a scalar operand a
    0-d tensor."""
    run = fn if differentiable else _detached(fn)

    def op(x, y, name=None):
        x, y = operands(op_name, x, y, tensors=tensors)
        if inexact:
            d = inexact_dtype(result_dtype(x, y))
            x, y = operands(op_name, x, y, tensors=tensors, dtype=d)
        return run(x, y)

    op_name = name
    op.__name__ = name
    return op


def normalize_axis(axis, ndim):
    if axis is None:
        return None
    if isinstance(axis, (list, tuple)):
        return tuple(normalize_axis(a, ndim) for a in axis)
    axis = int(axis)
    if axis < 0:
        axis += ndim
    return axis


def axes(axis):
    """An axis argument as the reductions take it: None, an int or a tuple
    (a list, or a tensor of axes, becomes a tuple)."""
    if axis is None:
        return None
    if torch.is_tensor(axis):
        return tuple(int(a) for a in axis.reshape(-1).tolist())
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def public(namespace):
    """The op names of a module's ``namespace`` (its ``__all__``): no
    modules, no private names, none of these helpers."""
    return sorted(n for n, v in namespace.items()
                  if not n.startswith("_") and not isinstance(v, types.ModuleType)
                  and n not in _NOT_OPS)


def value(v):
    """A scalar argument that may come as a 0-d tensor, as a Python number."""
    return v.item() if torch.is_tensor(v) else v


_NOT_OPS = {n for n in dir() if not n.startswith("_")} | {"cast_inputs", "Place"}
