"""Shape, layout and indexing ops (counterpart of paddle_tpu/ops/manipulation.py).

Paddle's semantics, as the JAX package has them, where torch's differ:
``transpose(x, perm)`` takes a full permutation; ``gather`` selects slices
along ``axis`` by a 1-D (or 0-d) index (``jnp.take``, torch's
``index_select``); ``scatter`` overwrites, or with ``overwrite=False`` zeroes
the indexed rows and then accumulates; ``sort`` / ``argsort`` with
``descending=True`` flip the stable ascending order, so ties come
last-index-first; ``topk`` keeps ties in index order; ``pad`` with a list of
``2 * ndim`` pads first dim first, a shorter list pads the spatial dims last
first; ``split`` takes a ``-1`` section; ``unique`` and
``unique_consecutive`` give numpy's outputs (first-occurrence index, int64
inverse and counts). ``getitem`` / ``setitem`` are the functions behind
indexing (the port attaches no methods to ``torch.Tensor``); ``setitem``
writes in place, so on a leaf that requires grad it raises, as the
reference's does. ``diff`` takes ``prepend`` / ``append`` (the reference
accepts and drops them).
"""
from __future__ import annotations

import builtins

import numpy as np
import torch
import torch.nn.functional as TF

from ..amp import cast_inputs
from ..core import dtype as dtypes
from ._helpers import axes, inputs, normalize_axis, operands, public, t_, value


def _static_shape(shape):
    if torch.is_tensor(shape):
        return tuple(int(s) for s in shape.reshape(-1).tolist())
    return tuple(int(value(s)) for s in shape)


def cast(x, dtype):
    d = dtypes.convert_dtype(dtype)
    x = t_(x)
    if x.dtype == d:
        return x
    (x,) = cast_inputs("cast", x)
    out = x.to(d)
    if not (d.is_floating_point and x.is_floating_point()):
        out = out.detach()
    return out


astype = cast


def reshape(x, shape, name=None):
    return torch.reshape(inputs("reshape", x), _static_shape(shape))


def reshape_(x, shape, name=None):
    """Reshape ``x`` in place (a contiguous tensor takes the new shape's
    strides over the same storage)."""
    if not x.is_contiguous():
        raise ValueError("reshape_ needs a contiguous tensor")
    new = torch.empty(x.shape, device="meta").reshape(_static_shape(shape))
    return x.as_strided_(new.shape, new.stride(), x.storage_offset())


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    x = inputs("flatten", x)
    nd = builtins.max(x.dim(), 1)
    return torch.flatten(x, normalize_axis(start_axis, nd), normalize_axis(stop_axis, nd))


def transpose(x, perm, name=None):
    return inputs("transpose", x).permute(*[int(p) for p in perm])


def t(x, name=None):
    x = t_(x)
    if x.dim() < 2:
        return x
    return inputs("transpose", x).transpose(-1, -2)


def moveaxis(x, source, destination, name=None):
    return torch.movedim(inputs("moveaxis", x), source, destination)


def swapaxes(x, axis0, axis1, name=None):
    return torch.swapaxes(inputs("swapaxes", x), axis0, axis1)


def concat(x, axis=0, name=None):
    return torch.cat(operands("concat", *x), dim=int(value(axis)))


def stack(x, axis=0, name=None):
    return torch.stack(operands("stack", *x), dim=int(axis))


def vstack(x):
    return torch.vstack(operands("vstack", *x))


def hstack(x):
    return torch.hstack(operands("hstack", *x))


def dstack(x):
    return torch.dstack(operands("dstack", *x))


def split(x, num_or_sections, axis=0, name=None):
    x = inputs("split", x)
    axis = normalize_axis(value(axis), x.dim())
    dim = x.shape[axis]
    if isinstance(num_or_sections, int):
        if dim % num_or_sections != 0:
            raise ValueError(
                f"split: dimension {dim} along axis {axis} is not divisible by "
                f"num_or_sections={num_or_sections}")
        sizes = [dim // num_or_sections] * num_or_sections
    else:
        sizes = [int(value(s)) for s in num_or_sections]
        if -1 in sizes:
            known = builtins.sum(s for s in sizes if s != -1)
            sizes = [s if s != -1 else dim - known for s in sizes]
    return list(torch.split(x, sizes, dim=axis))


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis)


def unbind(x, axis=0, name=None):
    return list(torch.unbind(inputs("unbind", x), dim=int(axis)))


def squeeze(x, axis=None, name=None):
    x = inputs("squeeze", x)
    if axis is None:
        return torch.squeeze(x)
    if isinstance(axis, (int, np.integer)):
        axis = [axis]
    ax = tuple(a for a in normalize_axis(tuple(axis), x.dim()) if x.shape[a] == 1)
    return torch.squeeze(x, ax) if ax else x.view(x.shape)


def _expand_axes(ndim, axis):
    """jnp.expand_dims' positions of new axes, in the output's rank."""
    if torch.is_tensor(axis):
        axis = axis.reshape(-1).tolist()
    if isinstance(axis, (int, np.integer)):
        axis = [int(axis)]
    out = ndim + len(axis)
    return sorted(normalize_axis(int(a), out) for a in axis)


def unsqueeze(x, axis, name=None):
    x = inputs("unsqueeze", x)
    for a in _expand_axes(x.dim(), axis):
        x = x.unsqueeze(a)
    return x


def expand(x, shape, name=None):
    x = inputs("expand", x)
    shape = _static_shape(shape)
    shape = tuple(x.shape[i - (len(shape) - x.dim())] if s == -1 else s
                  for i, s in enumerate(shape))
    return torch.broadcast_to(x, shape)


broadcast_to = expand


def expand_as(x, y, name=None):
    return expand(x, t_(y).shape)


def broadcast_shape(x_shape, y_shape):
    return list(np.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def broadcast_tensors(inputs, name=None):
    return list(torch.broadcast_tensors(*[t_(i) for i in inputs]))


def tile(x, repeat_times, name=None):
    if torch.is_tensor(repeat_times):
        repeat_times = repeat_times.reshape(-1).tolist()
    return torch.tile(inputs("tile", x), tuple(int(value(r)) for r in repeat_times))


def repeat_interleave(x, repeats, axis=None, name=None):
    x = inputs("repeat_interleave", x)
    if torch.is_tensor(repeats):
        repeats = repeats.to(device=x.device, dtype=torch.int64)
    else:
        repeats = int(repeats)
    return torch.repeat_interleave(x, repeats, dim=axis)


def flip(x, axis, name=None):
    if isinstance(axis, int):
        axis = [axis]
    return torch.flip(inputs("flip", x), tuple(axis))


def rot90(x, k=1, axes=(0, 1), name=None):
    return torch.rot90(inputs("rot90", x), k, tuple(axes))


def roll(x, shifts, axis=None, name=None):
    x = inputs("roll", x)
    if axis is None:
        return torch.roll(x.reshape(-1), shifts).reshape(x.shape)
    return torch.roll(x, shifts, axis)


def where(condition, x=None, y=None, name=None):
    if x is None and y is None:
        return nonzero(condition, as_tuple=True)
    cond = t_(condition)
    x, y = operands("where", x, y, tensors=True)
    return torch.where(cond if cond.dtype == torch.bool else cond != 0, x, y)


def nonzero(x, as_tuple=False, name=None):
    x = t_(x)
    with torch.no_grad():
        if as_tuple:
            return tuple(torch.nonzero(x, as_tuple=True))
        return torch.nonzero(x)


def masked_select(x, mask, name=None):
    x = inputs("masked_select", x)
    return torch.masked_select(x, t_(mask, x).bool())


def masked_fill(x, mask, value, name=None):
    x = t_(x)
    mask = t_(mask, x).bool()
    if torch.is_tensor(value):
        (x, value) = cast_inputs("masked_fill", x, value)
        return torch.where(mask, value.to(x.dtype), x)
    x, v = operands("masked_fill", x, value, tensors=True)
    return torch.where(mask, v, x)


def gather(x, index, axis=0, name=None):
    """Slices of ``x`` along ``axis`` at a 1-D index (a 0-d index drops the
    axis; a deeper one is flattened), as jnp.take."""
    x = inputs("gather", x)
    index = t_(index, x).long()
    axis = int(value(axis))
    if index.dim() == 0:
        return torch.index_select(x, axis, index.reshape(1)).squeeze(axis)
    return torch.index_select(x, axis, index.reshape(-1))


def gather_nd(x, index, name=None):
    x = inputs("gather_nd", x)
    index = t_(index, x).long()
    return x[tuple(torch.movedim(index, -1, 0))]


def take_along_axis(arr, indices, axis, broadcast=True, name=None):
    arr = inputs("take_along_axis", arr)
    return torch.take_along_dim(arr, t_(indices, arr).long(), int(axis))


def put_along_axis(arr, indices, values, axis, reduce="assign", name=None):
    arr = inputs("put_along_axis", arr)
    idx = t_(indices, arr).long()
    v = torch.broadcast_to(t_(values, arr).to(arr.dtype), idx.shape)
    if reduce == "assign":
        return torch.scatter(arr, axis, idx, v)
    if reduce == "add":
        return torch.scatter_add(arr, axis, idx, v)
    if reduce in ("multiply", "mul"):
        return torch.scatter_reduce(arr, axis, idx, v, "prod")
    raise ValueError(f"unknown reduce {reduce}")


def scatter(x, index, updates, overwrite=True, name=None):
    """Rows of ``x`` at ``index`` replaced by ``updates``; with
    ``overwrite=False`` the indexed rows are zeroed, then ``updates`` are
    added (duplicate indices sum)."""
    x, updates = inputs("scatter", x, updates)
    idx = t_(index, x).long().reshape(-1)
    u = updates.to(x.dtype)
    if overwrite:
        return x.index_put((idx,), u)
    zeroed = x.index_put((idx,), torch.zeros_like(u))
    return zeroed.index_put((idx,), u, accumulate=True)


def scatter_nd_add(x, index, updates, name=None):
    x, updates = inputs("scatter_nd_add", x, updates)
    idx = tuple(torch.movedim(t_(index, x).long(), -1, 0))
    return x.index_put(idx, updates.to(x.dtype), accumulate=True)


def scatter_nd(index, updates, shape, name=None):
    updates = t_(updates)
    zeros = torch.zeros(_static_shape(shape), dtype=updates.dtype, device=updates.device)
    return scatter_nd_add(zeros, index, updates)


def index_select(x, index, axis=0, name=None):
    return gather(x, index, axis)


def index_sample(x, index, name=None):
    return take_along_axis(x, index, axis=1)


def index_add(x, index, axis, value, name=None):
    x, value = inputs("index_add", x, value)
    return torch.index_add(x, axis, t_(index, x).long(), value.to(x.dtype))


def index_put(x, indices, value, accumulate=False, name=None):
    x = inputs("index_put", x)
    idx = tuple(t_(i, x) for i in indices)
    idx = tuple(i if i.dtype == torch.bool else i.long() for i in idx)
    (v,) = cast_inputs("index_put", t_(value, x))
    return x.index_put(idx, v.to(x.dtype), accumulate=bool(accumulate))


def sort(x, axis=-1, descending=False, name=None):
    out = torch.sort(inputs("sort", x), dim=axis, stable=True).values
    return torch.flip(out, (axis,)) if descending else out


def argsort(x, axis=-1, descending=False, name=None):
    with torch.no_grad():
        out = torch.argsort(inputs("argsort", x), dim=axis, stable=True)
    return torch.flip(out, (axis,)) if descending else out


def topk(x, k, axis=-1, largest=True, sorted=True, name=None):
    """The k largest (smallest) along ``axis`` and their indices; equal
    values in index order (lax.top_k)."""
    x = inputs("topk", x)
    k = int(value(k))
    axis = normalize_axis(axis if axis is not None else -1, x.dim())
    with torch.no_grad():
        order = torch.sort(x, dim=axis, descending=bool(largest), stable=True).indices
    inds = torch.narrow(order, axis, 0, k)
    return torch.take_along_dim(x, inds, axis), inds


def _first_index(inverse, n_unique, n):
    pos = torch.arange(n, device=inverse.device)
    first = torch.full((n_unique,), n, dtype=torch.int64, device=inverse.device)
    return first.scatter_reduce(0, inverse, pos, "amin")


def unique(x, return_index=False, return_inverse=False, return_counts=False, axis=None,
           dtype="int64", name=None):
    """np.unique's outputs: the sorted unique values (along ``axis``), and
    as asked the index of each one's first occurrence, the inverse and the
    counts, int64."""
    x = t_(x)
    with torch.no_grad():
        src = x.reshape(-1) if axis is None else x
        vals, inverse, counts = torch.unique(src, sorted=True, return_inverse=True,
                                             return_counts=True, dim=axis)
        if axis is None:
            inverse = inverse.reshape(x.shape)
        outs = [vals]
        if return_index:
            outs.append(_first_index(inverse, vals.shape[0 if axis is None else axis],
                                     inverse.numel()))
        if return_inverse:
            outs.append(inverse)
        if return_counts:
            outs.append(counts)
    return tuple(outs) if len(outs) > 1 else outs[0]


def unique_consecutive(x, return_inverse=False, return_counts=False, axis=None,
                       dtype="int64", name=None):
    x = t_(x)
    with torch.no_grad():
        src = x.reshape(-1) if axis is None else x
        vals, inverse, counts = torch.unique_consecutive(
            src, return_inverse=True, return_counts=True, dim=axis)
    out = [vals]
    if return_inverse:
        out.append(inverse.reshape(-1))
    if return_counts:
        out.append(counts)
    return tuple(out) if len(out) > 1 else out[0]


def searchsorted(sorted_sequence, values, out_int32=False, right=False, name=None):
    s, v = operands("searchsorted", sorted_sequence, values, tensors=True)
    with torch.no_grad():
        return torch.searchsorted(s.contiguous(), v.contiguous(), right=bool(right),
                                  out_int32=bool(out_int32))


def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    return searchsorted(sorted_sequence, x, out_int32, right)


def _pad_index(n, lo, hi, mode, device):
    """Source positions of a dim of size ``n`` padded by (lo, hi) in
    numpy's 'reflect', 'edge' or 'wrap' mode."""
    i = torch.arange(-lo, n + hi, device=device)
    if mode == "edge":
        return i.clamp(0, n - 1)
    if mode == "wrap":
        return torch.remainder(i, n)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    i = torch.remainder(i, period)
    return torch.where(i < n, i, period - i)


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    x = inputs("pad", x)
    if torch.is_tensor(pad):
        pad = pad.reshape(-1).tolist()
    pad = [int(p) for p in pad]
    nd = x.dim()
    if len(pad) == 2 * nd:
        width = [(pad[2 * i], pad[2 * i + 1]) for i in range(nd)]
    else:
        # paddle NCHW/NCL/NCDHW convention: the spatial dims, last dim first
        n_spatial = len(pad) // 2
        width = [(0, 0)] * nd
        first = 2 if data_format.startswith("NC") else 1
        spatial = list(range(first, first + n_spatial))
        for j, d in enumerate(reversed(spatial)):
            width[d] = (pad[2 * j], pad[2 * j + 1])
    jmode = {"constant": "constant", "reflect": "reflect", "replicate": "edge",
             "circular": "wrap"}[mode]
    if jmode == "constant":
        flat = [p for lo_hi in reversed(width) for p in lo_hi]
        return TF.pad(x, flat, mode="constant", value=value)
    for d, (lo, hi) in enumerate(width):
        if lo or hi:
            x = torch.index_select(x, d, _pad_index(x.shape[d], lo, hi, jmode, x.device))
    return x


def strided_slice(x, axes, starts, ends, strides, name=None):
    x = inputs("strided_slice", x)
    for ax, s, e, st in zip(axes, starts, ends, strides):
        ax = normalize_axis(ax, x.dim())
        sl = builtins.slice(s, e, st)
        if st > 0:
            idx = [builtins.slice(None)] * x.dim()
            idx[ax] = sl
            x = x[tuple(idx)]
        else:   # torch slices take no negative step
            pos = list(range(x.shape[ax]))[sl]
            x = torch.index_select(x, ax, torch.tensor(pos, dtype=torch.int64,
                                                       device=x.device))
    return x


def slice(x, axes, starts, ends, name=None):
    return strided_slice(x, axes, starts, ends, [1] * len(axes))


def crop(x, shape=None, offsets=None, name=None):
    x = t_(x)
    shape = _static_shape(shape)
    offsets = [0] * x.dim() if offsets is None else [int(o) for o in offsets]
    return strided_slice(x, list(range(x.dim())), offsets,
                         [o + s for o, s in zip(offsets, shape)], [1] * x.dim())


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    a = t_(input)
    shard_size = (index_num + nshards - 1) // nshards
    with torch.no_grad():
        in_shard = torch.div(a, shard_size, rounding_mode="floor") == shard_id
        return torch.where(in_shard, torch.remainder(a, shard_size),
                           torch.full_like(a, ignore_value))


def tensordot(x, y, axes=2, name=None):
    x, y = operands("tensordot", x, y, tensors=True)
    return torch.tensordot(x, y, dims=axes)


def as_real(x, name=None):
    x = inputs("as_real", x)
    return torch.stack([x.real, x.imag], -1)


def as_complex(x, name=None):
    x = inputs("as_complex", x)
    return torch.complex(x[..., 0], x[..., 1])


def unstack(x, axis=0, num=None, name=None):
    x = t_(x)
    if num is not None and num != x.shape[axis]:
        raise ValueError(f"unstack: num {num} is not the size {x.shape[axis]} of axis {axis}")
    return unbind(x, axis)


def reverse(x, axis, name=None):
    return flip(x, axis)


def view(x, shape_or_dtype, name=None):
    if isinstance(shape_or_dtype, (list, tuple)):
        return reshape(x, shape_or_dtype)
    return cast(x, shape_or_dtype)


def _atleast(fn, inputs):
    outs = [fn(t_(i)) for i in inputs]
    return outs if len(outs) > 1 else outs[0]


def atleast_1d(*inputs):
    return _atleast(torch.atleast_1d, inputs)


def atleast_2d(*inputs):
    return _atleast(torch.atleast_2d, inputs)


def atleast_3d(*inputs):
    return _atleast(torch.atleast_3d, inputs)


def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    x = inputs("diff", x)
    pre = None if prepend is None else t_(prepend, x)
    app = None if append is None else t_(append, x)
    return torch.diff(x, n=n, dim=axis, prepend=pre, append=app)


# ---- indexing: the functions behind x[item] and x[item] = value ----

def _convert_index(item, like):
    if isinstance(item, tuple):
        return tuple(_convert_index(i, like) for i in item)
    if torch.is_tensor(item):
        return item.to(like.device)
    if isinstance(item, (list, np.ndarray)):
        return torch.as_tensor(np.asarray(item), device=like.device)
    return item     # int, slice, None, Ellipsis


def _index_dims(entry):
    """How many dims of the indexed tensor an index entry consumes."""
    if entry is None or entry is Ellipsis:
        return 0
    if torch.is_tensor(entry) and entry.dtype == torch.bool:
        return entry.dim()
    return 1


def _negative_steps(x, idx):
    """``x`` with every slice of a negative step applied as a gather along
    its dim (torch slices take no negative step), and the index with those
    entries made ``slice(None)``; the other entries index as before."""
    entries = list(idx) if isinstance(idx, tuple) else [idx]
    if not any(isinstance(e, builtins.slice) and (e.step or 1) < 0 for e in entries):
        return x, idx
    span = x.dim() - builtins.sum(_index_dims(e) for e in entries)
    d = 0
    for i, e in enumerate(entries):
        if e is Ellipsis:
            d += span
        elif isinstance(e, builtins.slice) and (e.step or 1) < 0:
            pos = list(range(x.shape[d]))[e]
            x = torch.index_select(x, d, torch.tensor(pos, dtype=torch.int64, device=x.device))
            entries[i] = builtins.slice(None)
            d += 1
        else:
            d += _index_dims(e)
    return x, tuple(entries) if isinstance(idx, tuple) else entries[0]


def getitem(x, item):
    x = inputs("getitem", x)
    x, idx = _negative_steps(x, _convert_index(item, x))
    return x[idx]


def setitem(x, item, value):
    """``x[item] = value`` in place; returns ``x``."""
    if torch.is_tensor(value):
        value = value.to(device=x.device, dtype=x.dtype)
    elif not isinstance(value, (bool, int, float, complex)):
        value = t_(value, x).to(x.dtype)
    x[_convert_index(item, x)] = value
    return x


__all__ = public(globals())
