"""Eager collectives of the port on ``torch.distributed`` (counterpart of
paddle_tpu/distributed/collective.py's ``ReduceOp``, ``new_group``,
``get_group``, ``all_reduce``, ``all_gather``, ``reduce_scatter``,
``broadcast``, ``barrier`` and ``wait``; ``all_to_all_single`` for the int8
ZeRO reduce and Ulysses attention; ``ring_exchange``, the point-to-point
step of ring attention).

``group`` is a ``mesh.CommGroup`` or None (every rank). Without
torch.distributed, or for a group that carries no process group, a
collective is the identity (a copy where it has an output of its own); a
group of one rank with a process group still calls the backend, which
runs it as the identity. The calls are synchronous; ``all_reduce`` and
``broadcast`` with ``sync_op`` false return the backend's work handle
instead.
"""
from __future__ import annotations

import warnings

import torch
import torch.distributed as dist

from .mesh import CommGroup, get_hybrid_communicate_group


class ReduceOp:
    SUM = 0
    MAX = 1
    MIN = 2
    PROD = 3
    AVG = 4


_TORCH_OPS = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.MAX: dist.ReduceOp.MAX,
              ReduceOp.MIN: dist.ReduceOp.MIN, ReduceOp.PROD: dist.ReduceOp.PRODUCT}

_group_counter = [0]
_group_registry = {}


def new_group(ranks=None, backend=None, timeout=None):
    """A group over ``ranks`` (all by default). Every rank must call it, as
    with ``torch.distributed.new_group``."""
    _group_counter[0] += 1
    if not dist.is_initialized():
        g = CommGroup(None, [0] if ranks is None else ranks, None, id=_group_counter[0])
    else:
        ranks = list(range(dist.get_world_size())) if ranks is None else list(ranks)
        pg = dist.new_group(ranks, timeout=timeout, backend=backend)
        g = CommGroup(None, ranks, pg, id=_group_counter[0])
    _group_registry[g.id] = g
    return g


def get_group(gid=0):
    if gid == 0 and gid not in _group_registry:
        hcg = get_hybrid_communicate_group()
        if hcg is not None:
            return hcg.get_check_parallel_group()
    return _group_registry.get(gid)


def _pg(group):
    """(process group, live): live is false when the call is the identity."""
    if group is None:
        return None, dist.is_initialized()
    return group.process_group, group.process_group is not None


def _nranks(group):
    if group is None:
        return dist.get_world_size() if dist.is_initialized() else 1
    return group.nranks


def _quiet(fn, *args, **kw):
    """Call a torch.distributed function whose name newer torch releases
    deprecate (``reduce_scatter_tensor``, ``all_gather_into_tensor``: the
    names every supported release has) without its FutureWarning."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        return fn(*args, **kw)


def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True):
    """In place; AVG is the sum divided by the group's size."""
    pg, live = _pg(group)
    if not live:
        return tensor
    work = dist.all_reduce(tensor, op=_TORCH_OPS.get(op, dist.ReduceOp.SUM), group=pg,
                           async_op=not sync_op)
    if op == ReduceOp.AVG:
        if work is not None:
            work.wait()
        tensor.div_(_nranks(group))
        return tensor
    return work if not sync_op else tensor


def all_gather(tensor_list, tensor, group=None):
    """Appends every rank's ``tensor`` to ``tensor_list`` in rank order (a
    new list when it is None) and returns the list."""
    pg, live = _pg(group)
    out = [] if tensor_list is None else tensor_list
    if not live:
        out.append(tensor)
        return out
    parts = [torch.empty_like(tensor) for _ in range(_nranks(group))]
    dist.all_gather(parts, tensor.contiguous(), group=pg)
    out.extend(parts)
    return out


def all_gather_into(output, tensor, group=None, sync_op=True):
    """The rank-order concatenation of every rank's ``tensor`` (the flat
    form the gradient reduce uses) written into the contiguous ``output``
    (any shape of nranks x tensor.numel() elements). With ``sync_op``
    false it returns the backend's work handle (None for the identity)."""
    pg, live = _pg(group)
    if not live:
        output.copy_(tensor.reshape(output.shape))
        return output if sync_op else None
    work = _quiet(dist.all_gather_into_tensor, output.view(-1),
                  tensor.contiguous().view(-1), group=pg, async_op=not sync_op)
    return output if sync_op else work


def reduce_scatter(tensor, tensor_or_tensor_list, op=ReduceOp.SUM, group=None):
    """Rank r receives the reduction of the r-th of the equal parts of the
    input (a list is concatenated first) in ``tensor``."""
    src = tensor_or_tensor_list
    if isinstance(src, (list, tuple)):
        src = torch.cat([t.reshape(-1) for t in src])
    pg, live = _pg(group)
    if not live:
        tensor.copy_(src.reshape(tensor.shape))
        return tensor
    _quiet(dist.reduce_scatter_tensor, tensor, src.contiguous(),
           op=_TORCH_OPS.get(op, dist.ReduceOp.SUM), group=pg)
    if op == ReduceOp.AVG:
        tensor.div_(_nranks(group))
    return tensor


def all_to_all_single(output, tensor, group=None):
    """Equal splits along dim 0: rank r's j-th part lands as rank j's r-th
    (``output`` contiguous, of the input's size)."""
    pg, live = _pg(group)
    if not live:
        output.copy_(tensor)
        return output
    dist.all_to_all_single(output.view(-1), tensor.contiguous().view(-1), group=pg)
    return output


def ring_exchange(tensors, group=None, reverse=False):
    """Send each of ``tensors`` to the next rank of ``group`` (its rank
    order, wrapping around) and receive the previous rank's, in one
    ``batch_isend_irecv``; returns the received tensors (new tensors of the
    same shapes and dtypes, in order). ``reverse``: send to the previous
    rank and receive the next one's. On a group of one rank, or one
    without a process group, it returns ``tensors`` themselves."""
    pg, live = _pg(group)
    n = _nranks(group)
    if not live or n == 1:
        return list(tensors)
    ranks = group.ranks if group is not None else list(range(n))
    me = ranks.index(dist.get_rank())
    nxt, prv = ranks[(me + 1) % n], ranks[(me - 1) % n]
    if reverse:
        nxt, prv = prv, nxt
    outs = [torch.empty_like(t) for t in tensors]
    ops = []
    for t, o in zip(tensors, outs):
        ops.append(dist.P2POp(dist.isend, t.contiguous(), nxt, pg))
        ops.append(dist.P2POp(dist.irecv, o, prv, pg))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return outs


def broadcast(tensor, src=0, group=None, sync_op=True):
    pg, live = _pg(group)
    if not live:
        return tensor
    work = dist.broadcast(tensor, src=src, group=pg, async_op=not sync_op)
    return work if not sync_op else tensor


def barrier(group=None):
    pg, live = _pg(group)
    if live:
        dist.barrier(group=pg)


def wait(tensor):
    """Block the host until ``tensor``'s pending work on its device is done."""
    if tensor.is_cuda:
        torch.cuda.current_stream(tensor.device).synchronize()
    return tensor
