"""``DataParallel`` and its bucketed ``Reducer`` (counterpart of
paddle_tpu/distributed/meta_parallel/data_parallel.py; reference
fluid/dygraph/parallel.py:413 and imperative/reducer.cc).

The eager data-parallel path: each rank runs ``loss.backward()`` on its own
rows, then the gradients are averaged over the data-parallel group in
buckets, one ``all_reduce`` (``ReduceOp.AVG``) of a flat buffer a bucket,
and each parameter's ``grad`` becomes its slice of the averaged buffer. The
sync runs after the backward, as in the JAX package: through
``fleet.distributed_optimizer``'s ``HybridParallelOptimizer`` at ``step()``
(``fleet.utils.fused_allreduce_gradients``), or by calling
``DataParallel.sync_gradients()``. This is not
``torch.nn.parallel.DistributedDataParallel``, whose hooks reduce during the
backward in buckets of another order and count; the overlap with the
backward is ROADMAP.md Queue 1 item 6.
"""
from __future__ import annotations

import contextlib

import torch

from .. import collective
from ..env import get_world_size
from ..mesh import get_hybrid_communicate_group


class Reducer:
    """Bucketed fused gradient all-reduce (reference reducer.h:126).

    Trainable parameters go into buckets in reverse registration order (the
    backward makes their gradients back to front), each of one dtype and at
    most ``comm_buffer_size`` MiB; the last bucket (the front of the model)
    gives its tail parameters to one more bucket of at most
    ``last_comm_buffer_size`` MiB. A parameter larger than the cap has a
    bucket of its own. ``sync()`` runs one collective a bucket, so the count
    a step is the bucket count, not the parameter count; ``n_collectives``
    adds them up.

    ``find_unused_parameters=True``: a parameter without a gradient
    contributes zeros and gets the group's average back, so a parameter any
    rank used steps on every rank. False: parameters without a gradient are
    left out, and every rank must agree on which those are.
    """

    def __init__(self, parameters, group=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False):
        self.params = [p for p in parameters if p.requires_grad and p.numel()]
        self.group = group
        self.find_unused_parameters = find_unused_parameters
        self.n_collectives = 0
        self._buckets = self._build_buckets(
            comm_buffer_size * (1 << 20), last_comm_buffer_size * (1 << 20))

    def _build_buckets(self, cap, last_cap):
        def nbytes(p):
            return p.numel() * p.element_size()

        buckets, cur, cur_bytes, cur_dtype = [], [], 0, None
        for p in reversed(self.params):
            if cur and (cur_dtype != p.dtype or cur_bytes + nbytes(p) > cap):
                buckets.append(cur)
                cur, cur_bytes = [], 0
            cur.append(p)
            cur_bytes, cur_dtype = cur_bytes + nbytes(p), p.dtype
        if cur:
            buckets.append(cur)
        # only the final flush stays small: the last bucket's tail parameters
        # move into one bucket of at most last_cap bytes
        if buckets and last_cap < cap and len(buckets[-1]) > 1:
            tail = list(buckets[-1])
            small, size = [], 0
            while tail and size + nbytes(tail[-1]) <= last_cap:
                size += nbytes(tail[-1])
                small.insert(0, tail.pop())
            if small and tail:
                buckets[-1] = tail
                buckets.append(small)
        return buckets

    @torch.no_grad()
    def sync(self):
        """All-reduce (AVG) every bucket; returns the number of collectives."""
        if self.group is None or self.group.nranks <= 1:
            return 0
        calls = 0
        for bucket in self._buckets:
            live = (bucket if self.find_unused_parameters
                    else [p for p in bucket if p.grad is not None])
            if not live:
                continue
            buf = torch.cat([p.grad.reshape(-1) if p.grad is not None
                             else torch.zeros(p.numel(), dtype=p.dtype, device=p.device)
                             for p in live])
            collective.all_reduce(buf, op=collective.ReduceOp.AVG, group=self.group)
            calls += 1
            off = 0
            for p in live:
                p.grad = buf[off:off + p.numel()].view_as(p)
                off += p.numel()
        self.n_collectives += calls
        return calls


class DataParallel(torch.nn.Module):
    """The model wrapper of the eager data-parallel path: ``forward`` is the
    wrapped model's, ``sync_gradients()`` runs the Reducer, and
    ``state_dict`` / ``set_state_dict`` are the wrapped model's (no
    ``_layers.`` prefix). ``no_sync()`` is the reference's context for
    backward passes that accumulate without a sync; here no backward syncs
    (the sync runs at ``step`` or ``sync_gradients``), so it only marks
    them."""

    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False, group=None):
        super().__init__()
        self._layers = layers
        self.find_unused_parameters = find_unused_parameters
        self.comm_buffer_size = comm_buffer_size
        self.last_comm_buffer_size = last_comm_buffer_size
        self._enable_sync = True
        hcg = get_hybrid_communicate_group()
        self.group = group or (hcg.get_data_parallel_group() if hcg else None)
        self._world = self.group.nranks if self.group else get_world_size()
        self._reducer = self._new_reducer(list(layers.parameters()))

    def _new_reducer(self, params):
        return Reducer(params, group=self.group, comm_buffer_size=self.comm_buffer_size,
                       last_comm_buffer_size=self.last_comm_buffer_size,
                       find_unused_parameters=self.find_unused_parameters)

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    @contextlib.contextmanager
    def no_sync(self):
        prev = self._enable_sync
        self._enable_sync = False
        try:
            yield
        finally:
            self._enable_sync = prev

    def sync_gradients(self):
        """The Reducer's sync, after the backward. The buckets are rebuilt
        when the trainable parameters changed since the last build (frozen or
        unfrozen ones, or new ones)."""
        if self._world <= 1:
            return
        trainable = [p for p in self._layers.parameters() if p.requires_grad and p.numel()]
        if [id(p) for p in trainable] != [id(p) for p in self._reducer.params]:
            calls = self._reducer.n_collectives
            self._reducer = self._new_reducer(trainable)
            self._reducer.n_collectives = calls
        self._reducer.sync()

    def scale_loss(self, loss):
        return loss

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.load_state_dict(state_dict, *args, **kwargs)

    load_state_dict = set_state_dict


@torch.no_grad()
def sync_params_buffers(model, comm_group=None, src_rank=0, is_model_parallel=False):
    """Broadcast every parameter from ``src_rank`` (reference
    parallel.py:369); a world of one rank does nothing."""
    if get_world_size() <= 1:
        return
    for p in model.parameters():
        collective.broadcast(p.data, src=src_rank, group=comm_group)
