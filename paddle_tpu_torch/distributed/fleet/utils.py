"""Recompute, activation checkpointing, and the eager data-parallel helpers
(counterpart of paddle_tpu/distributed/fleet/utils.py's ``recompute``,
``fused_allreduce_gradients`` and ``broadcast_*_parameters``).

The JAX package lowers a recomputed segment to ``jax.checkpoint`` with a
policy; here it is ``torch.utils.checkpoint.checkpoint(use_reentrant=False)``:
the forward saves only the segment's inputs, and the backward runs the
segment again to rebuild what it needs. The policies keep the JAX names:

- ``"full"`` (or None): save nothing inside the segment.
- ``"selective"``: JAX's ``dots_with_no_batch_dims_saveable``. The outputs
  of products without batch dims (``aten.mm``, ``aten.addmm``: the linear
  layers) are saved; everything else is recomputed, the flash kernels and
  the batched products (``bmm``, ``baddbmm``) of attention included.

The replay runs under what the forward ran under, beyond the global CPU and
CUDA RNG states that ``preserve_rng_state`` restores: the port's
``amp.auto_cast`` context active at forward time (it is not
``torch.autocast``, so checkpoint does not carry it), the trace flag of
jit.py (a replay inside the engine's step leaves a QATLinear's activation
scale alone, as the JAX package's traced replay does), the sequence-parallel
scope (meta_parallel/sequence_parallel.py: the replay's attention runs over
the ranks again), the RNG tracker's draw source (its generator on the
segment's device) and the states of the ``generators`` the segment draws
from (the model's dropout generator), each put back as it was after the
replay.

``fused_allreduce_gradients(parameter_list, hcg)`` averages the gradients
over the data replicas (``hcg.replica_group()``: dp x sharding x sp, the
ranks that hold the same shards) with the bucketed ``Reducer``, one
collective a bucket; the Reducers are kept in an LRU of at most 4 a group,
keyed by the trainable members, so freezing or unfreezing a parameter
rebuilds the buckets. ``broadcast_dp_parameters`` /
``broadcast_sharding_parameters`` / ``broadcast_mp_parameters`` broadcast
every parameter from the group's first rank; the mp one skips the
parameters the mp layers shard, which differ by construction (reference
:197-201). The
JAX package's ``fs`` (``LocalFS``, ``HDFSClient``) is not ported (ROADMAP.md
Queue 1 item 3).
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ...amp import amp_ctx, amp_scope
from ...jit import in_jit_trace, trace_scope

#: ops whose outputs "selective" saves: products with no batch dims
SAVED_OPS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default})


def selective_policy(ctx, op, *args, **kwargs):
    """The selective-checkpoint policy of ``"selective"``: save ``SAVED_OPS``'
    outputs, recompute the rest (a fresh ``empty`` for every kernel output)."""
    return (CheckpointPolicy.MUST_SAVE if op in SAVED_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


_REMAT_POLICIES = {
    # reference recompute_granularity names
    "full": None,
    "selective": selective_policy,
}


def _resolve_policy(policy):
    if policy is None:
        return None
    if isinstance(policy, str) and policy in _REMAT_POLICIES:
        return _REMAT_POLICIES[policy]
    raise ValueError(f"unknown recompute policy {policy!r}; use 'full' or "
                     f"'selective'")


def recompute(function, *args, policy=None, preserve_rng_state=True,
              generators=()):
    """``function(*args)`` with its activations recomputed in the backward.

    policy: "full" / None, or "selective" (module docstring). generators:
    the ``torch.Generator``s ``function`` draws from besides the global
    ones; with ``preserve_rng_state`` the replay draws what the forward
    drew from each. Without grad (or without an input that needs it) this
    is just ``function(*args)``."""
    policy_fn = _resolve_policy(policy)
    if not torch.is_grad_enabled() or not any(
            torch.is_tensor(a) and a.requires_grad for a in args):
        return function(*args)
    from ...ops.nn_functional import current_draw_source, draw_source
    from ..meta_parallel import sequence_parallel as _sp

    amp, traced, sp_ctx, draw = amp_ctx(), in_jit_trace(), _sp.current(), current_draw_source()
    gens = list(generators) if preserve_rng_state else []
    if draw is not None and preserve_rng_state:
        dev = next(a.device for a in args if torch.is_tensor(a))
        gens.append(draw.generator(dev))
    fwd_states = [g.get_state() for g in gens]
    calls = 0

    def segment(*a):
        nonlocal calls
        calls += 1
        if calls == 1:          # the forward itself
            return function(*a)
        now = [g.get_state() for g in gens]
        for g, s in zip(gens, fwd_states):
            g.set_state(s)
        try:
            with amp_scope(amp), trace_scope(traced), _sp.scope_of(sp_ctx), \
                    draw_source(draw):
                return function(*a)
        finally:
            for g, s in zip(gens, now):
                g.set_state(s)

    kw = {}
    if policy_fn is not None:
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                             policy_fn)
    return checkpoint(segment, *args, use_reentrant=False,
                      preserve_rng_state=preserve_rng_state, **kw)


def allreduce_gradients_over(parameter_list, group, find_unused_parameters=False):
    """Average the gradients of ``parameter_list`` over ``group`` with the
    group's cached Reducer (module docstring). Returns the Reducer."""
    from ..meta_parallel.data_parallel import Reducer

    params = [p for p in parameter_list if p.requires_grad and p.numel()]
    key = (tuple(id(p) for p in params), bool(find_unused_parameters))
    slots = _reducer_cache.setdefault(id(group), {})
    red = slots.pop(key, None)  # pop and put back: dict order is recency
    if red is None:
        while len(slots) >= 4:  # the least recently used goes
            slots.pop(next(iter(slots)))
        red = Reducer(params, group=group, find_unused_parameters=find_unused_parameters)
    slots[key] = red
    red.sync()
    return red


_reducer_cache = {}  # id(group) -> {(trainable ids, find_unused): Reducer} (LRU, at most 4)


def fused_allreduce_gradients(parameter_list, hcg, find_unused_parameters=False):
    """Reference hybrid_parallel_util.py:142: the bucketed average over
    ``hcg``'s data replicas (``replica_group``); nothing for a group of one
    rank.
    ``find_unused_parameters``: a missing gradient counts as zeros (the
    Reducer's), which the port's callers take from the strategy: its ranks
    are processes that may disagree on which parameters a step used."""
    group = hcg.replica_group() if hcg else None
    if group is None or group.nranks <= 1:
        return None
    return allreduce_gradients_over(parameter_list, group, find_unused_parameters)


@torch.no_grad()
def _broadcast_group_parameters(model, group, skip=()):
    from .. import collective

    if group is None or group.nranks <= 1:
        return
    for name, p in model.named_parameters():
        if name not in skip:
            collective.broadcast(p.data, src=group.ranks[0], group=group)


def broadcast_mp_parameters(model, hcg):
    from ..meta_parallel.mp_layers import sharded_parameters

    _broadcast_group_parameters(model, hcg.get_model_parallel_group(),
                                skip=sharded_parameters(model))


def broadcast_dp_parameters(model, hcg):
    _broadcast_group_parameters(model, hcg.get_data_parallel_group())


def broadcast_sharding_parameters(model, hcg):
    _broadcast_group_parameters(model, hcg.get_sharding_parallel_group())
