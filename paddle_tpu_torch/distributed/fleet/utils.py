"""Recompute, activation checkpointing (counterpart of
paddle_tpu/distributed/fleet/utils.py's ``recompute``).

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
``torch.autocast``, so checkpoint does not carry it), and the states of the
``generators`` the segment draws from (the model's dropout generator), each
put back as it was after the replay.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ...amp import amp_ctx, amp_scope

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
    amp = amp_ctx()
    gens = list(generators) if preserve_rng_state else []
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
            with amp_scope(amp):
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
