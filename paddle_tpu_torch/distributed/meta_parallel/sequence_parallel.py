"""Sequence parallelism: ring attention and Ulysses attention (counterpart of
paddle_tpu/distributed/meta_parallel/sequence_parallel.py).

Under sp each rank of the sequence-parallel group holds ``s / sp``
consecutive positions of every sequence (rank r the r-th block); attention,
the only op that mixes positions, runs over the group:

- **ring** (Liu et al., arXiv:2310.01889): each rank keeps its query block
  and the KV blocks go round the ring. Forward: one pass; on each block
  the flash forward (``flash_attention_with_lse``'s kernels) runs causal on
  the diagonal block, plain on a past block and not at all on a future one
  (causal), and the blocks merge by their lse, ``o <- w1 o + w2 o_t`` with
  ``w = exp(lse_i - logaddexp(lse_acc, lse_t))``. Backward: one more pass;
  each block takes the FA2 backward pair (``flash_attention_bwd_dkdv`` and
  ``flash_attention_bwd_dq``) with the merged, global lse and
  ``delta = rowsum(o do)``; dQ accumulates on the rank, and dK and dV
  travel round the ring with K and V (in f32) back to their owner.
- **Ulysses** (arXiv:2309.14509): an all_to_all re-shards q, k, v from
  sequence-split to head-split, ``flash_attention`` runs on the rank's
  ``h / sp`` heads over the whole sequence, and the inverse all_to_all
  brings the output back. Each all_to_all is differentiable (its adjoint
  is itself). The heads must divide by sp (the JAX package's ValueError).

On CUDA tensors both launch the hand flash kernels (a failure to build or
launch raises); on CPU tensors they take the kernels' plain versions, as
every kernel wrapper of the port does.

The ring's per-rank bodies are generators that yield at each exchange of
KV blocks; ``drive`` runs them and does the exchange:
``collective.ring_exchange`` for this rank of a process group
(``ring_attention``), or a rotation among P bodies run in this process
(``ring_attention_virtual``: P virtual ranks on one device, which
chip_smoke.py and the tests use).

``sequence_parallel_scope(group, impl)`` installs the group (the engine
does when ``sep_degree > 1``); inside it ``ops.nn_functional``'s
``scaled_dot_product_attention`` sends mask-free attention here
(``apply_ring_attention``), and ``position_offset`` gives the model its
block's first position.
"""
from __future__ import annotations

import contextlib
import math
import threading

import torch

from ...ops.kernels import flash_attention as _fa
from .. import collective

NEG_INF = -1e30
IMPLS = ("ring", "ulysses")

_state = threading.local()


def active() -> bool:
    """True inside a ``sequence_parallel_scope``."""
    return getattr(_state, "ctx", None) is not None


@contextlib.contextmanager
def sequence_parallel_scope(group, impl: str = "ulysses"):
    """Route attention to ring or Ulysses attention over ``group`` (a
    ``mesh.CommGroup``). Default matches ``DistributedStrategy.sep_impl``."""
    if impl not in IMPLS:
        raise ValueError(f"sequence-parallel impl must be 'ring' or 'ulysses', got "
                         f"{impl!r}")
    with scope_of((group, impl)):
        yield


def current():
    """The active scope, (group, impl), or None: a recomputed segment
    (distributed/fleet/utils.py) replays under the scope it ran in."""
    return getattr(_state, "ctx", None)


@contextlib.contextmanager
def scope_of(ctx):
    """Install ``current()``'s value ``ctx`` (None: no scope) in the block."""
    prev = getattr(_state, "ctx", None)
    _state.ctx = ctx
    try:
        yield
    finally:
        _state.ctx = prev


def position_offset(s_local: int) -> int:
    """The global position of this rank's first token: its sp rank x
    ``s_local`` inside a scope, 0 outside."""
    ctx = getattr(_state, "ctx", None)
    if ctx is None or ctx[0] is None:
        return 0
    return max(ctx[0].rank, 0) * int(s_local)


def apply_ring_attention(q, k, v, causal: bool):
    """Entry of ops.nn_functional inside a scope: this rank's q, k, v
    shards [b, s/sp, h, d] -> its shard of the output."""
    group, impl = _state.ctx
    fn = ring_attention if impl == "ring" else ulysses_attention
    return fn(q, k, v, group=group, causal=causal)


def _scale(q, sm_scale):
    return 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None else float(sm_scale)


# ------------------------------------------------------------------- ring ----

def _block_mode(rank, t, size, causal):
    """The held block's attention at step t: None (a future block, skipped),
    True (the diagonal block, causal) or False (plain)."""
    j = (rank - t) % size
    if not causal or j < rank:
        return False
    return True if j == rank else None


def _fwd_block(q, k, v, causal, scale):
    if q.is_cuda:
        return _fa._launch(q, k, v, causal, scale)
    return _fa.flash_attention_plain(q, k, v, causal, scale)


def _ring_fwd_body(q, k, v, rank, size, causal, scale):
    """One rank's forward; yields the (k, v) it passes on and is sent the
    (k, v) it receives. Returns (o in q's dtype, lse [b, h, s] f32)."""
    b, s, h, d = q.shape
    o = torch.zeros((b, s, h, d), dtype=torch.float32, device=q.device)
    lse = torch.full((b, h, s), NEG_INF, dtype=torch.float32, device=q.device)
    kc, vc = k, v
    for t in range(size):
        mode = _block_mode(rank, t, size, causal)
        if mode is not None:
            o_t, lse_t = _fwd_block(q, kc, vc, mode, scale)
            new = torch.logaddexp(lse, lse_t)
            w1 = torch.exp(lse - new).transpose(1, 2)[..., None]
            w2 = torch.exp(lse_t - new).transpose(1, 2)[..., None]
            o = o * w1 + o_t.float() * w2
            lse = new
        if t + 1 < size:
            kc, vc = yield (kc, vc)
    return o.to(q.dtype), lse


def _ring_bwd_body(q, k, v, o, lse, do, rank, size, causal, scale):
    """One rank's backward; yields (k, v, dk, dv) of the block it passes on
    (after the last block only (dk, dv), which reach their owner). Returns
    (dq, dk, dv) in the dtypes of q, k, v."""
    delta = _fa.attention_delta(o, do)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    kc, vc = k, v
    for t in range(size):
        mode = _block_mode(rank, t, size, causal)
        if mode is not None:
            args = (q, kc, vc, do, lse, delta, mode, scale)
            dk_t, dv_t = _fa.flash_attention_bwd_dkdv(*args)
            dq += _fa.flash_attention_bwd_dq(*args).float()
            dk += dk_t.float()
            dv += dv_t.float()
        if t + 1 < size:
            kc, vc, dk, dv = yield (kc, vc, dk, dv)
        else:
            dk, dv = yield (dk, dv)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def drive(bodies, exchange):
    """Advance the bodies in lockstep: each yield is one exchange of the
    messages (``exchange``: the bodies' messages -> what each receives).
    Returns the bodies' return values."""
    out = [None] * len(bodies)

    def advance(i, body, value):
        try:
            return body.send(value)
        except StopIteration as stop:
            out[i] = stop.value
            return None

    msgs = [advance(i, b, None) for i, b in enumerate(bodies)]
    while any(m is not None for m in msgs):
        got = exchange(msgs)
        msgs = [advance(i, b, g) for i, (b, g) in enumerate(zip(bodies, got))]
    return out


class GroupRing:
    """This rank of a process group's ring."""

    def __init__(self, group):
        self.group = group
        self.size = 1 if group is None else group.nranks
        self.ranks = [0 if group is None else group.rank]

    def exchange(self, msgs, reverse=False):
        return [tuple(collective.ring_exchange(list(msgs[0]), self.group, reverse))]


class VirtualRing:
    """``size`` ranks of a ring run in this process: rank i receives rank
    i - 1's message (``reverse``: rank i + 1's)."""

    def __init__(self, size):
        self.size = int(size)
        self.ranks = list(range(self.size))

    def exchange(self, msgs, reverse=False):
        step = -1 if reverse else 1
        return [msgs[(i - step) % self.size] for i in range(self.size)]


class _RingAttention(torch.autograd.Function):
    """The ring over ``ring``'s ranks held here: inputs q_0.., k_0.., v_0..
    (one block each), outputs o_0..; differentiable in every block."""

    @staticmethod
    def forward(ctx, causal, scale, ring, *qkv):
        n = len(ring.ranks)
        qs, ks, vs = qkv[:n], qkv[n:2 * n], qkv[2 * n:]
        res = drive([_ring_fwd_body(q, k, v, r, ring.size, causal, scale)
                      for r, q, k, v in zip(ring.ranks, qs, ks, vs)], ring.exchange)
        outs = [o for o, _ in res]
        ctx.save_for_backward(*qkv, *outs, *(lse for _, lse in res))
        ctx.causal, ctx.scale, ctx.ring = causal, scale, ring
        return tuple(outs)

    @staticmethod
    def backward(ctx, *g_outs):
        ring = ctx.ring
        n = len(ring.ranks)
        saved = ctx.saved_tensors
        qs, ks, vs = saved[:n], saved[n:2 * n], saved[2 * n:3 * n]
        outs, lses = saved[3 * n:4 * n], saved[4 * n:]
        res = drive([_ring_bwd_body(q, k, v, o, lse, g, r, ring.size, ctx.causal, ctx.scale)
                      for r, q, k, v, o, lse, g in zip(ring.ranks, qs, ks, vs, outs, lses,
                                                       g_outs)], ring.exchange)
        return (None, None, None, *(r[0] for r in res), *(r[1] for r in res),
                *(r[2] for r in res))


def ring_attention(q, k, v, group=None, causal: bool = False,
                   sm_scale: float | None = None):
    """This rank's shards [b, s/sp, h, d] of q, k, v in ``group`` (its
    rank-th block of the sequence) -> its shard of the output."""
    return _RingAttention.apply(bool(causal), _scale(q, sm_scale), GroupRing(group),
                                q, k, v)[0]


def ring_attention_virtual(q, k, v, size: int, causal: bool = False,
                           sm_scale: float | None = None):
    """The whole sequence [b, s, h, d] split into ``size`` blocks, run as
    ``size`` ranks of a ring in this process; returns the whole output."""
    qs, ks, vs = (x.chunk(size, dim=1) for x in (q, k, v))
    outs = _RingAttention.apply(bool(causal), _scale(q, sm_scale), VirtualRing(size),
                                *qs, *ks, *vs)
    return torch.cat(outs, dim=1)


# ---------------------------------------------------------------- ulysses ----

class _AllToAll(torch.autograd.Function):
    """all_to_all_single over ``group`` along dim 0; its adjoint is itself."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous()
        return collective.all_to_all_single(torch.empty_like(x), x, group=group)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        return collective.all_to_all_single(torch.empty_like(g), g, group=ctx.group), None


def ulysses_attention(q, k, v, group=None, causal: bool = False,
                      sm_scale: float | None = None):
    """This rank's shards [b, s/sp, h, d] -> its shard of the output, by
    all_to_all to [b, s, h/sp, d] and back; needs h % sp == 0."""
    size = 1 if group is None else group.nranks
    n_heads = q.shape[2]
    if n_heads % size:
        raise ValueError(
            f"ulysses sequence parallelism scatters heads over the 'sp' axis and "
            f"needs num_heads ({n_heads}) divisible by its size ({size}); use "
            f"strategy.sep_impl = 'ring' (no divisibility requirement) or change "
            f"the head count / sep_degree")
    scale = _scale(q, sm_scale)
    if size == 1:
        return _fa.flash_attention(q, k, v, causal, scale)

    def scatter_heads(x):            # [b, sl, h, d] -> [b, sl * P, h / P, d]
        b, sl, h, d = x.shape
        x = x.reshape(b, sl, size, h // size, d).permute(2, 0, 1, 3, 4)
        x = _AllToAll.apply(x, group)          # [P: seq block, b, sl, h/P, d]
        return x.permute(1, 0, 2, 3, 4).reshape(b, size * sl, h // size, d)

    def gather_heads(x, sl):         # [b, s, h / P, d] -> [b, sl, h, d]
        b, _, hp, d = x.shape
        x = x.reshape(b, size, sl, hp, d).permute(1, 0, 2, 3, 4)
        x = _AllToAll.apply(x, group)          # [P: head group, b, sl, h/P, d]
        return x.permute(1, 2, 0, 3, 4).reshape(b, sl, size * hp, d)

    out = _fa.flash_attention(scatter_heads(q), scatter_heads(k), scatter_heads(v),
                              causal, scale)
    return gather_heads(out, q.shape[1])
