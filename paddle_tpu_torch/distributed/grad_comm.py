"""Gradient communication of the data-parallel step (counterpart of
paddle_tpu/distributed/grad_comm.py): ONE deferred reduce of one flat
buffer a step, after all K microbatches, with opt-in low-precision
payloads and ZeRO weight-update sharding.

The flat buffer holds every trainable parameter's gradient in f32, in
sorted parameter-name order (``FlatLayout``); the engine lets autograd
accumulate the K microbatches straight into it. Then:

- ``reduce_local`` (the JAX ``_reduce_local``): f32, one ``all_reduce``
  of ``[flat | loss]`` divided by the replicas; bf16, the same buffer in
  bf16 (NCCL and gloo sum it in bf16, as ``psum`` does); int8, the
  chunk-scaled payload (``_quantize_int8``: per-chunk absmax / 127, round
  half to even, clip +-127) and ``[scales | loss]`` in f32 gathered from
  every rank, then dequantised and summed in f32. With error feedback the
  rank keeps ``flat - dequant(quant(flat))`` (one f32 buffer of n) and adds
  it to the next step's gradient.
- ZeRO (the JAX ``make_zero_accum_step``): the buffer is padded to
  ``zero_pad_elems`` (the f32/bf16 loss rides in pad slot n); one
  ``reduce_scatter`` leaves rank r the reduced slice ``[r*shard,
  (r+1)*shard)`` (int8: an ``all_to_all`` of payload and scales instead);
  the rank clips and updates only its slice (``clip_shard``; the optimizer
  state lives as flat f32 shards), and one ``all_gather`` of ``[new weight
  shard | loss part]`` brings every rank the new weights.

Without a process group (``group`` None) every collective is the identity
and the low-precision payloads still round-trip, so their numerics are
testable on one process, as in the JAX package.

Counters (core/monitor.py), as in the JAX package: ``grad_comm.steps``,
``.microbatches``, ``.bytes_moved`` (the bytes a rank hands to the gradient
collectives a step: ``payload_bytes``, or ``zero_payload_bytes``' sum),
``.lowp_steps``, ``.rs_bytes`` and ``.ag_bytes`` (ZeRO's two collectives).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..core import flags as _flags
from ..core import monitor as _monitor
from . import collective

STEPS = _monitor.stat("grad_comm.steps")
MICROBATCHES = _monitor.stat("grad_comm.microbatches")
BYTES_MOVED = _monitor.stat("grad_comm.bytes_moved")
LOWP_STEPS = _monitor.stat("grad_comm.lowp_steps")
RS_BYTES = _monitor.stat("grad_comm.rs_bytes")
AG_BYTES = _monitor.stat("grad_comm.ag_bytes")

_CANON = {"f32": "f32", "float32": "f32", "fp32": "f32",
          "bf16": "bf16", "bfloat16": "bf16", "int8": "int8"}

#: elements a block of the quantiser and of the flat update works on at a
#: time (row-wise and elementwise work: blocks bound the temporaries and
#: change no result)
BLOCK = 1 << 24


def comm_dtype() -> str:
    """Canonical FLAGS_grad_comm_dtype value: 'f32' | 'bf16' | 'int8'."""
    v = str(_flags.flag("grad_comm_dtype")).lower()
    if v not in _CANON:
        raise ValueError(
            f"FLAGS_grad_comm_dtype={v!r} — expected one of "
            f"{sorted(set(_CANON))}")
    return _CANON[v]


def error_feedback() -> bool:
    return bool(_flags.flag("grad_comm_error_feedback"))


def chunk_size() -> int:
    c = int(_flags.flag("grad_comm_chunk"))
    if c <= 0:
        raise ValueError(f"FLAGS_grad_comm_chunk={c} must be positive")
    return c


def payload_bytes(n_grads: int, dtype: str, chunk: int) -> int:
    """Per-device bytes handed to the gradient collective for one optimizer
    step. f32/bf16 carry the loss scalar in the same buffer; int8 ships the
    quantized payload plus one f32 scale per chunk (+ the loss)."""
    if dtype == "f32":
        return (n_grads + 1) * 4
    if dtype == "bf16":
        return (n_grads + 1) * 2
    n_chunks = -(-n_grads // chunk)
    return n_chunks * chunk * 1 + (n_chunks + 1) * 4


def zero_pad_elems(n_grads: int, nrep: int, chunk: int) -> int:
    """Padded flat-buffer length for the ZeRO update path: a multiple of
    nrep*chunk, so every replica owns an equal contiguous shard AND the int8
    chunk grid tiles it exactly. Always leaves at least ONE spare pad slot —
    the f32/bf16 paths ride the loss scalar through the reduce-scatter in
    slot n_grads (the bit-exactness trick vs the replicated psum).
    dtype-independent on purpose — the sharded optimizer state keeps ONE
    shape across f32/bf16/int8 steps."""
    unit = max(1, nrep) * max(1, chunk)
    return -(-(n_grads + 1) // unit) * unit


def zero_payload_bytes(n_grads: int, nrep: int, dtype: str, chunk: int,
                       health_elems: int = 0) -> Tuple[int, int]:
    """(reduce_scatter_bytes, all_gather_bytes) per device per step for the
    ZeRO update path — the local contribution handed to each collective,
    the payload_bytes convention. The all-gather slab carries the updated
    f32 weight shard + the loss scalar + the health partials (when on)."""
    n_pad = zero_pad_elems(n_grads, nrep, chunk)
    shard = n_pad // max(1, nrep)
    if dtype == "f32":
        rs = n_pad * 4
    elif dtype == "bf16":
        rs = n_pad * 2
    else:  # int8 payload + one f32 scale per chunk, both via all-to-all
        rs = n_pad * 1 + (n_pad // chunk) * 4
    ag = (shard + 1 + health_elems) * 4
    return rs, ag


# ---------------------------------------------------------------- quantize --

def _quantize_int8(x, chunk):
    """Chunk-scaled int8 quantization: (q [C, chunk] int8, scales [C] f32)
    of the 1-D f32 ``x``, zero-padded to a chunk multiple (the pad
    quantizes to exact zeros). scale = absmax / 127 a chunk; q =
    clip(round(x / max(scale, 1e-30)), -127, 127), round half to even."""
    n = x.shape[0]
    pad = (-n) % chunk
    xp = torch.nn.functional.pad(x, (0, pad)) if pad else x
    xp = xp.reshape(-1, chunk)
    q = torch.empty(xp.shape, dtype=torch.int8, device=x.device)
    scale = torch.empty(xp.shape[0], dtype=torch.float32, device=x.device)
    rows = max(1, BLOCK // chunk)
    for lo in range(0, xp.shape[0], rows):
        blk = xp[lo:lo + rows]
        s = blk.abs().amax(dim=1) / 127.0
        scale[lo:lo + rows] = s
        safe = torch.clamp(s, min=1e-30)
        q[lo:lo + rows] = torch.round(blk / safe[:, None]).clamp_(-127, 127).to(torch.int8)
    return q, scale


def _dequantize_int8(q, scale, n):
    return (q.to(torch.float32) * scale[..., None]).reshape(
        q.shape[:-2] + (-1,))[..., :n]


def _blocks(q, n):
    """(chunk rows, flat start, flat stop) of q [C, chunk] a block at a
    time, the flat range cut at n."""
    chunk = q.shape[1]
    rows = max(1, BLOCK // chunk)
    for lo in range(0, q.shape[0], rows):
        a, b = lo * chunk, min(n, (lo + rows) * chunk)
        if a >= b:
            break
        yield slice(lo, lo + rows), a, b


def _sub_dequantized(out, x, q, scale, n):
    """out[:n] = x[:n] - dequant(q, scale)[:n]."""
    for rs, a, b in _blocks(q, n):
        torch.sub(x[a:b], _dequantize_int8(q[rs], scale[rs], b - a), out=out[a:b])


def _add_dequantized(out, q, scale, n):
    """out[:n] += dequant(q, scale)[:n]."""
    for rs, a, b in _blocks(q, n):
        out[a:b].add_(_dequantize_int8(q[rs], scale[rs], b - a))


# ------------------------------------------------------------------ layout --

class FlatLayout:
    """The flat f32 vector of the trainable parameters: sorted names, each
    parameter's elements at ``offsets[name]`` in its own (row-major) order,
    n elements; ``n_pad`` / ``shard`` are ZeRO's padded length and the
    slice each of ``nrep`` ranks owns."""

    def __init__(self, shapes: Dict[str, tuple], nrep: int, chunk: int):
        self.names = sorted(shapes)
        self.shapes = {nm: tuple(shapes[nm]) for nm in self.names}
        self.offsets, off = {}, 0
        for nm in self.names:
            self.offsets[nm] = off
            off += int(torch.Size(self.shapes[nm]).numel())
        self.n = off
        self.nrep = max(1, nrep)
        self.n_pad = zero_pad_elems(self.n, self.nrep, chunk)
        self.shard = self.n_pad // self.nrep

    def pieces(self, lo, hi):
        """(name, start, stop) for each parameter that overlaps the flat
        range [lo, hi): its elements [start, stop) lie at flat
        offsets[name] + start."""
        for nm in self.names:
            off = self.offsets[nm]
            size = int(torch.Size(self.shapes[nm]).numel())
            a, b = max(lo, off), min(hi, off + size)
            if a < b:
                yield nm, a - off, b - off


def replica_count(group) -> int:
    return 1 if group is None else group.nranks


# ---------------------------------------------------- the replicated reduce --

def reduce_local(buf, n, loss, group, dtype, chunk, residual):
    """The ONE deferred gradient collective of the replicated update.

    buf: [n + 1] f32 whose first n hold this rank's mean gradient (slot n is
    free); loss: this rank's mean loss (0-dim f32); residual: the rank's
    [n] f32 error-feedback buffer (bf16/int8 only), updated in place, or
    None. Returns (the mean gradient over the replicas [n] f32, the mean
    loss, a tensor of its own). The result is written into buf (the
    gradient is a view of it), so no payload allocates a second f32
    buffer."""
    nrep = replica_count(group)
    flat = buf[:n]
    if residual is not None:
        flat.add_(residual)
    if dtype == "f32":
        buf[n] = loss
        collective.all_reduce(buf, group=group)
    elif dtype == "bf16":
        b = torch.empty(n + 1, dtype=torch.bfloat16, device=buf.device)
        b[:n].copy_(flat)
        b[n] = loss
        if residual is not None:
            torch.sub(flat, b[:n].float(), out=residual)
        collective.all_reduce(b, group=group)
        buf.copy_(b)
        del b
    else:
        # int8: gather every rank's payload and [scales | loss], dequantise
        # and sum in f32 (a quantized all-reduce built from all-gather:
        # every rank's scales survive the trip). The loss rides the f32
        # scales buffer.
        q, scale = _quantize_int8(flat, chunk)
        if residual is not None:
            _sub_dequantized(residual, flat, q, scale, n)
        aux = torch.cat([scale, loss.reshape(1).float()])
        gq = torch.empty((nrep,) + tuple(q.shape), dtype=torch.int8, device=q.device)
        gaux = torch.empty((nrep, aux.shape[0]), dtype=torch.float32, device=q.device)
        collective.all_gather_into(gq, q, group=group)
        collective.all_gather_into(gaux, aux, group=group)
        del q, scale, aux
        flat.zero_()
        for i in range(nrep):
            _add_dequantized(flat, gq[i], gaux[i, :-1], n)
        buf[n] = gaux[:, -1].sum()
    if nrep > 1:
        buf.div_(nrep)
    return flat, buf[n].clone()


# ------------------------------------------------------------------- ZeRO --

def zero_scatter(buf, layout: FlatLayout, loss, group, dtype, chunk, residual):
    """The ONE gradient reduce-scatter of the ZeRO update.

    buf: f32 of at least n_pad elements, this rank's mean gradient in [:n]
    and zeros after it; loss: the rank's mean loss; residual as in
    reduce_local. Returns (this rank's slice of the mean gradient over the
    replicas [shard] f32, the loss part): at f32/bf16 the loss rides pad
    slot n, so the part is the reduced mean loss on the rank that owns slot
    n and 0 elsewhere; at int8 it is the rank's own mean loss. buf is free
    for other use afterwards (``zero_gather`` writes into it)."""
    n, n_pad, shard, nrep = layout.n, layout.n_pad, layout.shard, layout.nrep
    r = 0 if group is None else group.rank
    flat = buf[:n_pad]
    if residual is not None:
        flat[:n].add_(residual)
    ride = dtype != "int8"
    if ride:
        flat[n] = loss
    if dtype == "f32":
        g = torch.empty(shard, dtype=torch.float32, device=buf.device)
        collective.reduce_scatter(g, flat, group=group)
    elif dtype == "bf16":
        b = flat.to(torch.bfloat16)
        if residual is not None:
            torch.sub(flat[:n], b[:n].float(), out=residual)
        out = torch.empty(shard, dtype=torch.bfloat16, device=b.device)
        collective.reduce_scatter(out, b, group=group)
        del b
        g = out.float()
    else:
        # int8: a quantized reduce-scatter built from all-to-all: rank i
        # receives the chunk rows of its own slice from every rank, with
        # their scales, and sums their dequantised values in f32
        q, scale = _quantize_int8(flat, chunk)
        if residual is not None:
            _sub_dequantized(residual, flat, q, scale, n)
        rows = shard // chunk
        qr = torch.empty((nrep, rows, chunk), dtype=torch.int8, device=q.device)
        sr = torch.empty((nrep, rows), dtype=torch.float32, device=q.device)
        collective.all_to_all_single(qr, q.reshape(nrep, rows, chunk), group=group)
        collective.all_to_all_single(sr, scale.reshape(nrep, rows), group=group)
        del q, scale
        g = torch.zeros(shard, dtype=torch.float32, device=buf.device)
        for i in range(nrep):
            _add_dequantized(g, qr[i], sr[i], shard)
    if nrep > 1:
        g.div_(nrep)
    if not ride:
        return g, loss.reshape(()).float()
    idx = n - r * shard
    loss_part = torch.zeros((), dtype=torch.float32, device=g.device)
    if 0 <= idx < shard:
        loss_part = g[idx].clone()
        g[idx] = 0.0
    return g, loss_part


def clip_shard(g, clip, group):
    """Grad clip on the rank's slice of the flat mean gradient, in place.
    ByValue is elementwise; ByGlobalNorm needs the global sum of squares,
    one scalar all_reduce (summed in another order than the replicated
    per-parameter clip, so a clipped ZeRO run matches it to rounding, not
    bit for bit). Other rules need per-parameter norms: the engine runs the
    replicated update for them."""
    from ..nn.clip import ClipGradByGlobalNorm, ClipGradByValue

    if clip is None:
        return g
    if isinstance(clip, ClipGradByGlobalNorm):
        sq = torch.dot(g, g).reshape(1)
        collective.all_reduce(sq, group=group)
        gn = torch.sqrt(sq[0])
        return g.mul_(clip.clip_norm / torch.clamp(gn, min=clip.clip_norm))
    if isinstance(clip, ClipGradByValue):
        return g.clamp_(clip.min, clip.max)
    raise ValueError(f"unsupported grad clip for the ZeRO update: {clip!r}")


def zero_gather(new_p_shard, loss_part, group, nrep, ride_loss, out):
    """The ONE all-gather of ``[new weight shard | loss part]`` into ``out``
    (f32, at least nrep x (shard + 1) elements: the step's spent gradient
    buffer): returns (rows [nrep, shard], a view of out; the step's mean
    loss). Rank i's row is the flat slice it owns."""
    shard = new_p_shard.shape[0]
    slab = torch.cat([new_p_shard, loss_part.reshape(1)])
    rows = out[:nrep * (shard + 1)].view(nrep, shard + 1)
    collective.all_gather_into(rows, slab, group=group)
    loss = rows[:, shard].sum()
    if not ride_loss:
        loss = loss / nrep
    return rows[:, :shard], loss
