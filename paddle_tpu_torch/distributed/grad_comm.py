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

import math
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


def clip_shard(g, clip, group, split=None):
    """Grad clip on the rank's slice of the flat mean gradient, in place.
    ByValue is elementwise; ByGlobalNorm needs the global sum of squares,
    one scalar all_reduce (summed in another order than the replicated
    per-parameter clip, so a clipped ZeRO run matches it to rounding, not
    bit for bit). ``split`` = (spans (start, stop, mask) of ``g`` by the
    bit mask of the axes that split their parameter, and the engine's
    function that sums a [8] vector of squares by mask over those axes'
    groups): a split parameter's squares are also summed over its axes,
    the others counted once. Other rules need per-parameter norms: the
    engine runs the replicated update for them."""
    from ..nn.clip import ClipGradByGlobalNorm, ClipGradByValue

    if clip is None:
        return g
    if isinstance(clip, ClipGradByGlobalNorm):
        if split is None:
            sq = torch.dot(g, g).reshape(1)
            collective.all_reduce(sq, group=group)
        else:
            spans, sum_split = split
            parts = [[] for _ in range(8)]
            covered = torch.zeros(g.shape, dtype=torch.bool, device=g.device)
            for a, b, m in spans:
                if m:
                    parts[m].append(torch.dot(g[a:b], g[a:b]))
                    covered[a:b] = True
            rest = g[~covered]
            parts[0].append(torch.dot(rest, rest))
            sq = torch.stack([torch.stack(p).sum() if p else g.new_zeros(()) for p in parts])
            collective.all_reduce(sq, group=group)
            sum_split(sq)
        gn = torch.sqrt(sq.sum())
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


# ------------------------------------------------------------------- FSDP --

def default_layer_key(name: str) -> str:
    """The FSDP bucket key of a parameter without a model hook: its owning
    module's path (a Linear's weight and bias share a bucket). A model
    groups otherwise by defining ``fsdp_layer_key(name)`` (models/gpt.py:
    one bucket a transformer block)."""
    return name.rsplit(".", 1)[0] if "." in name else name


def fsdp_buckets(param_shapes: Dict[str, tuple], nrep: int, chunk: int,
                 layer_key=None):
    """The per-layer buckets of the sorted-name flat parameter vector
    (reference grad_comm.py:591): a bucket is a maximal run of names with
    one layer key (a key that comes back later opens another bucket), so
    each is a contiguous slice of the flat vector, padded to a multiple of
    nrep x chunk (equal shards a rank and an exact int8 chunk grid).
    Returns dicts {key, names, off (flat offset), n (elements), pad, shard
    (pad // nrep)}. Only element counts enter, so the port's transposed
    Linear weights give the JAX package's buckets."""
    key_fn = layer_key or default_layer_key
    unit = max(1, nrep) * max(1, chunk)
    buckets: list = []
    off = 0
    for nm in sorted(param_shapes):
        key = str(key_fn(nm))
        size = math.prod(tuple(param_shapes[nm])) or 1
        if not buckets or key != buckets[-1]["key"]:
            buckets.append({"key": key, "names": [], "off": off, "n": 0})
        buckets[-1]["names"].append(nm)
        buckets[-1]["n"] += size
        off += size
    for b in buckets:
        b["pad"] = -(-b["n"] // unit) * unit
        b["shard"] = b["pad"] // max(1, nrep)
    return buckets


def fsdp_payload_bytes(shard_elems, nrep: int, dtype: str, chunk: int):
    """(reduce_scatter_bytes, all_gather_bytes, per-bucket gather bytes) a
    rank hands the FSDP step's collectives (the payload_bytes convention):
    one f32 shard gather a bucket and no trailing gather; the scatter
    carries the bucket-padded gradients plus one loss column a destination
    row (int8: in the f32 scales exchange)."""
    nrep = max(1, nrep)
    s_total = int(sum(shard_elems))
    if dtype == "f32":
        rs = nrep * (s_total + 1) * 4
    elif dtype == "bf16":
        rs = nrep * (s_total + 1) * 2
    else:  # int8 payload + one f32 scale per chunk + the loss column
        rs = nrep * s_total * 1 + nrep * (s_total // chunk + 1) * 4
    per_layer = [int(s) * 4 for s in shard_elems]
    return rs, sum(per_layer), per_layer


def fsdp_window_bytes(buckets, depth: int) -> int:
    """Gathered bytes a depth-``depth`` prefetch window holds at once: the
    most, over window positions in the sorted bucket order, of the summed
    padded f32 bucket sizes (depth 0 and 1 hold one bucket). The
    reference's formula, kept for the memory model's parity."""
    gb = [int(b["pad"]) * 4 for b in buckets]
    if not gb:
        return 0
    d = max(1, min(int(depth), len(gb)))
    return max(sum(gb[i:i + d]) for i in range(len(gb) - d + 1))


def fsdp_prefetch_ahead_bytes(buckets, depth: int) -> int:
    """Bytes a depth-``depth`` window holds beyond the just-in-time one:
    the padded f32 buckets 1..depth-1 (0 below depth 2)."""
    if int(depth) < 2:
        return 0
    return sum(int(b["pad"]) * 4 for b in buckets[1:int(depth)])


def fsdp_prefetch_depth(buckets, requested: int) -> int:
    """The requested prefetch depth clamped so the window never holds more
    than the two largest adjacent buckets (the largest d <= requested whose
    fsdp_window_bytes fits under depth 2's); <= 0 stays 0."""
    d = min(int(requested), max(1, len(buckets)))
    if d <= 0:
        return 0
    cap = fsdp_window_bytes(buckets, 2)
    while d > 2 and fsdp_window_bytes(buckets, d) > cap:
        d -= 1
    return d


class FsdpRows:
    """The bucket-shard-major permutation of the flat [n] vector that the
    FSDP reduce-scatter scatters by (reference ``_rows``): row r holds rank
    r's shard of every bucket, in bucket order, ``s_total`` elements, zeros
    in the pads; rank r's shard of bucket b is row r's
    [``soffs[b]``, ``soffs[b + 1]``)."""

    def __init__(self, buckets, nrep: int):
        self.nrep = max(1, nrep)
        self.soffs = [0]
        for b in buckets:
            self.soffs.append(self.soffs[-1] + b["shard"])
        self.s_total = self.soffs[-1]
        self.n = sum(b["n"] for b in buckets)
        self.segments = []  # (flat start, flat stop, row, column)
        for bi, b in enumerate(buckets):
            for r in range(self.nrep):
                lo = r * b["shard"]
                hi = min(b["n"], lo + b["shard"])
                if lo < hi:
                    self.segments.append((b["off"] + lo, b["off"] + hi, r,
                                          self.soffs[bi]))

    def to_rows(self, flat, rows):
        """rows[r, c:c + len] = flat[a:b] for every segment (rows' pads are
        left as they are)."""
        for a, b, r, c in self.segments:
            rows[r, c:c + b - a].copy_(flat[a:b])

    def from_rows(self, rows, flat):
        for a, b, r, c in self.segments:
            flat[a:b].copy_(rows[r, c:c + b - a])


def fsdp_pack(flat, rows: FsdpRows, loss, dtype, chunk, residual):
    """The FSDP reduce-scatter's payload from this rank's mean gradient
    ``flat`` ([n] f32, read once: the caller frees it afterwards) and mean
    loss; residual as in reduce_local ([n] f32 flat order, updated in place,
    or None). f32 / bf16: [nrep, s_total + 1] rows with the loss in every
    row's last column; int8: (q [nrep, s_total / chunk, chunk], [scales |
    loss] [nrep, s_total / chunk + 1])."""
    nrep, s = rows.nrep, rows.s_total
    if residual is not None:
        flat.add_(residual)
    if dtype == "f32":
        out = torch.zeros((nrep, s + 1), dtype=torch.float32, device=flat.device)
        rows.to_rows(flat, out)
        out[:, s] = loss
        return out
    if dtype == "bf16":
        b16 = flat.to(torch.bfloat16)
        if residual is not None:
            torch.sub(flat, b16.float(), out=residual)
        out = torch.zeros((nrep, s + 1), dtype=torch.bfloat16, device=flat.device)
        rows.to_rows(b16, out)
        out[:, s] = loss
        return out
    # int8: each bucket shard is a chunk multiple, so the rows' chunks are
    # the padded buckets' chunks (reference _scatter's grid), reordered
    f = torch.zeros((nrep, s), dtype=torch.float32, device=flat.device)
    rows.to_rows(flat, f)
    q, scale = _quantize_int8(f.view(-1), chunk)
    if residual is not None:
        _sub_dequantized(f.view(-1), f.view(-1), q, scale, f.numel())
        rows.from_rows(f, residual)
    del f
    aux = torch.empty((nrep, s // chunk + 1), dtype=torch.float32, device=q.device)
    aux[:, :-1] = scale.view(nrep, s // chunk)
    aux[:, -1] = loss
    return q.view(nrep, s // chunk, chunk), aux


def fsdp_scatter(payload, rows: FsdpRows, group, dtype, chunk):
    """The ONE gradient reduce-scatter of the FSDP step (reference
    ``_scatter``, grad_comm.py:863): returns (this rank's shards of the mean
    gradient over the replicas [s_total] f32, in bucket order; the mean
    loss). f32 / bf16: one ``reduce_scatter`` of the rows (the loss column
    sums to the replicas' loss sum on every rank); int8: two
    ``all_to_all``s, the payload and the scales with the loss, dequantised
    and summed in f32 in rank order."""
    nrep, s = rows.nrep, rows.s_total
    if dtype in ("f32", "bf16"):
        out = torch.empty(s + 1, dtype=payload.dtype, device=payload.device)
        collective.reduce_scatter(out, payload.view(-1), group=group)
        out = out.float()
        return out[:s].div_(nrep), out[s] / nrep
    q, aux = payload
    qr = torch.empty_like(q)
    ar = torch.empty_like(aux)
    collective.all_to_all_single(qr, q, group=group)
    collective.all_to_all_single(ar, aux, group=group)
    g = torch.zeros(s, dtype=torch.float32, device=q.device)
    for i in range(nrep):
        _add_dequantized(g, qr[i], ar[i, :-1], s)
    return g.div_(nrep), ar[:, -1].sum() / nrep
