"""Training-health telemetry of the train step (counterpart of
paddle_tpu/observability/health.py).

The signals that predict a run going sideways — the global grad norm,
per-parameter grad/weight norms and update-to-weight ratios, and *which
parameter first went non-finite* — computed on the card from the step's
own tensors and decoded on the host. The contract:

- **interval steps only**: on a step that is a multiple of
  ``FLAGS_health_interval`` the engine computes the stats; every other step
  launches nothing and syncs nothing for them (the reference computes them
  inside its compiled step every step and fetches them on interval steps;
  an eager step has no program to ride, so the port skips the work too);
- **one device->host transfer**: everything is packed into ONE f32 ``[4P]``
  buffer (P = parameter count) laid out as
  ``[grad_sq | weight_sq | update_sq | nonfinite_count]`` in segment order,
  fetched in one copy;
- **host-side attribution**: the first segment with a non-finite gradient
  is mapped back to the parameter NAME, fed to the metrics registry
  (``health.nonfinite.<param>``), written to the ``health.jsonl`` sink, and
  stamped into the flight-recorder dump that the breach triggers.

The device half (``begin_stats`` / ``end_stats``) takes lists of tensors,
one a *piece*: a whole parameter, or the part of one that a ZeRO or FSDP
rank's flat shard holds, with its ordinal in segment order. The squared
norms come from ``torch._foreach_norm`` (a few multi-tensor launches for
all pieces), the gradient's from the PRE-clip gradient; the non-finite
counts from one prefix sum over the concatenated gradient (exact: the
difference of the int prefix at the pieces' ends). The update's norm is
had from a copy of the pre-update weights, taken on interval steps only
(``begin_stats``), subtracted from the updated weights (``end_stats``). A
shard's partial ``[4P]`` (zeros for the parameters it does not hold) is
placed by ``index_add_`` on the pieces' ordinals and summed over the
replicas by the engine, so the buffer the host decodes is the replicated
step's.

Segment boundaries come from ``segment_layout`` — sorted parameter names
with cumulative offsets, the order of grad_comm's flat gradient buffer.
Module-level imports stay stdlib-only; torch, numpy, flags and the monitor
are imported inside the methods that need them.
"""
from __future__ import annotations

import collections
import math
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

# log-spaced boundaries for norm/ratio histograms: grad norms and update
# ratios span many decades (1e-8 .. 1e6), unlike the default ms buckets
NORM_BUCKETS: Tuple[float, ...] = tuple(
    10.0 ** e for e in range(-8, 7))

_RING_CAPACITY = 64
_DUMP_LIMIT = 2  # per reason class, so a diverged run can't flood the disk


def segment_layout(param_shapes: Dict[str, Sequence[int]]
                   ) -> List[Tuple[str, int, int]]:
    """(name, flat_offset, size) per parameter, in flat-buffer order.

    Order is sorted-by-name — the order of grad_comm's flat gradient
    buffer (``FlatLayout``) and of the reference's. Scalar params count as
    size 1.
    """
    out = []
    off = 0
    for name in sorted(param_shapes):
        size = 1
        for d in param_shapes[name]:
            size *= int(d)
        out.append((name, off, size))
        off += size
    return out


def _jf(x: float) -> Optional[float]:
    """JSON-safe float: finite values pass, inf/nan become None (the
    ``nonfinite_count`` field carries the signal)."""
    x = float(x)
    return x if math.isfinite(x) else None


def _as_f32(ts):
    import torch

    return [t if t.dtype == torch.float32 else t.float() for t in ts]


def _sq_norms(ts):
    """[len(ts)] f32: each tensor's sum of squares (inf and nan propagate)."""
    import torch

    return torch.stack(torch._foreach_norm(ts)).square()


class TrainingHealthMonitor:
    """Computes the packed health buffer on interval steps and fans it out.

    The device half (``begin_stats`` / ``end_stats``) runs in the engine's
    step on interval steps; the host half (``on_step``) fetches the packed
    buffer every ``interval`` steps, decodes it against the segment layout,
    feeds the metrics registry (``train.grad_norm`` / ``train.weight_norm`` /
    ``train.update_ratio`` histograms), appends to the JSONL sink and the
    in-memory ring (the flight recorder's ``health_tail``), and triggers a
    flight-recorder dump on a grad-norm spike or a non-finite gradient —
    naming the offending parameter in both cases.
    """

    def __init__(self, param_shapes: Dict[str, Sequence[int]],
                 interval: Optional[int] = None,
                 spike_factor: Optional[float] = None,
                 sink=None, ring_capacity: int = _RING_CAPACITY):
        from ..core import flags as _flags

        self.segments = segment_layout(param_shapes)
        self.names = [s[0] for s in self.segments]
        self.packed_size = 4 * len(self.segments)
        self.interval = max(1, int(interval if interval is not None
                                   else _flags.flag("health_interval")))
        self.spike_factor = float(
            spike_factor if spike_factor is not None
            else _flags.flag("health_spike_factor"))
        self.sink = sink
        self._ring = collections.deque(maxlen=int(ring_capacity))
        self._lock = threading.Lock()
        self._ema: Optional[float] = None
        self._dumps: Dict[str, int] = {}
        self._indices: Dict[tuple, Any] = {}
        _set_current(self)

    # ---- device half (interval steps only) ---------------------------------

    def begin_stats(self, grads, weights, ords=None):
        """Start one interval step's stats, before the clip and the update.
        ``grads`` (PRE-clip) and ``weights``: lists of tensors, one a piece;
        ``ords``: each piece's parameter ordinal in segment order (None:
        every parameter, in order). Returns the state ``end_stats`` takes:
        the squared grad and weight norms, the non-finite counts, and an f32
        copy of the weights."""
        import torch

        g, w = _as_f32(grads), _as_f32(weights)
        return (ords, _sq_norms(g), _sq_norms(w), self._nonfinite(g),
                torch._foreach_mul(w, 1.0))

    def end_stats(self, begun, new_weights):
        """The packed f32 ``[4P]`` buffer of one interval step, after the
        update: ``begun`` from ``begin_stats``, ``new_weights`` the same
        pieces updated. A rank's pieces give a partial buffer: zeros for the
        parameters it does not hold."""
        import torch

        ords, g2, w2, nf, old = begun
        u2 = _sq_norms(torch._foreach_sub(_as_f32(new_weights), old))
        rows = torch.stack([g2, w2, u2, nf])
        if ords is None:
            return rows.reshape(-1)
        p = len(self.segments)
        idx = self._index(rows.device, "ords", tuple(ords))
        return rows.new_zeros(4, p).index_add_(1, idx, rows).reshape(-1)

    def _nonfinite(self, grads):
        """Each piece's count of non-finite entries (f32), exact: the int
        prefix sum of the concatenated gradient's non-finite mask, read at
        the pieces' ends."""
        import torch

        flat = torch.cat([t.reshape(-1) for t in grads])
        idt = torch.int32 if flat.numel() < 2 ** 31 else torch.int64
        cs = torch.cumsum(torch.isfinite(flat).logical_not_(), 0, dtype=idt)
        ends, run = [], 0
        for t in grads:
            run += t.numel()
            ends.append(run - 1)
        at = cs[self._index(flat.device, "ends", tuple(ends))]
        return torch.diff(at, prepend=at.new_zeros(1)).float()

    def _index(self, device, kind, values):
        """A long tensor of ``values`` on ``device``, built once: a host
        list copied to the card would sync the step."""
        import torch

        key = (str(device), kind, values)
        t = self._indices.get(key)
        if t is None:
            t = self._indices[key] = torch.tensor(values, dtype=torch.long,
                                                  device=device)
        return t

    # ---- host half --------------------------------------------------------

    def wants(self, step: int) -> bool:
        return step % self.interval == 0

    def on_step(self, step: int, packed) -> Optional[dict]:
        """Interval-gated ingest: fetch the ONE packed buffer, decode, fan
        out. Off-interval steps cost one modulo and have no buffer."""
        if packed is None or not self.wants(step):
            return None
        return self._ingest(step, packed)

    def _ingest(self, step: int, packed) -> dict:
        import numpy as np

        from ..core import monitor as _monitor

        if hasattr(packed, "detach"):   # a torch tensor: the one D2H copy
            packed = packed.detach().cpu().numpy()
        buf = np.asarray(packed, dtype=np.float64)
        _monitor.stat("health.fetches").increase()
        p = len(self.segments)
        g2, w2, u2, nf = buf[:p], buf[p:2 * p], buf[2 * p:3 * p], buf[3 * p:]
        nf_counts = np.nan_to_num(nf, nan=0.0, posinf=0.0).astype(np.int64)

        grad_norm = float(np.sqrt(g2.sum()))
        weight_norm = float(np.sqrt(w2.sum()))
        update_norm = float(np.sqrt(u2.sum()))
        update_ratio = update_norm / weight_norm if weight_norm > 0 else 0.0

        total_nf = int(nf_counts.sum())
        first_seg = first_param = None
        if total_nf:
            first_seg = int(np.argmax(nf_counts > 0))
            first_param = self.names[first_seg]

        per_param = {}
        for i, (name, _, _) in enumerate(self.segments):
            wn = math.sqrt(w2[i]) if math.isfinite(w2[i]) else math.inf
            un = math.sqrt(u2[i]) if math.isfinite(u2[i]) else math.inf
            per_param[name] = {
                "grad_norm": _jf(math.sqrt(g2[i]) if g2[i] >= 0
                                 else math.nan),
                "weight_norm": _jf(wn),
                "update_ratio": _jf(un / wn if wn > 0 else 0.0),
                "nonfinite": int(nf_counts[i]),
            }

        spike = (self.spike_factor > 0 and self._ema is not None
                 and math.isfinite(grad_norm)
                 and grad_norm > self.spike_factor * max(self._ema, 1e-30))
        rec = {
            "event": "health",
            "step": int(step),
            "ts": time.time(),
            "grad_norm": _jf(grad_norm),
            "weight_norm": _jf(weight_norm),
            "update_ratio": _jf(update_ratio),
            "nonfinite_count": total_nf,
            "first_nonfinite_param": first_param,
            "first_nonfinite_segment": first_seg,
            "spike": bool(spike),
            "per_param": per_param,
        }
        with self._lock:
            self._ring.append(rec)
        if self.sink is not None:
            self.sink.write(rec)
        self._feed_registry(rec)
        if total_nf:
            _monitor.stat("health.nonfinite_steps").increase()
            self._dump("health_nonfinite",
                       {"param": first_param, "segment": first_seg,
                        "step": int(step), "count": total_nf})
        if spike:
            _monitor.stat("health.spikes").increase()
            self._dump("health_grad_spike",
                       {"step": int(step), "grad_norm": grad_norm,
                        "ema": self._ema})
        if math.isfinite(grad_norm):
            self._ema = (grad_norm if self._ema is None
                         else 0.9 * self._ema + 0.1 * grad_norm)
        return rec

    def _feed_registry(self, rec: dict) -> None:
        from . import metrics as _metrics

        reg = _metrics.active_registry()
        if reg is None:
            return
        for field, hist in (("grad_norm", "train.grad_norm"),
                            ("weight_norm", "train.weight_norm"),
                            ("update_ratio", "train.update_ratio")):
            v = rec.get(field)
            if v is not None:  # non-finite values carry no distribution info
                reg.histogram(hist, boundaries=NORM_BUCKETS).observe(v)
        reg.gauge("health.last_step").set(rec["step"])
        if rec["nonfinite_count"]:
            reg.counter("health.nonfinite_steps").inc()
            reg.counter(
                "health.nonfinite." + rec["first_nonfinite_param"]).inc()
        if rec["spike"]:
            reg.counter("health.spikes").inc()

    def _dump(self, reason: str, extra: dict) -> Optional[str]:
        """Flight-recorder dump for a threshold breach, per-reason
        rate-limited. The dump's state.json carries the extra dict (which
        names the offending parameter) AND the health ring tail."""
        from . import flight_recorder as _flight

        fr = _flight.get()
        if fr is None:
            return None
        n = self._dumps.get(reason, 0)
        if n >= _DUMP_LIMIT:
            return None
        self._dumps[reason] = n + 1
        suffix = ""
        if extra.get("param"):
            suffix = "_" + str(extra["param"])
        return fr.dump(reason + suffix, extra)

    # ---- inspection -------------------------------------------------------

    def recent(self, n: int = 32) -> List[dict]:
        """Most recent decoded health records, oldest first (the flight
        recorder embeds this as ``health_tail`` in state.json dumps)."""
        with self._lock:
            recs = list(self._ring)
        return recs[-int(n):]

    def close(self) -> None:
        if self.sink is not None:
            self.sink.close()


# ---- process-global current monitor (for the flight recorder) --------------

_current: Optional[TrainingHealthMonitor] = None
_glock = threading.Lock()


def _set_current(m: TrainingHealthMonitor) -> None:
    global _current
    with _glock:
        _current = m


def get_monitor() -> Optional[TrainingHealthMonitor]:
    """The most recently constructed monitor, or None — what the flight
    recorder asks for when assembling a state.json health tail."""
    return _current


def reset() -> None:
    """Drop the global monitor reference (test isolation)."""
    global _current
    with _glock:
        _current = None


def from_env_or_flags(param_shapes: Dict[str, Sequence[int]]
                      ) -> Optional[TrainingHealthMonitor]:
    """Monitor iff FLAGS_health_monitor or PADDLE_TPU_HEALTH_DIR is set,
    else None — the engines' zero-cost construction probe. The env var also
    attaches a ``health.jsonl`` JsonlSink in that directory."""
    import os

    from ..core import flags as _flags

    d = os.environ.get("PADDLE_TPU_HEALTH_DIR")
    if not d and not _flags.flag("health_monitor"):
        return None
    sink = None
    if d:
        from .step_telemetry import JsonlSink

        sink = JsonlSink(os.path.join(d, "health.jsonl"))
    return TrainingHealthMonitor(param_shapes, sink=sink)
