"""Per-step training telemetry: one structured record per optimizer step
(counterpart of paddle_tpu/observability/step_telemetry.py).

The training loop emits a JSONL stream of step records — wall time,
tokens/s, achieved TFLOP/s, estimated MFU (flops.py's model, the bench's
convention, against the card's dense bf16 peak), the card's memory from the
caching allocator, and the ``core.monitor`` counters — through a pluggable
sink. The serving engine's ``serve_request`` / ``serve_step`` records and
the router's ``route`` records go through the same two sinks.

Disabled-path contract: when no telemetry is attached nothing here runs —
no file I/O, no sync. This module itself imports only stdlib; device stats
are fetched lazily inside ``record_step``. An eager port compiles nothing,
so the reference's ``engine.jit_*`` and ``compile_*`` counters are never
registered and their keys are absent, as in the reference when those
counters are unregistered.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional


class InMemorySink:
    """Collects records in a list — for tests and notebook inspection."""

    def __init__(self):
        self.records: List[Dict[str, Any]] = []

    def write(self, record: Dict[str, Any]) -> None:
        self.records.append(record)

    def close(self) -> None:
        pass


class JsonlSink:
    """Appends one JSON line per record; opened lazily, flushed per write so
    a crashed run keeps every completed step."""

    def __init__(self, path: str):
        self.path = path
        self._f = None

    def write(self, record: Dict[str, Any]) -> None:
        if self._f is None:
            d = os.path.dirname(os.path.abspath(self.path))
            os.makedirs(d, exist_ok=True)
            self._f = open(self.path, "a")
        self._f.write(json.dumps(record) + "\n")
        self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


class StepTelemetry:
    """Builds and emits per-step records.

    flops_per_token: model-FLOPs per trained token (see
        flops.transformer_flops_per_token); enables tflops_per_sec and mfu.
    peak_flops: MFU denominator in FLOP/s; defaults at the first record to
        the card's (flops.card_peak_flops_per_sec of ``device``'s name), None
        where flops.py has no peak (the CPU) — mfu is then omitted.
    device: the device whose peak and memory are recorded (the engine's);
        None is the current CUDA card, if any.
    """

    def __init__(self, sink=None, flops_per_token: Optional[int] = None,
                 peak_flops: Optional[float] = None,
                 collect_memory: bool = True,
                 collect_live_buffers: bool = False, device=None):
        self.sink = sink if sink is not None else InMemorySink()
        self.device = device
        self.flops_per_token = flops_per_token
        self.peak_flops = peak_flops
        self.collect_memory = collect_memory
        # live-allocation census (the caching allocator's count + bytes of
        # live blocks, with a high-water mark across records) — opt-in
        self.collect_live_buffers = collect_live_buffers
        self._records = 0
        self._live_high_water = 0
        self._last_counters: Dict[str, int] = {}

    # ---- construction helpers ----
    @classmethod
    def from_env(cls, **kw) -> Optional["StepTelemetry"]:
        """JsonlSink telemetry when PADDLE_TPU_TELEMETRY_DIR is set, else
        None (the cheap probe callers use to stay zero-cost when off)."""
        d = os.environ.get("PADDLE_TPU_TELEMETRY_DIR")
        if not d:
            return None
        return cls(sink=JsonlSink(os.path.join(d, "step_telemetry.jsonl")),
                   **kw)

    def set_flop_model(self, flops_per_token: int,
                       peak_flops: Optional[float] = None) -> None:
        self.flops_per_token = flops_per_token
        if peak_flops is not None:
            self.peak_flops = peak_flops

    # ---- emission ----
    def record_step(self, *, step: int, wall_time: float,
                    samples: Optional[int] = None,
                    tokens: Optional[int] = None,
                    loss: Optional[float] = None,
                    reader_cost: Optional[float] = None,
                    h2d_ms: Optional[float] = None,
                    prefetch_depth: Optional[int] = None,
                    microbatches: Optional[int] = None,
                    grad_comm_dtype: Optional[str] = None,
                    grad_comm_bytes: Optional[int] = None,
                    phase: str = "train",
                    extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Emit one record; returns it (tests read the return directly)."""
        rec: Dict[str, Any] = {
            "event": f"{phase}_step",
            "step": int(step),
            "ts": time.time(),
            "wall_time_s": round(wall_time, 6),
        }
        if loss is not None:
            rec["loss"] = float(loss)
        if reader_cost is not None:
            rec["reader_cost_s"] = round(reader_cost, 6)
        if h2d_ms is not None:
            # host->device staging: the batch's copy issue wall time
            # (non_blocking copies — issue cost, not transfer completion)
            rec["h2d_ms"] = round(h2d_ms, 3)
        if prefetch_depth is not None:
            # look-ahead the consumer actually had when this batch was taken
            rec["prefetch_depth"] = int(prefetch_depth)
        if microbatches is not None:
            # gradient accumulation (distributed/grad_comm.py): K
            # microbatches per optimizer step, one deferred reduce
            rec["microbatches"] = int(microbatches)
        if grad_comm_dtype is not None:
            rec["grad_comm_dtype"] = str(grad_comm_dtype)
        if grad_comm_bytes is not None:
            # per-device payload handed to the gradient collective — the
            # number the low-precision dtypes shrink
            rec["grad_comm_bytes"] = int(grad_comm_bytes)
        if samples is not None:
            rec["samples"] = int(samples)
            rec["samples_per_sec"] = round(samples / max(wall_time, 1e-9), 2)
        if tokens is not None:
            rec["tokens"] = int(tokens)
            tps = tokens / max(wall_time, 1e-9)
            rec["tokens_per_sec"] = round(tps, 1)
            if self.flops_per_token:
                fps = self.flops_per_token * tps
                rec["tflops_per_sec"] = round(fps / 1e12, 3)
                peak = self._resolve_peak()
                if peak:
                    rec["mfu"] = round(fps / peak, 4)
        rec.update(self._counter_deltas())
        if self.collect_memory:
            # always present so consumers see a stable shape; {} on the CPU
            rec["device_memory"] = self._memory_stats()
        if self.collect_live_buffers:
            lb = self._live_buffers()
            if lb:
                self._live_high_water = max(self._live_high_water,
                                            lb["bytes"])
                lb["high_water_bytes"] = self._live_high_water
                rec["live_buffers"] = lb
        if extra:
            rec.update(extra)
        self.sink.write(rec)
        self._records += 1
        return rec

    def close(self) -> None:
        self.sink.close()

    # ---- internals ----
    def _resolve_peak(self) -> Optional[float]:
        if self.peak_flops is not None:
            return self.peak_flops
        import torch

        from . import flops as _flops

        dev = self.device
        if dev is None and torch.cuda.is_available():
            dev = torch.device("cuda", torch.cuda.current_device())
        dev = None if dev is None else torch.device(dev)
        if dev is None or dev.type != "cuda":
            self.peak_flops = None
        else:
            self.peak_flops = _flops.card_peak_flops_per_sec(
                torch.cuda.get_device_name(dev))
        return self.peak_flops

    def _counter_deltas(self) -> Dict[str, Any]:
        """Counters from core.monitor: running totals, and the delta since
        the previous record for the compile counters (which an eager port
        never registers: their keys are absent)."""
        from ..core import monitor

        out: Dict[str, Any] = {}
        rep = monitor.registry().report()
        for key, field in (("engine.jit_compiles", "jit_compiles"),
                           ("engine.jit_compile_ms", "jit_compile_ms"),
                           ("engine.jit_recompiles", "jit_recompiles"),
                           # persistent-compilation-cache split: cold paid
                           # XLA, warm deserialized from the store
                           # (core/compile_cache.py) — a restarted process
                           # with a warm cache shows compile_warm_ms only
                           ("engine.compile_cold", "compile_cold"),
                           ("engine.compile_cold_ms", "compile_cold_ms"),
                           ("engine.compile_warm", "compile_warm"),
                           ("engine.compile_warm_ms", "compile_warm_ms"),
                           # gradient-communication subsystem
                           # (distributed/grad_comm.py): accumulated steps,
                           # microbatches, and collective payload bytes
                           ("grad_comm.steps", "grad_comm_steps"),
                           ("grad_comm.microbatches",
                            "grad_comm_microbatches"),
                           ("grad_comm.bytes_moved", "grad_comm_bytes_moved"),
                           ("grad_comm.lowp_steps", "grad_comm_lowp_steps"),
                           # ZeRO weight-update sharding: bytes handed to
                           # the gradient reduce-scatter / weight all-gather
                           ("grad_comm.rs_bytes", "grad_comm_rs_bytes"),
                           ("grad_comm.ag_bytes", "grad_comm_ag_bytes"),
                           ("dispatch.calls", "dispatch_calls"),
                           ("dispatch.nan_inf_hits", "nan_inf_hits"),
                           # decode/serving executables (models/gpt.py LRU
                           # + serving/engine.py): compile growth here mid-
                           # serve means something re-keyed on prompt shape
                           ("decode.jit_compiles", "decode_jit_compiles"),
                           ("decode.cache_evictions",
                            "decode_cache_evictions"),
                           ("serving.prefill_compiles",
                            "serving_prefill_compiles"),
                           ("serving.decode_compiles",
                            "serving_decode_compiles"),
                           ("serving.steps", "serving_steps"),
                           ("serving.tokens", "serving_tokens")):
            if key in rep:
                v = rep[key]["value"]
                out[field] = v
                delta = v - self._last_counters.get(key, 0)
                if field in ("jit_compiles", "jit_recompiles") and delta:
                    out[field + "_delta"] = delta
                self._last_counters[key] = v
        return out

    def _live_buffers(self) -> Dict[str, int]:
        try:
            from ..core import monitor

            return dict(monitor.live_buffer_stats(self.device))
        except Exception:
            return {}

    def _memory_stats(self) -> Dict[str, int]:
        try:
            from ..core import monitor

            stats = monitor.device_memory_stats(self.device)
        except Exception:
            return {}
        keep = ("bytes_in_use", "peak_bytes_in_use", "bytes_limit",
                "largest_alloc_size")
        return {k: int(stats[k]) for k in keep if k in stats}
