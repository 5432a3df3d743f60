"""Runtime flag registry (counterpart of paddle_tpu/core/flags.py).

A flag is read once from ``FLAGS_<name>`` in the environment when it is
defined, and later set with ``set_flags({...})`` (re-exported as
``paddle_tpu_torch.set_flags``). Only the flags the port reads are defined.
"""
from __future__ import annotations

import os
from typing import Any, Dict

_REGISTRY: Dict[str, Any] = {}


def define_flag(name: str, default, help_: str = ""):
    env = os.environ.get("FLAGS_" + name)
    if env is not None:
        if isinstance(default, bool):
            default = env.lower() in ("1", "true", "yes", "on")
        elif isinstance(default, int):
            default = int(env)
        elif isinstance(default, float):
            default = float(env)
        else:
            default = env
    _REGISTRY[name] = default


def set_flags(flags: Dict[str, Any]):
    for k, v in flags.items():
        k = k.removeprefix("FLAGS_")
        if k not in _REGISTRY:
            raise KeyError(f"unknown flag {k!r}; known: {sorted(_REGISTRY)}")
        _REGISTRY[k] = v


def get_flags(names):
    if isinstance(names, str):
        names = [names]
    return {("FLAGS_" + n.removeprefix("FLAGS_")): _REGISTRY[n.removeprefix("FLAGS_")]
            for n in names}


def flag(name: str):
    return _REGISTRY[name]


define_flag("grad_comm_dtype", "f32",
            "gradient reduce precision of the data-parallel step "
            "(distributed/grad_comm.py): f32 (default), bf16 (half the "
            "bytes), or int8 (chunk-scaled quantized payload, ~4x fewer "
            "bytes)")
define_flag("grad_comm_error_feedback", False,
            "carry the local quantization error of the bf16/int8 gradient "
            "reduce into the next step (one f32 gradient-sized buffer a rank)")
define_flag("grad_comm_chunk", 1024,
            "elements per scaling block of the int8 gradient payload")
define_flag("zero_update", False,
            "ZeRO weight-update sharding: reduce-scatter, shard-local clip and "
            "update, all-gather of the new weights; the optimizer state lives "
            "as flat f32 1/N shards a rank. Also TrainStepEngine(zero_update=True)")
define_flag("fsdp", False,
            "fully sharded data parallelism (distributed/grad_comm.py's FSDP "
            "step): parameters and optimizer state live only as per-layer "
            "flat f32 1/N shards a rank between steps; each layer's weights "
            "are all-gathered for the step's forward and backward, the "
            "gradients reduce-scatter onto the owning shard, and the update "
            "runs on the shards, with no trailing parameter gather. ZeRO's "
            "eligibility gate; supersedes zero_update. Also "
            "TrainStepEngine(fsdp=True)")
define_flag("fsdp_prefetch", 2,
            "gather-prefetch window of the FSDP forward: up to this many "
            "per-layer all-gathers in flight ahead of the layer that waits "
            "for its own, in the forward's order. 0 gathers just in time. "
            "Clamped so the live window never exceeds the two largest "
            "adjacent buckets; every depth gives the same bits")
define_flag("ckpt_dir", os.environ.get("PADDLE_TPU_CKPT_DIR", ""),
            "checkpoint directory (also PADDLE_TPU_CKPT_DIR). Non-empty: every "
            "TrainStepEngine attaches a distributed/elastic.py "
            "CheckpointManager at construction (crash-safe saves every "
            "FLAGS_ckpt_interval steps, newest-valid restore). Empty = off")
define_flag("ckpt_interval", 100,
            "optimizer steps between automatic checkpoints; an interval that "
            "fires while the previous async save is still writing skips "
            "(ckpt.skipped)")
define_flag("ckpt_keep", 3,
            "retention: committed checkpoints beyond the newest N are removed "
            "after each save (ckpt.gc_removed)")
define_flag("ckpt_async", True,
            "write checkpoints on a background thread behind a depth-1 queue "
            "(the capture stays on the step's thread); False = the step "
            "waits for the commit")
define_flag("ckpt_rollback", False,
            "a non-finite training loss restores the newest valid checkpoint "
            "in place of the diverged state (ckpt.rollbacks); one loss read "
            "a step while on")
define_flag("health_monitor", False,
            "compute training-health statistics (global + per-parameter "
            "grad/weight norms, update-to-weight ratios, non-finite "
            "localization) on the train step's interval steps "
            "(observability/health.py): one packed f32 [4P] buffer fetched "
            "to the host in one copy; off-interval steps launch nothing. Also "
            "enabled by PADDLE_TPU_HEALTH_DIR (which adds a health.jsonl "
            "sink). Read at engine construction")
define_flag("health_interval", 10,
            "steps between health statistics: the stats are computed and "
            "fetched (ONE transfer of one f32 [4P] array) only on steps that "
            "are a multiple of this, with the registry feed and JSONL write")
define_flag("health_spike_factor", 10.0,
            "grad-norm spike threshold: a fetched global grad norm above "
            "factor*EMA(grad_norm) bumps health.spikes and triggers a "
            "flight-recorder dump (reason health_grad_spike). <= 0 disables "
            "spike detection")
define_flag("elastic_lease_s", 5.0,
            "membership heartbeat lease duration in seconds "
            "(distributed/membership.py). A worker whose lease key is older "
            "than this is treated as departed at the next coordinator poll "
            "(elastic.lease_expiries counter); heartbeats refresh at a third "
            "of the lease so one missed beat never evicts")
define_flag("elastic_check_interval", 1,
            "optimizer steps between ElasticCoordinator membership polls "
            "when driving through coordinator.on_step(). 1 = re-form at the "
            "very next step boundary after a join/leave lands")
define_flag("elastic_drain_timeout_s", 30.0,
            "serving-replica drain bound: a SIGTERM'd ServingEngine stops "
            "admission and runs active slots to completion for at most this "
            "long before retiring (elastic.drain_ms histogram)")
define_flag("kv_page_tokens", 64,
            "tokens per KV-cache page for the paged serving layout "
            "(serving/kv_pages.py). Smaller pages waste fewer bytes on the "
            "last partial page per sequence and share finer-grained "
            "prefixes; larger pages shrink the page table and the gather. "
            "Any positive value works; prefix reuse only shares whole pages")
define_flag("kv_cache_dtype", "auto",
            "paged KV-cache storage dtype: 'auto' stores pages in the "
            "attention compute dtype, 'bf16' casts pages to bfloat16, "
            "'int8' stores chunk-scaled int8 pages (one f32 absmax/127 "
            "scale per (page, token, head), dequantized inside the "
            "attention read). Only the paged layout honors this")
