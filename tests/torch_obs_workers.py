"""Rank bodies of tests/test_torch_train_obs.py (a helper module: pytest
does not collect it). It imports torch and the port only, never jax:
``spawn`` imports it again in every rank.

``run_cases(out_dir, state_path)`` runs in each of 2 gloo ranks: gpt_tiny
with the JAX model's weights (``state_path``), ids [8, 128] from
``RandomState`` (tests/torch_dp_workers.py's batch), SGD(0.05), through
``fleet.distributed_engine`` with the health monitor at interval 1 and
telemetry on, ``STEPS`` steps of each of ``CASES`` (replicated, ZeRO,
FSDP). Each rank saves {case: result} to
``out_dir/rank<r>.pt``.
"""
from __future__ import annotations

import os

import numpy as np
import torch

import torch_dp_workers as W

STEPS = 2
SGD_LR = 0.05
CASES = {"replicated": {}, "zero": {"zero": True}, "fsdp": {"fsdp": True}}


def _strip(rec):
    """A record without its wall clock and timings."""
    return {k: v for k, v in rec.items()
            if k not in ("ts", "wall_time_s", "samples_per_sec", "tokens_per_sec",
                         "tflops_per_sec", "h2d_ms")}


def train(state, zero=False, fsdp=False):
    import paddle_tpu_torch as P
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.optimizer import SGD

    P.set_flags({"grad_comm_dtype": "f32", "grad_comm_error_feedback": False,
                 "zero_update": False, "fsdp": False, "fsdp_prefetch": 2,
                 "grad_comm_chunk": 1024})
    m = W._model(state)
    e = fleet.distributed_engine(m, SGD(learning_rate=SGD_LR, parameters=m.named_parameters()),
                                 zero_update=zero, fsdp=fsdp)
    health = e.enable_health(interval=1)
    tele = e.enable_telemetry()
    ids, labels = W.batch()
    losses = [e.step(ids, labels).item() for _ in range(STEPS)]
    out = {"losses": losses,
           "health": [{k: v for k, v in r.items() if k != "ts"} for r in health.recent()],
           "telemetry": [_strip(r) for r in tele.sink.records],
           "zero_engaged": e._zero_opt is not None,
           "fsdp_engaged": e._fsdp_params is not None}
    if fsdp:
        out["window_bytes"] = e.fsdp_memory_model()["window_bytes"]
    e.disable_health()
    return out


def run_cases(out_dir, state_path):
    torch.set_num_threads(2)
    torch.use_deterministic_algorithms(True)  # the embedding's backward in one order
    from paddle_tpu_torch.distributed import fleet

    state = dict(np.load(state_path))
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 2, "mp_degree": 1}
    fleet.init(is_collective=True, strategy=strategy, device="cpu")
    rank = fleet.worker_index()
    results = {name: train(state, **kw) for name, kw in CASES.items()}
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
