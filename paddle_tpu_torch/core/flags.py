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
