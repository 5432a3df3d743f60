"""``DistributedStrategy`` of the port (counterpart of
paddle_tpu/distributed/fleet/distributed_strategy.py), with the options this
slice reads: ``hybrid_configs`` (the degrees) and ``sharding`` (True runs
the engine's ZeRO update, as the JAX engine shards the optimizer state for
it). Like the reference, ``hybrid_configs`` takes a dict, merged key by key
into its config; an unknown key raises.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict


@dataclass
class HybridConfig:
    dp_degree: int = -1
    mp_degree: int = 1
    pp_degree: int = 1
    sharding_degree: int = 1
    sep_degree: int = 1
    ep_degree: int = 1


class DistributedStrategy:
    def __init__(self):
        self.sharding = False
        self.hybrid_configs = HybridConfig()

    def __setattr__(self, name, value):
        if name.endswith("_configs") and isinstance(value, dict):
            current = self.__dict__.get(name)
            if current is not None and dataclasses.is_dataclass(current):
                for k, v in value.items():
                    if not hasattr(current, k):
                        raise ValueError(f"unknown {name} key {k!r}")
                    setattr(current, k, v)
                return
        object.__setattr__(self, name, value)

    def to_dict(self) -> Dict[str, Any]:
        return {k: dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v
                for k, v in self.__dict__.items()}

    def __repr__(self):
        return f"DistributedStrategy({self.to_dict()})"
