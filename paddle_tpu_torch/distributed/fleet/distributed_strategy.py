"""``DistributedStrategy`` of the port (counterpart of
paddle_tpu/distributed/fleet/distributed_strategy.py): every switch and
sub-config of the JAX package's, with its defaults.

What reads them: ``hybrid_configs`` (the degrees: ``fleet.init``);
``sharding`` (True runs the engine's ZeRO update, as the JAX engine shards
the optimizer state for it); ``amp`` and ``amp_configs`` (the engine's
forward under ``amp.amp_guard_from_configs(..., force_bf16=True)``, and the
AMP meta-optimizer); the meta-optimizers' switches and configs
(``fleet.distributed_optimizer``'s ``StrategyCompiler``: ``recompute``,
``gradient_merge``, ``localsgd``, ``dgc``, ``fp16_allreduce``, ``lars``,
``lamb``, ``without_graph_optimization``). The others are kept for the
reference's surface and read by nothing here, as in the JAX package.

Like the reference, a ``*_configs`` attribute takes a dict, merged key by
key into its config; an unknown key raises.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List


@dataclass
class AMPConfig:
    init_loss_scaling: float = 32768.0
    incr_every_n_steps: int = 1000
    decr_every_n_nan_or_inf: int = 2
    incr_ratio: float = 2.0
    decr_ratio: float = 0.8
    use_dynamic_loss_scaling: bool = True
    custom_white_list: List[str] = field(default_factory=list)
    custom_black_list: List[str] = field(default_factory=list)
    use_pure_fp16: bool = False
    use_fp16_guard: bool = True
    dtype: str = "bfloat16"


@dataclass
class RecomputeConfig:
    checkpoints: List[str] = field(default_factory=list)
    enable_offload: bool = False
    checkpoint_shape: List[int] = field(default_factory=list)
    granularity: str = "full"    # "full" or "selective" (fleet.utils.recompute)


@dataclass
class GradientMergeConfig:
    k_steps: int = 1
    avg: bool = True


@dataclass
class ShardingConfig:
    sharding_segment_strategy: str = "segment_broadcast_MB"
    segment_broadcast_MB: float = 32.0
    sharding_degree: int = 8
    stage: int = 1
    mp_degree: int = 1
    dp_degree: int = 1
    pp_degree: int = 1
    optimize_offload: bool = False
    gradient_merge_acc_step: int = 1


@dataclass
class PipelineConfig:
    micro_batch_size: int = 1
    accumulate_steps: int = 1
    schedule_mode: str = "1F1B"
    p2p_cache_shape: bool = True


@dataclass
class HybridConfig:
    dp_degree: int = -1
    mp_degree: int = 1
    pp_degree: int = 1
    sharding_degree: int = 1
    sep_degree: int = 1
    ep_degree: int = 1


@dataclass
class TensorParallelConfig:
    tensor_parallel_degree: int = 1
    tensor_init_seed: int = -1


@dataclass
class LocalSGDConfig:
    k_steps: int = 1
    begin_step: int = 1


@dataclass
class DGCConfig:
    rampup_begin_step: int = 0
    rampup_step: int = 1
    sparsity: List[float] = field(default_factory=lambda: [0.999])


@dataclass
class LambConfig:
    lamb_weight_decay: float = 0.01
    exclude_from_weight_decay: List[str] = field(default_factory=list)


@dataclass
class LarsConfig:
    lars_coeff: float = 0.001
    lars_weight_decay: float = 0.0005
    epsilon: float = 0.0
    exclude_from_weight_decay: List[str] = field(default_factory=list)


@dataclass
class ASyncConfig:
    k_steps: int = -1
    max_merge_var_num: int = 1
    send_queue_size: int = 16
    independent_recv_thread: bool = False
    thread_pool_size: int = 1
    send_wait_times: int = 1
    runtime_split_send_recv: bool = False


class DistributedStrategy:
    def __init__(self):
        # feature switches
        self.amp = False
        self.recompute = False
        self.gradient_merge = False
        self.sharding = False
        self.pipeline = False
        self.tensor_parallel = False
        self.sequence_parallel = False
        self.expert_parallel = False
        self.dgc = False
        self.localsgd = False
        self.lars = False
        self.lamb = False
        self.fp16_allreduce = False
        self.a_sync = False
        self.heter_ccl_mode = False
        self.fuse_all_reduce_ops = True
        self.fuse_grad_size_in_MB = 32
        self.nccl_comm_num = 1
        self.gradient_scale_configs = {"scale_strategy": "avg"}
        self.without_graph_optimization = True
        self.find_unused_parameters = False
        self.last_comm_group_size_MB = 1.0
        self.fuse_grad_merge = False
        self.semi_auto = False
        self.auto_search = False
        self.sep_impl = "ulysses"

        # sub-configs
        self.amp_configs = AMPConfig()
        self.recompute_configs = RecomputeConfig()
        self.gradient_merge_configs = GradientMergeConfig()
        self.sharding_configs = ShardingConfig()
        self.pipeline_configs = PipelineConfig()
        self.hybrid_configs = HybridConfig()
        self.tensor_parallel_configs = TensorParallelConfig()
        self.localsgd_configs = LocalSGDConfig()
        self.dgc_configs = DGCConfig()
        self.lamb_configs = LambConfig()
        self.lars_configs = LarsConfig()
        self.a_sync_configs = ASyncConfig()

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
