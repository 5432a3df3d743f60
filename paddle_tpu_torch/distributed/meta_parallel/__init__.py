"""meta_parallel of the port (counterpart of
paddle_tpu/distributed/meta_parallel/): ``DataParallel`` and the
group-sharded wrappers. The tensor-parallel layers and the RNG tracker
(ROADMAP.md Queue 1 item 9) and the pipeline and MoE layers (item 11) are
not ported: their names raise ``NotImplementedError`` saying so.
"""
from .data_parallel import DataParallel, Reducer, sync_params_buffers
from .sharding import (GroupShardedOptimizerStage2, GroupShardedStage2,
                       GroupShardedStage3, group_sharded_parallel)

_NOT_PORTED = {
    **dict.fromkeys(("ColumnParallelLinear", "RowParallelLinear", "VocabParallelEmbedding",
                     "ParallelCrossEntropy", "get_rng_state_tracker",
                     "model_parallel_random_seed"),
                    "ROADMAP.md Queue 1 item 9 (tensor parallelism)"),
    **dict.fromkeys(("LayerDesc", "PipelineLayer", "SharedLayerDesc", "PipelineParallel",
                     "PipelineParallelWithInterleave"),
                    "ROADMAP.md Queue 1 item 11 (pipeline parallelism)"),
    **dict.fromkeys(("GShardGate", "MoELayer", "NaiveGate", "SwitchGate"),
                    "ROADMAP.md Queue 1 item 11 (expert parallelism)"),
}


def __getattr__(name):
    if name in _NOT_PORTED:
        raise NotImplementedError(f"meta_parallel.{name} is not ported: {_NOT_PORTED[name]}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["DataParallel", "Reducer", "sync_params_buffers", "GroupShardedOptimizerStage2",
           "GroupShardedStage2", "GroupShardedStage3", "group_sharded_parallel"]
