"""meta_parallel of the port (counterpart of
paddle_tpu/distributed/meta_parallel/): ``DataParallel`` and the
group-sharded wrappers, the tensor-parallel layers (``mp_layers``), the RNG
tracker (``parallel_layers``) and ring and Ulysses attention
(``sequence_parallel``). The pipeline and MoE layers (ROADMAP.md Queue 1
item 11) are not ported: their names raise ``NotImplementedError`` saying
so.
"""
from . import sequence_parallel
from .data_parallel import DataParallel, Reducer, sync_params_buffers
from .mp_layers import (ColumnParallelLinear, ParallelCrossEntropy, RowParallelLinear,
                        VocabParallelEmbedding, split)
from .parallel_layers import (RNGStatesTracker, get_rng_state_tracker,
                              model_parallel_random_seed)
from .sharding import (GroupShardedOptimizerStage2, GroupShardedStage2,
                       GroupShardedStage3, group_sharded_parallel)

_NOT_PORTED = {
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
           "GroupShardedStage2", "GroupShardedStage3", "group_sharded_parallel",
           "ColumnParallelLinear", "RowParallelLinear", "VocabParallelEmbedding",
           "ParallelCrossEntropy", "split", "RNGStatesTracker", "get_rng_state_tracker",
           "model_parallel_random_seed", "sequence_parallel"]
