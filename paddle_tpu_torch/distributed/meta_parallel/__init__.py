"""meta_parallel of the port (counterpart of
paddle_tpu/distributed/meta_parallel/): ``DataParallel`` and the
group-sharded wrappers, the tensor-parallel layers (``mp_layers``), the RNG
tracker (``parallel_layers``), ring and Ulysses attention
(``sequence_parallel``), the pipeline layers and the eager pipeline facade
(``pp_layers``, ``pipeline_parallel``; the stacked pipeline is
distributed/pipeline_schedule.py) and the mixture of experts on the ep
axis (``moe``).
"""
from . import sequence_parallel
from .data_parallel import DataParallel, Reducer, sync_params_buffers
from .moe import ExpertFFN, GShardGate, MoELayer, NaiveGate, SwitchGate
from .mp_layers import (ColumnParallelLinear, ParallelCrossEntropy, RowParallelLinear,
                        VocabParallelEmbedding, split)
from .parallel_layers import (RNGStatesTracker, get_rng_state_tracker,
                              model_parallel_random_seed)
from .pipeline_parallel import PipelineParallel, PipelineParallelWithInterleave
from .pp_layers import LayerDesc, PipelineLayer, SharedLayerDesc
from .sharding import (GroupShardedOptimizerStage2, GroupShardedStage2,
                       GroupShardedStage3, group_sharded_parallel)

__all__ = ["DataParallel", "Reducer", "sync_params_buffers", "GroupShardedOptimizerStage2",
           "GroupShardedStage2", "GroupShardedStage3", "group_sharded_parallel",
           "ColumnParallelLinear", "RowParallelLinear", "VocabParallelEmbedding",
           "ParallelCrossEntropy", "split", "RNGStatesTracker", "get_rng_state_tracker",
           "model_parallel_random_seed", "sequence_parallel", "LayerDesc",
           "SharedLayerDesc", "PipelineLayer", "PipelineParallel",
           "PipelineParallelWithInterleave", "NaiveGate", "GShardGate", "SwitchGate",
           "ExpertFFN", "MoELayer"]
