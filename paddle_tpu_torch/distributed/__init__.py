"""Distributed training of the port (counterpart of paddle_tpu/distributed/):
one process per GPU on ``torch.distributed`` (NCCL on the card, gloo on the
CPU). ``env`` (the environment contract and ``init_parallel_env``),
``collective`` (eager collectives), ``spawn`` and ``launch`` (starting the
ranks), ``mesh`` (the data-parallel topology), ``fleet`` (the user's entry
points, eager and fused), ``meta_parallel`` (``DataParallel`` and its
bucketed ``Reducer``, the group-sharded wrappers), ``grad_comm`` (the one
fused gradient reduce, ZeRO and FSDP), ``engine`` (``TrainStepEngine``) and
``elastic`` (checkpoints); ``ps`` (the parameter server: tables in host RAM
behind the native service, pulled and pushed around the card's dense
compute) and ``fleet.dataset`` (``InMemoryDataset`` / ``QueueDataset`` over
the native data feed)."""
from . import collective, elastic, fleet, grad_comm, meta_parallel  # noqa: F401
from .collective import (ReduceOp, all_gather, all_reduce, barrier, broadcast,
                         get_group, new_group, reduce_scatter, wait)
from .engine import TrainStepEngine
from .env import (ParallelEnv, get_rank, get_world_size, init_parallel_env,
                  is_initialized)
from .fleet import DistributedStrategy
from .fleet.dataset import InMemoryDataset, QueueDataset
from .mesh import (CommGroup, HybridCommunicateGroup, get_hybrid_communicate_group,
                   set_hybrid_communicate_group)
from .meta_parallel import DataParallel, group_sharded_parallel
from .spawn import spawn

__all__ = ["TrainStepEngine", "ParallelEnv", "init_parallel_env", "get_rank",
           "get_world_size", "is_initialized", "ReduceOp", "new_group", "get_group",
           "all_reduce", "all_gather", "reduce_scatter", "broadcast", "barrier",
           "wait", "spawn", "DistributedStrategy", "CommGroup", "HybridCommunicateGroup",
           "get_hybrid_communicate_group", "set_hybrid_communicate_group", "fleet",
           "grad_comm", "collective", "elastic", "meta_parallel", "DataParallel",
           "group_sharded_parallel", "InMemoryDataset", "QueueDataset"]
