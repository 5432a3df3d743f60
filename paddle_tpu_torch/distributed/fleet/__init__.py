"""fleet of the port (counterpart of paddle_tpu/distributed/fleet/):
``init``, the worker queries, ``barrier_worker``, ``distributed_engine``,
``DistributedStrategy`` and ``recompute``.

    from paddle_tpu_torch.distributed import fleet
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": world, "mp_degree": 1}
    fleet.init(is_collective=True, strategy=strategy)   # joins the process group
    engine = fleet.distributed_engine(model, optimizer)
    loss = engine.step(ids, labels)                      # the global batch

``init`` joins the job's process group (``env.init_parallel_env``; NCCL on
the card, gloo with ``device="cpu"``) and builds the topology
(``mesh.HybridCommunicateGroup``). The planner of
``distributed_engine(auto=True)`` is not ported.
"""
from __future__ import annotations

from typing import Optional

from ..env import ParallelEnv, get_rank, init_parallel_env
from ..mesh import HybridCommunicateGroup, set_hybrid_communicate_group
from .distributed_strategy import DistributedStrategy
from .utils import recompute


class Fleet:
    def __init__(self):
        self._strategy: Optional[DistributedStrategy] = None
        self._hcg: Optional[HybridCommunicateGroup] = None
        self._is_initialized = False

    def init(self, role_maker=None, is_collective=True, strategy=None,
             log_level="INFO", device=None):
        """Join the process group and build the topology of ``strategy``'s
        ``hybrid_configs``. ``device``: None (the card) or "cpu"."""
        if not is_collective:
            raise NotImplementedError("the port runs collective training only "
                                      "(parameter-server mode is not ported)")
        self._strategy = strategy or DistributedStrategy()
        init_parallel_env(device=device)
        hc = self._strategy.hybrid_configs
        self._hcg = HybridCommunicateGroup(
            dp_degree=hc.dp_degree, mp_degree=hc.mp_degree, pp_degree=hc.pp_degree,
            sharding_degree=hc.sharding_degree, sp_degree=hc.sep_degree,
            ep_degree=hc.ep_degree)
        set_hybrid_communicate_group(self._hcg)
        self._is_initialized = True
        return self

    def get_hybrid_communicate_group(self):
        return self._hcg

    def worker_index(self):
        return get_rank()

    def worker_num(self):
        return self._hcg.nranks if self._hcg is not None else ParallelEnv().world_size

    def is_first_worker(self):
        return self.worker_index() == 0

    def barrier_worker(self):
        from .. import collective

        collective.barrier()

    def distributed_engine(self, model, optimizer, loss_fn=None, auto=False,
                           sample_batch=None, **kw):
        """The data-parallel ``TrainStepEngine`` of this fleet's topology and
        strategy; ``kw`` (``microbatches``, ``zero_update``) go to it."""
        from ..engine import TrainStepEngine

        if auto:
            raise NotImplementedError("distributed_engine(auto=True): the topology "
                                      "planner is not ported")
        if loss_fn is not None:
            raise NotImplementedError("the port's engine takes a model whose "
                                      "forward returns the loss (loss_fn is not ported)")
        if not self._is_initialized:
            self.init()
        return TrainStepEngine(model, optimizer, hcg=self._hcg,
                               strategy=self._strategy, **kw)


fleet = Fleet()

init = fleet.init
distributed_engine = fleet.distributed_engine
worker_index = fleet.worker_index
worker_num = fleet.worker_num
is_first_worker = fleet.is_first_worker
barrier_worker = fleet.barrier_worker
get_hybrid_communicate_group = fleet.get_hybrid_communicate_group

__all__ = ["DistributedStrategy", "Fleet", "fleet", "init", "distributed_engine",
           "worker_index", "worker_num", "is_first_worker", "barrier_worker",
           "get_hybrid_communicate_group", "recompute"]
