"""fleet of the port (counterpart of paddle_tpu/distributed/fleet/): ``init``,
the role makers and worker queries, ``barrier_worker``, the eager entry
points ``distributed_model`` / ``distributed_optimizer`` / ``minimize``,
``distributed_engine``, ``save_persistables``, ``DistributedStrategy`` and
``recompute``.

The eager (dygraph) data-parallel script, one process a rank::

    from paddle_tpu_torch.distributed import fleet
    fleet.init(is_collective=True, strategy=strategy)     # joins the process group
    model = fleet.distributed_model(model)                 # DataParallel past one rank
    opt = fleet.distributed_optimizer(opt, strategy)       # meta chain + HybridParallelOptimizer
    loss = model(ids, labels)                              # this rank's rows
    loss.backward(); opt.step(); opt.clear_grad()          # bucketed gradient average at step

The fused step, on the global batch::

    engine = fleet.distributed_engine(model, optimizer)
    loss = engine.step(ids, labels)

``init`` joins the job's process group (``env.init_parallel_env``; NCCL on
the card, gloo with ``device="cpu"``) and builds the topology
(``mesh.HybridCommunicateGroup``) of ``hybrid_configs``: ``dp_degree``,
``sharding_degree``, ``mp_degree`` (tensor parallelism: build the model
after ``init``, its mp layers take the rank's shards) and ``sep_degree``
(sequence parallelism: ``strategy.sep_impl`` "ulysses", the default, or
"ring", reaches the engine), all composed in one ``distributed_engine``::

    strategy.hybrid_configs = {"dp_degree": 2, "mp_degree": 2, "sep_degree": 2}
    strategy.sep_impl = "ring"
    fleet.init(is_collective=True, strategy=strategy)
    model = GPTForPretraining(gpt_tiny())                  # this rank's shards
    engine = fleet.distributed_engine(model, optimizer)    # global batch in

``distributed_model`` wraps the model in ``DataParallel`` (with the strategy's ``find_unused_parameters``) only
in data-parallel mode past one rank; at ``pp_degree > 1`` a
``PipelineLayer`` becomes the eager ``PipelineParallel`` facade and a
pipeline-stacked model (``GPTForPretrainingPipe``, whose stages run
distributed/pipeline_schedule.py over the pp group inside the engine's
step) passes through, as in the reference; otherwise it returns the model
as it is. Pipeline and expert parallelism (``pp_degree``, ``ep_degree``)::

    strategy.hybrid_configs = {"dp_degree": 2, "pp_degree": 2}
    fleet.init(is_collective=True, strategy=strategy)
    model = GPTForPretrainingPipe(GPTConfig(), num_microbatches=4)   # this rank's stage
    model = fleet.distributed_model(model)
    engine = fleet.distributed_engine(model, optimizer)
    loss = engine.step(ids, labels)                        # the global batch

``distributed_optimizer`` compiles
the strategy into the meta-optimizer chain (``meta_optimizers``) and wraps
it in ``HybridParallelOptimizer``; ``_applied_meta_list`` names what was
applied. ``distributed_engine`` unwraps that chain (and a
``GroupShardedOptimizerStage2``) down to the optimizer. Not ported
(ROADMAP.md Queue 1 item 3): the planner of ``distributed_engine(auto=True)``,
``fleet.fs``, ``fleet.dataset`` and ``fleet.elastic``.
"""
from __future__ import annotations

from typing import Optional

from ..env import ParallelEnv, get_rank, init_parallel_env
from ..mesh import HybridCommunicateGroup, set_hybrid_communicate_group
from . import utils
from .distributed_strategy import DistributedStrategy
from .hybrid_parallel_optimizer import HybridParallelOptimizer
from .utils import recompute


class RoleMakerBase:
    def __init__(self, is_collective=True, **kwargs):
        self._is_collective = is_collective
        self._env = ParallelEnv()

    def worker_index(self):
        return self._env.rank

    def worker_num(self):
        return self._env.world_size

    def is_first_worker(self):
        return self._env.rank == 0

    def is_worker(self):
        return True

    def is_server(self):
        return False


class PaddleCloudRoleMaker(RoleMakerBase):
    pass


class UserDefinedRoleMaker(RoleMakerBase):
    pass


class Fleet:
    def __init__(self):
        self._role_maker = None
        self._strategy: Optional[DistributedStrategy] = None
        self._hcg: Optional[HybridCommunicateGroup] = None
        self._is_initialized = False
        self._applied_meta_list = []

    def init(self, role_maker=None, is_collective=True, strategy=None,
             log_level="INFO", device=None):
        """Join the process group and build the topology of ``strategy``'s
        ``hybrid_configs``. ``device``: None (the card) or "cpu"."""
        if not is_collective:
            raise NotImplementedError("the port runs collective training only "
                                      "(parameter-server mode is not ported)")
        self._role_maker = role_maker or PaddleCloudRoleMaker(is_collective=is_collective)
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

    def worker_endpoints(self, to_string=False):
        eps = ParallelEnv().trainer_endpoints
        return ",".join(eps) if to_string else eps

    def barrier_worker(self):
        from .. import collective

        collective.barrier()

    # ---- the eager entry points (reference fleet_base.py:1038-1061) ----
    def distributed_model(self, model):
        """``DataParallel(model)`` in data-parallel mode past one rank, else
        ``model`` itself (the engine shards for the other modes). At pp above
        one rank (reference fleet/__init__.py:99-118) a ``PipelineLayer``
        becomes ``PipelineParallel``, a pipeline-stacked model passes
        through, anything else raises. Under mp or sp above one rank the
        eager path raises: ``distributed_engine`` runs them (ROADMAP.md
        Queue 1 item 9); so does ep (item 11: the eager reducer would
        average the experts' shards)."""
        from ..meta_parallel import DataParallel, PipelineLayer, PipelineParallel

        if not self._is_initialized:
            self.init()
        hcg = self._hcg
        if hcg.get_pipe_parallel_world_size() > 1:
            if isinstance(model, PipelineLayer):
                return PipelineParallel(model, hcg, self._strategy)
            if not getattr(model, "_pipeline_stacked", False):
                # pipeline-stacked models (e.g. GPTForPretrainingPipe) run the
                # schedule inside the engine and need no wrapper
                raise RuntimeError(
                    "pp_degree > 1 requires a PipelineLayer or a pipeline-stacked model")
            return model
        if hcg.degrees["ep"] > 1:
            raise NotImplementedError(
                f"fleet.distributed_model at ep_degree={hcg.degrees['ep']}: the eager "
                "path averages every gradient over the ranks; use "
                "fleet.distributed_engine (ROADMAP.md Queue 1 item 11)")
        if hcg.degrees["mp"] > 1 or hcg.degrees["sp"] > 1:
            raise NotImplementedError(
                f"fleet.distributed_model at mp_degree={hcg.degrees['mp']}, sep_degree="
                f"{hcg.degrees['sp']}: the eager path runs data parallelism; use "
                "fleet.distributed_engine (ROADMAP.md Queue 1 item 9)")
        if hcg.get_parallel_mode() == "data_parallel" and hcg.nranks > 1:
            return DataParallel(model, find_unused_parameters=bool(
                self._strategy.find_unused_parameters))
        return model

    def distributed_optimizer(self, optimizer, strategy=None, model=None):
        """The strategy's meta-optimizer chain around ``optimizer`` (its rule
        swapped first by ``lars`` / ``lamb``), inside a
        ``HybridParallelOptimizer``. ``model``: the model whose blocks
        ``recompute`` turns on."""
        from .meta_optimizers import StrategyCompiler

        if strategy is not None:
            self._strategy = strategy
        if not self._is_initialized:
            self.init()
        optimizer, applied = StrategyCompiler().compile(
            optimizer, self._strategy, self._hcg, model=model)
        self._applied_meta_list = applied
        return HybridParallelOptimizer(optimizer, self._hcg, self._strategy)

    def minimize(self, optimizer, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        return optimizer.minimize(loss)

    def distributed_engine(self, model, optimizer, loss_fn=None, auto=False,
                           sample_batch=None, **kw):
        """The data-parallel ``TrainStepEngine`` of this fleet's topology and
        strategy, with ``loss_fn`` when given (the model eats all but the
        last batch tensor); ``kw`` (``num_model_inputs``, ``microbatches``,
        ``zero_update``, ``fsdp``) go to it. ``optimizer`` may be ``distributed_optimizer``'s chain."""
        from ..engine import TrainStepEngine

        if auto:
            raise NotImplementedError("distributed_engine(auto=True): the topology "
                                      "planner is not ported (ROADMAP.md Queue 1 item 3)")
        if not self._is_initialized:
            self.init()
        inner = optimizer
        while hasattr(inner, "_inner_opt") or hasattr(inner, "_optim"):
            inner = inner._inner_opt if hasattr(inner, "_inner_opt") else inner._optim
        return TrainStepEngine(model, inner, loss_fn=loss_fn, hcg=self._hcg,
                               strategy=self._strategy, **kw)

    # ---- checkpoints (reference fleet_base.py:824) ----
    def save_persistables(self, executor_or_model, dirname, main_program=None, mode=0):
        """``dirname/model.pdparams``: the model's state dict, in the file of
        ``paddle_tpu_torch.save`` (which the JAX package loads)."""
        from ...framework import io as fio

        if hasattr(executor_or_model, "state_dict"):
            fio.save(executor_or_model.state_dict(), dirname + "/model.pdparams")


fleet = Fleet()

init = fleet.init
distributed_model = fleet.distributed_model
distributed_optimizer = fleet.distributed_optimizer
distributed_engine = fleet.distributed_engine
minimize = fleet.minimize
worker_index = fleet.worker_index
worker_num = fleet.worker_num
worker_endpoints = fleet.worker_endpoints
is_first_worker = fleet.is_first_worker
barrier_worker = fleet.barrier_worker
save_persistables = fleet.save_persistables
get_hybrid_communicate_group = fleet.get_hybrid_communicate_group

__all__ = ["DistributedStrategy", "Fleet", "fleet", "init", "distributed_model",
           "distributed_optimizer", "distributed_engine", "minimize", "worker_index",
           "worker_num", "worker_endpoints", "is_first_worker", "barrier_worker",
           "save_persistables", "get_hybrid_communicate_group", "recompute", "utils",
           "HybridParallelOptimizer", "RoleMakerBase", "PaddleCloudRoleMaker",
           "UserDefinedRoleMaker"]
