"""Group-sharded (ZeRO) wrappers (counterpart of
paddle_tpu/distributed/meta_parallel/sharding.py; reference
group_sharded_optimizer_stage2.py:48, group_sharded_stage2.py,
group_sharded_stage3.py:58, sharding/group_sharded.py:40).

As in the JAX package these wrappers keep the reference's API and mark what
the engine (``fleet.distributed_engine``) reads; the sharding itself is the
engine's:

- **Stage 2** (``level`` "os" or "os_g"): ``GroupShardedOptimizerStage2``
  sets the optimizer's ``_offload`` (optimizer state in pinned host memory
  between steps, moved to the parameter's card for its update: the same
  numbers). The engine shards the optimizer state by ZeRO under
  ``sharding_degree > 1`` or ``strategy.sharding``.
- **Stage 3** (``level`` "p_g_os"): ``GroupShardedStage3`` marks every
  parameter of more than ``segment_size`` elements (and none already
  marked) with a ``dist_attr``, the spec ``"sharding"`` on its first dim
  that the sharding degree divides, as the JAX package does. Under
  ``sharding_degree > 1`` a marked model runs the engine's FSDP step.
  **Which parameters are sharded differs:** the JAX engine shards only the
  marked parameters, along the marked dim, and keeps the small ones whole;
  the port's FSDP shards every parameter, as flat f32 slices of whole
  per-layer buckets (``grad_comm.fsdp_buckets``). Both give the replicated
  step's numbers.

**The eager step of more than one rank.** The JAX package runs one
controller, whose eager arrays are global, so its wrappers have no gradient
to sync. The port runs a process a rank, so the wrappers average the
gradients over every data replica (``mesh.replica_group()``: dp x
sharding) through the bucketed ``Reducer`` before the update: stage 2 in
``GroupShardedOptimizerStage2.step``, stage 3 (whose optimizer is returned
unwrapped) at the end of each backward that ``GroupShardedStage3`` ran
(``sync_in_backward``, which the engine turns off: it reduces for itself).
The eager step keeps every rank's optimizer state whole, as the JAX eager
step does.
"""
from __future__ import annotations

import torch

from ..mesh import get_hybrid_communicate_group


def _replica_group(group=None):
    if group is not None:
        return group
    hcg = get_hybrid_communicate_group()
    return hcg.replica_group() if hcg is not None else None


def _sync_grads(params, group):
    from ..fleet.utils import allreduce_gradients_over

    if group is not None and group.nranks > 1:
        allreduce_gradients_over(params, group)


class GroupShardedOptimizerStage2:
    """Wraps an optimizer: ``offload=True`` keeps its state in pinned host
    memory between steps; ``step`` syncs the gradients over the replicas
    first (module docstring)."""

    def __init__(self, params, optim, group=None, offload=False, device="gpu", **kw):
        self._optim = optim
        self._params = list(params)
        self._group = _replica_group(group)
        self.offload = offload
        self.zero_stage = 2
        optim._zero_stage = 2
        optim._offload = bool(offload)

    def __getattr__(self, name):
        return getattr(self._optim, name)

    def step(self):
        _sync_grads(self._optim._parameter_list, self._group)
        self._optim.step()

    def clear_grad(self, *a, **k):
        self._optim.clear_grad(*a, **k)


class _ShardedModel(torch.nn.Module):
    """A model wrapper: ``forward``, ``state_dict`` and ``set_state_dict``
    are the wrapped model's; ``fsdp_layer_key`` and ``generator`` too, for
    the engine."""

    def __init__(self, layer):
        super().__init__()
        self._layers = layer

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    @property
    def fsdp_layer_key(self):
        return getattr(self._layers, "fsdp_layer_key", None)

    @property
    def generator(self):
        return getattr(self._layers, "generator", None)

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def set_state_dict(self, sd, *a, **k):
        return self._layers.load_state_dict(sd, *a, **k)

    load_state_dict = set_state_dict


class GroupShardedStage2(_ShardedModel):
    def __init__(self, layer, sharding_optimizer, group=None, sync_buffers=False,
                 buffer_max_size=2 ** 23, auto_refresh_trainable=True, device="gpu"):
        super().__init__(layer)
        self._sharding_optimizers = (sharding_optimizer
                                     if isinstance(sharding_optimizer, list)
                                     else [sharding_optimizer])


class GroupShardedStage3(_ShardedModel):
    """Stage 3: marks the parameters of more than ``segment_size`` elements
    for sharding over the sharding axis (module docstring)."""

    def __init__(self, layer, optimizer=None, group=None, sync_buffers=False,
                 device="gpu", segment_size=2 ** 20, pertrain_sync_models=True,
                 offload=False, sync_comm=False):
        super().__init__(layer)
        self._optim = optimizer
        self._group = _replica_group(group)
        self.segment_size = segment_size
        self.sync_in_backward = True
        self._sync_queued = False
        hcg = get_hybrid_communicate_group()
        deg = hcg.degrees["sharding"] if hcg else 1
        if deg > 1:
            for p in layer.parameters():
                if getattr(p, "dist_attr", None) is not None:
                    continue  # an annotation of its own stays
                if p.numel() <= segment_size:
                    continue  # small parameters stay whole (reference :314)
                for i, s in enumerate(p.shape):
                    if s % deg == 0:
                        spec = [None] * p.dim()
                        spec[i] = "sharding"
                        p.dist_attr = tuple(spec)
                        break
        if optimizer is not None:
            optimizer._zero_stage = 3
            optimizer._offload = bool(offload)

    def forward(self, *inputs, **kwargs):
        out = self._layers(*inputs, **kwargs)
        group = self._group
        if (self.sync_in_backward and torch.is_grad_enabled() and group is not None
                and group.nranks > 1):
            outs = out if isinstance(out, (tuple, list)) else (out,)
            for t in outs:
                if torch.is_tensor(t) and t.requires_grad:
                    t.register_hook(self._queue_sync)
        return out

    def _queue_sync(self, grad):
        """The first output gradient of a backward queues the sync at its end."""
        if not self._sync_queued:
            self._sync_queued = True
            torch.autograd.Variable._execution_engine.queue_callback(self._end_sync)
        return grad

    def _end_sync(self):
        self._sync_queued = False
        _sync_grads([p for p in self._layers.parameters()], self._group)


def group_sharded_parallel(model, optimizer, level, scaler=None, group=None,
                           offload=False, sync_buffers=False, buffer_max_size=2 ** 23,
                           segment_size=2 ** 20, sync_comm=False):
    """Reference group_sharded.py:40: ``(model, optimizer)``, or ``(model,
    optimizer, scaler)`` when a scaler is given. "os" / "os_g": the stage-2
    wrappers; "p_g_os": ``GroupShardedStage3`` and the optimizer itself."""
    if level in ("os", "os_g"):
        opt = GroupShardedOptimizerStage2(model.parameters(), optimizer, group=group,
                                          offload=offload)
        model = GroupShardedStage2(model, opt, group=group, sync_buffers=sync_buffers,
                                   buffer_max_size=buffer_max_size)
        out_opt = opt
    elif level == "p_g_os":
        model = GroupShardedStage3(model, optimizer=optimizer, group=group,
                                   sync_buffers=sync_buffers, segment_size=segment_size,
                                   offload=offload, sync_comm=sync_comm)
        out_opt = optimizer
    else:
        raise ValueError(f"level must be os | os_g | p_g_os, got {level!r}")
    if scaler is not None:
        return model, out_opt, scaler
    return model, out_opt
