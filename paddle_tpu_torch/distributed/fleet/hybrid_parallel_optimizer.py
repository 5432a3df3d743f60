"""``HybridParallelOptimizer`` (counterpart of
paddle_tpu/distributed/fleet/hybrid_parallel_optimizer.py; reference
dygraph_optimizer/hybrid_parallel_optimizer.py:170): the outermost wrapper
that ``fleet.distributed_optimizer`` returns.

``step`` averages the gradients over the data-parallel group
(``fleet.utils.fused_allreduce_gradients``: the bucketed Reducer) and then
steps the wrapped optimizer, unless a meta-optimizer chain took the sync
innermost (``_handles_dp_sync``). The strategy's ``find_unused_parameters``
reaches the Reducer: a parameter a rank did not use counts as zeros there. ``minimize`` is ``backward`` then
``step``; any other attribute is the wrapped optimizer's.
"""
from __future__ import annotations

import torch

from .utils import fused_allreduce_gradients


class HybridParallelOptimizer:
    def __init__(self, optimizer, hcg=None, strategy=None):
        self._inner_opt = optimizer
        self._hcg = hcg
        self._strategy = strategy

    def __getattr__(self, name):
        return getattr(self._inner_opt, name)

    @torch.no_grad()
    def step(self):
        if (not getattr(self._inner_opt, "_handles_dp_sync", False)
                and self._hcg is not None
                and self._hcg.get_data_parallel_world_size() > 1):
            fused_allreduce_gradients(
                self._inner_opt._parameter_list, self._hcg,
                getattr(self._strategy, "find_unused_parameters", False))
        self._inner_opt.step()

    def clear_grad(self, *a, **kw):
        self._inner_opt.clear_grad(*a, **kw)

    def minimize(self, loss, startup_program=None, parameters=None, no_grad_set=None):
        loss.backward()
        self.step()
        return None, []
