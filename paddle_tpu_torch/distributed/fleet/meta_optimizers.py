"""Meta-optimizers and the ``StrategyCompiler`` (counterpart of
paddle_tpu/distributed/fleet/meta_optimizers.py; reference
fleet/meta_optimizers/ and strategy_compiler.py).

Each meta-optimizer wraps the optimizer's ``step`` / ``clear_grad`` on the
eager path, or marks what the engine reads (amp, sharding). The compiler
keeps the JAX package's selection and order:

- the rule swaps come first and replace the optimizer: ``lars`` turns SGD
  or Momentum into ``Lars`` (momentum: the optimizer's own, else 0.9),
  ``lamb`` turns Adam or AdamW into ``Lamb``;
- conflicting meta-optimizers resolve first-wins in ``_META_OPTIMIZERS``
  order (``localsgd`` and ``dgc`` exclude each other);
- the chain is built innermost-first in that order, with ``DpSyncOptimizer``
  innermost when a real chain exists (anything beyond the ``sharding`` and
  ``raw_program`` markers) and the data-parallel group has more than one
  rank, unless ``localsgd`` replaces it;
- ``compile`` returns the chain and the applied names
  (``applied_meta_list``).

The semantics are the JAX package's, kept as they are:

- ``fp16_allreduce`` rounds f32 gradients through bfloat16 (not float16);
- ``dgc`` keeps the entries of |g + residual| at or above the k-th largest
  (k = round(numel x (1 - sparsity)), at least 1; ties all kept) and keeps
  the rest as the parameter's residual;
- ``gradient_merge`` steps every ``k_steps`` calls, divides the summed
  gradients by ``k_steps`` only with ``avg``, and clears them only at a
  boundary;
- ``localsgd`` steps locally and, every ``k_steps`` steps from
  ``begin_step`` on, all-reduces (SUM) the parameters and divides them by
  the world;
- ``amp`` has a ``GradScaler`` enabled only for float16 with dynamic
  scaling, and unscales only a loss it scaled itself (``scale``);
- the swaps match their exclude strings against the parameter's ``name``
  attribute, as the JAX swaps do, not against the module path the port's
  optimizers name parameters by. A JAX parameter's is its ``ParamAttr``
  name, "" without one; a torch parameter's is None, read as "". So an
  exclude string excludes nothing in either package (but "", which
  excludes every parameter in both).
"""
from __future__ import annotations

from typing import List

import torch

from ...optimizer import Lamb, Lars


class MetaOptimizerBase:
    """Everything not overridden is the wrapped optimizer's."""

    name = "base"
    conflicts: tuple = ()

    def __init__(self, inner, strategy, hcg=None):
        self._inner_opt = inner
        self._strategy = strategy
        self._hcg = hcg

    @classmethod
    def can_apply(cls, strategy, hcg=None) -> bool:
        return False

    def __getattr__(self, name):
        return getattr(self._inner_opt, name)

    def step(self):
        self._inner_opt.step()

    def clear_grad(self, set_to_zero=True):
        self._inner_opt.clear_grad(set_to_zero)

    def minimize(self, loss, startup_program=None, parameters=None, no_grad_set=None):
        loss.backward()
        self.step()
        return None, []

    @property
    def applied_meta_list(self):
        chain, opt = [], self
        while isinstance(opt, MetaOptimizerBase):
            chain.append(opt.name)
            opt = opt._inner_opt
        return chain


class AMPOptimizer(MetaOptimizerBase):
    """Autocast through ``amp_context()`` (the strategy's AMPConfig), with
    dynamic loss scaling for float16 only (bfloat16 has f32's exponent
    range)."""

    name = "amp"

    def __init__(self, inner, strategy, hcg=None):
        super().__init__(inner, strategy, hcg)
        from ...amp import GradScaler

        cfg = strategy.amp_configs
        self._scaler = GradScaler(
            enable=cfg.dtype == "float16" and cfg.use_dynamic_loss_scaling,
            init_loss_scaling=cfg.init_loss_scaling,
            incr_ratio=cfg.incr_ratio, decr_ratio=cfg.decr_ratio,
            incr_every_n_steps=cfg.incr_every_n_steps,
            decr_every_n_nan_or_inf=cfg.decr_every_n_nan_or_inf)
        self._loss_was_scaled = False

    @classmethod
    def can_apply(cls, strategy, hcg=None):
        return bool(strategy.amp)

    def amp_context(self):
        from ...amp import amp_guard_from_configs

        return amp_guard_from_configs(self._strategy.amp_configs)

    def scale(self, loss):
        if self._scaler._enable:
            self._loss_was_scaled = True
            return self._scaler.scale(loss)
        return loss

    def minimize(self, loss, startup_program=None, parameters=None, no_grad_set=None):
        self.scale(loss).backward()
        self.step()
        return None, []

    def step(self):
        # a plain loss.backward(); step() must not divide unscaled gradients
        if self._scaler._enable and self._loss_was_scaled:
            self._scaler.step(self._inner_opt)
            self._scaler.update()
            self._loss_was_scaled = False
        else:
            self._inner_opt.step()


class RecomputeOptimizer(MetaOptimizerBase):
    """Turns on recompute in the model's blocks (``use_recompute``, and
    ``recompute_granularity`` from the strategy's RecomputeConfig)."""

    name = "recompute"

    @classmethod
    def can_apply(cls, strategy, hcg=None):
        return bool(strategy.recompute)

    def enable_on(self, model):
        gran = getattr(self._strategy.recompute_configs, "granularity", "full")
        n = 0
        for layer in model.modules():
            if hasattr(layer, "use_recompute"):
                layer.use_recompute = True
                if hasattr(layer, "recompute_granularity"):
                    layer.recompute_granularity = gran
                n += 1
        return n


class GradientMergeOptimizer(MetaOptimizerBase):
    """One update every ``k_steps`` steps over the gradients the backward
    passes summed in between."""

    name = "gradient_merge"

    def __init__(self, inner, strategy, hcg=None):
        super().__init__(inner, strategy, hcg)
        self.k_steps = max(1, int(strategy.gradient_merge_configs.k_steps))
        self.avg = bool(strategy.gradient_merge_configs.avg)
        self._acc = 0

    @classmethod
    def can_apply(cls, strategy, hcg=None):
        return bool(strategy.gradient_merge) and strategy.gradient_merge_configs.k_steps > 1

    @torch.no_grad()
    def step(self):
        self._acc += 1
        if self._acc % self.k_steps:
            return
        if self.avg:
            for p in self._inner_opt._parameter_list:
                if p.grad is not None:
                    p.grad.div_(self.k_steps)
        self._inner_opt.step()

    def clear_grad(self, set_to_zero=True):
        if self._acc % self.k_steps == 0:
            self._inner_opt.clear_grad(set_to_zero)


class LocalSGDOptimizer(MetaOptimizerBase):
    """Local steps; the parameters averaged over the data-parallel group
    every ``k_steps`` steps (reference localsgd_optimizer.py)."""

    name = "localsgd"
    conflicts = ("dgc",)

    def __init__(self, inner, strategy, hcg=None):
        super().__init__(inner, strategy, hcg)
        self.k_steps = max(1, int(strategy.localsgd_configs.k_steps))
        self.begin_step = int(strategy.localsgd_configs.begin_step)
        self._step_i = 0

    @classmethod
    def can_apply(cls, strategy, hcg=None):
        return bool(strategy.localsgd)

    @torch.no_grad()
    def step(self):
        self._inner_opt.step()
        self._step_i += 1
        if self._step_i >= self.begin_step and self._step_i % self.k_steps == 0:
            self._sync_params()

    def _sync_params(self):
        from .. import collective
        from ..env import get_world_size

        world = (self._hcg.get_data_parallel_world_size() if self._hcg is not None
                 else get_world_size())
        if world <= 1:
            return
        group = self._hcg.get_data_parallel_group() if self._hcg else None
        for p in self._inner_opt._parameter_list:
            collective.all_reduce(p.data, group=group)
            p.data.div_(world)


class DGCOptimizer(MetaOptimizerBase):
    """Deep gradient compression: before each step only the top (1 -
    sparsity) share of each gradient's entries stays; the rest is the
    parameter's residual, added to its next gradient."""

    name = "dgc"
    conflicts = ("localsgd",)

    def __init__(self, inner, strategy, hcg=None):
        super().__init__(inner, strategy, hcg)
        cfg = strategy.dgc_configs
        self.rampup_begin_step = int(cfg.rampup_begin_step)
        self.sparsity = list(cfg.sparsity) or [0.999]
        self._step_i = 0
        self._residual = {}

    @classmethod
    def can_apply(cls, strategy, hcg=None):
        return bool(strategy.dgc)

    @torch.no_grad()
    def step(self):
        self._step_i += 1
        if self._step_i > self.rampup_begin_step:
            s = self.sparsity[min(len(self.sparsity) - 1, self._step_i - 1)]
            for p in self._inner_opt._parameter_list:
                if p.grad is None:
                    continue
                g = p.grad + self._residual.get(id(p), 0.0)
                k = max(1, int(round(g.numel() * (1.0 - s))))
                # the k-th largest |g| (the JAX package's sort(|g|)[-k]: the same
                # value); every tie at it stays
                thresh = torch.topk(g.abs().reshape(-1), k, sorted=False).values.min()
                mask = (g.abs() >= thresh).to(g.dtype)
                self._residual[id(p)] = g * (1.0 - mask)
                p.grad = g * mask
        self._inner_opt.step()


class FP16AllReduceOptimizer(MetaOptimizerBase):
    """f32 gradients rounded through bfloat16 before the data-parallel sync
    (the bytes a bf16 all-reduce would carry)."""

    name = "fp16_allreduce"

    @classmethod
    def can_apply(cls, strategy, hcg=None):
        return bool(getattr(strategy, "fp16_allreduce", False))

    @torch.no_grad()
    def step(self):
        for p in self._inner_opt._parameter_list:
            if p.grad is not None and p.grad.dtype == torch.float32:
                p.grad = p.grad.to(torch.bfloat16).float()
        self._inner_opt.step()


def _attr_name(param) -> str:
    return getattr(param, "name", "") or ""


class LarsOptimizer(MetaOptimizerBase):
    """The swap of SGD or Momentum for Lars (reference lars_optimizer.py)."""

    name = "lars"

    @classmethod
    def can_apply(cls, strategy, hcg=None):
        return bool(strategy.lars)

    @staticmethod
    def rebuild(inner, strategy):
        if inner._rule not in ("sgd", "momentum"):
            return inner
        cfg = strategy.lars_configs
        return _SwapLars(
            learning_rate=inner._learning_rate,
            momentum=inner._hyper.get("momentum", 0.9),
            lars_coeff=cfg.lars_coeff, lars_weight_decay=cfg.lars_weight_decay,
            epsilon=cfg.epsilon, exclude_from_weight_decay=cfg.exclude_from_weight_decay,
            parameters=list(zip(inner._param_names, inner._parameter_list)),
            grad_clip=inner._grad_clip)


class LambOptimizer(MetaOptimizerBase):
    """The swap of Adam or AdamW for Lamb (reference lamb_optimizer.py)."""

    name = "lamb"

    @classmethod
    def can_apply(cls, strategy, hcg=None):
        return bool(strategy.lamb)

    @staticmethod
    def rebuild(inner, strategy):
        if inner._rule not in ("adam", "adamw"):
            return inner
        cfg = strategy.lamb_configs
        exclude = list(cfg.exclude_from_weight_decay)
        by_name = dict(zip(inner._param_names, inner._parameter_list))

        def exclude_fn(name):   # the JAX swap's test, on the parameter's name attribute
            return any(s in _attr_name(by_name[name]) for s in exclude)

        return Lamb(
            learning_rate=inner._learning_rate, lamb_weight_decay=cfg.lamb_weight_decay,
            parameters=list(by_name.items()), grad_clip=inner._grad_clip,
            exclude_from_weight_decay_fn=exclude_fn if exclude else None)


class _SwapLars(Lars):
    """Lars whose exclude strings match the parameter's name attribute (the
    JAX swap's ``Lars``) instead of the port's parameter name."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self._attr_names = {n: _attr_name(p) for n, p in zip(self._param_names,
                                                             self._parameter_list)}

    def _rule_kwargs(self, name):
        kw = dict(self._hyper)
        if any(s in self._attr_names[name] for s in self._exclude_names):
            kw["exclude_from_decay"] = True
        return kw


class ShardingOptimizer(MetaOptimizerBase):
    """Marker: the engine shards the optimizer state (``strategy.sharding``
    runs its ZeRO update)."""

    name = "sharding"

    @classmethod
    def can_apply(cls, strategy, hcg=None):
        return bool(strategy.sharding)


class RawProgramOptimizer(MetaOptimizerBase):
    """Marker of the plain data-parallel mode: the eager sync is the
    HybridParallelOptimizer's, the engine's is its one fused reduce."""

    name = "raw_program"

    @classmethod
    def can_apply(cls, strategy, hcg=None):
        return bool(getattr(strategy, "without_graph_optimization", False))


class DpSyncOptimizer(MetaOptimizerBase):
    """The data-parallel gradient average, innermost: after every gradient
    transform (dgc, the bf16 round) and only when an update happens (at a
    gradient-merge boundary)."""

    name = "dp_sync"

    @torch.no_grad()
    def step(self):
        from .utils import fused_allreduce_gradients

        if self._hcg is not None and self._hcg.get_data_parallel_world_size() > 1:
            fused_allreduce_gradients(
                self._inner_opt._parameter_list, self._hcg,
                getattr(self._strategy, "find_unused_parameters", False))
        self._inner_opt.step()


# innermost first: the gradient transforms just outside dp_sync, the
# step-frequency wrapper (gradient merge) outside those, amp outermost
_META_OPTIMIZERS = [
    FP16AllReduceOptimizer,
    DGCOptimizer,
    LocalSGDOptimizer,
    ShardingOptimizer,
    GradientMergeOptimizer,
    RecomputeOptimizer,
    AMPOptimizer,
    RawProgramOptimizer,
]


class StrategyCompiler:
    """Picks the applicable meta-optimizers, drops conflicting ones (first
    wins), orders and chains them (module docstring)."""

    def compile(self, optimizer, strategy, hcg=None, model=None):
        applied: List[str] = []
        disabled: set = set()

        # the rule swaps first: they replace the optimizer
        for swap in (LarsOptimizer, LambOptimizer):
            if swap.can_apply(strategy, hcg):
                rebuilt = swap.rebuild(optimizer, strategy)
                if rebuilt is not optimizer:
                    optimizer = rebuilt
                    applied.append(swap.name)

        wrappers = []
        for cls in _META_OPTIMIZERS:
            if cls.name in disabled or not cls.can_apply(strategy, hcg):
                continue
            disabled.update(cls.conflicts)
            wrappers.append(cls)

        handles_dp_sync = False
        if any(w.name not in ("sharding", "raw_program") for w in wrappers):
            # a real chain: the dp sync moves innermost (localsgd replaces it)
            if (not any(w.name == "localsgd" for w in wrappers) and hcg is not None
                    and hcg.get_data_parallel_world_size() > 1):
                optimizer = DpSyncOptimizer(optimizer, strategy, hcg)
            handles_dp_sync = True

        for cls in wrappers:
            wrapper = cls(optimizer, strategy, hcg)
            if isinstance(wrapper, RecomputeOptimizer) and model is not None:
                wrapper.enable_on(model)
            applied.append(cls.name)
            if cls.name in ("sharding", "raw_program"):
                continue  # markers: the engine's behaviour, nothing wrapped
            optimizer = wrapper

        if handles_dp_sync:
            optimizer._handles_dp_sync = True
        return optimizer, applied
