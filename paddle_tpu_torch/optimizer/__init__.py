"""Optimizers (counterpart of paddle_tpu/optimizer/__init__.py).

An ``Optimizer`` holds its parameters by name, its learning rate (a float or
an ``lr.LRScheduler``), a grad-clip rule and one f32 state tuple per
parameter. ``step()`` reads ``p.grad``, clips, adds an ``L1Decay`` penalty,
runs the functional rule (``optimizer/functional.py``) and writes
parameters and state in place; ``distributed/engine.py``'s
``TrainStepEngine`` runs the same rules over the same state. All ten of the
JAX package's rules: ``SGD``, ``Momentum``, ``Adam``, ``AdamW``,
``Adamax``, ``Adagrad``, ``Adadelta``, ``RMSProp``, ``Lars``
(``LarsMomentum``) and ``Lamb``.

``parameters`` may be ``model.named_parameters()`` (names are the module
paths) or bare tensors (named ``param_<i>``); ``apply_decay_param_fun``
receives those names, and so does Lamb's ``exclude_from_weight_decay_fn``:
the JAX package passes that one the parameter, the one place where the two
APIs differ. Lars excludes a parameter whose name contains one of
``exclude_from_weight_decay``.

``weight_decay`` is a float, an ``L2Decay`` (its coefficient is the rule's
decay) or an ``L1Decay`` (the penalty ``grad + coeff * sign(param)`` in
``step``, not folded into the rule); anything else raises ``TypeError``. A
parameter whose ``regularizer`` attribute is an ``L1Decay`` takes that one.
Only the rules of ``_DECAY_RULES`` take ``weight_decay``; Lamb and Lars
have their own.

``_offload`` (set by ``GroupShardedOptimizerStage2(offload=True)`` or
``GroupShardedStage3(offload=True)``, as in the JAX package) keeps the state
on the host between steps, in pinned memory when the parameter is on a
card: each parameter's state is moved to the parameter's device for its
update and copied back, so the numbers are those of the run without it.

As the JAX package does: ``set_lr`` replaces a scheduler with a float;
``clear_grad`` ignores ``set_to_zero``; Adam's and AdamW's ``lazy_mode``
and ``multi_precision``, and AdamW's ``lr_ratio``, are accepted and have no
effect; Adagrad ignores ``initial_accumulator_value``; the engine applies
no ``L1Decay``, only ``step`` does.
"""
from __future__ import annotations

import torch

from ..nn.clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue  # noqa: F401
from ..regularizer import L1Decay, L2Decay, WeightDecayRegularizer  # noqa: F401
from . import functional as funct
from . import lr  # noqa: F401
from .lr import LRScheduler


def _named(parameters):
    out = []
    for i, item in enumerate(parameters or ()):
        if isinstance(item, tuple):
            name, p = item
        else:
            name, p = f"param_{i}", item
        out.append((str(name), p))
    return out


def _to_host(t, pin):
    t = t.to("cpu", copy=True)
    return t.pin_memory() if pin else t


class Optimizer:
    _rule = "sgd"
    _offload = False  # state on the host between steps (module docstring)
    # the rules that take the optimizer's weight_decay (L2, or AdamW's
    # decoupled decay)
    _DECAY_RULES = frozenset({"sgd", "momentum", "adam", "adamax", "adagrad",
                              "adadelta", "rmsprop", "adamw"})

    def __init__(self, learning_rate=0.001, parameters=None, weight_decay=None,
                 grad_clip=None, apply_decay_param_fun=None):
        named = _named(parameters)
        self._param_names = [n for n, _ in named]
        self._parameter_list = [p for _, p in named]
        self._learning_rate = learning_rate
        self._grad_clip = grad_clip
        self._l1_decay = None
        if weight_decay is None:
            weight_decay = 0.0
        elif getattr(weight_decay, "_is_l1", False):
            self._l1_decay, weight_decay = weight_decay, 0.0
        elif isinstance(weight_decay, WeightDecayRegularizer):
            weight_decay = weight_decay._coeff
        elif not isinstance(weight_decay, (int, float)):
            raise TypeError("weight_decay is a float, an L2Decay or an L1Decay, got "
                            f"{type(weight_decay).__name__}")
        self._weight_decay = float(weight_decay)
        self._hyper = {}
        self._states = {}  # name -> state tuple (f32)
        self._step_count = 0
        self._apply_decay_param_fun = apply_decay_param_fun

    # ---- lr ----
    def get_lr(self):
        if isinstance(self._learning_rate, LRScheduler):
            return self._learning_rate()
        return float(self._learning_rate)

    def set_lr(self, value):
        self._learning_rate = float(value)

    # ---- core ----
    def _rule_kwargs(self, name):
        """Hyperparameters of the rule for parameter ``name``; weight decay is
        0 for it when ``apply_decay_param_fun(name)`` is false."""
        kw = dict(self._hyper)
        if self._rule in self._DECAY_RULES:
            wd = self._weight_decay
            if (self._apply_decay_param_fun is not None
                    and not self._apply_decay_param_fun(name)):
                wd = 0.0
            kw["weight_decay"] = wd
        return kw

    def _state(self, name, param):
        st = self._states.get(name)
        if st is None:
            st = self._states[name] = funct.init_state(self._rule, param)
        return st

    @torch.no_grad()
    def _apply(self, params, grads, lr_val, step):
        """Run the rule over name -> tensor dicts; parameters and state are
        written in place, one parameter at a time (its new values are copied
        before the next parameter's are made, so the rule's temporaries are
        one parameter's, not the model's)."""
        update = funct.make_param_update(self)
        for n, p in params.items():
            state = self._state(n, p)
            if self._offload:
                if any(s.device.type != "cpu" for s in state):
                    state = self._states[n] = tuple(_to_host(s, p.is_cuda) for s in state)
                work = tuple(s.to(p.device, non_blocking=True) for s in state)
            else:
                work = state
            new_p, new_state = update(n, p, grads[n], work, lr_val, step)
            p.copy_(new_p)
            for old, new in zip(state, new_state):
                old.copy_(new)
            del new_p, new_state, work

    @torch.no_grad()
    def step(self):
        if not self._parameter_list:
            raise ValueError("optimizer has no parameters; pass `parameters=`")
        self._step_count += 1
        named_grads = [(n, p.grad) for n, p in zip(self._param_names,
                                                   self._parameter_list)
                       if p.requires_grad and p.grad is not None]
        if self._grad_clip is not None:
            named_grads = self._grad_clip(named_grads)
        by_name = dict(zip(self._param_names, self._parameter_list))
        grads = {}
        for n, g in named_grads:
            reg = getattr(by_name[n], "regularizer", None)
            if not getattr(reg, "_is_l1", False):
                reg = self._l1_decay
            grads[n] = g if reg is None else reg.apply(by_name[n], g)
        self._apply({n: by_name[n] for n in grads}, grads, self.get_lr(),
                    self._step_count)

    def clear_grad(self, set_to_zero=False):
        for p in self._parameter_list:
            p.grad = None

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None, no_grad_set=None):
        """Backward of ``loss``, then ``step()``; returns ``(None, [(param,
        grad), ...])`` as the JAX package's dygraph ``minimize`` does."""
        loss.backward()
        self.step()
        return None, [(p, p.grad) for p in self._parameter_list]

    # ---- checkpoint (the JAX package's keys) ----
    def state_dict(self, states=None):
        """The JAX package's keys. ``states`` (name -> state tuple) replaces
        the optimizer's own: the engine passes the state it gathered from
        ZeRO's flat shards."""
        states = self._states if states is None else states
        out = {"_step_count": self._step_count}
        for i, n in enumerate(self._param_names):
            for j, s in enumerate(states.get(n, ())):
                out[f"param{i}_state{j}"] = s
        if isinstance(self._learning_rate, LRScheduler):
            out["LR_Scheduler"] = self._learning_rate.state_dict()
        return out

    def set_state_dict(self, state_dict):
        self._step_count = int(state_dict.get("_step_count", 0))
        if "LR_Scheduler" in state_dict and isinstance(self._learning_rate,
                                                       LRScheduler):
            self._learning_rate.set_state_dict(state_dict["LR_Scheduler"])
        for i, (n, p) in enumerate(zip(self._param_names, self._parameter_list)):
            states = []
            while f"param{i}_state{len(states)}" in state_dict:
                s = torch.as_tensor(state_dict[f"param{i}_state{len(states)}"])
                states.append(s.to(device=p.device, dtype=torch.float32).clone())
            if states:
                self._states[n] = tuple(states)

    set_dict = set_state_dict


class SGD(Optimizer):
    _rule = "sgd"


class Momentum(Optimizer):
    _rule = "momentum"

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 apply_decay_param_fun=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         apply_decay_param_fun)
        self._hyper = {"momentum": momentum, "use_nesterov": use_nesterov}


class Adam(Optimizer):
    _rule = "adam"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 parameters=None, weight_decay=None, grad_clip=None, lazy_mode=False,
                 multi_precision=True, apply_decay_param_fun=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         apply_decay_param_fun)
        self._hyper = {"beta1": float(beta1), "beta2": float(beta2),
                       "epsilon": float(epsilon)}


class AdamW(Optimizer):
    """Adam with decoupled weight decay (default 0.01)."""

    _rule = "adamw"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 parameters=None, weight_decay=0.01, lr_ratio=None,
                 apply_decay_param_fun=None, grad_clip=None, lazy_mode=False,
                 multi_precision=True):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         apply_decay_param_fun)
        self._hyper = {"beta1": float(beta1), "beta2": float(beta2),
                       "epsilon": float(epsilon)}


class Adamax(Optimizer):
    _rule = "adamax"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 parameters=None, weight_decay=None, grad_clip=None,
                 apply_decay_param_fun=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         apply_decay_param_fun)
        self._hyper = {"beta1": beta1, "beta2": beta2, "epsilon": epsilon}


class Adagrad(Optimizer):
    _rule = "adagrad"

    def __init__(self, learning_rate, epsilon=1e-6, parameters=None, weight_decay=None,
                 grad_clip=None, initial_accumulator_value=0.0,
                 apply_decay_param_fun=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         apply_decay_param_fun)
        self._hyper = {"epsilon": epsilon}


class Adadelta(Optimizer):
    _rule = "adadelta"

    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95, parameters=None,
                 weight_decay=None, grad_clip=None, apply_decay_param_fun=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         apply_decay_param_fun)
        self._hyper = {"epsilon": epsilon, "rho": rho}


class RMSProp(Optimizer):
    _rule = "rmsprop"

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None, grad_clip=None,
                 apply_decay_param_fun=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         apply_decay_param_fun)
        self._hyper = {"rho": rho, "epsilon": epsilon, "momentum": momentum,
                       "centered": centered}


class Lars(Optimizer):
    """LARS momentum: a parameter whose name contains one of
    ``exclude_from_weight_decay`` takes no ``lars_weight_decay``."""

    _rule = "lars"

    def __init__(self, learning_rate=0.001, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, parameters=None, grad_clip=None,
                 exclude_from_weight_decay=None, epsilon=0.0):
        super().__init__(learning_rate, parameters, None, grad_clip)
        self._hyper = {"momentum": momentum, "lars_coeff": lars_coeff,
                       "lars_weight_decay": lars_weight_decay, "epsilon": epsilon}
        self._exclude_names = list(exclude_from_weight_decay or [])

    def _rule_kwargs(self, name):
        kw = dict(self._hyper)
        if any(s in name for s in self._exclude_names):
            kw["exclude_from_decay"] = True
        return kw


LarsMomentum = Lars


class Lamb(Optimizer):
    """LAMB: ``exclude_from_weight_decay_fn(name)`` true takes no
    ``lamb_weight_decay`` (the JAX package calls it with the parameter)."""

    _rule = "lamb"

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01, beta1=0.9,
                 beta2=0.999, epsilon=1e-6, parameters=None, grad_clip=None,
                 exclude_from_weight_decay_fn=None):
        super().__init__(learning_rate, parameters, None, grad_clip)
        self._hyper = {"beta1": beta1, "beta2": beta2, "epsilon": epsilon,
                       "lamb_weight_decay": lamb_weight_decay}
        self._exclude_fn = exclude_from_weight_decay_fn

    def _rule_kwargs(self, name):
        kw = dict(self._hyper)
        if self._exclude_fn is not None and self._exclude_fn(name):
            kw["exclude_from_decay"] = True
        return kw


__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adamax", "Adagrad",
           "Adadelta", "RMSProp", "Lars", "LarsMomentum", "Lamb", "LRScheduler", "lr",
           "ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue", "L1Decay",
           "L2Decay"]
