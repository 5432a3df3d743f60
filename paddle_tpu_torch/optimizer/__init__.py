"""Optimizers (counterpart of paddle_tpu/optimizer/__init__.py).

An ``Optimizer`` holds its parameters by name, its learning rate (a float or
an ``lr.LRScheduler``), a grad-clip rule and one f32 state tuple per
parameter. ``step()`` reads ``p.grad``, clips, runs the functional rule
(``optimizer/functional.py``) and writes parameters and state in place;
``distributed/engine.py``'s ``TrainStepEngine`` runs the same rules over the
same state. Ported: ``SGD``, ``Momentum``, ``Adam``, ``AdamW``.

``parameters`` may be ``model.named_parameters()`` (names are the module
paths) or bare tensors (named ``param_<i>``); ``apply_decay_param_fun``
receives those names.
"""
from __future__ import annotations

import torch

from ..nn.clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue  # noqa: F401
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


class Optimizer:
    _rule = "sgd"

    def __init__(self, learning_rate=0.001, parameters=None, weight_decay=None,
                 grad_clip=None, apply_decay_param_fun=None):
        named = _named(parameters)
        self._param_names = [n for n, _ in named]
        self._parameter_list = [p for _, p in named]
        self._learning_rate = learning_rate
        self._grad_clip = grad_clip
        if weight_decay is None:
            weight_decay = 0.0
        if not isinstance(weight_decay, (int, float)):
            raise TypeError("the port takes weight_decay as a float (L1Decay and "
                            "L2Decay objects are not ported)")
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

    # ---- core ----
    def _rule_kwargs(self, name):
        """Hyperparameters of the rule for parameter ``name``; weight decay is
        0 for it when ``apply_decay_param_fun(name)`` is false."""
        kw = dict(self._hyper)
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
            new_p, new_state = update(n, p, grads[n], state, lr_val, step)
            p.copy_(new_p)
            for old, new in zip(state, new_state):
                old.copy_(new)
            del new_p, new_state

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
        grads = dict(named_grads)
        self._apply({n: by_name[n] for n in grads}, grads, self.get_lr(),
                    self._step_count)

    def clear_grad(self):
        for p in self._parameter_list:
            p.grad = None

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
                 parameters=None, weight_decay=None, grad_clip=None,
                 apply_decay_param_fun=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         apply_decay_param_fun)
        self._hyper = {"beta1": float(beta1), "beta2": float(beta2),
                       "epsilon": float(epsilon)}


class AdamW(Optimizer):
    """Adam with decoupled weight decay (default 0.01)."""

    _rule = "adamw"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 parameters=None, weight_decay=0.01, apply_decay_param_fun=None,
                 grad_clip=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         apply_decay_param_fun)
        self._hyper = {"beta1": float(beta1), "beta2": float(beta2),
                       "epsilon": float(epsilon)}


__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "LRScheduler", "lr",
           "ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue"]
