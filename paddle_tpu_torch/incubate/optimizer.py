"""LookAhead and ModelAverage (counterpart of paddle_tpu/incubate/optimizer.py).

The JAX package holds its snapshots by reference, which is safe there
because its arrays are immutable. The port's optimizers write parameters
in place, so each snapshot here is a copy (``detach().clone()``) and every
write-back is ``p.copy_``: the slow weights and the backup never alias the
parameters.
"""
from __future__ import annotations

import torch

from ..optimizer import _named


class LookAhead:
    """k steps forward, 1 step back (arXiv:1907.08610): every ``k`` steps of
    ``inner_optimizer`` the slow weights move ``alpha`` of the way to the
    fast ones, and the parameters take the slow weights."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5):
        self.inner_optimizer = inner_optimizer
        self.alpha = float(alpha)
        self.k = int(k)
        self._steps = 0
        self._slow = [p.detach().clone() for p in inner_optimizer._parameter_list]

    @property
    def _parameters(self):
        return self.inner_optimizer._parameter_list

    @torch.no_grad()
    def step(self):
        self.inner_optimizer.step()
        self._steps += 1
        if self._steps % self.k == 0:
            for i, p in enumerate(self.inner_optimizer._parameter_list):
                slow = self._slow[i]
                slow = slow + self.alpha * (p - slow)
                self._slow[i] = slow
                p.copy_(slow)

    def clear_grad(self, set_to_zero=False):
        self.inner_optimizer.clear_grad(set_to_zero)

    def get_lr(self):
        return self.inner_optimizer.get_lr()

    def state_dict(self):
        sd = self.inner_optimizer.state_dict()
        sd["lookahead_steps"] = self._steps
        return sd

    def minimize(self, loss, **kw):
        loss.backward()
        self.step()
        self.clear_grad()


class ModelAverage:
    """The running mean of ``parameters`` over the calls of ``step()``;
    ``apply()`` puts the mean into the parameters and ``restore()`` puts
    them back (a cumulative mean: the window arguments are read by neither
    package)."""

    def __init__(self, average_window_rate=0.15, parameters=None,
                 min_average_window=10000, max_average_window=10000):
        if parameters is None:
            raise ValueError("ModelAverage needs the parameter list")
        self._parameters = [p for _, p in _named(parameters)]
        self._sum = [torch.zeros_like(p) for p in self._parameters]
        self._count = 0
        self._backup = None

    @torch.no_grad()
    def step(self):
        for s, p in zip(self._sum, self._parameters):
            s.add_(p)
        self._count += 1

    @torch.no_grad()
    def apply(self, executor=None, need_restore=True):
        if self._count == 0:
            raise RuntimeError("ModelAverage.step() never ran")
        self._backup = [p.detach().clone() for p in self._parameters]
        for s, p in zip(self._sum, self._parameters):
            p.copy_(s / self._count)
        return _RestoreCtx(self) if need_restore else None

    @torch.no_grad()
    def restore(self, executor=None):
        if self._backup is not None:
            for b, p in zip(self._backup, self._parameters):
                p.copy_(b)
            self._backup = None


class _RestoreCtx:
    def __init__(self, ma):
        self._ma = ma

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._ma.restore()
        return False
