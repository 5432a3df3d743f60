"""L1Decay / L2Decay (counterpart of paddle_tpu/regularizer.py).

``L2Decay`` folds into the optimizer rules' ``weight_decay``; ``L1Decay``
is a gradient penalty, ``grad + coeff * sign(param)``, that the eager
``Optimizer.step`` adds for a parameter whose ``regularizer`` attribute is
an ``L1Decay`` (set it on the ``nn.Parameter``) or when it is the
optimizer's ``weight_decay``. As the JAX package does, the engine's step
applies no ``L1Decay``.
"""
from __future__ import annotations

import torch


class WeightDecayRegularizer:
    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)
        self._coeff = self.coeff  # the reference's attribute name

    def __repr__(self):
        return f"{type(self).__name__}(coeff={self.coeff})"


class L2Decay(WeightDecayRegularizer):
    """The optimizer reads ``_coeff`` and applies it as its rule's decay."""


class L1Decay(WeightDecayRegularizer):
    """L1 penalty: ``grad + coeff * sign(param)``."""

    _is_l1 = True

    def apply(self, param, grad):
        return grad + self.coeff * torch.sign(param)
