"""Tensor attribute ops (counterpart of paddle_tpu/ops/attribute.py).

``shape`` and ``rank`` return int32 tensors on the input's device, as the
reference does.
"""
from __future__ import annotations

import numpy as np
import torch

from ._helpers import public, t_


def is_tensor(x):
    return torch.is_tensor(x)


def rank(input, name=None):
    x = t_(input)
    return torch.tensor(x.dim(), dtype=torch.int32, device=x.device)


def shape(input, name=None):
    x = t_(input)
    return torch.tensor(list(x.shape), dtype=torch.int32, device=x.device)


def is_empty(x, name=None):
    x = t_(x)
    return torch.tensor(x.numel() == 0, device=x.device)


def is_complex(x):
    return t_(x).is_complex()


def is_integer(x):
    x = t_(x)
    return not (x.is_floating_point() or x.is_complex() or x.dtype == torch.bool)


def is_floating_point(x):
    return t_(x).is_floating_point()


def check_shape(shape):
    """Validate a shape argument (reference: fluid/layers/utils.py:373)."""
    if torch.is_tensor(shape):
        return
    for ele in shape:
        if not torch.is_tensor(ele):
            if ele < 0:
                raise ValueError(
                    "All elements in shape must be positive when argument shape is a list or tuple")
            if not isinstance(ele, (int, np.integer)):
                raise TypeError("Elements in shape must be integers or Tensors")


__all__ = public(globals())
