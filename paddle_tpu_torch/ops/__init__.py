"""Tensor functions of the port (counterpart of paddle_tpu/ops/): the op
namespace that ``paddle_tpu_torch`` exports at its top level.

The reference also attaches every op to its ``Tensor`` class as a method
or dunder (``ops/__init__.py`` ``_attach_methods``). The port's tensors are
``torch.Tensor``, and patching torch's class would change torch for every
module of the process, the port's own included, so nothing is attached:
``paddle_tpu_torch.reshape(x, shape)`` and the other functions are the API.
"""
from __future__ import annotations

from . import (attribute as _attribute, creation as _creation, linalg as _linalg,
               manipulation as _manip, math as _math, reduction as _reduction)
from .creation import *  # noqa: F401,F403
from .math import *  # noqa: F401,F403
from .reduction import *  # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .linalg import *  # noqa: F401,F403
from .attribute import *  # noqa: F401,F403
from .activation import (  # noqa: F401
    celu, elu, gelu, glu, gumbel_softmax, hardshrink, hardsigmoid, hardswish,
    hardtanh, leaky_relu, log_sigmoid, log_softmax, maxout, mish, prelu, relu,
    relu6, rrelu, selu, silu, softmax, softplus, softshrink, softsign, swiglu,
    swish, tanhshrink, thresholded_relu,
)
from . import nn_functional as F  # noqa: F401,E402

ACTIVATIONS = ("celu", "elu", "gelu", "glu", "gumbel_softmax", "hardshrink", "hardsigmoid",
               "hardswish", "hardtanh", "leaky_relu", "log_sigmoid", "log_softmax", "maxout",
               "mish", "prelu", "relu", "relu6", "rrelu", "selu", "silu", "softmax",
               "softplus", "softshrink", "softsign", "swiglu", "swish", "tanhshrink",
               "thresholded_relu")

__all__ = sorted({*_creation.__all__, *_math.__all__, *_reduction.__all__,
                  *_manip.__all__, *_linalg.__all__, *_attribute.__all__, *ACTIVATIONS})
