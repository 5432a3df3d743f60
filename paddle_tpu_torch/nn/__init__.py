"""nn of the port (counterpart of paddle_tpu/nn/): ``Layer``,
``Parameter``, ``ParamAttr``, the layers of ``nn/layers/`` under their
Paddle names (their ops are ops/nn_functional.py's and
ops/activation.py's), the submodules ``functional``, ``initializer`` and
``utils``, and gradient clipping. The RNN layers and the beam-search
decoder of the JAX package's ``nn/layers/rnn.py`` and ``decode.py`` (but
``gather_tree``) are ROADMAP Queue 1 item 17."""
from . import functional, initializer, utils  # noqa: F401
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue, clip_grad_norm_
from .layer import Layer, ParamAttr, Parameter, create_parameter  # noqa: F401
from .layers import *  # noqa: F401,F403
from .layers import __all__ as _layers

__all__ = ["ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue", "clip_grad_norm_",
           "Layer", "ParamAttr", "Parameter", "create_parameter", "functional",
           "initializer", "utils", *_layers]
