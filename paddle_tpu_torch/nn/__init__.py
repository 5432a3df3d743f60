"""nn of the port (counterpart of paddle_tpu/nn/): gradient clipping and the
layers of ``nn/layers/`` under their Paddle names (their ops are
ops/nn_functional.py's and ops/activation.py's). ``Layer`` is
``torch.nn.Module``."""
from torch.nn import Module as Layer

from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue, clip_grad_norm_
from .layers import *  # noqa: F401,F403
from .layers import __all__ as _layers

__all__ = ["ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue", "clip_grad_norm_",
           "Layer", *_layers]
