"""nn of the port (counterpart of paddle_tpu/nn/): ``Layer``,
``Parameter``, ``ParamAttr``, the layers of ``nn/layers/`` under their
Paddle names (their ops are ops/nn_functional.py's and
ops/activation.py's), the submodules ``functional``, ``initializer`` and
``utils``, and gradient clipping; among the layers, the recurrent cells,
``RNN`` / ``BiRNN`` and the ``SimpleRNN`` / ``LSTM`` / ``GRU`` stacks
(``nn/layers/rnn.py``) and beam-search decoding (``BeamSearchDecoder``,
``Decoder``, ``dynamic_decode``, ``gather_tree``; ``nn/layers/decode.py``)."""
from . import functional, initializer, utils  # noqa: F401
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue, clip_grad_norm_
from .layer import Layer, ParamAttr, Parameter, create_parameter  # noqa: F401
from .layers import *  # noqa: F401,F403
from .layers import __all__ as _layers

__all__ = ["ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue", "clip_grad_norm_",
           "Layer", "ParamAttr", "Parameter", "create_parameter", "functional",
           "initializer", "utils", *_layers]
