"""Layers of the port (counterpart of paddle_tpu/nn/layers/)."""
from .activation import (CELU, ELU, GELU, GLU, SELU, Hardshrink, Hardsigmoid,  # noqa: F401
                         Hardswish, Hardtanh, LeakyReLU, LogSigmoid, LogSoftmax, Maxout,
                         Mish, PReLU, ReLU, ReLU6, RReLU, Sigmoid, SiLU, Silu, Softmax,
                         Softmax2D, Softplus, Softshrink, Softsign, Swish, Tanh,
                         Tanhshrink, ThresholdedReLU)
from .common import Dropout, Embedding, Flatten, Identity, Linear  # noqa: F401
from .container import LayerDict, LayerList, ParameterList, Sequential  # noqa: F401
from .conv_pool import (AdaptiveAvgPool1D, AdaptiveAvgPool2D, AdaptiveAvgPool3D,  # noqa: F401
                        AdaptiveMaxPool1D, AdaptiveMaxPool2D, AdaptiveMaxPool3D,
                        AvgPool1D, AvgPool2D, AvgPool3D, Conv1D, Conv2D, Conv3D,
                        MaxPool1D, MaxPool2D, MaxPool3D)
from .loss import (BCELoss, BCEWithLogitsLoss, CrossEntropyLoss, KLDivLoss, L1Loss,  # noqa: F401
                   MSELoss, NLLLoss, SmoothL1Loss)
from .norm import (BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D, LayerNorm,  # noqa: F401
                   SyncBatchNorm)

__all__ = ["AdaptiveAvgPool1D", "AdaptiveAvgPool2D", "AdaptiveAvgPool3D",
           "AdaptiveMaxPool1D", "AdaptiveMaxPool2D", "AdaptiveMaxPool3D", "AvgPool1D",
           "AvgPool2D", "AvgPool3D", "BCELoss", "BCEWithLogitsLoss", "BatchNorm",
           "BatchNorm1D", "BatchNorm2D", "BatchNorm3D", "CELU", "Conv1D", "Conv2D",
           "Conv3D", "CrossEntropyLoss", "Dropout", "ELU", "Embedding", "Flatten",
           "GELU", "GLU", "Hardshrink", "Hardsigmoid", "Hardswish", "Hardtanh",
           "Identity", "KLDivLoss", "L1Loss", "LayerDict", "LayerList", "LayerNorm",
           "LeakyReLU", "Linear", "LogSigmoid", "LogSoftmax", "MSELoss", "MaxPool1D",
           "MaxPool2D", "MaxPool3D", "Maxout", "Mish", "NLLLoss", "PReLU",
           "ParameterList", "RReLU", "ReLU", "ReLU6", "SELU", "Sequential", "SiLU",
           "Sigmoid", "Silu", "SmoothL1Loss", "Softmax", "Softmax2D", "Softplus",
           "Softshrink", "Softsign", "Swish", "SyncBatchNorm", "Tanh", "Tanhshrink",
           "ThresholdedReLU"]
