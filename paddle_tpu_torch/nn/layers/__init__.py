"""Layers of the port (counterpart of paddle_tpu/nn/layers/)."""
from .activation import (CELU, ELU, GELU, GLU, SELU, Hardshrink, Hardsigmoid,  # noqa: F401
                         Hardswish, Hardtanh, LeakyReLU, LogSigmoid, LogSoftmax, Maxout,
                         Mish, PReLU, ReLU, ReLU6, RReLU, Sigmoid, SiLU, Silu, Softmax,
                         Softmax2D, Softplus, Softshrink, Softsign, Swish, Tanh,
                         Tanhshrink, ThresholdedReLU)
from .common import (AlphaDropout, Bilinear, CosineSimilarity, Dropout, Dropout2D,  # noqa: F401
                     Dropout3D, Embedding, Flatten, Fold, Identity, Linear, Pad1D, Pad2D,
                     Pad3D, PairwiseDistance, PixelShuffle, SpectralNorm, Unfold, Upsample,
                     UpsamplingBilinear2D, UpsamplingNearest2D, ZeroPad2D)
from .container import LayerDict, LayerList, ParameterList, Sequential  # noqa: F401
from .conv_pool import (AdaptiveAvgPool1D, AdaptiveAvgPool2D, AdaptiveAvgPool3D,  # noqa: F401
                        AdaptiveMaxPool1D, AdaptiveMaxPool2D, AdaptiveMaxPool3D,
                        AvgPool1D, AvgPool2D, AvgPool3D, Conv1D, Conv1DTranspose, Conv2D,
                        Conv2DTranspose, Conv3D, Conv3DTranspose, MaxPool1D, MaxPool2D,
                        MaxPool3D, MaxUnPool1D, MaxUnPool2D, MaxUnPool3D)
from .decode import BeamSearchDecoder, Decoder, dynamic_decode, gather_tree  # noqa: F401
from .loss import (BCELoss, BCEWithLogitsLoss, CosineEmbeddingLoss,  # noqa: F401
                   CrossEntropyLoss, CTCLoss, HingeEmbeddingLoss, HSigmoidLoss, KLDivLoss,
                   L1Loss, MarginRankingLoss, MSELoss, NLLLoss, SmoothL1Loss)
from .norm import (BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D, GroupNorm,  # noqa: F401
                   InstanceNorm1D, InstanceNorm2D, InstanceNorm3D, LayerNorm,
                   LocalResponseNorm, RMSNorm, SyncBatchNorm)
from .rnn import (GRU, LSTM, RNN, BiRNN, GRUCell, LSTMCell, RNNCellBase,  # noqa: F401
                  SimpleRNN, SimpleRNNCell)
from .transformer import (MultiHeadAttention, Transformer, TransformerDecoder,  # noqa: F401
                          TransformerDecoderLayer, TransformerEncoder,
                          TransformerEncoderLayer)

__all__ = sorted(n for n in dir() if n[0].isupper() or n in ("dynamic_decode", "gather_tree"))
