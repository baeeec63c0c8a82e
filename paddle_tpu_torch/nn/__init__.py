"""``paddle.nn`` of the port — the counterpart of ``paddle_tpu/nn``:
``Layer`` (a ``torch.nn.Module`` with Paddle's surface), ``ParamAttr``,
``Parameter``, the initializers, the containers, the common, activation,
normalisation, loss and Transformer layers, the convolution, pooling,
recurrent and decoding layers and the reference's ``layers_extra``,
``nn.functional`` and ``nn.utils``; the gradient clips are re-exported
from ``utils.clip_grad``, as the reference's root does. ``LayerMixin``
gives a plain ``torch.nn.Module`` (the GPT's) Paddle's
``set_state_dict``."""
from . import functional  # noqa: F401
from . import initializer  # noqa: F401
from . import utils  # noqa: F401
from .layer import Layer, LayerMixin, ParamAttr, Parameter
from .container import LayerDict, LayerList, ParameterList, Sequential
from .layers_common import (AlphaDropout, Bilinear, CosineSimilarity,
                            Dropout, Dropout2D, Dropout3D, Embedding,
                            Flatten, Identity, Linear, Pad1D, Pad2D, Pad3D,
                            PixelShuffle, Unfold, Upsample,
                            UpsamplingBilinear2D, UpsamplingNearest2D)
from .layers_norm import (BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D,
                          GroupNorm, InstanceNorm1D, InstanceNorm2D,
                          InstanceNorm3D, LayerNorm, LocalResponseNorm,
                          SpectralNorm, SyncBatchNorm)
from .layers_activation import (CELU, ELU, GELU, GLU, Hardshrink,
                                Hardsigmoid, Hardswish, Hardtanh, LeakyReLU,
                                LogSigmoid, LogSoftmax, Maxout, Mish, PReLU,
                                ReLU, ReLU6, SELU, Sigmoid, Silu, Softmax,
                                Softplus, Softshrink, Softsign, Swish, Tanh,
                                Tanhshrink)
from .transformer import (MultiHeadAttention, Transformer,
                          TransformerDecoder, TransformerDecoderLayer,
                          TransformerEncoder, TransformerEncoderLayer)
from .loss import (BCELoss, BCEWithLogitsLoss, CrossEntropyLoss,
                   HingeEmbeddingLoss, KLDivLoss, L1Loss, MarginRankingLoss,
                   MSELoss, NLLLoss, SmoothL1Loss)
from .layers_conv import Conv1D, Conv2D, Conv2DTranspose, Conv3D
from .layers_pooling import (AdaptiveAvgPool1D, AdaptiveAvgPool2D,
                             AdaptiveMaxPool2D, AvgPool1D, AvgPool2D,
                             MaxPool1D, MaxPool2D)
from .rnn import (GRU, GRUCell, LSTM, LSTMCell, RNN, BiRNN, RNNCellBase,
                  SimpleRNN, SimpleRNNCell)
from .decode import BeamSearchDecoder, Decoder, dynamic_decode
from .layers_extra import (AdaptiveAvgPool3D, AdaptiveMaxPool1D,
                           AdaptiveMaxPool3D, AvgPool3D, ChannelShuffle,
                           Conv1DTranspose, Conv3DTranspose, CTCLoss, Fold,
                           HSigmoidLoss, MaxPool3D, MaxUnPool1D, MaxUnPool2D,
                           MaxUnPool3D, PairwiseDistance, PixelUnshuffle,
                           Softmax2D, ThresholdedReLU, ZeroPad2D)
from . import (container, decode, layer, layers_activation,  # noqa: F401
               layers_common, layers_conv, layers_extra, layers_norm,
               layers_pooling, loss, rnn, transformer)
from ..utils.clip_grad import (ClipGradByGlobalNorm, ClipGradByNorm,
                               ClipGradByValue)

__all__ = [
    "functional", "initializer", "utils", "container", "decode", "layer",
    "layers_activation", "layers_common", "layers_conv", "layers_extra",
    "layers_norm", "layers_pooling", "loss", "rnn", "transformer",
    "Layer", "LayerMixin", "ParamAttr", "Parameter",
    "LayerDict", "LayerList", "ParameterList", "Sequential",
    "AlphaDropout", "Bilinear", "CosineSimilarity", "Dropout", "Dropout2D",
    "Dropout3D", "Embedding", "Flatten", "Identity", "Linear", "Pad1D",
    "Pad2D", "Pad3D", "PixelShuffle", "Unfold", "Upsample",
    "UpsamplingBilinear2D", "UpsamplingNearest2D",
    "BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D", "GroupNorm",
    "InstanceNorm1D", "InstanceNorm2D", "InstanceNorm3D", "LayerNorm",
    "LocalResponseNorm", "SpectralNorm", "SyncBatchNorm",
    "CELU", "ELU", "GELU", "GLU", "Hardshrink", "Hardsigmoid", "Hardswish",
    "Hardtanh", "LeakyReLU", "LogSigmoid", "LogSoftmax", "Maxout", "Mish",
    "PReLU", "ReLU", "ReLU6", "SELU", "Sigmoid", "Silu", "Softmax",
    "Softplus", "Softshrink", "Softsign", "Swish", "Tanh", "Tanhshrink",
    "MultiHeadAttention", "Transformer", "TransformerDecoder",
    "TransformerDecoderLayer", "TransformerEncoder",
    "TransformerEncoderLayer",
    "BCELoss", "BCEWithLogitsLoss", "CrossEntropyLoss", "HingeEmbeddingLoss",
    "KLDivLoss", "L1Loss", "MarginRankingLoss", "MSELoss", "NLLLoss",
    "SmoothL1Loss",
    "Conv1D", "Conv2D", "Conv2DTranspose", "Conv3D",
    "AdaptiveAvgPool1D", "AdaptiveAvgPool2D", "AdaptiveMaxPool2D",
    "AvgPool1D", "AvgPool2D", "MaxPool1D", "MaxPool2D",
    "GRU", "GRUCell", "LSTM", "LSTMCell", "RNN", "BiRNN", "RNNCellBase",
    "SimpleRNN", "SimpleRNNCell",
    "BeamSearchDecoder", "Decoder", "dynamic_decode",
    "AdaptiveAvgPool3D", "AdaptiveMaxPool1D", "AdaptiveMaxPool3D",
    "AvgPool3D", "ChannelShuffle", "Conv1DTranspose", "Conv3DTranspose",
    "CTCLoss", "Fold", "HSigmoidLoss", "MaxPool3D", "MaxUnPool1D",
    "MaxUnPool2D", "MaxUnPool3D", "PairwiseDistance", "PixelUnshuffle",
    "Softmax2D", "ThresholdedReLU", "ZeroPad2D",
    "ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
]
