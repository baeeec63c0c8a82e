"""``paddle.nn`` of the port — the counterpart of ``paddle_tpu/nn``:
``Layer`` (a ``torch.nn.Module`` with Paddle's surface), ``ParamAttr``,
``Parameter``, the initializers, the containers, the common, activation,
normalisation, loss and Transformer layers, ``nn.functional`` and
``nn.utils``; the gradient clips are re-exported from
``utils.clip_grad``, as the reference's root does. ``LayerMixin`` gives
a plain ``torch.nn.Module`` (the GPT's) Paddle's ``set_state_dict``.

Conv, pooling, RNN, decode and the reference's ``layers_extra`` are
ROADMAP Queue 1 item 12b-2."""
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
from . import (container, layer, layers_activation, layers_common,  # noqa: F401
               layers_norm, loss, transformer)
from ..utils.clip_grad import (ClipGradByGlobalNorm, ClipGradByNorm,
                               ClipGradByValue)

__all__ = [
    "functional", "initializer", "utils", "container", "layer",
    "layers_activation", "layers_common", "layers_norm", "loss",
    "transformer",
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
    "ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
]
