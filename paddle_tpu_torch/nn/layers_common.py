"""Common layers — the port of ``paddle_tpu/nn/layers_common.py``:
``Linear`` (weight ``[in, out]``, ``XavierNormal``; bias 0),
``Embedding`` (``Normal(0, 1)``, the ``padding_idx`` row zeroed), the
dropouts, ``Identity``, ``Flatten``, ``Bilinear``, ``CosineSimilarity``,
the pads, ``PixelShuffle``, ``Unfold`` and the upsamplers. Each is a
:class:`.layer.Layer` whose parameters are made, in the reference's
order, by the initializers of :mod:`.initializer`."""
from __future__ import annotations

import torch

from . import functional as F
from . import initializer as I
from .layer import Layer

__all__ = ["Identity", "Linear", "Dropout", "Dropout2D", "Dropout3D",
           "AlphaDropout", "Flatten", "Embedding", "Pad1D", "Pad2D",
           "Pad3D", "Upsample", "UpsamplingBilinear2D",
           "UpsamplingNearest2D", "PixelShuffle", "Unfold", "Bilinear",
           "CosineSimilarity"]


class Identity(Layer):
    def forward(self, x):
        return x


class Linear(Layer):
    """``y = x @ weight + bias`` with ``weight [in_features,
    out_features]``; ``bias_attr=False`` leaves the bias out."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = self.create_parameter(
            (in_features, out_features), attr=weight_attr,
            default_initializer=I.XavierNormal())
        self.bias = None if bias_attr is False else self.create_parameter(
            (out_features,), attr=bias_attr, is_bias=True,
            default_initializer=I.Constant(0.0))

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return f"in_features={self.in_features}, " \
               f"out_features={self.out_features}"


class Dropout(Layer):
    """Dropout with probability ``p``, the mask broadcast over every
    dimension not in ``axis`` (None: no broadcast), ``mode``
    ``upscale_in_train`` or ``downscale_in_infer``: draws from the key
    schedule in training, the identity in eval mode."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, x):
        return F.dropout(x, self.p, axis=self.axis, training=self.training,
                         mode=self.mode)

    def extra_repr(self):
        return f"p={self.p}"


class Dropout2D(Layer):
    def __init__(self, p=0.5, data_format="NCHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return F.dropout2d(x, self.p, training=self.training,
                           data_format=self.data_format)


class Dropout3D(Layer):
    def __init__(self, p=0.5, data_format="NCDHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return F.dropout3d(x, self.p, training=self.training,
                           data_format=self.data_format)


class AlphaDropout(Layer):
    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.alpha_dropout(x, self.p, training=self.training)


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, x):
        return torch.flatten(x, self.start_axis, self.stop_axis)


class Embedding(Layer):
    """A ``[num_embeddings, embedding_dim]`` table, ``Normal(0, 1)``; the
    ``padding_idx`` row starts at 0, reads as 0 and takes no gradient."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None):
        super().__init__()
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self._padding_idx = padding_idx
        self._sparse = sparse
        self.weight = self.create_parameter(
            (num_embeddings, embedding_dim), attr=weight_attr,
            default_initializer=I.Normal(0.0, 1.0))
        if padding_idx is not None and not self.weight.is_meta:
            with torch.no_grad():
                self.weight[padding_idx] = 0.0

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self._padding_idx,
                           sparse=self._sparse)

    def extra_repr(self):
        return f"{self._num_embeddings}, {self._embedding_dim}"


class _Pad(Layer):
    _width = 2
    _format = "NCL"

    def __init__(self, padding, mode="constant", value=0.0,
                 data_format=None, name=None):
        super().__init__()
        p = padding if isinstance(padding, (list, tuple)) \
            else [padding] * self._width
        self.padding = list(p)
        self.mode, self.value = mode, value
        self.data_format = data_format or self._format

    def forward(self, x):
        return F.pad(x, self.padding, self.mode, self.value,
                     self.data_format)


class Pad1D(_Pad):
    _width, _format = 2, "NCL"


class Pad2D(_Pad):
    _width, _format = 4, "NCHW"


class Pad3D(_Pad):
    _width, _format = 6, "NCDHW"


class Upsample(Layer):
    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, align_mode=0, data_format="NCHW",
                 name=None):
        super().__init__()
        self.size, self.scale_factor = size, scale_factor
        self.mode, self.align_corners = mode, align_corners
        self.align_mode, self.data_format = align_mode, data_format

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, self.mode,
                             self.align_corners, self.align_mode,
                             self.data_format)


class UpsamplingBilinear2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "bilinear", True, 0,
                         data_format)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "nearest", False, 0,
                         data_format)


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.upscale_factor = upscale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.pixel_shuffle(x, self.upscale_factor, self.data_format)


class Unfold(Layer):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None):
        super().__init__()
        self.kernel_sizes, self.strides = kernel_sizes, strides
        self.paddings, self.dilations = paddings, dilations

    def forward(self, x):
        return F.unfold(x, self.kernel_sizes, self.strides, self.paddings,
                        self.dilations)


class Bilinear(Layer):
    """``out[n, o] = x1[n] · weight[o] · x2[n] + bias[o]``: weight
    ``[out, in1, in2]`` (``XavierNormal`` with fans ``in1``, ``out``),
    bias ``[1, out]``."""

    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None):
        super().__init__()
        self.weight = self.create_parameter(
            (out_features, in1_features, in2_features), attr=weight_attr,
            default_initializer=I.XavierNormal(fan_in=in1_features,
                                               fan_out=out_features))
        self.bias = None if bias_attr is False else self.create_parameter(
            (1, out_features), attr=bias_attr, is_bias=True)

    def forward(self, x1, x2):
        return F.bilinear(x1, x2, self.weight, self.bias)


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis, self.eps = axis, eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, self.axis, self.eps)
