"""The rest of the reference's layers — the port of
``paddle_tpu/nn/layers_extra.py``: the 3-D pools, the 1-D and 3-D
adaptive pools, the unpools, ``Conv1DTranspose`` / ``Conv3DTranspose``,
``ChannelShuffle``, ``PixelUnshuffle``, ``ZeroPad2D``, ``Fold``,
``Softmax2D``, ``ThresholdedReLU``, ``PairwiseDistance``, ``CTCLoss``
and ``HSigmoidLoss``: each a call of its :mod:`.functional` counterpart
with the arguments it was made with, the parameters drawn in the
reference's order."""
from __future__ import annotations

import numpy as np
import torch

from . import functional as F
from . import initializer as I
from .layer import Layer
from .layers_conv import _make_weights, _pair

__all__ = ["MaxPool3D", "AvgPool3D", "AdaptiveAvgPool3D",
           "AdaptiveMaxPool1D", "AdaptiveMaxPool3D", "MaxUnPool1D",
           "MaxUnPool2D", "MaxUnPool3D", "Conv1DTranspose",
           "Conv3DTranspose", "ChannelShuffle", "PixelUnshuffle",
           "ZeroPad2D", "Fold", "Softmax2D", "ThresholdedReLU",
           "PairwiseDistance", "CTCLoss", "HSigmoidLoss"]


# ------------------------------------------------------------------- pooling
class MaxPool3D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 return_mask=False, data_format="NCDHW", name=None):
        super().__init__()
        self._args = (kernel_size, stride, padding, ceil_mode, return_mask)

    def forward(self, x):
        k, s, p, cm, rm = self._args
        return F.max_pool3d(x, k, s, p, ceil_mode=cm, return_mask=rm)


class AvgPool3D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCDHW",
                 name=None):
        super().__init__()
        self._args = (kernel_size, stride, padding, ceil_mode, exclusive)

    def forward(self, x):
        k, s, p, cm, ex = self._args
        return F.avg_pool3d(x, k, s, p, ceil_mode=cm, exclusive=ex)


class AdaptiveAvgPool3D(Layer):
    def __init__(self, output_size, data_format="NCDHW", name=None):
        super().__init__()
        self._output_size = output_size

    def forward(self, x):
        return F.adaptive_avg_pool3d(x, self._output_size)


class AdaptiveMaxPool1D(Layer):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self._output_size = output_size
        self._return_mask = return_mask

    def forward(self, x):
        return F.adaptive_max_pool1d(x, self._output_size,
                                     return_mask=self._return_mask)


class AdaptiveMaxPool3D(Layer):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self._output_size = output_size
        self._return_mask = return_mask

    def forward(self, x):
        return F.adaptive_max_pool3d(x, self._output_size,
                                     return_mask=self._return_mask)


class _MaxUnPoolNd(Layer):
    FN = None

    def __init__(self, kernel_size, stride=None, padding=0, data_format=None,
                 output_size=None, name=None):
        super().__init__()
        self._args = (kernel_size, stride, padding, output_size)

    def forward(self, x, indices):
        k, s, p, o = self._args
        return type(self).FN(x, indices, k, s, p, output_size=o)


class MaxUnPool1D(_MaxUnPoolNd):
    FN = staticmethod(F.max_unpool1d)


class MaxUnPool2D(_MaxUnPoolNd):
    FN = staticmethod(F.max_unpool2d)


class MaxUnPool3D(_MaxUnPoolNd):
    FN = staticmethod(F.max_unpool3d)


# ------------------------------------------------------------------- conv
class _ConvTransposeNd(Layer):
    ND = 1
    FN = staticmethod(F.conv1d_transpose)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format=None):
        super().__init__()
        nd = self.ND
        self._stride = _pair(stride, nd)
        self._padding = padding
        self._output_padding = output_padding
        self._dilation = _pair(dilation, nd)
        self._groups = groups
        k = _pair(kernel_size, nd)
        _make_weights(self, (in_channels, out_channels // groups, *k),
                      in_channels * int(np.prod(k)), weight_attr, bias_attr,
                      out_channels)

    def forward(self, x, output_size=None):
        return type(self).FN(
            x, self.weight, self.bias, self._stride, self._padding,
            self._output_padding, self._groups, self._dilation, output_size)


class Conv1DTranspose(_ConvTransposeNd):
    ND = 1
    FN = staticmethod(F.conv1d_transpose)


class Conv3DTranspose(_ConvTransposeNd):
    ND = 3
    FN = staticmethod(F.conv3d_transpose)


# ------------------------------------------------------------------- vision
class ChannelShuffle(Layer):
    def __init__(self, groups, data_format="NCHW", name=None):
        super().__init__()
        self._groups = groups
        self._data_format = data_format

    def forward(self, x):
        return F.channel_shuffle(x, self._groups, self._data_format)


class PixelUnshuffle(Layer):
    def __init__(self, downscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self._factor = downscale_factor
        self._data_format = data_format

    def forward(self, x):
        return F.pixel_unshuffle(x, self._factor, self._data_format)


class ZeroPad2D(Layer):
    def __init__(self, padding, data_format="NCHW", name=None):
        super().__init__()
        self._padding = padding
        self._data_format = data_format

    def forward(self, x):
        return F.zeropad2d(x, self._padding, self._data_format)


class Fold(Layer):
    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0,
                 dilations=1, name=None):
        super().__init__()
        self._args = (output_sizes, kernel_sizes, strides, paddings,
                      dilations)

    def forward(self, x):
        return F.fold(x, *self._args)


# ------------------------------------------------------------------- misc
class Softmax2D(Layer):
    """Softmax over the channel dimension of ``[N, C, H, W]``."""

    def forward(self, x):
        return F.softmax(x, axis=-3)


class ThresholdedReLU(Layer):
    def __init__(self, threshold=1.0, name=None):
        super().__init__()
        self._threshold = threshold

    def forward(self, x):
        return F.thresholded_relu(x, self._threshold)


class PairwiseDistance(Layer):
    """``(sum |x - y + epsilon| ** p) ** (1 / p)`` over the last
    dimension."""

    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self._p, self._eps, self._keepdim = p, epsilon, keepdim

    def forward(self, x, y):
        d = x - y + self._eps
        return torch.sum(torch.abs(d) ** self._p, dim=-1,
                         keepdim=self._keepdim) ** (1.0 / self._p)


# ------------------------------------------------------------------- losses
class CTCLoss(Layer):
    def __init__(self, blank=0, reduction="mean"):
        super().__init__()
        self._blank, self._reduction = blank, reduction

    def forward(self, log_probs, labels, input_lengths, label_lengths,
                norm_by_times=False):
        return F.ctc_loss(log_probs, labels, input_lengths, label_lengths,
                          blank=self._blank, reduction=self._reduction,
                          norm_by_times=norm_by_times)


class HSigmoidLoss(Layer):
    """Hierarchical sigmoid over the default tree: weight
    ``[num_classes - 1, feature_size]`` (``XavierUniform``), bias
    ``[num_classes - 1]`` (0). Custom trees are not supported, as in the
    reference."""

    def __init__(self, feature_size, num_classes, weight_attr=None,
                 bias_attr=None, is_custom=False, is_sparse=False,
                 name=None):
        super().__init__()
        if is_custom:
            raise NotImplementedError("custom trees not supported yet")
        self._num_classes = num_classes
        self.weight = self.create_parameter(
            (num_classes - 1, feature_size), attr=weight_attr,
            default_initializer=I.XavierUniform())
        self.bias = None if bias_attr is False else self.create_parameter(
            (num_classes - 1,), attr=bias_attr, is_bias=True)

    def forward(self, input, label):  # noqa: A002
        return F.hsigmoid_loss(input, label, self._num_classes, self.weight,
                               self.bias)
