"""Convolution layers — the port of ``paddle_tpu/nn/layers_conv.py``:
``Conv1D``, ``Conv2D``, ``Conv3D`` (weight ``[out, in / groups, *k]``)
and ``Conv2DTranspose`` (weight ``[in, out / groups, *k]``). The weight
is drawn by ``KaimingUniform(fan_in, negative_slope=sqrt(5),
"leaky_relu")`` and the bias by ``Uniform(-1 / sqrt(fan_in), 1 /
sqrt(fan_in))``, in that order, as the reference draws them;
``bias_attr=False`` leaves the bias out. The forwards are
:mod:`.functional`'s convolutions (cuDNN on the card, a float32 one
without TF32)."""
from __future__ import annotations

import numpy as np

from . import functional as F
from . import initializer as I
from .layer import Layer

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv2DTranspose"]


def _pair(v, n=2):
    return tuple(v) if isinstance(v, (list, tuple)) else (v,) * n


def _make_weights(layer, shape, fan_in, weight_attr, bias_attr, out):
    layer.weight = layer.create_parameter(
        shape, attr=weight_attr,
        default_initializer=I.KaimingUniform(
            fan_in=fan_in, negative_slope=np.sqrt(5.0),
            nonlinearity="leaky_relu"))
    bound = 1.0 / np.sqrt(fan_in)
    layer.bias = None if bias_attr is False else layer.create_parameter(
        (out,), attr=bias_attr, is_bias=True,
        default_initializer=I.Uniform(-bound, bound))


class _ConvNd(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, nd, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__()
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = _pair(kernel_size, nd)
        self._stride = _pair(stride, nd)
        self._padding = padding
        self._dilation = _pair(dilation, nd)
        self._groups = groups
        self._data_format = data_format
        fan_in = in_channels * int(np.prod(self._kernel_size)) // groups
        _make_weights(self, (out_channels, in_channels // groups,
                             *self._kernel_size), fan_in, weight_attr,
                      bias_attr, out_channels)

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={list(self._kernel_size)}, "
                f"stride={list(self._stride)}")

    def _conv(self, fn, x):
        return fn(x, self.weight, self.bias, self._stride, self._padding,
                  self._dilation, self._groups, self._data_format)


class Conv1D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL"):
        super().__init__(in_channels, out_channels, kernel_size, 1, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format)

    def forward(self, x):
        return self._conv(F.conv1d, x)


class Conv2D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__(in_channels, out_channels, kernel_size, 2, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format)

    def forward(self, x):
        return self._conv(F.conv2d, x)


class Conv3D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW"):
        super().__init__(in_channels, out_channels, kernel_size, 3, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format)

    def forward(self, x):
        return self._conv(F.conv3d, x)


class Conv2DTranspose(Layer):
    """Transposed 2-D convolution; ``forward(x, output_size=None)``. The
    fan-in of its initializers is ``in_channels * kh * kw``, as the
    reference's."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__()
        self._stride = _pair(stride)
        self._padding = padding
        self._output_padding = output_padding
        self._dilation = _pair(dilation)
        self._groups = groups
        self._data_format = data_format
        k = _pair(kernel_size)
        _make_weights(self, (in_channels, out_channels // groups, *k),
                      in_channels * int(np.prod(k)), weight_attr, bias_attr,
                      out_channels)

    def forward(self, x, output_size=None):
        return F.conv2d_transpose(x, self.weight, self.bias, self._stride,
                                  self._padding, self._output_padding,
                                  self._dilation, self._groups, output_size,
                                  self._data_format)
