"""Pooling layers — the port of ``paddle_tpu/nn/layers_pooling.py``:
the 1-D and 2-D max and average pools and the 1-D / 2-D adaptive ones,
each a call of its :mod:`.functional` counterpart with the arguments it
was made with. As in the reference, ``return_mask`` is accepted and not
passed on."""
from __future__ import annotations

from . import functional as F
from .layer import Layer

__all__ = ["MaxPool1D", "MaxPool2D", "AvgPool1D", "AvgPool2D",
           "AdaptiveAvgPool1D", "AdaptiveAvgPool2D", "AdaptiveMaxPool2D"]


class MaxPool1D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, name=None):
        super().__init__()
        self.k, self.s, self.p = kernel_size, stride, padding
        self.ceil_mode = ceil_mode

    def forward(self, x):
        return F.max_pool1d(x, self.k, self.s, self.p,
                            ceil_mode=self.ceil_mode)


class MaxPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, data_format="NCHW", name=None):
        super().__init__()
        self.k, self.s, self.p, self.df = kernel_size, stride, padding, \
            data_format
        self.ceil_mode = ceil_mode

    def forward(self, x):
        return F.max_pool2d(x, self.k, self.s, self.p,
                            ceil_mode=self.ceil_mode, data_format=self.df)


class AvgPool1D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, exclusive=True,
                 ceil_mode=False, name=None):
        super().__init__()
        self.k, self.s, self.p = kernel_size, stride, padding
        self.ceil_mode = ceil_mode
        self.exclusive = exclusive

    def forward(self, x):
        return F.avg_pool1d(x, self.k, self.s, self.p,
                            ceil_mode=self.ceil_mode,
                            exclusive=self.exclusive)


class AvgPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self.k, self.s, self.p, self.df = kernel_size, stride, padding, \
            data_format
        self.ceil_mode = ceil_mode
        self.exclusive = exclusive

    def forward(self, x):
        return F.avg_pool2d(x, self.k, self.s, self.p,
                            ceil_mode=self.ceil_mode,
                            exclusive=self.exclusive, data_format=self.df)


class AdaptiveAvgPool1D(Layer):
    def __init__(self, output_size, name=None):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return F.adaptive_avg_pool1d(x, self.output_size)


class AdaptiveAvgPool2D(Layer):
    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__()
        self.output_size = output_size
        self.df = data_format

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self.output_size, self.df)


class AdaptiveMaxPool2D(Layer):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return F.adaptive_max_pool2d(x, self.output_size)
