"""Normalisation layers — the port of ``paddle_tpu/nn/layers_norm.py``.

``LayerNorm``'s parameters are named ``weight`` and ``bias``, as the
reference's are, so the GPT's parameter names (``gpt.blocks.{i}.ln1.
weight`` ...) and the weights bridge (``text/convert.py``) stay as they
were; its forward is :func:`.functional.layer_norm`, the hand-written
LayerNorm kernels on CUDA tensors and their plain versions on CPU
tensors. It also takes torch's ``device`` and ``dtype`` (the GPT's
modules pass them).

The BatchNorms keep the reference's buffers ``_mean`` and ``_variance``
and its momentum rule, ``running = momentum * running + (1 - momentum)
* batch`` with ``momentum=0.9`` — the opposite of torch's convention.
``SyncBatchNorm`` is ``BatchNorm`` in one process, as in the reference.
"""
from __future__ import annotations

import torch

from ..core.dtype import get_default_dtype, to_torch_dtype
from .._device import resolve_device
from . import functional as F
from . import initializer as I
from .layer import Layer, placed

__all__ = ["BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
           "SyncBatchNorm", "LayerNorm", "GroupNorm", "InstanceNorm1D",
           "InstanceNorm2D", "InstanceNorm3D", "LocalResponseNorm",
           "SpectralNorm"]


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        if weight_attr is False:
            self.weight = None
            self.bias = None
        else:
            self.weight = self.create_parameter(
                (num_features,), attr=weight_attr,
                default_initializer=I.Constant(1.0))
            self.bias = self.create_parameter(
                (num_features,), attr=bias_attr, is_bias=True,
                default_initializer=I.Constant(0.0))
        kw = dict(dtype=to_torch_dtype(get_default_dtype()),
                  device=resolve_device(None))
        self.register_buffer("_mean", torch.zeros((num_features,), **kw))
        self.register_buffer("_variance", torch.ones((num_features,), **kw))

    def forward(self, x):
        return F.batch_norm(
            x, self._mean, self._variance, self.weight, self.bias,
            training=self.training, momentum=self._momentum,
            epsilon=self._epsilon, data_format=self._data_format,
            use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return f"num_features={self._num_features}, " \
               f"momentum={self._momentum}"


class BatchNorm(_BatchNormBase):
    """The fluid ``BatchNorm`` (channels first), ``act="relu"`` applied
    after."""

    def __init__(self, num_channels, act=None, momentum=0.9, epsilon=1e-05,
                 **kw):
        super().__init__(num_channels, momentum, epsilon)
        self._act = act

    def forward(self, x):
        out = super().forward(x)
        return F.relu(out) if self._act == "relu" else out


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    pass


class SyncBatchNorm(_BatchNormBase):
    """``BatchNorm`` whose statistics would be summed across data-parallel
    ranks; in one process it is ``BatchNorm`` (the reference's too)."""

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        return layer


class LayerNorm(Layer):
    """LayerNorm over the trailing ``normalized_shape`` with a scale
    (``weight``, 1 unless ``weight_attr`` says otherwise; ``False``
    leaves it out) and a shift (``bias``, 0; ``bias_attr``). ``device``
    and ``dtype`` place and type the parameters (default: ``set_device``'s
    place and the default dtype)."""

    def __init__(self, normalized_shape, epsilon=1e-05, weight_attr=None,
                 bias_attr=None, name=None, device=None, dtype=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self._normalized_shape = tuple(normalized_shape)
        self._epsilon = float(epsilon)
        with placed(device):
            self.weight = None if weight_attr is False else \
                self.create_parameter(self._normalized_shape,
                                      attr=weight_attr, dtype=dtype,
                                      default_initializer=I.Constant(1.0))
            self.bias = None if bias_attr is False else \
                self.create_parameter(self._normalized_shape,
                                      attr=bias_attr, dtype=dtype,
                                      is_bias=True,
                                      default_initializer=I.Constant(0.0))

    @property
    def normalized_shape(self):
        return self._normalized_shape

    @property
    def epsilon(self):
        return self._epsilon

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight,
                            self.bias, self._epsilon)

    def extra_repr(self):
        return f"normalized_shape={list(self._normalized_shape)}, " \
               f"epsilon={self._epsilon}"


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self._num_groups = num_groups
        self._epsilon = epsilon
        self._data_format = data_format
        self.weight = None if weight_attr is False else \
            self.create_parameter((num_channels,), attr=weight_attr,
                                  default_initializer=I.Constant(1.0))
        self.bias = None if bias_attr is False else self.create_parameter(
            (num_channels,), attr=bias_attr, is_bias=True,
            default_initializer=I.Constant(0.0))

    def forward(self, x):
        return F.group_norm(x, self._num_groups, self._epsilon, self.weight,
                            self.bias, self._data_format)


class InstanceNorm2D(Layer):
    """Per-sample, per-channel statistics; parameters ``scale`` and
    ``bias`` (the reference's names)."""

    def __init__(self, num_features, epsilon=1e-05, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self._epsilon = epsilon
        if weight_attr is False:
            self.scale = None
            self.bias = None
        else:
            self.scale = self.create_parameter(
                (num_features,), attr=weight_attr,
                default_initializer=I.Constant(1.0))
            self.bias = self.create_parameter(
                (num_features,), attr=bias_attr, is_bias=True,
                default_initializer=I.Constant(0.0))

    def forward(self, x):
        return F.instance_norm(x, weight=self.scale, bias=self.bias,
                               eps=self._epsilon)


InstanceNorm1D = InstanceNorm2D
InstanceNorm3D = InstanceNorm2D


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.size, self.alpha, self.beta, self.k = size, alpha, beta, k

    def forward(self, x):
        return F.local_response_norm(x, self.size, self.alpha, self.beta,
                                     self.k)


class SpectralNorm(Layer):
    """``weight / sigma``, ``sigma`` the largest singular value of the
    weight seen as ``[shape[axis], -1]``, estimated by ``power_iters``
    rounds of power iteration from a vector of ones."""

    def __init__(self, weight_shape, axis=0, power_iters=1, epsilon=1e-12,
                 name=None):
        super().__init__()
        self.axis, self.power_iters, self.epsilon = axis, power_iters, \
            epsilon

    def forward(self, weight):
        mat = torch.movedim(weight, self.axis, 0).reshape(
            weight.shape[self.axis], -1)
        u = torch.ones((mat.shape[0],), dtype=mat.dtype, device=mat.device)
        for _ in range(max(1, self.power_iters)):
            v = mat.T @ u
            v = v / (torch.linalg.vector_norm(v) + self.epsilon)
            u = mat @ v
            u = u / (torch.linalg.vector_norm(u) + self.epsilon)
        sigma = u @ mat @ v
        return weight / sigma
