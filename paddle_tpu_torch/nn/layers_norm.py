"""Normalisation layers — the port of ``paddle_tpu/nn/layers_norm.py``
(``LayerNorm``).

``LayerNorm`` is a ``torch.nn.Module`` whose parameters are named
``weight`` and ``bias``, as the reference's are, so the GPT's parameter
names (``gpt.blocks.{i}.ln1.weight`` ...) and the weights bridge
(``text/convert.py``) are the same as with ``torch.nn.LayerNorm``. Its
forward is :func:`..nn.functional.layer_norm`: on CUDA tensors the
hand-written LayerNorm kernels, on CPU tensors their plain versions.
"""
from __future__ import annotations

import torch
from torch import nn

from . import functional as F

__all__ = ["LayerNorm"]


class LayerNorm(nn.Module):
    """LayerNorm over the trailing ``normalized_shape`` with a scale
    (``weight``, initialised to 1) and a shift (``bias``, initialised to
    0). The reference's ``weight_attr`` / ``bias_attr`` (parameter
    attributes, or False to leave one out) are not ported: the GPT uses
    neither."""

    def __init__(self, normalized_shape, epsilon=1e-05, device=None,
                 dtype=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(normalized_shape)
        self.epsilon = float(epsilon)
        kw = dict(device=device, dtype=dtype)
        self.weight = nn.Parameter(torch.ones(self.normalized_shape, **kw))
        self.bias = nn.Parameter(torch.zeros(self.normalized_shape, **kw))

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight, self.bias,
                            self.epsilon)

    def extra_repr(self) -> str:
        return f"normalized_shape={list(self.normalized_shape)}, " \
               f"epsilon={self.epsilon}"
