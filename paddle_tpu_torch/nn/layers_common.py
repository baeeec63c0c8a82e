"""Common layers — the port of ``paddle_tpu/nn/layers_common.py``
(``Dropout``).

``Dropout`` is a ``torch.nn.Module`` around :func:`.functional.dropout`:
it draws from the port's key schedule (``core.rng``) in training mode and
is the identity in eval mode."""
from __future__ import annotations

from torch import nn

from . import functional as F

__all__ = ["Dropout"]


class Dropout(nn.Module):
    """Dropout with probability ``p``, the mask broadcast over every
    dimension not in ``axis`` (None: no broadcast), ``mode``
    ``upscale_in_train`` or ``downscale_in_infer``."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train"):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, x):
        return F.dropout(x, self.p, axis=self.axis, training=self.training,
                         mode=self.mode)

    def extra_repr(self) -> str:
        return f"p={self.p}"
