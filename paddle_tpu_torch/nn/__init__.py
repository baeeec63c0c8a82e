"""Layers of the port: ``nn.functional`` holds ``layer_norm``,
``linear_cross_entropy``, ``dropout`` and
``scaled_dot_product_attention``; ``LayerNorm`` and ``Dropout`` are the
layers the GPT uses. The rest of the Paddle ``nn.Layer`` surface is
ROADMAP Queue 1 item 12."""
from . import functional
from .layers_common import Dropout
from .layers_norm import LayerNorm

__all__ = ["functional", "Dropout", "LayerNorm"]
