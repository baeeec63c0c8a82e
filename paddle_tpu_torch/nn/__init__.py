"""Layers of the port: ``nn.functional`` holds ``layer_norm``,
``linear_cross_entropy``, ``dropout`` and
``scaled_dot_product_attention``; ``LayerNorm`` and ``Dropout`` are the
layers the GPT uses, and ``LayerMixin`` (``nn.layer``) gives a
``torch.nn.Module`` Paddle's ``set_state_dict``. The rest of the Paddle
``nn.Layer`` surface is ROADMAP Queue 1 item 12b."""
from . import functional
from .layer import LayerMixin
from .layers_common import Dropout
from .layers_norm import LayerNorm

__all__ = ["functional", "Dropout", "LayerNorm", "LayerMixin"]
