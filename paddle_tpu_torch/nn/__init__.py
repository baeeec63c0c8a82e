"""Functional layers of the port (the training slice): ``nn.functional``
holds ``linear_cross_entropy`` and ``scaled_dot_product_attention``. The
Paddle ``nn.Layer`` surface is ROADMAP Queue 1 item 12."""
from . import functional

__all__ = ["functional"]
