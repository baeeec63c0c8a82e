"""Optimizers of the port (the training slice): ``Adam`` and ``AdamW``,
whose update is the fused Adam kernel on the card, and the learning-rate
schedulers of ``optimizer.lr``."""
from . import lr
from .optimizer import Optimizer
from .optimizers import Adam, AdamW

__all__ = ["Optimizer", "Adam", "AdamW", "lr"]
