"""Optimizers of the port — the counterpart of ``paddle_tpu/optimizer``:
``Adam`` and ``AdamW``, whose update is the fused Adam kernel on the
card, the reference's other eleven update rules, the decays
``L1Decay`` / ``L2Decay`` and the learning-rate schedulers of
``optimizer.lr``."""
from . import lr
from . import optimizer  # noqa: F401
from . import optimizers  # noqa: F401
from .optimizer import L1Decay, L2Decay, Optimizer
from .optimizers import (SGD, Adadelta, Adagrad, Adam, Adamax, AdamW,
                         DecayedAdagrad, Dpsgd, Ftrl, Lamb, LarsMomentum,
                         Momentum, RMSProp)

__all__ = ["Optimizer", "L1Decay", "L2Decay", "SGD", "Momentum", "Adam",
           "AdamW", "Lamb", "LarsMomentum", "RMSProp", "Adagrad",
           "Adadelta", "Adamax", "DecayedAdagrad", "Ftrl", "Dpsgd", "lr",
           "optimizer", "optimizers"]
