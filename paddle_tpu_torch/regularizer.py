"""``paddle.regularizer`` of the port: the weight-decay terms an optimizer
(``weight_decay=``) or a parameter (``ParamAttr(regularizer=)``) takes."""
from .optimizer.optimizer import L1Decay, L2Decay

__all__ = ["L1Decay", "L2Decay"]
