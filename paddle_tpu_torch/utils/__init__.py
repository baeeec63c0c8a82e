"""paddle_tpu_torch.utils — the port's copies of ``paddle_tpu/utils``
helpers it needs: the ``monitor`` stats registry and ``clip_grad``."""
from . import clip_grad, monitor
from .clip_grad import (ClipGradByGlobalNorm, ClipGradByNorm,
                        ClipGradByValue)

__all__ = ["clip_grad", "monitor", "ClipGradByGlobalNorm", "ClipGradByNorm",
           "ClipGradByValue"]
