"""paddle_tpu_torch.utils — the port's copies of ``paddle_tpu/utils``
helpers it needs: the ``monitor`` stats registry."""
from . import monitor

__all__ = ["monitor"]
