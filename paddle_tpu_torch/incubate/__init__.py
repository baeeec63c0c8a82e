"""paddle_tpu_torch.incubate — the port of the parts of
``paddle_tpu/incubate`` that parallel training needs: the
Mixture-of-Experts layer (``MoELayer``). The rest of ``incubate`` is
ROADMAP Queue 1 item 12f."""
from . import distributed
from .distributed.models.moe import MoELayer

__all__ = ["distributed", "MoELayer"]
