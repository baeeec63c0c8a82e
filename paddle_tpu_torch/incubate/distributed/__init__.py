"""paddle_tpu_torch.incubate.distributed: the MoE layer
(``models.moe``)."""
from . import models

__all__ = ["models"]
