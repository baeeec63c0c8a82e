"""paddle_tpu_torch.distributed.fleet — activation recompute
(``recompute``, ``apply_recompute``). As in the
reference, the name ``recompute`` here is the function; the module is
``importlib.import_module("paddle_tpu_torch.distributed.fleet.recompute")``."""
from .recompute import apply_recompute, recompute

__all__ = ["recompute", "apply_recompute"]
