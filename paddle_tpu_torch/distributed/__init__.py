"""paddle_tpu_torch.distributed — the port of the parts of
``paddle_tpu/distributed`` the training path needs: ``fleet.recompute``.
Parallel training (data, tensor, pipeline, sequence parallelism) is
ROADMAP Queue 1 items 9 and 12."""
from . import fleet

__all__ = ["fleet"]
