"""paddle_tpu_torch.distributed — the port of the parts of
``paddle_tpu/distributed`` that training and tensor-parallel serving
need: ``fleet.recompute``; the process group (``init_parallel_env``,
``get_rank``, ``get_world_size``, ``barrier``,
``destroy_process_group``), ``all_reduce`` and ``spawn``. The rest of the
collective surface and parallel training are ROADMAP Queue 1 item 12."""
from . import collective, env, fleet
from .collective import all_reduce
from .env import (barrier, destroy_process_group, get_rank, get_world_size,
                  init_parallel_env)
from .spawn import spawn

__all__ = ["fleet", "collective", "env", "all_reduce", "barrier",
           "destroy_process_group", "get_rank", "get_world_size",
           "init_parallel_env", "spawn"]
