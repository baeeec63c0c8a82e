"""paddle_tpu_torch.distributed.launch — the job launcher, the port of
``paddle_tpu/distributed/launch``: ``python -m
paddle_tpu_torch.distributed.launch [--nproc_per_node N] [--devices
0,1,..] [--max_restart K] script.py args`` starts a trainer process a
rank with the reference's ``PADDLE_*`` environment, writes each one's
output to ``log_dir/workerlog.N``, restarts the pod at the next
generation when a trainer fails (up to ``--max_restart`` times) and
exits with the failing trainer's code, or ``ELASTIC_EXIT_CODE`` when an
elastic job cannot go on."""
from .context import Context
from .controller import ELASTIC_EXIT_CODE, CollectiveController, PSController
from .main import launch
from .master import KVMaster

__all__ = ["launch", "Context", "CollectiveController", "PSController",
           "KVMaster", "ELASTIC_EXIT_CODE"]
