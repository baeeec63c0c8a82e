"""paddle_tpu_torch.distributed — the port of ``paddle_tpu/distributed``'s
collective training over ``torch.distributed``, a process a rank: the
process group (``init_parallel_env``, ``ParallelEnv``), the collectives
(``collective``) and their functional form (``ops``), the topology, the
``fleet`` façade with its hybrid step (data, model, pipeline and ZeRO
parallelism), ``DataParallel``, ``sharding``, ``spawn``, sequence
parallelism (``sequence_parallel``: ring and Ulysses attention and the
context-parallel step), distributed checkpoints (``checkpoint``), the
launcher (``python -m paddle_tpu_torch.distributed.launch``), the 1.x
cluster helpers (``utils``), auto-parallel (``auto_parallel``:
``ProcessMesh``, ``shard_tensor``, ``reshard``, completion, the planner
and ``Engine``) and the actor runtime (``fleet_executor``). What the
reference has beyond these (the parameter server, ``fleet``'s datasets
and data generators, the blocking queue) is ROADMAP Queue 1 item
12e-2c."""
from . import (auto_parallel, checkpoint, collective, env, fleet,
               fleet_executor, launch, ops, parallel, sequence_parallel,
               sharding, topology, utils)
from .auto_parallel import ProcessMesh, reshard, shard_op, shard_tensor
from .collective import (Group, ReduceOp, all_gather, all_reduce,
                         all_to_all, alltoall, barrier, broadcast, get_group,
                         irecv, isend, new_group, recv, reduce,
                         reduce_scatter, scatter, send, split, wait)
from .env import (ParallelEnv, destroy_process_group, get_rank,
                  get_world_size, init_parallel_env, is_initialized)
from .parallel import DataParallel
from .spawn import spawn
from .topology import CommunicateTopology, HybridCommunicateGroup

split_group = split


class ParallelMode:
    """The parallelism kinds (the reference's constants)."""

    DATA_PARALLEL = 0
    TENSOR_PARALLEL = 1
    PIPELINE_PARALLEL = 2
    SHARDING_PARALLEL = 3


def gloo_init_parallel_env(rank_id, rank_num, server_endpoint):
    """The reference's CPU-barrier bootstrap: a gloo process group of
    ``rank_num`` ranks at ``server_endpoint`` (``host:port``)."""
    init_parallel_env("gloo", f"tcp://{server_endpoint}", int(rank_num),
                      int(rank_id))


def gloo_barrier():
    barrier()


def gloo_release():
    """Leave the gloo process group."""
    destroy_process_group()


__all__ = ["auto_parallel", "fleet_executor", "ProcessMesh", "reshard",
           "shard_op", "shard_tensor",
           "checkpoint", "collective", "env", "fleet", "launch", "ops",
           "parallel", "sequence_parallel", "sharding", "topology", "utils",
           "Group", "ReduceOp", "all_gather", "all_reduce",
           "all_to_all", "alltoall", "barrier", "broadcast", "get_group",
           "irecv", "isend", "new_group", "recv", "reduce",
           "reduce_scatter", "scatter", "send", "split", "split_group",
           "wait", "ParallelEnv", "destroy_process_group", "get_rank",
           "get_world_size", "init_parallel_env", "is_initialized",
           "DataParallel", "spawn", "CommunicateTopology",
           "HybridCommunicateGroup", "ParallelMode",
           "gloo_init_parallel_env", "gloo_barrier", "gloo_release"]
