"""The process group — the port of ``paddle_tpu/distributed/env.py``:
``init_parallel_env``, ``ParallelEnv``, ``proc_world``, ``get_rank``,
``get_world_size``, ``barrier`` and ``destroy_process_group`` over
``torch.distributed``. The reference's ``global_mesh`` /
``set_global_mesh`` name a JAX device mesh and have no counterpart: a
rank of the port is a process, and its groups are
``collective.new_group``'s.

``init_parallel_env()`` with no argument is the reference's form: the
rank, the world size and the rendezvous come from the launcher's
environment — ``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM`` and
``PADDLE_MASTER`` (``host:port``, a TCP rendezvous) — and the backend
from ``PADDLE_DISTRIBUTED_BACKEND`` (default: NCCL where the process
sees a card, gloo otherwise). One process (``PADDLE_TRAINERS_NUM`` 1 or
unset) needs no process group, and none is made.

The backend is the caller's choice, by name: ``"nccl"`` when each rank
has a card of its own, ``"gloo"`` on the CPU and for ranks that share one
card (gloo's ``all_reduce`` stages CUDA tensors through the host). Nothing
tries one backend and then another. Every init takes a timeout, which
also bounds every collective of the group, so a rank that dies fails its
peers instead of hanging them. Nothing on a machine tells a program of
its cluster: the caller gives the rendezvous (``tcp://localhost:PORT`` or
``file://PATH``), the world size and the rank.
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

__all__ = ["BACKENDS", "DEFAULT_TIMEOUT_S", "init_parallel_env",
           "is_initialized", "get_rank", "get_world_size", "barrier",
           "destroy_process_group", "ParallelEnv", "proc_world"]

BACKENDS = ("nccl", "gloo")
DEFAULT_TIMEOUT_S = 300.0


def proc_world() -> tuple[int, int]:
    """``(rank, world_size)`` from the launcher's environment
    (``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``; 0 and 1 unset)."""
    return (int(os.environ.get("PADDLE_TRAINER_ID", "0")),
            int(os.environ.get("PADDLE_TRAINERS_NUM", "1")))


def init_parallel_env(backend: str | None = None,
                      init_method: str | None = None,
                      world_size: int | None = None, rank: int | None = None,
                      timeout_s: float = DEFAULT_TIMEOUT_S):
    """Join the process group of ``world_size`` ranks as ``rank`` and
    return the :class:`ParallelEnv`. Any argument left None comes from
    the launcher's environment (module docstring). Raises ValueError for
    an unknown backend or rank, or a world of several ranks with no
    rendezvous; RuntimeError when this process already joined one."""
    env_rank, env_world = proc_world()
    rank = env_rank if rank is None else rank
    world_size = env_world if world_size is None else world_size
    if backend is None and init_method is None and world_size == 1 \
            and not is_initialized():
        return ParallelEnv()
    if init_method is None:
        master = os.environ.get("PADDLE_MASTER")
        if not master:
            raise ValueError("no rendezvous: pass init_method or set "
                             "PADDLE_MASTER (host:port)")
        init_method = f"tcp://{master}"
    if backend is None:
        backend = os.environ.get("PADDLE_DISTRIBUTED_BACKEND") or (
            "nccl" if torch.cuda.is_available() else "gloo")
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} outside world_size {world_size}")
    if is_initialized():
        raise RuntimeError("this process already joined a process group")
    dist.init_process_group(
        backend, init_method=init_method, world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    return ParallelEnv()


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_rank() -> int:
    """This process's rank; 0 outside a process group."""
    return dist.get_rank() if is_initialized() else 0


def get_world_size() -> int:
    """The group's rank count; 1 outside a process group."""
    return dist.get_world_size() if is_initialized() else 1


def barrier() -> None:
    if is_initialized():
        dist.barrier()


def destroy_process_group() -> None:
    """Leave the process group and drop every group made over it."""
    if is_initialized():
        from . import collective

        collective.destroy_process_group()


class ParallelEnv:
    """This process's place in the job: the reference's ``ParallelEnv``
    (``rank``, ``world_size`` and their aliases, the endpoints from the
    launcher's environment)."""

    @property
    def rank(self) -> int:
        return get_rank()

    local_rank = rank

    @property
    def world_size(self) -> int:
        return get_world_size()

    nranks = world_size

    @property
    def device_id(self) -> int:
        return torch.cuda.current_device() if torch.cuda.is_available() \
            else 0

    @property
    def current_endpoint(self) -> str:
        return os.environ.get("PADDLE_CURRENT_ENDPOINT", "127.0.0.1:6170")

    @property
    def trainer_endpoints(self) -> list:
        return os.environ.get("PADDLE_TRAINER_ENDPOINTS",
                              "127.0.0.1:6170").split(",")
