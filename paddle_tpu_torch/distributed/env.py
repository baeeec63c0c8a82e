"""The process group — the port of the parts of
``paddle_tpu/distributed/env.py`` that tensor-parallel serving needs:
``init_parallel_env``, ``get_rank``, ``get_world_size``, ``barrier`` and
``destroy_process_group`` over ``torch.distributed``.

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

import torch.distributed as dist

__all__ = ["BACKENDS", "DEFAULT_TIMEOUT_S", "init_parallel_env",
           "is_initialized", "get_rank", "get_world_size", "barrier",
           "destroy_process_group"]

BACKENDS = ("nccl", "gloo")
DEFAULT_TIMEOUT_S = 300.0


def init_parallel_env(backend: str, init_method: str, world_size: int,
                      rank: int, timeout_s: float = DEFAULT_TIMEOUT_S):
    """Join the process group of ``world_size`` ranks as ``rank``.
    Raises ValueError for an unknown backend or rank, RuntimeError when
    this process already joined one."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} outside world_size {world_size}")
    if is_initialized():
        raise RuntimeError("this process already joined a process group")
    dist.init_process_group(
        backend, init_method=init_method, world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))


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
    if is_initialized():
        dist.destroy_process_group()
