"""Collectives — the port of ``all_reduce`` (SUM) of
``paddle_tpu/distributed/collective.py``, the one collective
tensor-parallel serving issues.

``all_reduces`` counts the calls since the caller last set it to 0 (read
and reset it through the module: ``collective.all_reduces``): the tests
and ``chip_smoke.py`` hold a serving step to its ``2L + 1`` (``2L + 2``
with quantized logits) all-reduces with it.

``census()`` records every call made inside it — kind, payload bytes,
dtype, shape and the ranks of the group — for ``analysis.hlocheck``,
which audits an executed step's collectives against its declared
``CollectiveBudget``. Outside a census a call pays one list check. Inside
a ``SyncTally`` the transport runs with the tally paused: whatever host
staging the backend does is the collective's, not a host read of the
step.
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from ..analysis import tracecheck

__all__ = ["all_reduce", "all_reduces", "census"]

all_reduces = 0
_censuses: list[list] = []  # the active censuses, innermost last


@contextlib.contextmanager
def census():
    """Record every collective call inside the block: yields a list that
    grows by one ``(kind, nbytes, ranks, dtype, shape)`` per call."""
    calls: list = []
    _censuses.append(calls)
    try:
        yield calls
    finally:
        # by identity: two censuses may hold equal records
        _censuses[:] = [c for c in _censuses if c is not calls]


def _group_ranks(group) -> tuple:
    if group is None:
        return tuple(range(dist.get_world_size()))
    return tuple(dist.get_process_group_ranks(group))


def all_reduce(tensor: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``tensor`` over the ranks of ``group`` (None: the whole
    process group) in place; returns it. Every rank receives the same
    bits."""
    global all_reduces
    all_reduces += 1
    if _censuses:
        rec = ("all-reduce", tensor.numel() * tensor.element_size(),
               _group_ranks(group), str(tensor.dtype).split(".")[-1],
               tuple(tensor.shape))
        for calls in _censuses:
            calls.append(rec)
    if tracecheck.tallying():
        # the transport's own staging (gloo copies CUDA tensors through
        # the host) belongs to the collective the census counts, not to
        # the step's host reads
        with tracecheck.sync_tally_paused():
            dist.all_reduce(tensor, op=dist.ReduceOp.SUM, group=group)
    else:
        dist.all_reduce(tensor, op=dist.ReduceOp.SUM, group=group)
    return tensor
