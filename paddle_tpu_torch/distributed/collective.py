"""Collectives — the port of ``all_reduce`` (SUM) of
``paddle_tpu/distributed/collective.py``, the one collective
tensor-parallel serving issues.

``all_reduces`` counts the calls since the caller last set it to 0 (read
and reset it through the module: ``collective.all_reduces``): the tests
and ``chip_smoke.py`` hold a serving step to its ``2L + 1`` (``2L + 2``
with quantized logits) all-reduces with it.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["all_reduce", "all_reduces"]

all_reduces = 0


def all_reduce(tensor: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``tensor`` over the ranks of ``group`` (None: the whole
    process group) in place; returns it. Every rank receives the same
    bits."""
    global all_reduces
    all_reduces += 1
    dist.all_reduce(tensor, op=dist.ReduceOp.SUM, group=group)
    return tensor
