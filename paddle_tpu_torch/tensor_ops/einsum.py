"""``einsum`` — the port of ``paddle_tpu/tensor_ops/einsum.py``."""
from __future__ import annotations

import torch

from ..core.tensor import as_port, as_tensor_arg


def einsum(equation, *operands):
    if len(operands) == 1 and isinstance(operands[0], (list, tuple)):
        operands = tuple(operands[0])
    return as_port(torch.einsum(equation,
                                *[as_tensor_arg(o) for o in operands]))
