"""``einsum`` — the port of ``paddle_tpu/tensor_ops/einsum.py``."""
from __future__ import annotations

import torch

from ..amp import amp_state, maybe_cast_inputs
from ..core.tensor import as_port, as_tensor_arg


def einsum(equation, *operands):
    if len(operands) == 1 and isinstance(operands[0], (list, tuple)):
        operands = tuple(operands[0])
    operands = [as_tensor_arg(o) for o in operands]
    if amp_state() is not None:
        operands = maybe_cast_inputs("einsum", operands)
    return as_port(torch.einsum(equation, *operands))
