"""``paddle.framework`` — the port of ``paddle_tpu/framework``: the mode
query, the functional gradient and ``save`` / ``load``."""
from __future__ import annotations

import torch

from ..core.tensor import as_port
from . import io  # noqa: F401
from .io import load, save

__all__ = ["in_dynamic_mode", "in_dygraph_mode", "grad", "save", "load",
           "io"]


def in_dynamic_mode() -> bool:
    """True: the port runs eagerly (it has no static-graph mode)."""
    return True


in_dygraph_mode = in_dynamic_mode


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None):
    """``paddle.grad`` over ``torch.autograd.grad``: the gradients of
    ``outputs`` with respect to ``inputs`` (a list, one per input),
    leaving every ``.grad`` untouched. An input the outputs do not reach
    gets zeros, or None with ``allow_unused=True`` — the reference's
    contract."""
    outs = list(outputs) if isinstance(outputs, (list, tuple)) \
        else [outputs]
    ins = list(inputs) if isinstance(inputs, (list, tuple)) else [inputs]
    gos = None
    if grad_outputs is not None:
        gos = list(grad_outputs) if isinstance(grad_outputs, (list, tuple)) \
            else [grad_outputs]
        gos += [None] * (len(outs) - len(gos))
    grads = torch.autograd.grad(
        outs, ins, grad_outputs=gos,
        retain_graph=bool(retain_graph) or bool(create_graph),
        create_graph=bool(create_graph), allow_unused=True)
    results = []
    for t, g in zip(ins, grads):
        if g is None and not allow_unused:
            g = torch.zeros_like(t)
        results.append(None if g is None else as_port(g))
    return results
