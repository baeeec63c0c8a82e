"""Gradient mode — the port of ``paddle_tpu/core/tape.py``'s public
part: ``no_grad``, ``enable_grad``, ``is_grad_enabled`` and
``set_grad_enabled`` over torch's grad mode. The reference records a
tape of ``jax.vjp`` closures; the port's tape is torch's autograd
graph, so ``Tensor.backward`` and ``framework.grad`` are torch's."""
from __future__ import annotations

import torch

__all__ = ["no_grad", "enable_grad", "is_grad_enabled", "set_grad_enabled"]


def no_grad():
    """A context (or decorator) in which no operation records a
    gradient."""
    return torch.no_grad()


def enable_grad():
    return torch.enable_grad()


def is_grad_enabled() -> bool:
    return torch.is_grad_enabled()


def set_grad_enabled(flag: bool):
    """Set grad mode to ``flag``; as a context, restore it on exit."""
    return torch.set_grad_enabled(bool(flag))
