"""``paddle.autograd`` — the port of ``paddle_tpu/autograd/__init__.py``:
``backward``, ``PyLayer`` and ``PyLayerContext``, with ``no_grad`` and
``grad`` re-exported.

The reference records a ``PyLayer`` as a tape node whose VJP calls the
user's ``backward``; the port records it as a ``torch.autograd.Function``
(:class:`_PyLayerFunction`). The reference's rules hold: ``forward`` runs
without recording, every tensor output takes a gradient, and
``backward`` returns one gradient per *positional* input tensor that has
``stop_gradient=False`` and for nothing else. A torch ``Function``'s
backward returns one value per forward argument, non-tensors included;
the adapter maps the user's list onto those slots.
"""
from __future__ import annotations

import torch

from ..core.tape import no_grad  # noqa: F401
from ..core.tensor import as_port
from ..framework import grad  # noqa: F401

__all__ = ["backward", "PyLayer", "PyLayerContext", "no_grad", "grad"]


def backward(tensors, grad_tensors=None, retain_graph=False):
    """``t.backward(g)`` for each tensor and its gradient (None: ones)."""
    tensors = tensors if isinstance(tensors, (list, tuple)) else [tensors]
    if grad_tensors is None:
        grad_tensors = [None] * len(tensors)
    for t, g in zip(tensors, grad_tensors):
        t.backward(g, retain_graph=retain_graph)


class PyLayerContext:
    """What ``forward`` hands to ``backward``: ``save_for_backward(*t)``
    keeps tensors, ``saved_tensor()`` returns them."""

    def __init__(self):
        self._saved = []
        self.saved_tensor_list = []

    def save_for_backward(self, *tensors):
        self._saved = list(tensors)

    def saved_tensor(self):
        return self._saved


class _PyLayerFunction(torch.autograd.Function):
    """The torch record of one ``PyLayer.apply``: ``forward(layer_cls,
    ctx, call, *inputs)`` runs the user's forward (autograd off) on
    ``call``'s ``args`` and ``kwargs``, notes the output's structure in
    ``call`` and returns its tensor outputs; ``inputs`` are the
    positional tensors that take a gradient, so the backward's slots
    after the first three are theirs."""

    @staticmethod
    def forward(fctx, layer_cls, ctx, call, *inputs):
        out = layer_cls.forward(ctx, *call["args"], **call["kwargs"])
        outs = list(out) if isinstance(out, (tuple, list)) else [out]
        fctx.layer_cls, fctx.ctx = layer_cls, ctx
        call["structure"] = (isinstance(out, (tuple, list)),
                             [None if isinstance(o, torch.Tensor) else o
                              for o in outs])
        return tuple(o for o in outs if isinstance(o, torch.Tensor))

    @staticmethod
    def backward(fctx, *grads):
        with torch.no_grad():
            gin = fctx.layer_cls.backward(fctx.ctx,
                                          *(as_port(g) for g in grads))
        gin = list(gin) if isinstance(gin, (tuple, list)) else [gin]
        return (None, None, None, *gin)


class PyLayer:
    """A custom autograd op: subclasses define static ``forward(ctx,
    *args)`` and ``backward(ctx, *grads)``; ``apply(*args)`` runs it."""

    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *args):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        ctx = PyLayerContext()
        inputs = [a for a in args if isinstance(a, torch.Tensor)
                  and a.requires_grad]
        if not torch.is_grad_enabled() or not inputs:
            with torch.no_grad():
                return as_port(cls.forward(ctx, *args, **kwargs))
        call = {"args": args, "kwargs": kwargs}
        outs = iter(_PyLayerFunction.apply(cls, ctx, call, *inputs))
        is_seq, consts = call["structure"]
        full = [as_port(next(outs)) if c is None else c for c in consts]
        return tuple(full) if is_seq else full[0]
