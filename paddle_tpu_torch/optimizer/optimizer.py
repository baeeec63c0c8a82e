"""Optimizer base — the port of ``paddle_tpu/optimizer/optimizer.py``
(``Optimizer``: per-parameter state, float32 master weights for
low-precision parameters, the step counter, ``functional_update``'s order
of operations).

A plain class with ``step()`` and ``zero_grad()`` over ``torch.Tensor``
parameters; the update itself is each subclass's ``_apply_dense``, which
works in place on the parameter (or its float32 master) and its state.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["Optimizer"]

_LOW_PRECISION = (torch.bfloat16, torch.float16)


def _named(parameters) -> list[tuple[str, torch.Tensor]]:
    """``(name, tensor)`` pairs from tensors or from ``named_parameters()``
    pairs; an unnamed tensor is called ``param_<i>``."""
    out = []
    for i, item in enumerate(parameters):
        name, p = item if isinstance(item, tuple) else (f"param_{i}", item)
        out.append((name, p))
    return out


class Optimizer:
    """``parameters``: tensors or ``(name, tensor)`` pairs (e.g.
    ``model.named_parameters()``); only those that require a gradient are
    updated. ``learning_rate`` is a float: learning-rate schedulers, like
    ``grad_clip``, are ROADMAP Queue 1 item 7. With ``multi_precision`` a
    float32 master is kept for every bfloat16/float16 parameter, made from
    its value at the first step that updates it; without it a
    low-precision parameter raises."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False):
        if grad_clip is not None:
            raise NotImplementedError(
                "grad_clip is not ported (ROADMAP Queue 1 item 7)")
        if isinstance(learning_rate, bool) or not isinstance(
                learning_rate, (int, float)):
            raise NotImplementedError(
                f"learning_rate must be a float: learning-rate schedulers are "
                f"not ported (ROADMAP Queue 1 item 7); got "
                f"{type(learning_rate).__name__}")
        if parameters is None:
            raise ValueError("parameters is required")
        self._params = [(n, p) for n, p in _named(parameters)
                        if p.requires_grad]
        for name, p in self._params:
            if p.dtype in _LOW_PRECISION and not multi_precision:
                raise ValueError(
                    f"parameter {name} is {p.dtype}: low-precision "
                    f"parameters need multi_precision=True (a float32 "
                    f"master)")
        self._learning_rate = float(learning_rate)
        self._weight_decay = float(weight_decay or 0.0)
        self._decoupled_wd = False  # AdamW overrides
        self._multi_precision = bool(multi_precision)
        #: per parameter name: its optimizer state tensors
        self.state: dict[str, dict[str, torch.Tensor]] = {}
        self._step_count = 0

    # ------------------------------------------------------------ state
    def _slot_init(self, p: torch.Tensor) -> dict:
        """Per-parameter state tensors. Override."""
        return {}

    def _state_for(self, name: str, p: torch.Tensor) -> dict:
        st = self.state.get(name)
        if st is None:
            st = self._slot_init(p)
            if self._multi_precision and p.dtype in _LOW_PRECISION:
                st["master_weight"] = p.detach().float().clone()
            self.state[name] = st
        return st

    def _decay_on(self, name: str) -> bool:
        return True

    def _apply_dense(self, updates, lr, step):
        """Apply one step to every ``(target, g, state, decay, p_out)`` in
        ``updates``: update ``target`` (a float32 parameter or master) and
        ``state`` in place from the gradient ``g``, scaling ``target`` by
        ``decay`` first and writing the new value into ``p_out`` when
        given. All at once, so that a fused update can batch its launches.
        Override."""
        raise NotImplementedError

    # ------------------------------------------------------------ step
    @torch.no_grad()
    def step(self) -> None:
        """One update of every parameter that has a gradient: the step
        counter is incremented before use, Adam's L2 term is added to the
        gradient in its own dtype, the gradient is read as float32,
        AdamW's decoupled decay scales the (master) weight before the
        update, and a low-precision parameter is written back from its new
        master. Either decay skips a parameter whose name ``_decay_on``
        turns off (the reference's ``wd_mask``)."""
        self._step_count += 1
        lr = self._learning_rate
        wd = self._weight_decay
        updates = []
        for name, p in self._params:
            g = p.grad
            if g is None:
                continue
            st = self._state_for(name, p)
            master = st.get("master_weight")
            decay_on = bool(wd) and self._decay_on(name)
            if decay_on and not self._decoupled_wd:
                # L2 folded into the gradient in the gradient's dtype, the
                # coefficient rounded to it first, as the reference's
                # weakly typed ``g + wd * p.astype(g.dtype)``; the update
                # reads the sum as float32
                g = g + g.new_tensor(wd) * p.to(g.dtype)
            decay = 1.0 - lr * wd if decay_on and self._decoupled_wd \
                else 1.0
            target = p if master is None else master
            updates.append((target, g, st, decay,
                            None if master is None else p))
        self._apply_dense(updates, lr, self._step_count)

    def zero_grad(self, set_to_none: bool = True) -> None:
        for _, p in self._params:
            if set_to_none:
                p.grad = None
            elif p.grad is not None:
                p.grad.zero_()


def bias_corrections(beta1: float, beta2: float, step: int):
    """``(1 - beta1**step, 1 - beta2**step)`` computed in float32, as the
    reference computes them from its float32 step."""
    s = np.float32(step)
    one = np.float32(1.0)
    return (float(one - np.float32(beta1) ** s),
            float(one - np.float32(beta2) ** s))
