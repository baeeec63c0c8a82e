"""Optimizer base — the port of ``paddle_tpu/optimizer/optimizer.py``
(``Optimizer``: per-parameter state, float32 master weights for
low-precision parameters, the step counter, the learning rate or its
scheduler, gradient clipping, ``state_dict``, ``functional_update``'s
order of operations).

A plain class with ``step()`` and ``zero_grad()`` (``clear_grad``) over
``torch.Tensor`` parameters; the update itself is each subclass's
``_apply_dense``, which works in place on the parameter (or its float32
master) and its state.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.clip_grad import ClipGradBase, ClipGradByGlobalNorm
from .lr import LRScheduler

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
    updated. ``learning_rate``: a float or an ``optimizer.lr.LRScheduler``
    (read at every step; the caller steps it). ``grad_clip``: a
    ``utils.clip_grad`` clip, applied to the step's gradients before the
    L2 term. With ``multi_precision`` a float32 master is kept for every
    bfloat16/float16 parameter, made from its value at the first step that
    updates it; without it a low-precision parameter raises."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False):
        if grad_clip is not None and not isinstance(grad_clip, ClipGradBase):
            raise TypeError(f"grad_clip must be a utils.clip_grad clip; got "
                            f"{type(grad_clip).__name__}")
        if isinstance(learning_rate, bool) or not isinstance(
                learning_rate, (int, float, LRScheduler)):
            raise TypeError(f"learning_rate must be a float or an "
                            f"LRScheduler; got "
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
        self._learning_rate = (learning_rate if isinstance(
            learning_rate, LRScheduler) else float(learning_rate))
        self._weight_decay = float(weight_decay or 0.0)
        self._decoupled_wd = False  # AdamW overrides
        self._grad_clip = grad_clip
        self._multi_precision = bool(multi_precision)
        #: per parameter name: its optimizer state tensors
        self.state: dict[str, dict[str, torch.Tensor]] = {}
        self._step_count = 0

    # ------------------------------------------------------------ lr
    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return float(self._learning_rate)

    def set_lr(self, value: float) -> None:
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError("set_lr not allowed when using an LRScheduler")
        self._learning_rate = float(value)

    @property
    def _lr_scheduler(self):
        return (self._learning_rate if isinstance(self._learning_rate,
                                                  LRScheduler) else None)

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

    def _apply_dense(self, updates, lr, step, scale=None):
        """Apply one step to every ``(target, g, state, decay, p_out)`` in
        ``updates``: update ``target`` (a float32 parameter or master) and
        ``state`` in place from the gradient ``g`` (clipped first by the
        float32 device scalar ``scale`` when given: ``(g * scale)`` rounded
        to g's dtype), scaling ``target`` by ``decay`` first and writing
        the new value into ``p_out`` when given. All at once, so that a
        fused update can batch its launches. Override."""
        raise NotImplementedError

    # ------------------------------------------------------------ step
    @torch.no_grad()
    def step(self) -> None:
        """One update of every parameter that has a gradient: the step
        counter is incremented before use, the gradients are clipped, Adam's
        L2 term is added to the gradient in its own dtype, the gradient is
        read as float32, AdamW's decoupled decay (``1 - lr * wd``, with the
        step's rate) scales the (master) weight before the update, and a
        low-precision parameter is written back from its new master. Either
        decay skips a parameter whose name ``_decay_on`` turns off (the
        reference's ``wd_mask``).

        A ``ClipGradByGlobalNorm`` clip costs no pass of its own: its scale
        stays on the device (``kernels.global_norm``) and the update reads
        ``(g * scale)`` rounded to g's dtype. Where an L2 term must be
        added to the clipped gradient, or for any other clip, the clipped
        gradients are formed first (``clip.apply``)."""
        self._step_count += 1
        lr = self.get_lr()
        wd = self._weight_decay
        live = [(name, p, p.grad) for name, p in self._params
                if p.grad is not None]
        grads = [g for _, _, g in live]
        scale = None
        if self._grad_clip is not None and live:
            l2 = bool(wd) and not self._decoupled_wd
            if isinstance(self._grad_clip, ClipGradByGlobalNorm) and not l2:
                scale = self._grad_clip.scale(grads)
            else:
                grads = self._grad_clip.apply(grads,
                                              [p for _, p, _ in live])
        updates = []
        for (name, p, _), g in zip(live, grads):
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
        self._apply_dense(updates, lr, self._step_count, scale)

    def zero_grad(self, set_to_none: bool = True) -> None:
        for _, p in self._params:
            if set_to_none:
                p.grad = None
            elif p.grad is not None:
                p.grad.zero_()

    def clear_grad(self, set_to_zero: bool = False) -> None:
        """Paddle's name: drop every gradient (zero it in place with
        ``set_to_zero``)."""
        self.zero_grad(set_to_none=not set_to_zero)

    clear_gradients = clear_grad

    # ------------------------------------------------------------ state io
    def state_dict(self) -> dict:
        """The reference's layout: ``"<param>.<slot>"`` for every state
        tensor (the tensors themselves, as torch's optimizers return
        them), ``"@step"`` the step count and, with a scheduler,
        ``"LR_Scheduler"`` its state. Parameter names are those given to
        the optimizer (``named_parameters()``: the reference's names, see
        ``text.convert``)."""
        sd = {f"{name}.{slot}": t for name, st in self.state.items()
              for slot, t in st.items()}
        sd["@step"] = self._step_count
        if self._lr_scheduler is not None:
            sd["LR_Scheduler"] = self._lr_scheduler.state_dict()
        return sd

    def set_state_dict(self, state_dict: dict) -> None:
        """Load :meth:`state_dict`'s layout; each state value (a tensor or
        an array) is copied as float32 onto its parameter's device."""
        self._step_count = int(state_dict.get("@step", 0))
        if "LR_Scheduler" in state_dict and self._lr_scheduler is not None:
            self._lr_scheduler.set_state_dict(state_dict["LR_Scheduler"])
        devices = {name: p.device for name, p in self._params}
        by_param: dict[str, dict] = {}
        for k, v in state_dict.items():
            if k in ("@step", "LR_Scheduler"):
                continue
            pname, slot = k.rsplit(".", 1)
            if pname in devices:
                by_param.setdefault(pname, {})[slot] = torch.as_tensor(
                    np.asarray(v) if not torch.is_tensor(v) else v,
                    dtype=torch.float32, device=devices[pname]).clone()
        self.state.update(by_param)


def bias_corrections(beta1: float, beta2: float, step: int):
    """``(1 - beta1**step, 1 - beta2**step)`` computed in float32, as the
    reference computes them from its float32 step."""
    s = np.float32(step)
    one = np.float32(1.0)
    return (float(one - np.float32(beta1) ** s),
            float(one - np.float32(beta2) ** s))
