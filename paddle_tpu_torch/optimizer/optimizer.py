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

from typing import NamedTuple

import numpy as np
import torch

from ..utils.clip_grad import ClipGradBase, ClipGradByGlobalNorm
from .lr import LRScheduler

__all__ = ["Optimizer", "L1Decay", "L2Decay"]

_LOW_PRECISION = (torch.bfloat16, torch.float16)


def _named(parameters) -> list[tuple[str, str, torch.Tensor]]:
    """``(key, name, tensor)`` triples from tensors or from
    ``named_parameters()`` pairs: a pair keeps its name, an
    ``nn.Parameter`` its ``name``, any other tensor is ``param_<i>``. The
    key is the name, with ``@<k>`` appended where the name was seen
    before (deep-copied layers share their parameters' names, as in the
    reference), so every parameter keeps its own state; ``name`` stays
    the parameter's own, which ``apply_decay_param_fun`` is asked about."""
    out, seen = [], set()
    for i, item in enumerate(parameters):
        if isinstance(item, tuple):
            name, p = item
        else:
            p = item
            name = getattr(p, "name", None)
            name = name if isinstance(name, str) else f"param_{i}"
        key, k = name, 0
        while key in seen:
            k += 1
            key = f"{name}@{k}"
        seen.add(key)
        out.append((key, name, p))
    return out


class _Update(NamedTuple):
    """One parameter's share of a step: ``target`` (the float32 parameter
    or master) is updated in place from ``g`` with ``lr`` (the step's
    rate times the parameter's multiplier), its ``state`` in place too,
    ``target`` scaled by ``decay`` first and written into ``p_out`` (the
    low-precision parameter) after, when given."""
    target: torch.Tensor
    g: torch.Tensor
    state: dict
    decay: float
    p_out: torch.Tensor | None
    lr: float
    param: torch.Tensor
    name: str


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
        named = [t for t in _named(parameters) if t[2].requires_grad]
        #: ``(state key, parameter)`` pairs, and each key's parameter name
        self._params = [(key, p) for key, _, p in named]
        self._names = {key: name for key, name, _ in named}
        for name, p in self._params:
            if p.dtype in _LOW_PRECISION and not multi_precision:
                raise ValueError(
                    f"parameter {name} is {p.dtype}: low-precision "
                    f"parameters need multi_precision=True (a float32 "
                    f"master)")
        self._learning_rate = (learning_rate if isinstance(
            learning_rate, LRScheduler) else float(learning_rate))
        self._weight_decay = _wd_coeff(weight_decay)
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

    #: whether ``_apply_dense`` folds a global-norm clip's device scale
    #: into its update (the fused Adam does); otherwise the clipped
    #: gradients are formed first
    _takes_clip_scale = False

    def _param_wd(self, p) -> float:
        """The L2 coefficient of ``p``: its ``ParamAttr`` regularizer's,
        else the optimizer's ``weight_decay`` (the reference's eager
        rule)."""
        reg = getattr(p, "regularizer", None)
        if reg is not None:
            return _wd_coeff(reg)
        return self._weight_decay

    def _apply_dense(self, updates, step, scale=None):
        """Apply one step to every :class:`_Update` of ``updates``, all at
        once so that a fused update can batch its launches (``scale``: a
        global-norm clip's float32 device scalar, given only when
        ``_takes_clip_scale``). The default runs :meth:`_rule` on each in
        float32 and writes the result back. Override one or the other."""
        for u in updates:
            g = u.g.to(u.target.dtype)
            new = self._rule(u.target, g, u.state, u.lr, step, u)
            torch.Tensor.copy_(u.target, new)
            if u.p_out is not None:
                torch.Tensor.copy_(u.p_out, new.to(u.p_out.dtype))

    def _rule(self, p, g, state, lr, step, update):
        """The update rule of one parameter: the new value of ``p`` (the
        float32 target) from the gradient ``g`` (in p's dtype), its
        ``state`` tensors updated in place."""
        raise NotImplementedError

    # ------------------------------------------------------------ step
    @torch.no_grad()
    def step(self) -> None:
        """One update of every parameter that has a gradient: the step
        counter is incremented before use, the gradients are clipped, the
        L2 term (the parameter's regularizer's coefficient, else
        ``weight_decay``) is added to the gradient in its own dtype, the
        gradient is read as float32, AdamW's decoupled decay (``1 - lr *
        wd``, with the step's rate) scales the (master) weight before the
        update, each parameter's rate is the step's times its
        ``ParamAttr`` ``learning_rate``, and a low-precision parameter is
        written back from its new master. Either decay skips a parameter
        whose name ``_decay_on`` turns off (the reference's ``wd_mask``).

        A ``ClipGradByGlobalNorm`` clip costs no pass of its own where the
        update takes it (``_takes_clip_scale``): its scale stays on the
        device (``kernels.global_norm``) and the update reads ``(g *
        scale)`` rounded to g's dtype. Where an L2 term must be added to
        the clipped gradient, or for any other clip or update, the
        clipped gradients are formed first (``clip.apply``)."""
        self._step_count += 1
        lr = self.get_lr()
        live = [(key, p, p.grad) for key, p in self._params
                if p.grad is not None]
        grads = [g for _, _, g in live]
        scale = None
        if self._grad_clip is not None and live:
            l2 = not self._decoupled_wd and any(
                self._param_wd(p) and self._decay_on(self._names[key])
                for key, p, _ in live)
            if self._takes_clip_scale and not l2 and isinstance(
                    self._grad_clip, ClipGradByGlobalNorm):
                scale = self._grad_clip.scale(grads,
                                              [p for _, p, _ in live])
            else:
                grads = self._grad_clip.apply(grads,
                                              [p for _, p, _ in live])
        updates = []
        for (key, p, _), g in zip(live, grads):
            name = self._names[key]
            st = self._state_for(key, p)
            master = st.get("master_weight")
            wd = self._weight_decay if self._decoupled_wd \
                else self._param_wd(p)
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
            mult = getattr(p, "optimize_attr", {}).get("learning_rate", 1.0)
            updates.append(_Update(target, g, st, decay,
                                   None if master is None else p,
                                   lr * mult, p, name))
        self._apply_dense(updates, self._step_count, scale)

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
        an array) is copied onto its parameter's device as float32, or as
        float64 where the optimizer keeps that slot in float64 (a float64
        parameter's Adam, Momentum or Lamb state)."""
        self._step_count = int(state_dict.get("@step", 0))
        if "LR_Scheduler" in state_dict and self._lr_scheduler is not None:
            self._lr_scheduler.set_state_dict(state_dict["LR_Scheduler"])
        params = dict(self._params)
        by_param: dict[str, dict] = {}
        f64_slots: dict[str, set] = {}   # per float64 parameter
        for k, v in state_dict.items():
            if k in ("@step", "LR_Scheduler"):
                continue
            pname, slot = k.rsplit(".", 1)
            p = params.get(pname)
            if p is None:
                continue
            if p.dtype == torch.float64 and pname not in f64_slots:
                # the slots' dtypes, from shapeless (meta) slots
                f64_slots[pname] = {
                    s for s, t in self._slot_init(
                        torch.empty_like(p, device="meta")).items()
                    if t.dtype == torch.float64}
            dt = torch.float64 if slot in f64_slots.get(pname, ()) \
                else torch.float32
            by_param.setdefault(pname, {})[slot] = torch.as_tensor(
                np.asarray(v) if not torch.is_tensor(v) else v,
                dtype=dt, device=p.device).clone()
        self.state.update(by_param)


def bias_corrections(beta1: float, beta2: float, step: int):
    """``(1 - beta1**step, 1 - beta2**step)`` computed in float32, as the
    reference computes them from its float32 step."""
    s = np.float32(step)
    one = np.float32(1.0)
    return (float(one - np.float32(beta1) ** s),
            float(one - np.float32(beta2) ** s))


def _wd_coeff(weight_decay) -> float:
    """A ``weight_decay`` value as its coefficient: a number, or an
    ``L1Decay`` / ``L2Decay``'s ``coeff``."""
    if weight_decay is None:
        return 0.0
    if isinstance(weight_decay, (int, float)):
        return float(weight_decay)
    return float(getattr(weight_decay, "coeff", 0.0))


class L2Decay:
    """``coeff * p`` added to the gradient."""

    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)


class L1Decay:
    """A decay of coefficient ``coeff``. The reference folds it into the
    gradient as ``coeff * p``, the L2 term (not ``coeff * sign(p)``), and
    the port does the same."""

    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)
