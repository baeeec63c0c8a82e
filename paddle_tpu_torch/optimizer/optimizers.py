"""Adam and AdamW — the port of ``paddle_tpu/optimizer/optimizers.py``
(``Adam._apply_dense``, ``AdamW``).

Every update runs through ``kernels.fused_optimizer.fused_adam_update_many``:
on CUDA tensors the Hopper kernel updates each float32 parameter (or
master), both moments and, for a bfloat16 parameter, the parameter itself
in one pass, with AdamW's decay folded in — every parameter of the step
in one multi-tensor launch (``adam_launch_plan``: more only where the
toolkit limits kernel parameters to 4 KB); on CPU tensors its plain
version does the same arithmetic.
"""
from __future__ import annotations

import torch

from ..kernels.fused_optimizer import fused_adam_update_many
from .optimizer import Optimizer, bias_corrections

__all__ = ["Adam", "AdamW"]


class Adam(Optimizer):
    """Adam with float32 moments; ``weight_decay`` is an L2 term folded
    into the gradient, as in the reference."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self._beta1 = float(beta1)
        self._beta2 = float(beta2)
        self._epsilon = float(epsilon)

    def _slot_init(self, p):
        return {"moment1": torch.zeros_like(p, dtype=torch.float32),
                "moment2": torch.zeros_like(p, dtype=torch.float32)}

    def _apply_dense(self, updates, lr, step):
        bc1, bc2 = bias_corrections(self._beta1, self._beta2, step)
        fused_adam_update_many(
            [(target, g, st["moment1"], st["moment2"], decay, p_out)
             for target, g, st, decay, p_out in updates],
            lr, bc1, bc2, beta1=self._beta1, beta2=self._beta2,
            eps=self._epsilon)


class AdamW(Adam):
    """Adam with decoupled weight decay: the (master) weight is scaled by
    ``1 - lr * weight_decay`` before the Adam update. Every parameter is
    decayed unless ``apply_decay_param_fun(name)`` says otherwise (names
    come from ``(name, tensor)`` pairs in ``parameters``)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=0.01,
                 apply_decay_param_fun=None, grad_clip=None,
                 multi_precision=False):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, multi_precision)
        self._decoupled_wd = True
        self._apply_decay_param_fun = apply_decay_param_fun

    def _decay_on(self, name: str) -> bool:
        fun = self._apply_decay_param_fun
        return fun is None or bool(fun(name))
