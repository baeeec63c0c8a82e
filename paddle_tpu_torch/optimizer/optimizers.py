"""The optimizers — the port of ``paddle_tpu/optimizer/optimizers.py``.

``Adam`` and ``AdamW`` run every float32 parameter (or float32 master)
through ``kernels.fused_optimizer.fused_adam_update_many``: on CUDA
tensors the Hopper kernel updates each of them, both moments
and, for a bfloat16 parameter, the parameter itself in one pass, with
AdamW's decay and a global-norm clip's scale folded in — every parameter
of the step in one multi-tensor launch (``adam_launch_plan``: more only
where the toolkit limits kernel parameters to 4 KB, and one plan for
each distinct per-parameter rate); on CPU tensors its plain version does
the same arithmetic. A float64 parameter keeps float64 moments and takes
a plain float64 update in the reference's order of operations
(``paddle_tpu/optimizer/optimizers.py:64-84``); the kernel takes float32
state only.

The others — ``SGD``, ``Momentum``, ``Lamb``, ``LarsMomentum``,
``RMSProp``, ``Adagrad``, ``Adadelta``, ``Adamax``, ``DecayedAdagrad``,
``Ftrl`` and ``Dpsgd`` — are the reference's update rules (not
``torch.optim``'s: RMSProp's ``epsilon`` sits inside the square root,
Momentum's Nesterov form adds ``momentum * velocity`` to the gradient,
Lamb's trust ratio is ``||w|| / ||r||``, Ftrl's ``lr_power`` exponent)
in float32 torch operations on each parameter (or its master), their
state float32 (float64 for a float64 parameter where the reference's is),
in the reference's order of operations.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.rng import fold_in_words, key_words
from ..kernels.fused_optimizer import fused_adam_update_many
from ..tensor_ops.random import _normal
from ..utils.clip_grad import _scaled
from .optimizer import Optimizer, bias_corrections

__all__ = ["Adam", "AdamW", "SGD", "Momentum", "Lamb", "LarsMomentum",
           "RMSProp", "Adagrad", "Adadelta", "Adamax", "DecayedAdagrad",
           "Ftrl", "Dpsgd"]


def _zeros(p, keep_float64=False):
    """A float32 state tensor like ``p`` — float64 for a float64 ``p``
    where ``keep_float64`` (the reference's Momentum and Lamb slots)."""
    f64 = keep_float64 and p.dtype == torch.float64
    return torch.zeros_like(p, dtype=torch.float64 if f64 else torch.float32)


def _norm(t):
    return torch.linalg.vector_norm(t.float())


class Adam(Optimizer):
    """Adam with float32 moments (float64 for a float64 parameter);
    ``weight_decay`` is an L2 term folded into the gradient, as in the
    reference."""

    _takes_clip_scale = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self._beta1 = float(beta1)
        self._beta2 = float(beta2)
        self._epsilon = float(epsilon)
        self._lazy_mode = lazy_mode

    def _slot_init(self, p):
        return {"moment1": _zeros(p, keep_float64=True),
                "moment2": _zeros(p, keep_float64=True)}

    def _apply_dense(self, updates, step, scale=None):
        bc1, bc2 = bias_corrections(self._beta1, self._beta2, step)
        by_lr: dict = {}
        for u in updates:
            if u.target.dtype == torch.float64:
                self._float64_update(u, bc1, bc2, scale)
                continue
            by_lr.setdefault(u.lr, []).append(
                (u.target, u.g, u.state["moment1"], u.state["moment2"],
                 u.decay, u.p_out))
        for lr, groups in by_lr.items():
            fused_adam_update_many(groups, lr, bc1, bc2, beta1=self._beta1,
                                   beta2=self._beta2, eps=self._epsilon,
                                   scale=scale)

    def _float64_update(self, u, bc1, bc2, scale):
        """The reference's update of a float64 parameter, in float64 but
        for the bias corrections (float32, from its float32 step)."""
        g = u.g.to(torch.float64)
        if scale is not None:
            g = _scaled(g, scale)
        p, m, v = u.target, u.state["moment1"], u.state["moment2"]
        if u.decay != 1.0:
            p.mul_(u.decay)
        m.copy_(self._beta1 * m + (1 - self._beta1) * g)
        v.copy_(self._beta2 * v + (1 - self._beta2) * (g * g))
        p.sub_(u.lr * (m / bc1) / (torch.sqrt(v / bc2) + self._epsilon))


class AdamW(Adam):
    """Adam with decoupled weight decay: the (master) weight is scaled by
    ``1 - lr * weight_decay`` before the Adam update. Every parameter is
    decayed unless ``apply_decay_param_fun(name)`` says otherwise (names
    come from ``(name, tensor)`` pairs in ``parameters``, else from each
    ``nn.Parameter``'s ``name``)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode, multi_precision)
        self._decoupled_wd = True
        self._apply_decay_param_fun = apply_decay_param_fun

    def _decay_on(self, name: str) -> bool:
        fun = self._apply_decay_param_fun
        return fun is None or bool(fun(name))


class SGD(Optimizer):
    """``p - lr * g``."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)

    def _rule(self, p, g, state, lr, step, update):
        return p - lr * g


class Momentum(Optimizer):
    """``v = momentum * v + g``; ``p - lr * v``, or with ``use_nesterov``
    ``p - lr * (g + momentum * v)``."""

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _slot_init(self, p):
        return {"velocity": _zeros(p, keep_float64=True)}

    def _rule(self, p, g, state, lr, step, update):
        vel = state["velocity"]
        vel.copy_(vel * self._momentum + g)
        upd = g + self._momentum * vel if self._nesterov else vel
        return p - lr * upd


class Lamb(Optimizer):
    """Adam's direction plus ``lamb_weight_decay * p``, scaled by the trust
    ratio ``||p|| / ||r||`` (1 where either is 0). A parameter for which
    ``exclude_from_weight_decay_fn(param)`` is true takes no decay term
    (the reference takes the function and never calls it)."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-06, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip,
                         multi_precision)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._lamb_wd = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn

    def _slot_init(self, p):
        return {"moment1": _zeros(p, keep_float64=True),
                "moment2": _zeros(p, keep_float64=True)}

    def _rule(self, p, g, state, lr, step, update):
        m, v = state["moment1"], state["moment2"]
        m.copy_(self._beta1 * m + (1 - self._beta1) * g)
        v.copy_(self._beta2 * v + (1 - self._beta2) * (g * g))
        bc1, bc2 = bias_corrections(self._beta1, self._beta2, step)
        wd = 0.0 if self._exclude_fn is not None and self._exclude_fn(
            update.param) else self._lamb_wd
        r = (m / bc1) / (torch.sqrt(v / bc2) + self._epsilon) + wd * p
        w_norm, r_norm = _norm(p), _norm(r)
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            torch.ones_like(w_norm))
        return p - lr * trust * r


class LarsMomentum(Optimizer):
    """Momentum with the layer-wise rate ``lr * lars_coeff * ||p|| /
    (||g|| + lars_weight_decay * ||p|| + epsilon)`` (``lr`` where a norm
    is 0) and the decay term in the velocity."""

    def __init__(self, learning_rate=0.001, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, parameters=None, grad_clip=None,
                 exclude_from_weight_decay=None, epsilon=1e-9,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip,
                         multi_precision)
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_wd = lars_weight_decay
        self._eps = epsilon

    def _slot_init(self, p):
        return {"velocity": _zeros(p)}

    def _rule(self, p, g, state, lr, step, update):
        w_norm, g_norm = _norm(p), _norm(g)
        local_lr = torch.where(
            (w_norm > 0) & (g_norm > 0),
            lr * self._lars_coeff * w_norm
            / (g_norm + self._lars_wd * w_norm + self._eps),
            torch.full_like(w_norm, lr))
        vel = state["velocity"]
        vel.copy_(self._momentum * vel + local_lr * (g + self._lars_wd * p))
        return p - vel


class RMSProp(Optimizer):
    """``ms = rho * ms + (1 - rho) * g²``; ``mom = momentum * mom + lr * g
    / sqrt(ms + epsilon)`` (``centered``: ``sqrt(ms - mg² + epsilon)``,
    ``mg`` the mean gradient); ``p - mom``."""

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._rho, self._epsilon = rho, epsilon
        self._momentum = momentum
        self._centered = centered

    def _slot_init(self, p):
        st = {"mean_square": _zeros(p), "momentum": _zeros(p)}
        if self._centered:
            st["mean_grad"] = _zeros(p)
        return st

    def _rule(self, p, g, state, lr, step, update):
        ms = state["mean_square"]
        ms.copy_(self._rho * ms + (1 - self._rho) * g * g)
        if self._centered:
            mg = state["mean_grad"]
            mg.copy_(self._rho * mg + (1 - self._rho) * g)
            denom = torch.sqrt(ms - mg * mg + self._epsilon)
        else:
            denom = torch.sqrt(ms + self._epsilon)
        mom = state["momentum"]
        mom.copy_(self._momentum * mom + lr * g / denom)
        return p - mom


class Adagrad(Optimizer):
    """``acc += g²``; ``p - lr * g / (sqrt(acc) + epsilon)``."""

    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _slot_init(self, p):
        return {"moment": torch.full_like(p, self._init_acc,
                                          dtype=torch.float32)}

    def _rule(self, p, g, state, lr, step, update):
        acc = state["moment"]
        acc.copy_(acc + g * g)
        return p - lr * g / (torch.sqrt(acc) + self._epsilon)


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._epsilon, self._rho = epsilon, rho

    def _slot_init(self, p):
        return {"avg_squared_grad": _zeros(p),
                "avg_squared_update": _zeros(p)}

    def _rule(self, p, g, state, lr, step, update):
        asg, asu = state["avg_squared_grad"], state["avg_squared_update"]
        asg.copy_(self._rho * asg + (1 - self._rho) * g * g)
        upd = torch.sqrt(asu + self._epsilon) / torch.sqrt(
            asg + self._epsilon) * g
        asu.copy_(self._rho * asu + (1 - self._rho) * upd * upd)
        return p - lr * upd


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _slot_init(self, p):
        return {"moment": _zeros(p), "inf_norm": _zeros(p)}

    def _rule(self, p, g, state, lr, step, update):
        m, u = state["moment"], state["inf_norm"]
        m.copy_(self._beta1 * m + (1 - self._beta1) * g)
        u.copy_(torch.maximum(self._beta2 * u, torch.abs(g)))
        bc1, _ = bias_corrections(self._beta1, self._beta2, step)
        lr_t = float(np.float32(lr) / np.float32(bc1))  # in float32
        return p - lr_t * m / (u + self._epsilon)


class DecayedAdagrad(Optimizer):
    """``acc = decay * acc + (1 - decay) * g²``; ``p - lr * g /
    (sqrt(acc) + epsilon)``."""

    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._decay = decay
        self._epsilon = epsilon

    def _slot_init(self, p):
        return {"moment": _zeros(p)}

    def _rule(self, p, g, state, lr, step, update):
        acc = state["moment"]
        acc.copy_(self._decay * acc + (1 - self._decay) * g * g)
        return p - lr * g / (torch.sqrt(acc) + self._epsilon)


class Ftrl(Optimizer):
    """Follow-the-regularised-leader: squared-gradient accumulator ``n``
    and linear term ``z``; ``sigma = (n_new**-lr_power - n**-lr_power) /
    lr``, ``z += g - sigma * p``, and ``p = (clip(z, ±l1) - z) /
    (n_new**-lr_power / lr + 2 l2)`` where ``|z| > l1``, else 0."""

    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._l1, self._l2, self._lr_power = l1, l2, lr_power

    def _slot_init(self, p):
        return {"squared": _zeros(p), "linear": _zeros(p)}

    def _rule(self, p, g, state, lr, step, update):
        sq, lin = state["squared"], state["linear"]
        new_sq = sq + g * g
        lp = -self._lr_power
        sigma = (new_sq ** lp - sq ** lp) / lr
        lin.copy_(lin + g - sigma * p)
        sq.copy_(new_sq)
        quad = new_sq ** lp / lr + 2 * self._l2
        pre = torch.clamp(lin, -self._l1, self._l1) - lin
        return torch.where(torch.abs(lin) > self._l1, pre / quad,
                           torch.zeros_like(lin))


class Dpsgd(Optimizer):
    """Differentially private SGD: each gradient clipped to norm ``clip``,
    Gaussian noise of standard deviation ``clip * sigma`` added, divided
    by ``batch_size``. The noise of a parameter's ``t``-th step is drawn
    from ``fold_in(key(seed), t)``, as the reference draws it."""

    def __init__(self, learning_rate=0.001, clip=0.9, batch_size=0.999,
                 sigma=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, seed=0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._clip = clip
        self._batch = batch_size
        self._sigma = sigma
        self._seed = seed

    def _slot_init(self, p):
        return {"t": torch.zeros((), dtype=torch.int32, device=p.device)}

    def _rule(self, p, g, state, lr, step, update):
        norm = torch.sqrt((g * g).sum())
        g = g * torch.clamp(self._clip / torch.clamp(norm, min=1e-12),
                            max=1.0)
        t = int(state["t"].item())
        words = fold_in_words(key_words(self._seed), t)
        noise = self._clip * self._sigma * _normal(
            words, tuple(g.shape), torch.float32, g.device)
        upd = (g + noise) / max(self._batch, 1e-12)
        state["t"].add_(1)
        return p - lr * upd
