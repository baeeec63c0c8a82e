"""Gradient clipping — the port of ``paddle_tpu/utils/clip_grad.py``
(``ClipGradBase``, ``ClipGradByValue``, ``ClipGradByNorm``,
``ClipGradByGlobalNorm``).

Each clip maps a list of gradients (``torch.Tensor`` or None) to the
clipped list, in the reference's arithmetic: norms from float32 sums of
squares, and ``(g * scale)`` rounded back to g's dtype (a bfloat16
gradient is multiplied in float32).

``ClipGradByGlobalNorm`` computes its norm through
``kernels.global_norm``: one multi-tensor kernel on the card, its plain
version on the CPU. An optimizer given it does not clip through
``apply``: it passes the kernel's device ``scale`` to the fused Adam
update, which clips in its own pass (``optimizer.Optimizer.step``).
"""
from __future__ import annotations

import torch

from ..kernels.global_norm import global_norm_scale

__all__ = ["ClipGradBase", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm"]


def _scaled(g, scale):
    """``(g * scale)`` in float32 rounded to g's dtype; in float64 for a
    float64 ``g``, as the reference promotes it."""
    if g.dtype == torch.float64:
        return g * scale.to(torch.float64)
    return (g.float() * scale).to(g.dtype)


class ClipGradBase:
    def apply(self, grads: list, params: list) -> list:
        """The clipped gradients (None stays None)."""
        raise NotImplementedError

    def __call__(self, params_grads):
        """Paddle's ``[(param, grad)]`` interface."""
        params = [p for p, _ in params_grads]
        grads = [g for _, g in params_grads]
        return list(zip(params, self.apply(grads, params)))


class ClipGradByValue(ClipGradBase):
    """Each element into ``[min, max]`` (``min`` defaults to ``-max``)."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def apply(self, grads, params):
        return [None if g is None else torch.clamp(g, self.min, self.max)
                for g in grads]


class ClipGradByNorm(ClipGradBase):
    """Each gradient whose own norm exceeds ``clip_norm`` scaled by
    ``clip_norm / (norm + 1e-12)``."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def apply(self, grads, params):
        out = []
        for g in grads:
            if g is None:
                out.append(None)
                continue
            full = lambda v: torch.full(  # noqa: E731
                (), v, dtype=torch.float32, device=g.device)
            n = torch.sqrt(torch.sum(g.float() ** 2))
            # tensor operands: a Python-number divisor or dividend is a
            # reciprocal multiply on CUDA
            scale = torch.where(n > self.clip_norm,
                                full(self.clip_norm) / (n + full(1e-12)),
                                full(1.0))
            out.append(_scaled(g, scale))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """Every gradient scaled by ``min(1, clip_norm / (global_norm +
    1e-6))``, the global norm over all of them. ``group_name`` and
    ``auto_skip_clip`` are kept for the reference's signature.

    Under hybrid-parallel training (``fleet.distributed_optimizer``) the
    norm is the whole model's, as the reference's single controller
    computes it: ``hybrid`` (set by fleet) maps the step's parameters to a
    ``reduce`` hook of ``kernels.global_norm``, which sums the rank's
    partial sums of squares over its model, pipeline and sharding groups
    between the sums launch and the scale launch, each parameter counted
    once."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name
        self.hybrid = None

    def scale(self, grads, params=None):
        """The float32 clip scale of ``grads`` (None entries skipped), a
        scalar on their device, or None when there is no gradient.
        ``params``: the gradients' parameters, which a hybrid-parallel
        norm needs."""
        keep = [i for i, g in enumerate(grads) if g is not None]
        if not keep:
            return None
        reduce = None
        if self.hybrid is not None:
            if params is None:
                raise ValueError("a hybrid-parallel norm needs the "
                                 "gradients' parameters")
            reduce = self.hybrid([params[i] for i in keep])
        return global_norm_scale([grads[i] for i in keep], self.clip_norm,
                                 reduce)[1]

    def apply(self, grads, params):
        scale = self.scale(grads, params)
        if scale is None:
            return grads
        return [None if g is None else _scaled(g, scale) for g in grads]
