"""Dynamic loss scaling — the port of ``paddle_tpu/amp/grad_scaler.py``
(``GradScaler``), with the reference's update rule, ``state_dict`` and
``load_state_dict``. Float16 needs it; bfloat16 runs unscaled.

The reference's ``unscale_`` reads each gradient's finiteness on the host,
one parameter at a time. The port unscales every gradient and forms one
found-inf flag on the device over all of them; ``step`` reads that flag
once, so a step costs one host read whatever the parameter count. The skip
decision and the scale follow the reference's over any sequence of finite
and non-finite steps.
"""
from __future__ import annotations

import torch

__all__ = ["GradScaler"]


def _parameters(optimizer) -> list:
    """The optimizer's parameters (the port keeps ``(key, p)`` pairs)."""
    params = getattr(optimizer, "_params", None)
    if params is not None:
        return [p for _, p in params]
    return list(getattr(optimizer, "_parameter_list", None) or [])


class GradScaler:
    def __init__(self, enable=True, init_loss_scaling=2.0**15, incr_ratio=2.0,
                 decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=2, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        #: False, or after ``unscale_`` a bool tensor on the gradients'
        #: device until ``step`` (or ``update``) reads it
        self._found_inf = False

    def scale(self, var):
        if not self._enable:
            return var
        return var * self._scale

    def unscale_(self, optimizer):
        """Every gradient times ``1 / scale`` in place, in its dtype, and
        one device flag: whether any of them holds an inf or a NaN."""
        if not self._enable:
            return
        inv = 1.0 / self._scale
        grads = [p.grad for p in _parameters(optimizer) if p.grad is not None]
        if not grads:
            self._found_inf = False
            return
        finite = []
        with torch.no_grad():
            for g in grads:
                g.mul_(inv)
                finite.append(torch.isfinite(g).all())
            self._found_inf = ~torch.stack(finite).all()

    def _read_found_inf(self) -> bool:
        """The flag as a Python bool: the one host read of a step."""
        if isinstance(self._found_inf, torch.Tensor):
            self._found_inf = bool(self._found_inf)
        return self._found_inf

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)
        optimizer.clear_grad()

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if not self._read_found_inf():
            optimizer.step()
        self.update()

    def update(self):
        if not (self._enable and self._dynamic):
            return
        if self._read_found_inf():
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        self._found_inf = False

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_init_loss_scaling(self):
        return self._scale

    def set_init_loss_scaling(self, v):
        self._scale = float(v)

    def state_dict(self):
        return {"scale": self._scale, "incr_count": self._good_steps,
                "decr_count": self._bad_steps}

    def load_state_dict(self, sd):
        self._scale = sd.get("scale", self._scale)
