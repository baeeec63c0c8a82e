"""Learning-rate schedulers — the port of ``paddle_tpu/optimizer/lr.py``
(the base ``LRScheduler`` and its fifteen schedules).

Plain Python, as in the reference: ``step()`` advances ``last_epoch`` and
sets ``last_lr = get_lr()``, a Python float computed in the reference's
order of operations, so the port's rate equals the reference's float for
float. An optimizer given a scheduler as ``learning_rate`` reads
``last_lr`` at every step; the caller advances the scheduler.
"""
from __future__ import annotations

import math

__all__ = ["LRScheduler", "NoamDecay", "PiecewiseDecay", "NaturalExpDecay",
           "InverseTimeDecay", "PolynomialDecay", "LinearWarmup",
           "ExponentialDecay", "MultiStepDecay", "StepDecay", "LambdaDecay",
           "CosineAnnealingDecay", "ReduceOnPlateau", "OneCycleLR",
           "CyclicLR", "MultiplicativeDecay"]


class LRScheduler:
    def __init__(self, learning_rate=0.1, last_epoch=-1, verbose=False):
        self.base_lr = float(learning_rate)
        self.last_epoch = last_epoch
        self.last_lr = float(learning_rate)
        self.verbose = verbose
        self.step()

    def __call__(self):
        return self.last_lr

    def step(self, epoch=None):
        if epoch is None:
            self.last_epoch += 1
        else:
            self.last_epoch = epoch
        self.last_lr = self.get_lr()

    def get_lr(self) -> float:
        raise NotImplementedError

    def state_dict(self):
        return {"last_epoch": self.last_epoch, "last_lr": self.last_lr}

    def set_state_dict(self, state):
        self.last_epoch = state.get("last_epoch", self.last_epoch)
        self.last_lr = state.get("last_lr", self.last_lr)

    set_dict = set_state_dict


class NoamDecay(LRScheduler):
    def __init__(self, d_model, warmup_steps, learning_rate=1.0,
                 last_epoch=-1, verbose=False):
        self.d_model = d_model
        self.warmup_steps = warmup_steps
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = max(1, self.last_epoch)
        return self.base_lr * self.d_model**-0.5 * min(
            step**-0.5, step * self.warmup_steps**-1.5)


class PiecewiseDecay(LRScheduler):
    def __init__(self, boundaries, values, last_epoch=-1, verbose=False):
        self.boundaries = list(boundaries)
        self.values = list(values)
        super().__init__(values[0], last_epoch, verbose)

    def get_lr(self):
        for b, v in zip(self.boundaries, self.values):
            if self.last_epoch < b:
                return v
        return self.values[len(self.boundaries)]


class NaturalExpDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * math.exp(-self.gamma * self.last_epoch)


class InverseTimeDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr / (1 + self.gamma * self.last_epoch)


class PolynomialDecay(LRScheduler):
    def __init__(self, learning_rate, decay_steps, end_lr=0.0001, power=1.0,
                 cycle=False, last_epoch=-1, verbose=False):
        self.decay_steps = decay_steps
        self.end_lr = end_lr
        self.power = power
        self.cycle = cycle
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = self.last_epoch
        ds = self.decay_steps
        if self.cycle:
            div = math.ceil(step / ds) if step > 0 else 1
            ds = ds * div
        else:
            step = min(step, ds)
        return ((self.base_lr - self.end_lr) * (1 - step / ds) ** self.power
                + self.end_lr)


class LinearWarmup(LRScheduler):
    """A linear ramp from ``start_lr`` to ``end_lr`` over ``warmup_steps``,
    then ``learning_rate``: a float, or a scheduler stepped to ``epoch -
    warmup_steps``."""

    def __init__(self, learning_rate, warmup_steps, start_lr, end_lr,
                 last_epoch=-1, verbose=False):
        self.lr_sched = (learning_rate if isinstance(learning_rate,
                                                     LRScheduler) else None)
        self.target = learning_rate if not self.lr_sched else None
        self.warmup_steps = warmup_steps
        self.start_lr = start_lr
        self.end_lr = end_lr
        super().__init__(start_lr, last_epoch, verbose)

    def get_lr(self):
        if self.last_epoch < self.warmup_steps:
            return (self.start_lr + (self.end_lr - self.start_lr)
                    * self.last_epoch / self.warmup_steps)
        if self.lr_sched is not None:
            self.lr_sched.step(self.last_epoch - self.warmup_steps)
            return self.lr_sched.last_lr
        return self.target


class ExponentialDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.gamma**self.last_epoch


class MultiStepDecay(LRScheduler):
    def __init__(self, learning_rate, milestones, gamma=0.1, last_epoch=-1,
                 verbose=False):
        self.milestones = list(milestones)
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        n = sum(1 for m in self.milestones if self.last_epoch >= m)
        return self.base_lr * self.gamma**n


class StepDecay(LRScheduler):
    def __init__(self, learning_rate, step_size, gamma=0.1, last_epoch=-1,
                 verbose=False):
        self.step_size = step_size
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.gamma ** (self.last_epoch
                                             // self.step_size)


class LambdaDecay(LRScheduler):
    def __init__(self, learning_rate, lr_lambda, last_epoch=-1,
                 verbose=False):
        self.lr_lambda = lr_lambda
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.lr_lambda(self.last_epoch)


class CosineAnnealingDecay(LRScheduler):
    def __init__(self, learning_rate, T_max, eta_min=0, last_epoch=-1,
                 verbose=False):
        self.T_max = T_max
        self.eta_min = eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return (self.eta_min + (self.base_lr - self.eta_min)
                * (1 + math.cos(math.pi * self.last_epoch / self.T_max)) / 2)


class ReduceOnPlateau(LRScheduler):
    """Multiply the rate by ``factor`` once the metric passed to
    ``step(metrics)`` has not improved for more than ``patience`` steps;
    ``step()`` without a metric does nothing."""

    def __init__(self, learning_rate, mode="min", factor=0.1, patience=10,
                 threshold=1e-4, threshold_mode="rel", cooldown=0, min_lr=0,
                 epsilon=1e-8, verbose=False):
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.best = None
        self.num_bad = 0
        self.cooldown_counter = 0
        self.base_lr = float(learning_rate)
        self.last_lr = float(learning_rate)
        self.last_epoch = 0
        self.verbose = verbose

    def get_lr(self):
        return self.last_lr

    def step(self, metrics=None, epoch=None):
        if metrics is None:
            return
        v = float(metrics.item() if hasattr(metrics, "item") else metrics)
        if self.best is None or self._better(v, self.best):
            self.best = v
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad = 0
        if self.num_bad > self.patience:
            self.last_lr = max(self.last_lr * self.factor, self.min_lr)
            self.cooldown_counter = self.cooldown
            self.num_bad = 0

    def _better(self, a, b):
        rel = self.threshold_mode == "rel"
        if self.mode == "min":
            return a < b - (abs(b) * self.threshold if rel
                            else self.threshold)
        return a > b + (abs(b) * self.threshold if rel else self.threshold)


class OneCycleLR(LRScheduler):
    def __init__(self, max_learning_rate, total_steps, divide_factor=25.0,
                 end_learning_rate=0.0001, phase_pct=0.3,
                 anneal_strategy="cos", three_phase=False, last_epoch=-1,
                 verbose=False):
        self.max_lr = max_learning_rate
        self.total_steps = total_steps
        self.initial_lr = max_learning_rate / divide_factor
        self.end_lr = end_learning_rate
        self.phase_pct = phase_pct
        super().__init__(self.initial_lr, last_epoch, verbose)

    def get_lr(self):
        up = int(self.total_steps * self.phase_pct)
        step = min(self.last_epoch, self.total_steps)
        if step <= up:
            pct = step / max(1, up)
            return (self.initial_lr + (self.max_lr - self.initial_lr)
                    * (1 - math.cos(math.pi * pct)) / 2)
        pct = (step - up) / max(1, self.total_steps - up)
        return (self.end_lr + (self.max_lr - self.end_lr)
                * (1 + math.cos(math.pi * pct)) / 2)


class CyclicLR(LRScheduler):
    def __init__(self, base_learning_rate, max_learning_rate, step_size_up,
                 step_size_down=None, mode="triangular", last_epoch=-1,
                 verbose=False, **kw):
        self.max_lr = max_learning_rate
        self.up = step_size_up
        self.down = step_size_down or step_size_up
        self.mode = mode
        super().__init__(base_learning_rate, last_epoch, verbose)

    def get_lr(self):
        cycle_len = self.up + self.down
        pos = self.last_epoch % cycle_len
        if pos < self.up:
            pct = pos / self.up
        else:
            pct = 1 - (pos - self.up) / self.down
        scale = 1.0
        if self.mode == "triangular2":
            scale = 0.5 ** (self.last_epoch // cycle_len)
        return self.base_lr + (self.max_lr - self.base_lr) * pct * scale


class MultiplicativeDecay(LRScheduler):
    """``lr = lr * lr_lambda(epoch)``, the factors applied cumulatively and
    each epoch's evaluated once."""

    def __init__(self, learning_rate, lr_lambda, last_epoch=-1,
                 verbose=False):
        self.lr_lambda = lr_lambda
        self._cum = {0: 1.0}  # epoch -> product of factors through epoch
        super().__init__(learning_rate, last_epoch, verbose)

    def _cum_factor(self, epoch):
        if epoch in self._cum:
            return self._cum[epoch]
        top = max(self._cum)
        prod = self._cum[top]
        for e in range(top + 1, epoch + 1):
            prod *= self.lr_lambda(e)
            self._cum[e] = prod
        return prod

    def get_lr(self):
        return self.base_lr * self._cum_factor(max(self.last_epoch, 0))
