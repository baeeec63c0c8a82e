"""Meta-optimizers chosen by ``DistributedStrategy`` — the port of
``paddle_tpu/distributed/fleet/meta_optimizers.py``
(``GradientMergeOptimizer``, ``LocalSGDOptimizer``,
``DGCMomentumOptimizer``, ``StrategyCompiler``, ``create_meta_optimizer``).

Each wraps an optimizer and changes its step, as the reference's do,
composed in the reference's order: gradient transforms (DGC), then
accumulation (gradient merge), then the inner optimizer (swapped for
LAMB or LARS by their switches), then periodic averaging (LocalSGD).
The reference's single controller holds each parameter once, so its
cross-rank reductions apply only "with real per-process ranks"; the
port's ranks are processes, so LocalSGD averages the parameters and DGC
averages the sparsified gradients over ``group`` (None: the whole
process group) whenever a process group of several ranks exists.
"""
from __future__ import annotations

import warnings

import torch

from .. import collective as C
from .. import env as env_mod

__all__ = ["GradientMergeOptimizer", "LocalSGDOptimizer",
           "DGCMomentumOptimizer", "StrategyCompiler",
           "create_meta_optimizer"]


def _params(opt):
    """The parameters an optimizer (or a meta-optimizer) updates."""
    while not hasattr(opt, "_params"):
        opt = opt.inner
    return [p for _, p in opt._params]


def _multi_rank(group) -> bool:
    return env_mod.is_initialized() and C._group(group).nranks > 1


class _MetaOptimizerBase:
    def __init__(self, inner):
        self.inner = inner

    def __getattr__(self, name):
        return getattr(self.__dict__["inner"], name)

    @property
    def _parameter_list(self):
        return _params(self.inner)

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        # through this wrapper's step(): the inner minimize would skip it
        loss.backward()
        self.step()
        self.clear_grad()
        return [], []

    def clear_grad(self, *a, **k):
        self.inner.clear_grad()

    clear_gradients = clear_grad


class GradientMergeOptimizer(_MetaOptimizerBase):
    """Accumulate ``k_steps`` steps' gradients, then update once with
    their sum (their mean with ``avg``)."""

    def __init__(self, inner, k_steps=1, avg=True):
        super().__init__(inner)
        self.k_steps = int(k_steps)
        self.avg = avg
        self._acc: dict[int, torch.Tensor] = {}
        self._count = 0

    @torch.no_grad()
    def step(self):
        self._count += 1
        params = [p for p in self._parameter_list if p.grad is not None]
        for p in params:
            acc = self._acc.get(id(p))
            self._acc[id(p)] = p.grad.clone() if acc is None \
                else acc + p.grad
        if self._count < self.k_steps:
            for p in params:    # the inner optimizer does not run
                p.grad = None
            return
        scale = 1.0 / self.k_steps if self.avg else 1.0
        for p in self._parameter_list:
            if id(p) in self._acc:
                p.grad = self._acc[id(p)] * scale
        self.inner.step()
        self._acc.clear()
        self._count = 0


class LocalSGDOptimizer(_MetaOptimizerBase):
    """The inner optimizer's steps, and every ``k_steps`` the parameters
    averaged over ``group``."""

    def __init__(self, inner, k_steps=1, group=None):
        super().__init__(inner)
        self.k_steps = int(k_steps)
        self.group = group
        self._count = 0

    def step(self):
        self.inner.step()
        self._count += 1
        if self._count % self.k_steps == 0:
            self._average_params()

    @torch.no_grad()
    def _average_params(self):
        if not _multi_rank(self.group):
            return
        for p in self._parameter_list:
            C.all_reduce(p.data, op=C.ReduceOp.AVG, group=self.group)


class DGCMomentumOptimizer(_MetaOptimizerBase):
    """Deep gradient compression: each gradient's momentum-corrected,
    error-fed top ``1 - sparsity`` share is sent (the rest kept for later
    steps) from the step after ``rampup_begin_step`` on, averaged over
    ``group``, then the inner optimizer steps."""

    def __init__(self, inner, rampup_begin_step=0, sparsity=0.999,
                 group=None):
        super().__init__(inner)
        self.begin = int(rampup_begin_step)
        self.sparsity = float(sparsity)
        self.group = group
        self._u: dict[int, torch.Tensor] = {}  # momentum correction
        self._v: dict[int, torch.Tensor] = {}  # error feedback
        self._step_idx = 0

    def _compress(self, p):
        g = p.grad
        u, v = self._u.get(id(p)), self._v.get(id(p))
        u = g if u is None else 0.9 * u + g
        v = u if v is None else v + u
        flat = v.abs().reshape(-1)
        k = max(1, int(flat.numel() * (1.0 - self.sparsity)))
        thresh = torch.sort(flat).values[-k]
        mask = v.abs() >= thresh
        sent = torch.where(mask, v, torch.zeros_like(v))
        self._v[id(p)] = v - sent
        self._u[id(p)] = torch.where(mask, torch.zeros_like(u), u)
        return sent

    @torch.no_grad()
    def step(self):
        self._step_idx += 1
        if self._step_idx > self.begin:
            for p in self._parameter_list:
                if p.grad is not None:
                    p.grad = self._compress(p)
            if _multi_rank(self.group):
                for p in self._parameter_list:
                    if p.grad is not None:
                        C.all_reduce(p.grad, op=C.ReduceOp.AVG,
                                     group=self.group)
        self.inner.step()


class StrategyCompiler:
    """Which meta-optimizers a strategy turns on, the exclusions between
    them (the winner keeps its switch, the loser is disabled with a
    warning), and the switches that have no effect, warned of."""

    EXCLUSIONS = [("lamb", "lars"), ("dgc", "localsgd")]
    META_FLAGS = ("lamb", "lars", "dgc", "gradient_merge", "localsgd")
    # honoured elsewhere: amp / recompute / sharding in the hybrid step,
    # pipeline in PipelineParallel, tensor parallelism in meta_parallel
    ROUTED_FLAGS = ("amp", "recompute", "sharding", "pipeline",
                    "tensor_parallel", "sequence_parallel", "a_sync",
                    "fuse_all_reduce_ops", "sync_batch_norm")
    UNWIRED_FLAGS = {
        "fp16_allreduce": "the gradients are reduced in their own dtype",
        "heter_ccl_mode": "heterogeneous (CPU+GPU) clusters are out of "
                          "scope",
        "find_unused_parameters": "every rank's gradients come from the "
                                  "same graph; a parameter without one "
                                  "is skipped on every rank alike",
    }

    def compile(self, strategy):
        flags = {f: bool(getattr(strategy, f, False)) for f in self.META_FLAGS}
        disabled = []
        for winner, loser in self.EXCLUSIONS:
            if flags.get(winner) and flags.get(loser):
                warnings.warn(
                    f"strategy.{loser} conflicts with strategy.{winner}; "
                    f"disabling {loser} (strategy_compiler exclusion)",
                    stacklevel=3)
                flags[loser] = False
                disabled.append(loser)
        for f, why in self.UNWIRED_FLAGS.items():
            if getattr(strategy, f, False):
                warnings.warn(f"strategy.{f} has no effect: {why}",
                              stacklevel=3)
                disabled.append(f)
        applied = [f for f in self.META_FLAGS if flags[f]]
        return flags, applied, disabled


def create_meta_optimizer(optimizer, strategy, group=None):
    """``optimizer`` wrapped in the meta-optimizers ``strategy`` turns on,
    in the reference's order; ``_meta_report`` names the applied and the
    disabled ones."""
    from ...optimizer.optimizers import Lamb, LarsMomentum

    flags, applied, disabled = StrategyCompiler().compile(strategy)
    opt = optimizer
    params = getattr(optimizer, "_params", None)
    lr = optimizer.get_lr() if hasattr(optimizer, "get_lr") else 1e-3
    if flags["lamb"] and not isinstance(opt, Lamb):
        opt = Lamb(learning_rate=lr, parameters=params)
    elif flags["lars"] and not isinstance(opt, LarsMomentum):
        opt = LarsMomentum(learning_rate=lr, parameters=params)
    if flags["dgc"]:
        cfg = getattr(strategy, "dgc_configs", {}) or {}
        sp = cfg.get("sparsity", 0.999)
        opt = DGCMomentumOptimizer(
            opt, rampup_begin_step=cfg.get("rampup_begin_step", 0),
            sparsity=sp[0] if isinstance(sp, list) else sp, group=group)
    if flags["gradient_merge"]:
        cfg = strategy.gradient_merge_configs
        opt = GradientMergeOptimizer(opt, k_steps=cfg.get("k_steps", 1),
                                     avg=cfg.get("avg", True))
    if flags["localsgd"]:
        cfg = getattr(strategy, "localsgd_configs", {}) or {}
        opt = LocalSGDOptimizer(opt, k_steps=cfg.get("k_steps", 1),
                                group=group)
    opt._meta_report = {"applied": applied, "disabled": disabled}
    return opt
