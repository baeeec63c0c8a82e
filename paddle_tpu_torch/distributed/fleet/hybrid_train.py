"""The hybrid-parallel training step — the port of
``paddle_tpu/distributed/fleet/hybrid_train.py`` (``HybridParallelModel``,
``hybrid_train_step``).

The reference builds one GSPMD program a step: the batch split over the
data and sharding axes, the model-parallel weights split by their specs,
ZeRO as sharded optimizer slots, every collective XLA's. Its result is
the unsharded model's step. The port runs one eager step a call on each
rank, which computes the same thing across processes:

1. the batch is cut to this rank's rows (the data x sharding ranks split
   it, in the reference's order);
2. the forward (under ``strategy.amp``'s ``auto_cast`` at its level, in
   bfloat16 as the reference's step; ``strategy.recompute`` wraps the
   blocks with ``fleet.recompute.apply_recompute`` first), drawing its
   dropout keys under ``trace_rng_scope`` of one key a step with the
   rank's ``ShardWindow`` (its rows of the batch and, under model
   parallelism, its heads: each mask is this rank's slice of the
   reference's one mask over the whole tensor), and the loss: the
   model's own loss where it takes ``labels`` and no ``loss_fn`` is
   given (the GPT: under model parallelism the
   vocab-parallel cross-entropy), else ``loss_fn(outputs, *labels)``;
3. the backward; the model-parallel collectives are in the layers
   (``meta_parallel.shard_model``);
4. with ``sync_whole`` (auto-parallel's Engine), the model group's
   average of the gradient of every parameter it holds whole: a layer
   kept whole runs on every model rank, and a replicated computation is
   not bit-identical across ranks (the flash backward sums dq in no
   fixed order), so without it the copies would drift apart; then the
   data-parallel average of every gradient (``parallel.average_gradients``,
   in buckets), or ZeRO's reduce (``sharding.ZeroOptimizer``);
5. the clip, where the optimizer has a ``ClipGradByGlobalNorm``: the norm
   of the whole model (``HybridNorm``: each rank's partial sums of
   squares summed over its model, pipeline and sharding groups between
   the kernel's two launches; a parameter split over the model group is
   counted on every model rank, one replicated across it only on model
   rank 0);
6. the inner optimizer's update (ZeRO: on this rank's pieces, then the
   all-gather).

As in the reference, ``train_batch`` updates with the innermost optimizer:
the reference's step calls ``functional_update``, which a meta-optimizer
passes through to the optimizer it wraps, so ``strategy.gradient_merge``
and the other meta-optimizers act in ``HybridParallelOptimizer.step``, not
here. The returned loss is the global batch's mean (the ranks' means
averaged over the batch ranks). The reference's mesh helpers
(``maybe_shard``, ``mesh_scope``, ``_zero_spec``) place arrays on a
device mesh and have no counterpart.
"""
from __future__ import annotations

import contextlib
import inspect

import torch

from ...core import rng as rng_mod
from .. import collective as C
from ..parallel import average_gradients

__all__ = ["HybridParallelModel", "hybrid_train_step", "HybridNorm",
           "unwrap_optimizer", "batch_slice"]


def unwrap_optimizer(optimizer):
    """The optimizer that updates: through ``HybridParallelOptimizer``
    (``_inner_opt``) and the meta-optimizers (``inner``)."""
    opt = getattr(optimizer, "_inner_opt", optimizer)
    while hasattr(opt, "inner") and not hasattr(opt, "_params"):
        opt = opt.inner
    return opt


def batch_slice(t, rank: int, n: int):
    """Rows ``[rank * b / n, (rank + 1) * b / n)`` of ``t``."""
    b = t.shape[0]
    if b % n:
        raise ValueError(f"batch {b} does not split over {n} ranks")
    k = b // n
    return t[rank * k:(rank + 1) * k]


class HybridNorm:
    """The hybrid-parallel global norm's ``reduce`` hook
    (``kernels.global_norm``): ``HybridNorm(hcg, sharded)(params)`` gives
    the hook for one step's parameters. ``sharded``: the parameters are
    ZeRO pieces, whose partial sums are summed over the sharding group
    too."""

    def __init__(self, hcg, sharded: bool = False):
        self.mp = hcg.get_model_parallel_group()
        self.mp_rank = hcg.get_model_parallel_rank()
        others = [hcg.get_pipe_parallel_group()]
        if sharded:
            others.append(hcg.get_sharding_parallel_group())
        self.others = [g for g in others if g is not None and g.nranks > 1]
        self._lengths: dict = {}
        self._masks: dict = {}

    def __call__(self, params):
        counted = tuple(self.mp is None or self.mp.nranks == 1
                        or self.mp_rank == 0
                        or bool(getattr(p, "_mp_split", False))
                        for p in params)

        def reduce(partials, ranges):
            if not all(counted):
                partials = partials * self._mask(partials, ranges, counted)
            if self.mp is not None and self.mp.nranks > 1:
                C.all_reduce(partials, group=self.mp)
            if not self.others:
                return partials
            n = partials.numel()
            length = self._lengths.get(n)
            if length is None:
                size = torch.tensor([n], dtype=torch.float32,
                                    device=partials.device)
                for g in self.others:
                    C.all_reduce(size, op=C.ReduceOp.MAX, group=g)
                length = self._lengths[n] = int(size.item())
            padded = torch.zeros(length, dtype=partials.dtype,
                                 device=partials.device)
            padded[:n] = partials
            for g in self.others:
                C.all_reduce(padded, group=g)
            return padded

        return reduce

    def _mask(self, partials, ranges, counted):
        key = (partials.numel(), counted)
        m = self._masks.get(key)
        if m is None:
            m = torch.ones(partials.numel(), dtype=partials.dtype)
            for (lo, hi), c in zip(ranges, counted):
                if not c:
                    m[lo:hi] = 0
            m = self._masks[key] = m.to(partials.device)
        return m


def _takes_labels(model) -> bool:
    model = getattr(model, "_layers", model)   # through a ZeRO wrapper
    try:
        return "labels" in inspect.signature(model.forward).parameters
    except (TypeError, ValueError):
        return False


class HybridParallelModel:
    """What ``fleet.distributed_model`` returns outside pipeline mode:
    ``train_batch([inputs..., labels...], optimizer)`` runs one hybrid
    step (module docstring). The model is cut for model parallelism when
    wrapped (``meta_parallel.shard_model``, where the model-parallel
    degree is above 1)."""

    def __init__(self, model, hcg, strategy, optimizer=None, loss_fn=None,
                 sync_whole=False):
        from .meta_parallel import shard_model

        self._model = model
        self._hcg = hcg
        self._strategy = strategy
        self._optimizer = optimizer
        self._loss_fn = loss_fn
        self.training = True
        self._zero = None
        mp = hcg.get_model_parallel_group()
        if mp is not None and mp.nranks > 1:
            shard_model(model, mp)
        self._whole_group = mp if sync_whole and mp is not None and \
            mp.nranks > 1 else None
        if strategy.recompute:
            from .recompute import apply_recompute

            cfg = strategy.recompute_configs or {}
            if apply_recompute(model, checkpoints=cfg.get("checkpoints"),
                               policy=cfg.get("policy")) == 0:
                raise ValueError(
                    f"recompute=True but no sublayer matched "
                    f"recompute_configs={cfg!r}: nothing would be "
                    f"rematerialized")
        self._n_inputs = getattr(model, "_n_inputs", 1)
        self._labels_kw = _takes_labels(model)
        # an attention whose fused projection stayed whole (an
        # auto-parallel layout) holds every head on each model rank
        self._heads_whole = any(
            getattr(getattr(m, "qkv_proj", None), "weight", None) is not None
            and not getattr(m.qkv_proj.weight, "_mp_split", False)
            for m in model.modules())

    def __call__(self, *a, **k):
        return self._model(*a, **k)

    def __getattr__(self, name):
        return getattr(self.__dict__["_model"], name)

    def _zero_stage(self) -> int:
        zero = getattr(self._model, "_zero_stage", 0)
        inner = getattr(self._model, "_layers", None)
        zero = max(zero, getattr(inner, "_zero_stage", 0))
        if self._strategy.sharding:
            zero = max(zero, int(self._strategy.sharding_configs.get(
                "stage", 1)))
        sharding = self._hcg.get_sharding_parallel_group()
        return zero if sharding is not None and sharding.nranks > 1 else 0

    def _amp(self):
        if not self._strategy.amp:
            return contextlib.nullcontext()
        from ...amp import auto_cast

        level = self._strategy.amp_configs.get("level", "O1")
        return auto_cast(True, level=level, dtype="bfloat16")

    def _setup(self, opt):
        clip = getattr(opt, "_grad_clip", None)
        zero = self._zero_stage()
        if zero and self._zero is None:
            from ..sharding import ZeroOptimizer

            self._zero = ZeroOptimizer(
                opt, self._hcg.get_sharding_parallel_group(), zero,
                self._hcg.get_data_parallel_group())
        if clip is not None and hasattr(clip, "hybrid"):
            clip.hybrid = HybridNorm(self._hcg, sharded=bool(zero))

    def _window(self, rank: int, n: int):
        """This rank's slice of the tensors the reference masks whole: its
        rows among the ``n`` batch ranks, its heads among the model
        ranks (the attention output; the hidden states are replicated
        over them)."""
        mp = self._hcg.get_model_parallel_group()
        heads = None if mp is None or mp.nranks == 1 or \
            self._heads_whole else \
            (self._hcg.get_model_parallel_rank(), mp.nranks)
        if n == 1 and heads is None:
            return None
        return rng_mod.ShardWindow(rows=(rank, n), heads=heads)

    def train_batch(self, data, optimizer=None, lr=None, loss_fn=None,
                    key=None):
        """One step on ``data`` (the whole batch); ``key``: the step's
        dropout key (two words; default the next of ``core.rng``)."""
        optimizer = optimizer or self._optimizer
        opt = unwrap_optimizer(optimizer)
        loss_fn = loss_fn or self._loss_fn
        self._setup(opt)
        if self._zero is not None:
            self._zero.gather_params()
        rank, n = self._hcg.get_batch_rank()
        dev = next(iter(self._model.parameters())).device
        data = [batch_slice(torch.as_tensor(d).to(dev), rank, n)
                for d in data]
        inputs, labels = data[:self._n_inputs], data[self._n_inputs:]
        key = rng_mod.next_rng_key() if key is None else key
        with rng_mod.trace_rng_scope(key, self._window(rank, n)), \
                self._amp():
            if loss_fn is None and self._labels_kw:
                loss = getattr(self._model, "_layers", self._model)(
                    *inputs, labels=labels[0])
            else:
                out = self._model(*inputs)
                outs = list(out) if isinstance(out, (tuple, list)) else [out]
                loss = (loss_fn or _default_loss)(*outs, *labels)
        if loss.dim() > 0:
            loss = loss.mean()
        loss.backward()
        if self._whole_group is not None:
            average_gradients(
                [p for _, p in opt._params if p.grad is not None
                 and not getattr(p, "_mp_split", False)],
                self._whole_group, self._strategy.fuse_grad_size_in_MB)
        if lr is not None:
            opt.set_lr(float(lr))
        if self._zero is not None:
            self._zero.step()
        else:
            params = [p for _, p in opt._params]
            if self._hcg.get_batch_group() is not None:
                average_gradients(params, self._hcg.get_batch_group(),
                                  self._strategy.fuse_grad_size_in_MB)
            opt.step()
            opt.clear_grad()
        loss = loss.detach().float().clone()
        batch = self._hcg.get_batch_group()
        if batch is not None and batch.nranks > 1:
            C.all_reduce(loss, op=C.ReduceOp.AVG, group=batch)
        return loss

    def sync_params_to_layer(self):
        """The reference syncs its step's arrays into the layer; the
        port's layer is the step's own, which stage 3 of ZeRO gathers."""
        if self._zero is not None:
            self._zero.gather_params()

    def state_dict(self, *a, **k):
        self.sync_params_to_layer()
        return self._model.state_dict(*a, **k)

    def set_state_dict(self, sd, *a, **k):
        self.sync_params_to_layer()
        return self._model.set_state_dict(sd, *a, **k)

    def parameters(self, *a, **k):
        return self._model.parameters(*a, **k)

    def eval(self):
        self.training = False
        self._model.eval()
        return self

    def train(self):
        self.training = True
        self._model.train()
        return self


def _default_loss(out, label):
    from ...nn import functional as F

    return F.cross_entropy(out, label)


def hybrid_train_step(model, optimizer, loss_fn=None, hcg=None,
                      strategy=None):
    """A ``train_step(data)`` closure over a ``HybridParallelModel`` of
    ``model`` (``hcg`` / ``strategy``: fleet's, by default)."""
    from .fleet_base import fleet

    dm = HybridParallelModel(model, hcg or fleet._hcg,
                             strategy or fleet._user_defined_strategy,
                             optimizer=optimizer, loss_fn=loss_fn)
    return lambda data: dm.train_batch(data)
