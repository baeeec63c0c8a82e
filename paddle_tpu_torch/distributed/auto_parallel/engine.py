"""Engine — the port of ``paddle_tpu/distributed/auto_parallel/engine.py``:
annotate, plan, complete, partition, train (``prepare``, ``fit``,
``evaluate``, ``predict``, ``save``, ``load``).

The reference compiles one GSPMD step (``build_hybrid_step``) over the
planned mesh. The port runs on every rank of a ``torch.distributed``
process group (one process, no group: a mesh of one) and builds
``fleet``'s ``HybridParallelModel`` over the mesh's topology
(``ProcessMesh.topology``):

1. the mesh: the given one, or ``plan_mesh(world_size, n_params)``;
2. ZeRO from ``strategy.sharding``, or stage 1 where the mesh has a
   ``sharding`` dim above 1 (the planner's memory decision); ``amp`` and
   ``recompute`` from the strategy;
3. completion of the user's ``shard_tensor`` annotations
   (``complete_param_specs``, when ``inputs_spec`` is given), then
   ``_annotate_default_mp`` for what is left when ``mp`` is above 1, then
   the ``Partitioner``'s checks;
4. each spec the partitioner keeps is realised one of two ways, which
   ``layout`` (``{name: "column" | "row" | "vocab" | "whole"}``) says:
   cut for real by ``meta_parallel.shard_model`` (a Linear split on its
   output features whose parent also holds a Linear split on its input
   features, and that one: the Megatron pairs; a vocab-split
   embedding; the fleet's parallel layers), or held whole on the model
   ranks (any other spec, such as a LayerNorm weight split over ``mp``,
   or a Linear whose partner is not split the other way: GSPMD would
   gather those before use). The step's losses and parameters are the
   unsharded step's either way; the gradient of every whole parameter
   is averaged over the model group (``sync_whole``), so that its copies
   stay bit-identical across the model ranks.

Every rank passes the whole batch; the data ranks each take their rows.
``fit``'s key for step ``k`` is ``fold_in(key, k)`` of one key drawn as
the reference draws it (``np.random.randint``) and broadcast from rank 0,
through ``core.rng``'s words. ``evaluate`` and ``predict`` run every
batch whole on every rank, in eval mode; ``save`` writes the whole model
(``checkpoint.full_state_dict``) from rank 0 through ``framework.io``
(``state.pdparams``); ``load`` reads it back into this rank's pieces.
"""
from __future__ import annotations

import copy

import numpy as np
import torch

from ...core import rng as rng_mod
from .. import collective as coll
from .. import env as env_mod
from ..fleet.distributed_strategy import DistributedStrategy
from .completion import reference_layout
from .planner import plan_mesh
from .process_mesh import ProcessMesh

__all__ = ["Engine"]


def _to_tensors(data) -> list:
    items = data if isinstance(data, (list, tuple)) else [data]
    return [d if isinstance(d, torch.Tensor)
            else torch.as_tensor(np.asarray(d)) for d in items]


def _is_linear(mod) -> bool:
    from ... import nn
    from ..fleet.meta_parallel import ColumnParallelLinear, RowParallelLinear

    return isinstance(mod, (torch.nn.Linear, nn.Linear, ColumnParallelLinear,
                            RowParallelLinear))


def _is_embedding(mod) -> bool:
    from ... import nn
    from ..fleet.meta_parallel import VocabParallelEmbedding

    return isinstance(mod, (torch.nn.Embedding, nn.Embedding,
                            VocabParallelEmbedding))


class Engine:
    def __init__(self, model=None, loss=None, optimizer=None, metrics=None,
                 strategy: DistributedStrategy | None = None,
                 process_mesh: ProcessMesh | None = None):
        self.model = model
        self.loss = loss
        self.optimizer = optimizer
        self.metrics = metrics if isinstance(metrics, (list, tuple)) else (
            [metrics] if metrics else [])
        self.strategy = strategy or DistributedStrategy()
        self.process_mesh = process_mesh
        self.layout: dict = {}
        self._dm = None
        self.history = {"loss": []}

    # ------------------------------------------------------------- planning
    def _plan(self) -> ProcessMesh:
        if self.process_mesh is None:
            n_params = sum(int(np.prod(p.shape))
                           for p in self.model.parameters())
            self.process_mesh = plan_mesh(env_mod.get_world_size(), n_params)
        return self.process_mesh

    def prepare(self, inputs_spec=None, labels_spec=None, mode="train"):
        """Plan the mesh, complete the user's annotations, partition and
        realise them, and build the hybrid step (module docstring).
        ``inputs_spec``: objects with ``shape`` and ``dtype`` (e.g.
        ``static.InputSpec``, arrays, tensors) for the completion's
        trace."""
        from ..fleet.hybrid_train import HybridParallelModel
        from ..topology import HybridCommunicateGroup
        from .completion import complete_param_specs
        from .partitioner import Partitioner

        pm = self._plan()
        strat = self.strategy
        zero = strat.sharding_configs.get("stage", 1) if strat.sharding else 0
        sizes = dict(zip(pm.dim_names, pm.shape))
        # Honor the planner's memory decision: if it chose a sharding/mp degree
        # to make the state fit, the step must actually apply it.
        if zero == 0 and sizes.get("sharding", 1) > 1:
            zero = 1
        params = dict(self.model.named_parameters())
        annotated = any(getattr(p, "_sharding_spec", None) is not None
                        for p in params.values())
        if annotated and inputs_spec is not None:
            example = [torch.zeros(tuple(s.shape), dtype=_torch_dtype(s))
                       for s in inputs_spec]
            complete_param_specs(self.model, example)
        mp = sizes.get("mp", 1)
        if mp > 1:
            self._annotate_default_mp(mp)
        part = Partitioner(pm)
        for name, place in part.partition_params(self.model).items():
            if getattr(params[name], "_sharding_spec", None) is not None:
                params[name]._sharding_spec = place.spec
        self.layout = self._realise(mp)
        eff = copy.deepcopy(strat)
        if zero:
            eff.sharding = True
            eff.sharding_configs = dict(strat.sharding_configs, stage=zero)
        hcg = HybridCommunicateGroup(pm.topology())
        self._dm = HybridParallelModel(self.model, hcg, eff,
                                       optimizer=self.optimizer,
                                       loss_fn=self.loss, sync_whole=True)
        self._check_head()
        return self

    def _annotate_default_mp(self, mp: int):
        """Give unannotated params a default tensor-parallel sharding: split
        the largest mp-divisible dim over 'mp' (in the reference's layout).
        User annotations made via shard_tensor always win."""
        flip = reference_layout(self.model)
        for name, p in self.model.named_parameters():
            if getattr(p, "_sharding_spec", None) is not None or not p.shape:
                continue
            shape = flip(name, tuple(int(s) for s in p.shape))
            dims = [(int(s), i) for i, s in enumerate(shape) if int(s) % mp == 0]
            if not dims:
                continue
            _, axis = max(dims)
            spec = [None] * len(shape)
            spec[axis] = "mp"
            p._sharding_spec = tuple(spec)

    def _realise(self, mp: int) -> dict:
        """Each parameter's layout (module docstring), with the
        ``meta_parallel`` tags (``_mp_dim``, ``_mp_groups``) that
        ``shard_model`` cuts by set on the cut ones and cleared on the
        others."""
        from ..fleet.meta_parallel import (ColumnParallelLinear,
                                           RowParallelLinear)

        mods = dict(self.model.named_modules())
        col, row = (None, "mp"), ("mp", None)

        def spec_of(mod):
            return tuple(getattr(mod.weight, "_sharding_spec", None) or ())

        def parent(mname):
            return mods[mname.rsplit(".", 1)[0]] if "." in mname \
                else self.model

        def linear_kind(mname, mod):
            spec = spec_of(mod)
            if isinstance(mod, ColumnParallelLinear) and spec == col:
                return "column"
            if isinstance(mod, RowParallelLinear) and spec == row:
                return "row"
            if mname.endswith("lm_head") and spec == col and getattr(
                    type(parent(mname)), "takes_mp_group", False):
                return "column"     # the model's vocab-parallel head
            mates = {spec_of(m) for m in parent(mname).children()
                     if _is_linear(m) and m is not mod}
            if spec == col and row in mates:
                return "column"
            if spec == row and col in mates:
                return "row"
            return "whole"

        layout = {}
        for name, p in self.model.named_parameters():
            mname, attr = name.rsplit(".", 1) if "." in name else ("", name)
            mod = mods[mname]
            spec = tuple(getattr(p, "_sharding_spec", None) or ())
            kind = "whole"
            if mp > 1 and "mp" in spec:
                if _is_embedding(mod) and attr == "weight" and spec == row:
                    kind = "vocab"
                elif _is_linear(mod) and attr == "weight":
                    kind = linear_kind(mname, mod)
                elif _is_linear(mod) and attr == "bias" and \
                        spec == ("mp",) and linear_kind(mname, mod) == \
                        "column":
                    kind = "column"
            layout[name] = kind
            if kind == "whole":
                for tag in ("_mp_dim", "_mp_groups"):
                    if hasattr(p, tag):
                        delattr(p, tag)
                continue
            dim = spec.index("mp")
            if p.dim() == 2 and isinstance(mod, torch.nn.Linear):
                dim = 1 - dim      # [out, in]
            p._mp_dim = dim
            p._mp_groups = 3 if "qkv_proj" in name else 1
        return layout

    def _check_head(self):
        """A model that forms its own vocab-parallel head under model
        parallelism (``takes_mp_group``) needs that head cut."""
        for mname, mod in self.model.named_modules():
            if getattr(mod, "_mp_group", None) is None or not getattr(
                    type(mod), "takes_mp_group", False):
                continue
            pre = f"{mname}." if mname else ""
            heads = [n for n in self.layout if n.startswith(pre) and n.endswith(
                ("lm_head.weight", "wte.weight", "word_embeddings.weight"))]
            if heads and all(self.layout[n] == "whole" for n in heads):
                raise ValueError(
                    f"{heads}: the model's head is not split over 'mp'; "
                    f"annotate it ('mp' on the vocabulary)")

    def _loss_fn(self, *args):
        if self.loss is None:
            return args[0]
        return self.loss(*args)

    # ------------------------------------------------------------- training
    def _base_key(self):
        """The run's key, drawn as the reference draws it, broadcast from
        rank 0 so that every rank folds the same one."""
        words = torch.tensor(rng_mod.key_words(
            int(np.random.randint(0, 2**31 - 1))), dtype=torch.int64)
        if env_mod.is_initialized() and env_mod.get_world_size() > 1:
            coll.broadcast(words, src=0)
        return tuple(int(w) for w in words.tolist())

    def fit(self, train_data, epochs=1, batch_size=None, steps_per_epoch=None,
            log_freq=10, verbose=0, n_inputs=1):
        """train_data: an iterable of batches (DataLoader or list of
        (inputs..., labels...) tuples), whole on every rank. n_inputs: how
        many leading arrays of each batch are model inputs (the rest are
        labels)."""
        if self._dm is None:
            self.prepare()
        lr = (self.optimizer.get_lr() if hasattr(self.optimizer, "get_lr")
              else 1e-3)
        key = self._base_key()
        self._dm._n_inputs = n_inputs
        self._dm.train()
        step_idx = 0
        loss = None
        for epoch in range(epochs):
            epoch_steps = 0
            for batch in train_data:
                loss = self._dm.train_batch(
                    _to_tensors(batch), self.optimizer, lr=lr,
                    key=rng_mod.fold_in_words(key, step_idx))
                step_idx += 1
                epoch_steps += 1
                if step_idx % log_freq == 0:
                    self.history["loss"].append(float(loss))
                    if verbose:
                        print(f"epoch {epoch} step {step_idx}: "
                              f"loss={float(loss):.5f}")
                if steps_per_epoch and epoch_steps >= steps_per_epoch:
                    break
        if loss is not None and step_idx % log_freq != 0:
            self.history["loss"].append(float(loss))
        self._dm.sync_params_to_layer()
        return self.history

    # ----------------------------------------------------------- inference
    def _eval_forward(self, arrs, n_inputs=1, labels=None):
        """The model on the whole batch, in eval mode, without a graph:
        its outputs (with ``labels`` and no ``loss``, a model that takes
        them returns its loss)."""
        from ..fleet.hybrid_train import _takes_labels

        if self._dm is None:
            self.prepare()
        self._dm.sync_params_to_layer()
        dev = next(iter(self.model.parameters())).device
        inputs = [a.to(dev) for a in arrs[:n_inputs]]
        self._dm.eval()
        try:
            with torch.no_grad(), self._dm._amp():
                if labels is not None and self.loss is None and \
                        _takes_labels(self.model):
                    return self.model(*inputs, labels=labels[0].to(dev))
                return self.model(*inputs)
        finally:
            self._dm.train()

    def evaluate(self, eval_data, batch_size=None, n_inputs=1, verbose=0):
        results = {}
        losses = []
        for m in self.metrics:
            m.reset()
        for batch in eval_data:
            arrs = _to_tensors(batch)
            labels = arrs[n_inputs:]
            own = self.loss is None and labels and not self.metrics
            out = self._eval_forward(arrs, n_inputs, labels if own else None)
            if own:
                losses.append(float(out))
                continue
            outs = out if isinstance(out, (tuple, list)) else [out]
            dev = outs[0].device
            labels = [t.to(dev) for t in labels]
            if self.loss is not None:
                losses.append(float(self._loss_fn(*(list(outs) + labels))))
            for m in self.metrics:
                m.update(m.compute(outs[0], *labels))
        if losses:
            results["loss"] = float(np.mean(losses))
        for m in self.metrics:
            name = m.name() if callable(getattr(m, "name", None)) else "metric"
            if isinstance(name, (list, tuple)):
                name = name[0]
            results[name] = m.accumulate()
        return results

    def predict(self, test_data, n_inputs=None):
        preds = []
        for batch in test_data:
            arrs = _to_tensors(batch)
            n = len(arrs) if n_inputs is None else n_inputs
            out = self._eval_forward(arrs, n)
            outs = out if isinstance(out, (tuple, list)) else [out]
            preds.append([o.detach().float().cpu().numpy() for o in outs])
        return preds

    # ---------------------------------------------------------- checkpoint
    def save(self, path):
        from ...framework.io import save
        from ..checkpoint import full_state_dict

        target = self.model
        if self._dm is not None:
            self._dm.sync_params_to_layer()
            target = self._dm
        state = full_state_dict(target)
        multi = env_mod.is_initialized() and env_mod.get_world_size() > 1
        if not multi or env_mod.get_rank() == 0:
            save(state, path if path.endswith(".pdparams")
                 else path + ".pdparams")
        if multi:
            env_mod.barrier()

    def load(self, path):
        from ...framework.io import load
        from ..fleet.meta_parallel import model_specs, shard_state_dict

        sd = load(path if path.endswith(".pdparams") else path + ".pdparams",
                  return_numpy=True)
        sd = {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}
        group = getattr(self.model, "_mp_group", None)
        if group is not None and group.nranks > 1:
            sd = shard_state_dict(sd, model_specs(self.model), group.rank,
                                  group.nranks)
        missing, unexpected = self.model.set_state_dict(sd)
        if missing or unexpected:
            raise KeyError(f"{path}: missing {missing}, unexpected "
                           f"{unexpected}")
        if self._dm is not None and self._dm._zero is not None:
            self._dm._zero = None   # its master copy is rebuilt at the next step


def _torch_dtype(spec):
    dt = getattr(spec, "dtype", "float32")
    if isinstance(dt, torch.dtype):
        return dt
    from ...core.dtype import to_torch_dtype

    return to_torch_dtype(np.dtype(dt).name if not isinstance(dt, str)
                          else dt)
