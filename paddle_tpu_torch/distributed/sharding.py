"""ZeRO sharding — the port of ``paddle_tpu/distributed/sharding.py``
(``group_sharded_parallel``, ``save_group_sharded_model``) and of the
ZeRO stages of the reference's hybrid step.

The reference's stages are sharding specs that XLA honours; the result
of a step is the unsharded step's. The port partitions for real, over
the sharding group (``ZeroOptimizer``):

- the model's (this rank's model-parallel) parameters, in order, form one
  flat vector padded to n equal chunks; rank r owns chunk r. The owned
  range is cut at parameter boundaries into pieces, each a float32
  master (a view of one owned buffer) with its parameter's name,
  learning-rate multiplier and decay, and the user's optimizer, copied,
  updates those pieces alone: 1/n of the optimizer state a rank, and on
  the card one fused Adam launch over them;
- level ``os``: the gradients are averaged over the batch ranks by
  all-reduce, each rank reads its chunk; ``os_g``: they are
  reduce-scattered over the sharding group (after a sum over the data
  group when there is one), each rank receiving its chunk only;
  ``p_g_os``: as ``os_g``, and between steps a rank keeps only its chunk
  of the parameters, which are all-gathered at the start of the next
  step (``gather_params``) and released after its update;
- after the update every rank all-gathers the chunks (in the parameters'
  dtype) into the full parameters.

A global-norm clip sees the pieces: each rank's partial sums are summed
over the sharding group (and the model and pipeline groups), so the norm
is the whole model's, each element counted once.
"""
from __future__ import annotations

import copy

import torch

from ..nn.layer import Layer
from . import collective as C

__all__ = ["group_sharded_parallel", "save_group_sharded_model",
           "ZeroOptimizer", "ZERO_STAGE"]

#: the reference's level names and the stage each is
ZERO_STAGE = {"os": 1, "os_g": 2, "p_g_os": 3}


class _ShardedModel(Layer):
    def __init__(self, layer, level, group):
        super().__init__()
        self._layers = layer
        self._level = level
        self._group = group
        layer._zero_stage = ZERO_STAGE[level]

    def forward(self, *a, **k):
        return self._layers(*a, **k)

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def set_state_dict(self, sd, *a, **k):
        return self._layers.set_state_dict(sd, *a, **k)


def group_sharded_parallel(model, optimizer, level="os_g", scaler=None,
                           group=None, offload=False, sync_buffers=False,
                           buffer_max_size=2 ** 23, segment_size=2 ** 20,
                           sync_comm=False):
    """Mark ``model`` and ``optimizer`` for ZeRO at ``level`` (``os``,
    ``os_g``, ``p_g_os``); ``fleet.distributed_model`` runs the stage."""
    if level not in ZERO_STAGE:
        raise ValueError(f"level {level!r} not in {tuple(ZERO_STAGE)}")
    wrapped = _ShardedModel(model, level, group)
    optimizer._zero_stage = ZERO_STAGE[level]
    if scaler is not None:
        return wrapped, optimizer, scaler
    return wrapped, optimizer


def save_group_sharded_model(model, output, optimizer=None):
    """The model's (and the optimizer's) state to ``output + ".pdmodel"``
    (``".pdopt"``), the reference's files."""
    from ..framework.io import save

    inner = model._layers if isinstance(model, _ShardedModel) else model
    save(inner.state_dict(), output + ".pdmodel")
    if optimizer is not None:
        save(optimizer.state_dict(), output + ".pdopt")


class ZeroOptimizer:
    """Stage ``stage`` (1-3) of ZeRO over ``group`` (the sharding group)
    for ``optimizer`` (an ``optimizer.Optimizer`` over the model's
    parameters); ``dp_group``: the data-parallel group beside it (None or
    one rank: none)."""

    def __init__(self, optimizer, group, stage: int, dp_group=None):
        self.group = C._group(group)
        self.dp = None if dp_group is None or C._group(dp_group).nranks == 1 \
            else C._group(dp_group)
        self.stage = int(stage)
        self.params = [p for _, p in optimizer._params]
        n, r = self.group.nranks, self.group.rank
        sizes = [p.numel() for p in self.params]
        total = sum(sizes)
        self.chunk = -(-total // n)
        lo, hi = r * self.chunk, (r + 1) * self.chunk
        dev = self.params[0].device
        self.master = torch.zeros(self.chunk, dtype=torch.float32, device=dev)
        self.pieces = []   # (param, start in param, stop, start in chunk)
        inner_params, names = [], {}
        off = 0
        for (key, p), size in zip(optimizer._params, sizes):
            a, b = max(lo, off), min(hi, off + size)
            if a < b:
                piece = self.master[a - lo:b - lo]
                piece.copy_(p.detach().reshape(-1)[a - off:b - off].float())
                for attr in ("optimize_attr", "regularizer", "_mp_split"):
                    if hasattr(p, attr):
                        setattr(piece, attr, getattr(p, attr))
                self.pieces.append((p, a - off, b - off, a - lo))
                inner_params.append((key, piece))
                names[key] = optimizer._names[key]
            off += size
        # the user's optimizer, over this rank's pieces (float32 masters)
        self.inner = copy.copy(optimizer)
        self.inner._params = inner_params
        self.inner._names = names
        self.inner.state = {}
        self.inner._multi_precision = False
        self.shapes = [p.shape for p in self.params]
        self.released = False

    def state_bytes(self) -> int:
        """Bytes of optimizer state this rank holds (its masters
        included)."""
        st = sum(t.numel() * t.element_size()
                 for s in self.inner.state.values() for t in s.values()
                 if isinstance(t, torch.Tensor))
        return st + self.master.numel() * 4

    def _grads(self):
        """This rank's chunk of the averaged flat gradient."""
        n = self.group.nranks
        dtype = next(p.grad.dtype for p in self.params if p.grad is not None)
        flat = torch.zeros(self.chunk * n, dtype=dtype,
                           device=self.master.device)
        off = 0
        for p in self.params:
            if p.grad is not None:
                flat[off:off + p.numel()] = p.grad.reshape(-1)
            off += p.numel()
        batch = n * (1 if self.dp is None else self.dp.nranks)
        if self.dp is not None:
            C.all_reduce(flat, group=self.dp)
        if self.stage == 1:
            C.all_reduce(flat, group=self.group)
            mine = flat[self.group.rank * self.chunk:
                        (self.group.rank + 1) * self.chunk]
        else:
            mine = torch.empty(self.chunk, dtype=dtype,
                               device=self.master.device)
            C.reduce_scatter(mine, flat, group=self.group)
        return mine.div_(batch)

    @torch.no_grad()
    def step(self):
        mine = self._grads()
        for (_, piece), (p, a, b, c) in zip(self.inner._params, self.pieces):
            piece.grad = mine[c:c + (b - a)]
        self.inner.step()
        for _, piece in self.inner._params:
            piece.grad = None
        for p in self.params:
            p.grad = None
        self._all_gather()
        if self.stage >= 3:
            self.release_params()

    def _all_gather(self):
        """Every rank's updated chunk, in the parameters' dtype, into the
        full parameters."""
        mine = self.master.to(self.params[0].dtype)
        full = C.all_gather(None, mine, group=self.group).reshape(-1)
        off = 0
        for p, shape in zip(self.params, self.shapes):
            n = shape.numel()
            if self.released:
                p.data = full[off:off + n].view(shape)
            else:
                p.data.copy_(full[off:off + n].view(shape))
            off += n

    def release_params(self):
        """Keep only this rank's chunk (stage 3, between steps)."""
        for p in self.params:
            p.data = torch.empty(0, dtype=p.dtype, device=p.device)
        self.released = True

    def gather_params(self):
        """The full parameters back from every rank's chunk (stage 3,
        before the forward)."""
        if self.released:
            self._all_gather()
            self.released = False
