"""Pipeline parallelism with the 1F1B schedule — the port of
``paddle_tpu/distributed/fleet/pipeline_parallel.py``.

The reference is one controller issuing each (stage, micro-batch)
computation to the stage's devices. The port runs a stage a rank: rank
``s`` of the pipeline group keeps stage ``s`` of the ``PipelineLayer``
(the others are dropped), and activations and their gradients cross
between neighbouring stages by ``isend`` / ``irecv``, a send and the
matching receive always posted together so that no pair waits on the
other. Each rank runs the non-interleaved 1F1B order: ``S - s - 1``
warm-up forwards, then one forward and one backward in turn, then the
remaining backwards.

``train_batch(data, optimizer)``: this rank's rows of the batch (the data
ranks split each micro-batch, as the reference's batch spec splits it on
the stage's devices) in ``accumulate_steps`` micro-batches; the last
stage forms ``loss_fn(output, label)`` for each; the gradients are summed
over the micro-batches, divided by their count (the reference's order),
averaged over the data-parallel group, and the optimizer steps. A
``SharedLayerDesc``'s weight gradient is summed over the stages holding
it. It returns the mean loss over the micro-batches (averaged over the
data ranks), on every rank (the last stage broadcasts it).

``pipeline_configs["recompute"]``: True (the default) keeps only each
stage's input a micro-batch and runs the stage's forward again in the
backward (the dropout keys replayed); False keeps the forward's
activations.

Dropout draws as the reference's: one key a (micro-batch, stage) in
training and one for every stage in ``eval_batch``, each mask over the
whole (micro-)batch, of which a data rank draws its rows
(``core.rng.ShardWindow``).
"""
from __future__ import annotations

import torch

from ...core import rng as rng_mod
from .. import collective as C
from ..parallel import average_gradients
from .hybrid_train import batch_slice, unwrap_optimizer

__all__ = ["PipelineParallel"]

_DTYPES = [torch.float32, torch.bfloat16, torch.float16, torch.float64,
           torch.int64, torch.int32]


class PipelineParallel:
    def __init__(self, layers, hcg, strategy):
        self._layers = layers
        self._hcg = hcg
        self._strategy = strategy
        self.num_stages = layers.num_stages
        cfg = strategy.pipeline_configs
        self.accumulate_steps = int(cfg.get("accumulate_steps", 1))
        self.micro_batch_size = int(cfg.get("micro_batch_size", 1))
        self.recompute = bool(cfg.get("recompute", True))
        self.training = True
        pp = hcg.get_pipe_parallel_group()
        if pp is None or pp.nranks != self.num_stages:
            raise ValueError(f"the PipelineLayer has {self.num_stages} "
                             f"stages; the pipeline group has "
                             f"{0 if pp is None else pp.nranks} ranks")
        mp = hcg.get_model_parallel_group()
        if mp is not None and mp.nranks > 1:
            raise NotImplementedError(
                "model parallelism inside a pipeline stage is not ported "
                "yet (ROADMAP Queue 1 item 3, 12e-3)")
        self.pp = pp
        self.stage = pp.rank
        # this rank's stage only
        for s in range(self.num_stages):
            if s != self.stage:
                layers.stages[s] = type(layers.stages[s])([])
        self.stage_layers = layers.stages[self.stage]
        self._shared_groups = self._shared_weight_groups()

    def _shared_weight_groups(self):
        """For each shared key held by several stages: the group of their
        ranks (made on every rank, in key order) and this stage's weight."""
        out = []
        pl = self._layers
        for key in sorted(pl._shared):
            stages = [s for s in range(self.num_stages)
                      if key in pl._stage_shared[s]]
            if len(stages) < 2:
                continue
            g = C.new_group([self.pp.ranks[s] for s in stages])
            if self.stage in stages:
                desc = next(d for d in pl.descs
                            if getattr(d, "layer_name", None) == key)
                w = getattr(pl._shared[key], desc.shared_weight_attr)
                out.append((g, w))
        return out

    def __call__(self, *a, **k):
        return self._layers(*a, **k)

    def __getattr__(self, name):
        return getattr(self.__dict__["_layers"], name)

    def parameters(self):
        return list(self.stage_layers.parameters())

    # ---------------------------------------------------------- p2p
    def _peer(self, delta):
        return self.pp.ranks[self.stage + delta]

    def _send_meta(self, t, delta):
        meta = torch.zeros(8, dtype=torch.int64)
        meta[0] = t.dim()
        meta[1:1 + t.dim()] = torch.tensor(t.shape)
        meta[7] = _DTYPES.index(t.dtype)
        C.send(meta.to(t.device), self._peer(delta), group=self.pp)

    def _recv_meta(self, delta, device):
        meta = torch.zeros(8, dtype=torch.int64, device=device)
        C.recv(meta, self._peer(delta), group=self.pp)
        meta = meta.cpu().tolist()
        return tuple(meta[1:1 + meta[0]]), _DTYPES[meta[7]]

    def _exchange(self, send=None, send_delta=0, recv_like=None,
                  recv_delta=0):
        """Post a send of ``send`` to stage ``stage + send_delta`` and a
        receive (a tensor like ``recv_like``) from ``stage + recv_delta``
        together; returns the received tensor."""
        tasks, out = [], None
        if recv_like is not None:
            out = torch.empty_like(recv_like)
            tasks.append(C.irecv(out, self._peer(recv_delta), group=self.pp))
        if send is not None:
            tasks.append(C.isend(send.contiguous(), self._peer(send_delta),
                                 group=self.pp))
        for t in tasks:
            t.wait()
        return out

    # ---------------------------------------------------------- stages
    def _run_stage(self, x, label, key):
        """This stage's forward of one micro-batch under its key (the
        last stage's output is the loss)."""
        with self._rng_scope(key):
            out = self._layers.stage_forward(self.stage, x)
            if self.stage == self.num_stages - 1:
                out = self._loss(out, label)
        return out

    def _rng_scope(self, key):
        """The scope of a stage's draws under ``key``: the reference draws
        each key's masks over the whole (micro-)batch, of which this
        rank's rows are its slice."""
        dp = self._hcg.get_batch_group()
        window = None if dp is None or dp.nranks == 1 else \
            rng_mod.ShardWindow(rows=(dp.rank, dp.nranks))
        return rng_mod.trace_rng_scope(key, window)

    def _loss(self, out, label):
        loss = self._layers.loss_fn(out, label)
        return loss.mean() if loss.dim() > 0 else loss

    # ---------------------------------------------------------- 1F1B
    def _micro(self, data):
        """This rank's micro-batches: each of the ``accumulate_steps``
        slices of the batch, cut to this rank's rows among the data
        ranks."""
        dev = next(iter(self.stage_layers.parameters())).device
        m = self.accumulate_steps
        dp = self._hcg.get_batch_group()
        r, n = (dp.rank, dp.nranks) if dp is not None else (0, 1)
        out = []
        for t in data:
            t = torch.as_tensor(t).to(dev)
            out.append([batch_slice(c, r, n) for c in t.chunk(m)])
        return out

    def forward_backward_pipeline(self, data, scaler=None):
        """One 1F1B pass over the micro-batches; the gradients are left
        on this stage's parameters (summed, divided by the micro-batch
        count). Returns the mean loss, on every rank of the pipeline."""
        xs, ys = self._micro(data)
        S, s, m = self.num_stages, self.stage, self.accumulate_steps
        first, last = s == 0, s == S - 1
        # the reference's keys: one a (micro-batch, stage), in that order
        keys = [[rng_mod.next_rng_key() for _ in range(S)] for _ in range(m)]
        kept = [None] * m      # per micro-batch: (input, output or None)
        losses = []
        link = {}              # the activation's (shape, dtype) per link

        def activation(device):
            shape, dtype = link["in"]
            return torch.empty(shape, dtype=dtype, device=device)

        def recv_forward(i):
            if first:
                return xs[i]
            if "in" not in link:
                link["in"] = self._recv_meta(-1, xs[i].device)
            x = self._exchange(recv_like=activation(xs[i].device),
                               recv_delta=-1)
            return x.requires_grad_(True)

        def forward(i, x):
            if self.recompute:
                with torch.no_grad():
                    out = self._run_stage(x, ys[i], keys[i][s])
                kept[i] = (x, None)
            else:
                out = self._run_stage(x, ys[i], keys[i][s])
                kept[i] = (x, out)
            if last:
                losses.append(out.detach())
            elif "out" not in link:
                self._send_meta(out, +1)
                link["out"] = out.detach()
            return out.detach()

        def backward(i, g):
            x, out = kept[i]
            if out is None:      # recompute: the forward again, same key
                out = self._run_stage(x, ys[i], keys[i][s])
            if g is None:
                out.backward()
            else:
                torch.autograd.backward(out, g)
            kept[i] = None
            return None if first else x.grad

        warmup = min(S - s - 1, m)
        for i in range(warmup):
            out = forward(i, recv_forward(i))
            self._exchange(send=out, send_delta=+1)
        x = recv_forward(warmup) if warmup < m else None
        for j in range(m - warmup):
            out = forward(warmup + j, x)
            g = None if last else self._exchange(
                send=out, send_delta=+1,
                recv_like=torch.empty_like(link["out"]), recv_delta=+1)
            gx = backward(j, g)
            if j == m - warmup - 1:
                if not first:
                    self._exchange(send=gx, send_delta=-1)
            elif first:
                x = recv_forward(warmup + j + 1)
            else:
                x = self._exchange(send=gx, send_delta=-1,
                                   recv_like=activation(gx.device),
                                   recv_delta=-1).requires_grad_(True)
        for j in range(m - warmup, m):
            g = None if last else self._exchange(
                recv_like=torch.empty_like(link["out"]), recv_delta=+1)
            gx = backward(j, g)
            if not first:
                self._exchange(send=gx, send_delta=-1)
        with torch.no_grad():
            for p in self.stage_layers.parameters():
                if p.grad is not None:
                    p.grad.div_(m)
            for g, w in self._shared_groups:
                if w.grad is not None:
                    C.all_reduce(w.grad, group=g)
        dev = xs[0].device
        loss = torch.stack(losses).mean().float() if last else \
            torch.zeros((), dtype=torch.float32, device=dev)
        C.broadcast(loss, self.pp.ranks[S - 1], group=self.pp)
        return loss

    def train_batch(self, data, optimizer=None, lr_scheduler=None,
                    scaler=None):
        loss = self.forward_backward_pipeline(data, scaler)
        dp = self._hcg.get_batch_group()
        if dp is not None and dp.nranks > 1:
            average_gradients(self.stage_layers.parameters(), dp,
                              self._strategy.fuse_grad_size_in_MB)
            C.all_reduce(loss, op=C.ReduceOp.AVG, group=dp)
        if optimizer is not None:
            opt = unwrap_optimizer(optimizer)
            clip = getattr(opt, "_grad_clip", None)
            if clip is not None and hasattr(clip, "hybrid"):
                from .hybrid_train import HybridNorm

                clip.hybrid = HybridNorm(self._hcg)
            opt.step()
            opt.clear_grad()
        if lr_scheduler is not None:
            lr_scheduler.step()
        return loss

    @torch.no_grad()
    def eval_batch(self, data, compute_loss=True):
        """The forward alone, stage by stage: the batch's mean loss (on
        every rank, averaged over the data ranks), or
        with ``compute_loss=False`` the last stage's output there (None on
        the other stages)."""
        x, y = (t[0] for t in self._micro_whole(data))
        s, S = self.stage, self.num_stages
        key = rng_mod.next_rng_key()  # one for every stage, as the reference
        if s > 0:
            shape, dtype = self._recv_meta(-1, y.device)
            x = self._exchange(recv_like=torch.empty(
                shape, dtype=dtype, device=y.device), recv_delta=-1)
        with self._rng_scope(key):
            out = self._layers.stage_forward(s, x)
        if s < S - 1:
            self._send_meta(out, +1)
            self._exchange(send=out, send_delta=+1)
            if not compute_loss:
                return None
            loss = torch.zeros((), dtype=torch.float32, device=y.device)
        elif not compute_loss:
            return out
        else:
            loss = self._loss(out, y).float().contiguous()
        C.broadcast(loss, self.pp.ranks[S - 1], group=self.pp)
        dp = self._hcg.get_batch_group()
        if dp is not None and dp.nranks > 1:
            C.all_reduce(loss, op=C.ReduceOp.AVG, group=dp)
        return loss

    def _micro_whole(self, data):
        dev = next(iter(self.stage_layers.parameters())).device
        dp = self._hcg.get_batch_group()
        r, n = (dp.rank, dp.nranks) if dp is not None else (0, 1)
        return [[batch_slice(torch.as_tensor(t).to(dev), r, n)]
                for t in data]

