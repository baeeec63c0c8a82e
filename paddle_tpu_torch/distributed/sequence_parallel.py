"""Sequence (context) parallelism — the port of
``paddle_tpu/distributed/sequence_parallel.py``: ring attention, Ulysses
attention, ``split_sequence`` / ``gather_sequence``, the scope that
makes the framework's attention take the ring, and
``build_context_parallel_step`` (data x sequence parallel training with
the parameters replicated).

The reference runs inside ``shard_map`` over a mesh axis; a rank of the
port is a process, and the axis is a process group
(``collective.Group``; None: the whole process group). Port rank ``r``
of the group computes the reference's shard ``r``: its sequence shard
of every activation ``[b, h, s / n, d]``.

Ring attention (``ring_attention``) is a ``torch.autograd.Function``
over the blocks of the ring. Each rank keeps its query shard; the K/V
shards go round the group, each rank handing its block to the previous
rank (``isend`` / ``irecv`` of :mod:`.collective`, which stages CUDA
tensors through pinned host buffers under gloo), so that at step ``j``
rank ``r`` holds the block of rank ``(r + j) % n``. The receive of the
next block is posted before the current block is computed. A block of
a query shard against a key shard of the same length is

- the diagonal (the rank's own keys): causal attention;
- a key shard before the query shard: full attention;
- a key shard after it (causal): fully masked, and skipped: the
  reference computes it with weight ``exp(-1e30 - m) = 0``, so nothing
  changes.

On CUDA tensors a block is the hand-written flash kernel
(``kernels.flash_attention.flash_attention_forward``, which returns the
block's output and its row logsumexp), and the blocks merge online in
float32: ``lse = logaddexp(lse, lse_b)``, ``o = o e^(lse_old - lse) +
o_b e^(lse_b - lse)``, the reference's running max and sum in another
form. The backward is a second ring: ``flash_attention_backward`` of each
visible block with the MERGED output and logsumexp gives the block's
exact share of ``dq``, ``dk`` and ``dv``; ``dq`` sums on the rank, and
the float32 ``dk`` / ``dv`` accumulators travel with their blocks and
arrive home after ``n`` steps. On CPU tensors a block is the plain
version (the reference's ``_block_attn`` arithmetic in float32).

``ring_bytes`` counts the bytes this process sent and received round a
ring (K/V forward; K/V and the float32 dK/dV backward) since the caller
last set it to ``[0, 0]`` (read it through the module).
"""
from __future__ import annotations

import contextlib
import threading

import torch

from ..core import rng as rng_mod
from . import collective as C

__all__ = ["ring_attention", "ulysses_attention", "split_sequence",
           "gather_sequence", "sequence_parallel_scope", "active_sp_axis",
           "sp_local_offset", "sp_attention", "build_context_parallel_step",
           "ring_bytes", "ring_blocks"]

#: bytes [sent, received] round the ring by this process
ring_bytes = [0, 0]
#: the blocks this process computed, by pass and kind (the diagonal's
#: causal ones and the full ones before it); read and reset through the
#: module
ring_blocks = {"fwd_causal": 0, "fwd_full": 0, "bwd_causal": 0,
               "bwd_full": 0}
_sp_tls = threading.local()
_NEG_INF = -1e30


@contextlib.contextmanager
def sequence_parallel_scope(group, attention: str = "ring"):
    """Inside this scope the framework's attention
    (``nn.functional.scaled_dot_product_attention``) runs ring attention
    over ``group`` (a ``collective.Group``; None: the whole process
    group), and the GPT offsets its position ids by the shard's offset.
    ``attention="ulysses"`` (a port extension: the reference's scope
    always takes the ring) runs :func:`ulysses_attention` instead."""
    if attention not in ("ring", "ulysses"):
        raise ValueError(f"attention must be 'ring' or 'ulysses'; got "
                         f"{attention!r}")
    prev = (getattr(_sp_tls, "group", None),
            getattr(_sp_tls, "attention", "ring"))
    _sp_tls.group = C.get_group() if group is None else group
    _sp_tls.attention = attention
    try:
        yield
    finally:
        _sp_tls.group, _sp_tls.attention = prev


def active_sp_axis():
    """The scope's group, or None outside a scope."""
    return getattr(_sp_tls, "group", None)


def sp_attention(q, k, v, causal=True, scale=None):
    """The scope's attention over its group: :func:`ring_attention`, or
    :func:`ulysses_attention` in a scope that names it."""
    fn = ulysses_attention if getattr(_sp_tls, "attention", "ring") == \
        "ulysses" else ring_attention
    return fn(q, k, v, active_sp_axis(), causal=causal, scale=scale)


def sp_local_offset(seq_local: int) -> int:
    """This rank's offset in the full sequence (0 outside a scope)."""
    g = active_sp_axis()
    return 0 if g is None else g.rank * int(seq_local)


def _scale(q, scale) -> float:
    from ..kernels.attention import default_scale

    return default_scale(q.shape[-1]) if scale is None else float(scale)


class _Ring:
    """The ring of ``group``: a rank sends to the previous rank and
    receives from the next."""

    def __init__(self, group):
        self.n, self.r = group.nranks, group.rank
        self.group = group
        self.prev = group.ranks[(self.r - 1) % self.n]
        self.next = group.ranks[(self.r + 1) % self.n]

    def shift(self, tensors):
        """Post the receives of the next rank's ``tensors`` and the sends
        of these; :func:`_arrived` of the result returns the received
        ones."""
        recv = [torch.empty_like(t) for t in tensors]
        tasks = [C.irecv(t, self.next, self.group) for t in recv]
        tasks += [C.isend(t, self.prev, self.group) for t in tensors]
        nbytes = sum(t.numel() * t.element_size() for t in tensors)
        ring_bytes[0] += nbytes
        ring_bytes[1] += nbytes
        return tasks, recv


def _arrived(pending):
    """The tensors of a :meth:`_Ring.shift`, once its transfers are done."""
    tasks, recv = pending
    for t in tasks:
        t.wait()
    return recv


def _block_forward(q, k, v, causal: bool, scale: float):
    """``(o, lse)`` of one block: the flash kernel on CUDA tensors, the
    plain version (float32 logits, the reference's ``_block_attn``)
    elsewhere."""
    if q.is_cuda:
        from ..kernels.flash_attention import flash_attention_forward

        return flash_attention_forward(q, k, v, causal=causal, scale=scale)
    acc = torch.float64 if q.dtype == torch.float64 else torch.float32
    s = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) * scale
    if causal:
        mask = torch.ones(s.shape[-2:], dtype=torch.bool).tril()
        s = s.masked_fill(~mask, _NEG_INF)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    ll = p.sum(-1)
    o = torch.matmul(p, v.to(acc)) / ll[..., None]
    return o, m + torch.log(ll)


def _block_backward(q, k, v, out, lse, dout, causal: bool, scale: float,
                    delta=None):
    """``(dq, dk, dv)`` of one block under the merged ``out`` and
    ``lse``: the flash backward on CUDA tensors, the reference's
    ``_ring_bwd`` arithmetic elsewhere."""
    if q.is_cuda:
        from ..kernels.flash_attention import flash_attention_backward

        return flash_attention_backward(q, k, v, out, lse, dout,
                                        causal=causal, scale=scale)
    acc = torch.float64 if q.dtype == torch.float64 else torch.float32
    qf, kf, vf, gf = (t.to(acc) for t in (q, k, v, dout))
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    p = torch.exp(s - lse[..., None])
    if causal:
        mask = torch.ones(s.shape[-2:], dtype=torch.bool).tril()
        p = p.masked_fill(~mask, 0.0)
    dv = torch.matmul(p.transpose(-1, -2), gf)
    dp = torch.matmul(gf, vf.transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * scale
    return (torch.matmul(ds, kf), torch.matmul(ds.transpose(-1, -2), qf),
            dv)


def _visible(causal: bool, src: int, r: int) -> bool:
    return not causal or src <= r


def _ring_forward(q, k, v, group, causal, scale):
    ring = _Ring(group)
    n, r = ring.n, ring.r
    o = lse = None
    kb, vb = k, v
    for j in range(n):
        src = (r + j) % n
        pending = ring.shift([kb, vb]) if j < n - 1 else None
        if _visible(causal, src, r):
            diag = causal and src == r
            ring_blocks["fwd_causal" if diag else "fwd_full"] += 1
            ob, lb = _block_forward(q, kb, vb, diag, scale)
            ob = ob.float() if ob.dtype != torch.float64 else ob
            if o is None:
                o, lse = ob, lb
            else:
                new = torch.logaddexp(lse, lb)
                o = (o * torch.exp(lse - new)[..., None]
                     + ob * torch.exp(lb - new)[..., None])
                lse = new
        if pending is not None:
            kb, vb = _arrived(pending)
    return o.to(q.dtype), lse


def _ring_backward(q, k, v, out, lse, dout, group, causal, scale):
    ring = _Ring(group)
    n, r = ring.n, ring.r
    acc = torch.float64 if q.dtype == torch.float64 else torch.float32
    delta = None if q.is_cuda else (dout.to(acc) * out.to(acc)).sum(-1)
    dq = torch.zeros(q.shape, dtype=acc, device=q.device)
    dkb = torch.zeros(k.shape, dtype=acc, device=k.device)
    dvb = torch.zeros(v.shape, dtype=acc, device=v.device)
    kb, vb = k, v
    for j in range(n):
        src = (r + j) % n
        pending = ring.shift([kb, vb]) if j < n - 1 else None
        if _visible(causal, src, r):
            diag = causal and src == r
            ring_blocks["bwd_causal" if diag else "bwd_full"] += 1
            bq, bk, bv = _block_backward(q, kb, vb, out, lse, dout, diag,
                                         scale, delta)
            dq += bq
            dkb += bk
            dvb += bv
        # the accumulators travel with their blocks: home after n steps
        dkb, dvb = _arrived(ring.shift([dkb, dvb]))
        if pending is not None:
            kb, vb = _arrived(pending)
    return dq.to(q.dtype), dkb.to(k.dtype), dvb.to(v.dtype)


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, causal, scale):
        out, lse = _ring_forward(q, k, v, group, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (group, causal, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _ring_backward(q, k, v, out, lse, dout.contiguous(),
                                    *ctx.args)
        return dq, dk, dv, None, None, None


def ring_attention(q, k, v, axis_name=None, causal=True, scale=None):
    """Ring attention over the group ``axis_name`` (a ``collective.Group``;
    None: the whole process group): q, k, v ``[b, h, s_local, d]`` are
    this rank's sequence shards; returns its shard of the output, in
    q's dtype (module docstring)."""
    group = C.get_group() if axis_name is None else axis_name
    q, k, v = (t.contiguous() for t in (q, k, v))
    return _RingAttention.apply(q, k, v, group, bool(causal),
                                _scale(q, scale))


class _AllToAll(torch.autograd.Function):
    """``x`` split into ``n`` chunks along ``split``, chunk ``j`` sent to
    rank ``j``, the received ones joined along ``concat`` in rank order;
    its gradient is the inverse exchange."""

    @staticmethod
    def forward(ctx, x, group, split, concat):
        ctx.args = (group, split, concat)
        return _all_to_all(x, group, split, concat)

    @staticmethod
    def backward(ctx, g):
        group, split, concat = ctx.args
        return _all_to_all(g.contiguous(), group, concat, split), None, \
            None, None


def _all_to_all(x, group, split, concat):
    chunks = [c.contiguous() for c in x.chunk(group.nranks, dim=split)]
    return torch.cat(C.alltoall(chunks, group=group), dim=concat)


def ulysses_attention(q, k, v, axis_name=None, causal=True, scale=None,
                      attn_fn=None):
    """DeepSpeed-Ulysses sequence parallelism over the group
    ``axis_name``: q, k, v ``[b, h, s_local, d]`` (h divisible by the
    group's size) go by one all-to-all to ``[b, h / n, s, d]``, the dense
    attention runs on the full sequence with a head shard, and one
    all-to-all brings the output back. ``attn_fn(q, k, v, causal=,
    scale=)`` where given; else ``kernels.attention.sdpa``: the flash
    kernel on CUDA tensors, its plain version (float32 logits) on CPU
    ones."""
    group = C.get_group() if axis_name is None else axis_name
    n = group.nranks
    if q.shape[1] % n:
        raise ValueError(f"heads {q.shape[1]} not divisible by sp size {n}")
    qh, kh, vh = (_AllToAll.apply(t.contiguous(), group, 1, 2)
                  for t in (q, k, v))
    if attn_fn is None:
        from ..kernels.attention import sdpa

        oh = sdpa(qh, kh, vh, is_causal=causal, scale=scale)
    else:
        oh = attn_fn(qh, kh, vh, causal=causal, scale=scale)
    return _AllToAll.apply(oh.contiguous(), group, 2, 1)


def split_sequence(x, axis_name=None, seq_dim=1):
    """This rank's sequence shard of a replicated tensor."""
    group = C.get_group() if axis_name is None else axis_name
    n = group.nranks
    if x.shape[seq_dim] % n != 0:
        raise ValueError(f"sequence length {x.shape[seq_dim]} not divisible "
                         f"by the group's size {n}")
    sl = x.shape[seq_dim] // n
    return x.narrow(seq_dim, group.rank * sl, sl)


class _GatherSequence(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.args = (group, dim)
        parts = C.all_gather(None, x.contiguous(), group=group).unbind(0)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        # the gathered tensor is replicated, and so is what every rank
        # computes from it: the gradient is this rank's slice (the
        # reference's transpose under a replicated output spec)
        group, dim = ctx.args
        return g.chunk(group.nranks, dim=dim)[group.rank].contiguous(), \
            None, None


def gather_sequence(x, axis_name=None, seq_dim=1):
    """The sequence shards of the group joined into the full sequence, the
    same on every rank; its gradient is the rank's slice of the
    gradient (every rank computes the same from it)."""
    group = C.get_group() if axis_name is None else axis_name
    return _GatherSequence.apply(x, group, seq_dim)


def _default_loss_weight(labels):
    """A rank's weight in the cross-rank loss mean: its non-ignored
    target tokens (``-100`` is ignored, cross-entropy's default) when the
    last labels tensor is an integer one; else 1 (a plain mean)."""
    if labels and not labels[-1].is_floating_point():
        return (labels[-1] != -100).sum().to(torch.float32)
    return torch.ones((), dtype=torch.float32)


def build_context_parallel_step(model, optimizer, loss_fn, mesh,
                                sp_axis: str = "sp", dp_axis: str = "dp",
                                donate: bool = True, loss_weight_fn=None,
                                attention: str = "ring"):
    """``(init_fn, step_fn, shard_batch)`` for dp x sp (context-parallel)
    training with the parameters replicated.

    ``mesh``: a ``topology.CommunicateTopology`` whose axis names hold
    ``dp_axis`` and ``sp_axis`` (the reference's mesh of those axes; rank
    ``r`` at its coordinate, the sequence axis inner as in
    ``Mesh(devices.reshape(dp, sp))``), spanning the process group. Every
    rank builds it, in the same order (its groups are made here).

    - ``init_fn()``: the step's state, ``{"model", "optimizer"}`` (the
      port's parameters live in the model, updated in place);
    - ``step_fn(state, key, lr, inputs, labels) -> (loss, state)``: the
      key (two 32-bit words) folded with the rank's index on each axis,
      in the reference's order (dp, then sp); the forward under
      ``trace_rng_scope`` and :func:`sequence_parallel_scope` (attention
      takes the ring); the loss ``loss_fn(*outputs, *labels)``, or the
      model's own with ``loss_fn=None`` and ``labels=``, its mean
      weighted by ``loss_weight_fn(*labels)`` (default: the rank's
      non-ignored tokens) over the weights' sum; the backward; the loss
      and every gradient summed over the dp x sp ranks (all-reduces of
      25 MiB buckets, ``parallel.average_gradients``);
      the optimizer's step at ``lr`` (None: the optimizer's own). The
      loss is the global token-weighted mean on every rank;
    - ``shard_batch(arrays)``: this rank's rows (dim 0, over ``dp_axis``)
      and sequence shard (dim 1, over ``sp_axis``) of each array, on the
      model's device.

    ``donate`` is the reference's buffer donation; the eager port has
    nothing to donate. ``attention="ulysses"`` (a port extension) runs
    the model's attention as :func:`ulysses_attention`."""
    names = list(mesh.get_hybrid_group_names())
    rank = C.get_rank()
    coord = mesh.get_coord(rank)
    sp_group = dp_group = None
    for axis in (dp_axis, sp_axis):
        if axis not in names:
            continue
        for ranks in mesh.get_comm_list(axis):
            g = C.new_group(ranks)
            if rank in ranks:
                if axis == sp_axis:
                    sp_group = g
                else:
                    dp_group = g
    grad_axes = [a for a in (dp_axis, sp_axis) if a in names]
    grad_group = C.new_group(list(range(mesh.world_size()))) \
        if grad_axes else None
    device = next(iter(model.parameters())).device

    def init_fn():
        return {"model": model, "optimizer": optimizer}

    def shard_batch(arrays):
        out = []
        for x in arrays:
            t = torch.as_tensor(x).to(device)
            if t.dim() >= 1 and dp_group is not None:
                t = t.chunk(dp_group.nranks, 0)[dp_group.rank]
            if t.dim() >= 2 and sp_group is not None:
                t = split_sequence(t, sp_group, 1)
            out.append(t.contiguous())
        return tuple(out)

    def step_fn(state, key, lr, inputs, labels):
        m, opt = state["model"], state["optimizer"]
        key = rng_mod._as_words(key)
        for a in grad_axes:
            key = rng_mod.fold_in_words(key, coord[a])
        scope = contextlib.nullcontext() if sp_group is None else \
            sequence_parallel_scope(sp_group, attention)
        with rng_mod.trace_rng_scope(key), scope:
            if loss_fn is None:
                loss = m(*inputs, labels=labels[-1])
            else:
                out = m(*inputs)
                outs = list(out) if isinstance(out, (tuple, list)) else [out]
                loss = loss_fn(*outs, *labels)
            if loss.dim() > 0:
                loss = loss.mean()
            loss = loss.float()
            if grad_group is not None:
                w = (loss_weight_fn(*labels) if loss_weight_fn is not None
                     else _default_loss_weight(list(labels)))
                w = torch.as_tensor(w, dtype=torch.float32).to(loss.device)
                total = w.clone()
                C.all_reduce(total, group=grad_group)
                # a batch with no valid token anywhere: loss 0, not NaN
                loss = loss * w / torch.clamp(total, min=1e-8)
            loss.backward()
        if grad_group is not None:
            from .parallel import average_gradients

            loss = loss.detach().clone()
            C.all_reduce(loss, group=grad_group)
            average_gradients([p for p in m.parameters()
                               if p.grad is not None], grad_group, divisor=1)
        if lr is not None:
            opt.set_lr(float(lr))
        opt.step()
        opt.clear_grad()
        return loss.detach(), state

    return init_fn, step_fn, shard_batch
