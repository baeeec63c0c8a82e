"""Functional collectives — the port of ``paddle_tpu/distributed/ops.py``,
the ``c_*`` op set.

The reference lowers each op to a ``jax.lax`` collective over a named
mesh axis inside ``shard_map``; the port takes a process group
(``collective.Group``, a raw ``torch.distributed`` group, or None for the
world) in place of the axis, and rank r's output equals the reference's
shard r. Each op is out of place and differentiable, with the
reference's gradient (the transpose ``jax.vjp`` takes inside
``shard_map``):

- ``c_identity``: forward the identity, backward a sum of the gradient
  over the group; ``mp_allreduce``: forward the sum, backward the
  identity — Megatron's f / g pair around a column- and a row-parallel
  layer;
- ``c_allreduce_sum`` / ``_avg``: backward the sum (the mean's: over n) of
  the gradients; ``_max`` / ``_min`` / ``_prod`` have none, as the
  reference's ``pmax`` has none;
- ``c_allgather`` / ``c_concat``: backward a reduce-scatter;
  ``c_reducescatter``: backward an all-gather; ``c_split``: backward the
  gradient of this rank's slice, zeros elsewhere (no communication);
  ``c_broadcast``: backward the gradients' sum at the source, zeros
  elsewhere;
- ``c_alltoall``, ``global_scatter`` / ``global_gather`` (MoE dispatch and
  combine): backward the all-to-all back;
- ``send_next`` / ``send_prev`` / ``send_v2`` / ``recv_v2`` /
  ``p2p_exchange`` (the reference's ``ppermute``): rank d receives what
  rank s sent for each pair ``(s, d)``, ranks receiving nothing get zeros;
  backward the inverse permutation;
- ``c_softmax_with_cross_entropy``: the vocab-parallel loss of logits
  split over the group on their last dimension: the global max, the
  summed denominator, the true logit from the shard that owns the label;
  its gradient ``softmax - onehot`` on this rank's shard, with no
  collective (Megatron's); ``c_embedding``: the lookup of a table split
  over the group by rows, each rank zeroing ids outside its rows, then
  ``mp_allreduce``.

Ranks in a pair list or ``src`` / ``dst`` are indices into the group, as
the reference's mesh-axis indices.
"""
from __future__ import annotations

import torch

from . import collective as C

__all__ = [
    "c_allreduce_sum", "c_allreduce_max", "c_allreduce_min",
    "c_allreduce_prod", "c_allreduce_avg", "c_allgather", "c_reducescatter",
    "c_broadcast", "c_identity", "mp_allreduce", "c_concat", "c_split",
    "send_next", "recv_prev", "send_prev", "recv_next", "send_v2", "recv_v2",
    "p2p_exchange", "c_alltoall", "global_scatter", "global_gather",
    "c_softmax_with_cross_entropy", "c_embedding", "axis_index", "axis_size",
]


def axis_index(group=None) -> int:
    """This rank's index in ``group``."""
    return C._group(group).rank


def axis_size(group=None) -> int:
    return C._group(group).nranks


def _sum(x, group):
    return C.all_reduce(x.clone(), group=group)


class _Identity(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g.contiguous(), ctx.group), None


class _AllReduceSum(torch.autograd.Function):
    """Forward the sum; backward the sum (``psum``'s transpose)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum(x.contiguous(), group)

    @staticmethod
    def backward(ctx, g):
        return _sum(g.contiguous(), ctx.group), None


class _MpAllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum(x.contiguous(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def c_identity(x, group=None):
    """Identity forward, the gradient summed over ``group`` backward (a
    column-parallel layer's input)."""
    return _Identity.apply(x, group)


def mp_allreduce(x, group=None):
    """The sum over ``group`` forward, the identity backward (a
    row-parallel layer's output)."""
    return _MpAllReduce.apply(x, group)


def c_allreduce_sum(x, group=None):
    return _AllReduceSum.apply(x, group)


def c_allreduce_avg(x, group=None):
    return c_allreduce_sum(x, group) / C._group(group).nranks


def _reduced(x, op, group):
    return C.all_reduce(x.detach().clone().contiguous(), op=op, group=group)


def c_allreduce_max(x, group=None):
    return _reduced(x, C.ReduceOp.MAX, group)


def c_allreduce_min(x, group=None):
    return _reduced(x, C.ReduceOp.MIN, group)


def c_allreduce_prod(x, group=None):
    return _reduced(x, C.ReduceOp.PROD, group)


def _gather(x, group, dim):
    """The group's tensors concatenated along ``dim``."""
    full = C.all_gather(None, x.contiguous(), group=group)
    return torch.cat(full.unbind(0), dim=dim)


def _scatter_sum(g, group, dim):
    """This rank's slice along ``dim`` of the group's summed ``g``."""
    n = C._group(group).nranks
    parts = torch.stack(g.chunk(n, dim=dim))
    out = torch.empty_like(parts[0])
    return C.reduce_scatter(out, parts, group=group)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _scatter_sum(g.contiguous(), ctx.group, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _scatter_sum(x.contiguous(), group, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.group, ctx.dim), None, None


def c_allgather(x, group=None, concat_axis: int = 0, tiled: bool = True):
    """Every rank's ``x`` along ``concat_axis`` (``tiled``), or stacked on a
    new leading dimension (not tiled)."""
    if not tiled:
        return _AllGather.apply(x.unsqueeze(0), group, 0)
    return _AllGather.apply(x, group, concat_axis % x.dim())


def c_reducescatter(x, group=None, scatter_axis: int = 0):
    """This rank's slice along ``scatter_axis`` of the sum over the
    group."""
    return _ReduceScatter.apply(x, group, scatter_axis % x.dim())


def c_concat(x, group=None, concat_axis: int = -1):
    return c_allgather(x, group, concat_axis, tiled=True)


def c_split(x, group=None, split_axis: int = -1):
    """This rank's slice of ``x`` along ``split_axis`` (sliced locally;
    the gradient is zero outside it)."""
    g = C._group(group)
    return x.chunk(g.nranks, dim=split_axis % x.dim())[g.rank]


class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, src):
        ctx.group, ctx.src = group, src
        g = C._group(group)
        return C.broadcast(x.detach().clone().contiguous(), g.ranks[src],
                           group=group)

    @staticmethod
    def backward(ctx, g):
        total = _sum(g.contiguous(), ctx.group)
        if C._group(ctx.group).rank != ctx.src:
            total.zero_()
        return total, None, None


def c_broadcast(x, group=None, src: int = 0):
    """Rank ``src``'s ``x`` on every rank."""
    return _Broadcast.apply(x, group, src)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return C.alltoall(x.contiguous(), group=group)

    @staticmethod
    def backward(ctx, g):
        return C.alltoall(g.contiguous(), group=ctx.group), None


def c_alltoall(x, group=None, split_axis=0, concat_axis=0):
    """The tiled all-to-all: ``x`` split into n blocks along
    ``split_axis``, block j sent to rank j, the received blocks
    concatenated along ``concat_axis`` in rank order."""
    n = C._group(group).nranks
    blocks = torch.stack(x.chunk(n, dim=split_axis))
    got = _AllToAll.apply(blocks, group)
    return torch.cat(got.unbind(0), dim=concat_axis)


def global_scatter(x, group=None):
    """MoE dispatch: ``x`` ``[n, cap, d]``, row j sent to rank j; row j of
    the result holds what rank j sent here."""
    return _AllToAll.apply(x, group)


def global_gather(x, group=None):
    """MoE combine: the inverse exchange of :func:`global_scatter`."""
    return _AllToAll.apply(x, group)


# ------------------------------------------------------- point to point
def _permute(x, group, pairs):
    """Rank d's output is rank s's ``x`` for each ``(s, d)`` of ``pairs``
    (group indices), zeros where nothing arrives."""
    g = C._group(group)
    me = g.rank
    out = torch.zeros_like(x)
    tasks = []
    for s, d in pairs:
        if d == me and s != me:
            tasks.append(C.irecv(out, g.ranks[s], group=group))
    for s, d in pairs:
        if s == me and d != me:
            tasks.append(C.isend(x.contiguous(), g.ranks[d], group=group))
    for t in tasks:
        t.wait()
    for s, d in pairs:
        if s == me and d == me:
            out = x.clone()
    return out


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, pairs):
        ctx.group, ctx.pairs = group, pairs
        return _permute(x.detach(), group, pairs)

    @staticmethod
    def backward(ctx, g):
        inverse = tuple((d, s) for s, d in ctx.pairs)
        return _permute(g, ctx.group, inverse), None, None


def p2p_exchange(x, group=None, pairs=()):
    """The general permutation over explicit ``(src, dst)`` pairs."""
    return _Permute.apply(x, group, tuple((int(s), int(d))
                                          for s, d in pairs))


def send_next(x, group=None):
    """Each rank's ``x`` to the next rank (ring): the result is the
    previous rank's."""
    n = C._group(group).nranks
    return p2p_exchange(x, group, [(i, (i + 1) % n) for i in range(n)])


def send_prev(x, group=None):
    n = C._group(group).nranks
    return p2p_exchange(x, group, [(i, (i - 1) % n) for i in range(n)])


recv_prev = send_next  # receiving from prev == prev sent forward
recv_next = send_prev


def send_v2(x, group=None, dst: int = 0, src: int | None = None):
    """The one pair ``(src, dst)``: rank ``dst`` receives rank ``src``'s
    ``x`` (``src`` defaults to ``dst - 1``), every other rank zeros."""
    if src is None:
        src = (dst - 1) % C._group(group).nranks
    return p2p_exchange(x, group, [(src, dst)])


def recv_v2(x, group=None, src: int = 0, dst: int | None = None):
    if dst is None:
        dst = (src + 1) % C._group(group).nranks
    return p2p_exchange(x, group, [(src, dst)])


# ------------------------------------------------- vocab-parallel ops
class _ParallelCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, group):
        g = C._group(group)
        v_local = logits.shape[-1]
        lf = logits.float()
        m = C.all_reduce(lf.amax(-1, keepdim=True), op=C.ReduceOp.MAX,
                         group=group)
        e = torch.exp(lf - m)
        denom = C.all_reduce(e.sum(-1, keepdim=True), group=group)
        local = labels.long() - g.rank * v_local
        in_range = (local >= 0) & (local < v_local)
        safe = local.clamp(0, v_local - 1)
        true = torch.gather(lf, -1, safe.unsqueeze(-1))
        true = torch.where(in_range.unsqueeze(-1), true, 0.0)
        true = C.all_reduce(true.contiguous(), group=group)
        loss = torch.log(denom) + m - true
        ctx.save_for_backward(e, denom, safe, in_range)
        ctx.dtype = logits.dtype
        return loss.squeeze(-1)

    @staticmethod
    def backward(ctx, g):
        e, denom, safe, in_range = ctx.saved_tensors
        grad = e / denom
        onehot = torch.zeros_like(grad).scatter_(
            -1, safe.unsqueeze(-1), in_range.unsqueeze(-1).to(grad.dtype))
        return ((grad - onehot) * g.unsqueeze(-1)).to(ctx.dtype), None, None


def c_softmax_with_cross_entropy(logits, labels, group=None):
    """The per-token cross-entropy (float32) of ``logits`` whose last
    dimension is split over ``group`` (rank r holds classes ``[r * v,
    (r + 1) * v)``); ``labels`` are global class ids."""
    return _ParallelCE.apply(logits, labels, group)


def c_embedding(ids, table, group=None, vocab_start: int | None = None):
    """The lookup of ``ids`` in a table split over ``group`` by rows (this
    rank's ``[v, d]`` block starts at ``vocab_start``, by default ``rank *
    v``)."""
    g = C._group(group)
    v = table.shape[0]
    lo = g.rank * v if vocab_start is None else vocab_start
    local = ids.long() - lo
    in_range = (local >= 0) & (local < v)
    emb = torch.nn.functional.embedding(local.clamp(0, v - 1), table)
    emb = emb * in_range.unsqueeze(-1).to(emb.dtype)
    return mp_allreduce(emb, group)
