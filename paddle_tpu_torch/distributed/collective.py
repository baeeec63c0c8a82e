"""Collectives — the port of ``paddle_tpu/distributed/collective.py``:
``ReduceOp``, ``Group`` / ``new_group`` / ``get_group``, ``all_reduce``,
``all_gather``, ``reduce_scatter``, ``broadcast``, ``reduce``,
``scatter``, ``alltoall``, ``send`` / ``recv`` / ``isend`` / ``irecv``,
``barrier``, ``wait``, ``destroy_process_group`` and ``split``.

The reference is one controller over a device mesh: an eager collective
takes a global ``[nranks, ...]`` array whose row r is "rank r's tensor".
The port is one process a rank over ``torch.distributed``, so each call
takes this rank's own tensor, and rank r's result equals row r of the
reference's. Every call is in place where the reference's is (the
tensor argument receives the result) and returns it.

Backends (``env.init_parallel_env``): NCCL with a card a rank; gloo on
the CPU and for ranks that share one card. Gloo reduces, broadcasts and
all-gathers CUDA tensors itself (it stages them through the host); the
other operations (reduce-scatter, all-to-all, scatter, reduce and the
point-to-point ones) take CPU tensors only there, so under gloo a CUDA
tensor is copied into a pinned host buffer, the same operation runs on
it, and the result is copied back (``staged`` counts those calls). The
census records the operation that ran, under its own kind, never another
one under the reference's name. ``ReduceOp.AVG`` is a sum followed by a
division by the group's size on every backend (the reference's
``pmean``); ``PROD`` is the backend's product.

``all_reduces`` counts the SUM all-reduces since the caller last set it
to 0 (read and reset it through the module: ``collective.all_reduces``):
the tests and ``chip_smoke.py`` hold a serving step to its ``2L + 1``
(``2L + 2`` with quantized logits) all-reduces with it.

``census()`` records every call made inside it — kind, payload bytes,
ranks of the group, dtype and shape — for ``analysis.hlocheck``, which
audits an executed step's collectives against its declared
``CollectiveBudget``, and for ``chip_smoke.py``'s hybrid-training census.
Outside a census a call pays one list check. Inside a ``SyncTally`` the
transport runs with the tally paused: whatever host staging the backend
does is the collective's, not a host read of the step.
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from ..analysis import tracecheck

__all__ = ["ReduceOp", "Group", "new_group", "get_group", "all_reduce",
           "all_gather", "reduce_scatter", "broadcast", "reduce", "scatter",
           "alltoall", "all_to_all", "send", "recv", "isend", "irecv",
           "barrier", "wait", "destroy_process_group", "split",
           "get_world_size", "get_rank", "all_reduces", "census", "staged"]

all_reduces = 0
#: calls that went through a pinned host buffer (gloo, CUDA tensors)
staged = 0
_censuses: list[list] = []  # the active censuses, innermost last


class ReduceOp:
    SUM = 0
    MAX = 1
    MIN = 2
    PROD = 3
    AVG = 4


_TORCH_OP = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.MAX: dist.ReduceOp.MAX,
             ReduceOp.MIN: dist.ReduceOp.MIN,
             ReduceOp.PROD: dist.ReduceOp.PRODUCT,
             ReduceOp.AVG: dist.ReduceOp.SUM}


class Group:
    """A communicator: the ranks of a ``torch.distributed`` process group
    (``pg``; None = the whole process group), in the order they were
    given, and the group's id (0 = the world)."""

    def __init__(self, pg, ranks, gid: int):
        self.pg = pg
        self.ranks = list(ranks)
        self.id = gid

    @property
    def nranks(self) -> int:
        return len(self.ranks)

    world_size = nranks

    @property
    def rank(self) -> int:
        """This process's index in the group (-1: not a member)."""
        return self.get_group_rank(dist.get_rank())

    def get_group_rank(self, rank: int) -> int:
        return self.ranks.index(rank) if rank in self.ranks else -1

    def is_member(self) -> bool:
        return self.rank >= 0

    def __repr__(self):
        return f"Group(id={self.id}, ranks={self.ranks})"


_groups: dict[int, Group] = {}
_next_gid = [1]


def _world() -> Group:
    g = _groups.get(0)
    if g is None or g.nranks != dist.get_world_size():
        g = _groups[0] = Group(None, range(dist.get_world_size()), 0)
    return g


def new_group(ranks=None, backend=None, timeout=None) -> Group:
    """A communicator over ``ranks`` (None: every rank). Every rank of the
    process group must make the same ``new_group`` calls in the same
    order, members or not, as ``torch.distributed.new_group`` requires."""
    ranks = list(range(dist.get_world_size())) if ranks is None \
        else sorted(int(r) for r in ranks)
    kw = {} if timeout is None else {"timeout": timeout}
    pg = dist.new_group(ranks, backend=backend, **kw)
    g = Group(pg, ranks, _next_gid[0])
    _groups[g.id] = g
    _next_gid[0] += 1
    return g


def get_group(gid=0) -> Group:
    """The group of id ``gid`` (0: the world)."""
    return _world() if gid in (0, None) else _groups[int(gid)]


def _group(group) -> Group:
    if group is None or isinstance(group, int):
        return get_group(group)
    if isinstance(group, Group):
        return group
    # a raw torch process group, as tensor-parallel serving passes it
    return Group(group, dist.get_process_group_ranks(group), -1)


def get_world_size(group=None) -> int:
    return _group(group).nranks


def get_rank(group=None) -> int:
    """This process's rank in ``group`` (None: its global rank)."""
    return dist.get_rank() if group is None else _group(group).rank


@contextlib.contextmanager
def census():
    """Record every collective call inside the block: yields a list that
    grows by one ``(kind, nbytes, ranks, dtype, shape)`` per call."""
    calls: list = []
    _censuses.append(calls)
    try:
        yield calls
    finally:
        # by identity: two censuses may hold equal records
        _censuses[:] = [c for c in _censuses if c is not calls]


def _record(kind: str, tensor: torch.Tensor, g: Group) -> None:
    if _censuses:
        rec = (kind, tensor.numel() * tensor.element_size(),
               tuple(g.ranks), str(tensor.dtype).split(".")[-1],
               tuple(tensor.shape))
        for calls in _censuses:
            calls.append(rec)


@contextlib.contextmanager
def _transport():
    """The backend's own host staging belongs to the collective the
    census counts, not to the step's host reads."""
    if tracecheck.tallying():
        with tracecheck.sync_tally_paused():
            yield
    else:
        yield


def _host_staged(t: torch.Tensor, g: Group) -> bool:
    """Whether an operation gloo runs on CPU tensors only must stage
    ``t`` through the host."""
    return t.is_cuda and dist.get_backend(g.pg) == "gloo"


@contextlib.contextmanager
def _staging(tensors, g: Group, writes=()):
    """Yields host copies of ``tensors`` (pinned) under gloo for CUDA
    tensors, the tensors themselves otherwise; on exit copies the host
    results back into the tensors at the indices ``writes``."""
    global staged
    if not tensors or not _host_staged(tensors[0], g):
        yield list(tensors)
        return
    staged += 1
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)
            for t in tensors]
    yield host
    for i in writes:
        tensors[i].copy_(host[i])


def all_reduce(tensor: torch.Tensor, op=ReduceOp.SUM, group=None,
               sync_op=True) -> torch.Tensor:
    """Reduce ``tensor`` over the ranks of ``group`` (None: the whole
    process group) in place; returns it. Every rank receives the same
    bits. AVG is the sum divided by the group's size."""
    global all_reduces
    g = _group(group)
    if op == ReduceOp.SUM:
        all_reduces += 1
    _record("all-reduce", tensor, g)
    with _transport():
        dist.all_reduce(tensor, op=_TORCH_OP[op], group=g.pg)
    if op == ReduceOp.AVG:
        tensor.div_(g.nranks)
    return tensor


def all_gather(tensor_list, tensor, group=None, sync_op=True):
    """Every rank's ``tensor``, in group order: into ``tensor_list``
    (cleared first) when given, which is returned; else one tensor
    ``[nranks, *tensor.shape]``."""
    g = _group(group)
    flat = torch.empty(g.nranks * tensor.numel(), dtype=tensor.dtype,
                       device=tensor.device)
    _record("all-gather", tensor, g)
    with _transport():
        dist.all_gather_into_tensor(flat, tensor.contiguous().reshape(-1),
                                    group=g.pg)
    out = flat.view(g.nranks, *tensor.shape)
    if tensor_list is None:
        return out
    del tensor_list[:]
    tensor_list.extend(out.unbind(0))
    return tensor_list


def reduce_scatter(tensor, tensor_or_tensor_list, op=ReduceOp.SUM,
                   group=None, sync_op=True):
    """``tensor`` receives the reduction over the group of every rank's
    ``tensor_or_tensor_list[rank]`` (a list of nranks tensors, or one
    tensor whose first dimension splits into nranks rows)."""
    g = _group(group)
    src = tensor_or_tensor_list
    if isinstance(src, (list, tuple)):
        src = torch.stack([torch.as_tensor(t) for t in src])
    src = src.reshape(g.nranks * tensor.numel()).contiguous()
    _record("reduce-scatter", src, g)
    flat = tensor.reshape(-1) if tensor.is_contiguous() \
        else torch.empty(tensor.numel(), dtype=tensor.dtype,
                         device=tensor.device)
    with _transport(), _staging([flat, src], g, writes=(0,)) as (o, s):
        dist.reduce_scatter_tensor(o, s, op=_TORCH_OP[op], group=g.pg)
    if flat.data_ptr() != tensor.data_ptr():
        tensor.copy_(flat.view(tensor.shape))
    if op == ReduceOp.AVG:
        tensor.div_(g.nranks)
    return tensor


def broadcast(tensor, src=0, group=None, sync_op=True):
    """``tensor`` takes rank ``src``'s value (``src`` a global rank)."""
    g = _group(group)
    _record("broadcast", tensor, g)
    with _transport():
        dist.broadcast(tensor, src=int(src), group=g.pg)
    return tensor


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True):
    """The reduction lands in rank ``dst``'s ``tensor``; every other
    rank's keeps its value (the reference's rows other than dst)."""
    g = _group(group)
    _record("reduce", tensor, g)
    with _transport(), _staging([tensor], g, writes=(0,)) as (t,):
        keep = None if dist.get_rank() == dst else t.clone()
        dist.reduce(t, int(dst), op=_TORCH_OP[op], group=g.pg)
        if keep is not None:
            t.copy_(keep)   # the backend may leave a partial sum there
    if op == ReduceOp.AVG and dist.get_rank() == dst:
        tensor.div_(g.nranks)
    return tensor


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    """Rank ``src``'s ``tensor_list[i]`` goes to the group's i-th rank's
    ``tensor``."""
    g = _group(group)
    _record("scatter", tensor, g)
    me = dist.get_rank() == src
    bufs = [tensor] + (list(tensor_list) if me else [])
    with _transport(), _staging(bufs, g, writes=(0,)) as host:
        dist.scatter(host[0], host[1:] if me else None, src=int(src),
                     group=g.pg)
    return tensor


def alltoall(in_tensor_list, out_tensor_list=None, group=None, sync_op=True):
    """Rank i's ``in_tensor_list[j]`` becomes rank j's
    ``out_tensor_list[i]``. Given one tensor instead of a list, its first
    dimension splits into nranks rows and a tensor of the same shape is
    returned (``global_scatter``'s form)."""
    g = _group(group)
    if isinstance(in_tensor_list, torch.Tensor):
        x = in_tensor_list.contiguous()
        out = torch.empty_like(x)
        _record("all-to-all", x, g)
        with _transport(), _staging([out, x], g, writes=(0,)) as (o, i):
            dist.all_to_all_single(o, i, group=g.pg)
        return out
    ins = [t.contiguous() for t in in_tensor_list]
    _record("all-to-all", torch.stack(ins), g)
    if len({(t.shape, t.dtype) for t in ins}) == 1:
        # one buffer: gloo runs the single-tensor exchange only (some
        # releases refuse the list form)
        x = torch.stack(ins)
        out = torch.empty_like(x)
        with _transport(), _staging([out, x], g, writes=(0,)) as (o, i):
            dist.all_to_all_single(o, i, group=g.pg)
        outs = list(out.unbind(0))
    else:
        outs = [torch.empty_like(t) for t in ins]
        with _transport(), _staging(outs + ins, g,
                                    writes=range(len(outs))) as host:
            dist.all_to_all(host[:len(outs)], host[len(outs):], group=g.pg)
    if out_tensor_list is None:
        return outs
    del out_tensor_list[:]
    out_tensor_list.extend(outs)
    return out_tensor_list


all_to_all = alltoall


class _Task:
    """A pending point-to-point operation: ``wait()`` completes it (a
    receive lands in its tensor then), as the reference's
    ``ProcessGroup::Task``."""

    def __init__(self, work, tensor=None, host=None):
        self._work = work
        self._tensor = tensor
        self._host = host
        self._done = False

    def wait(self, timeout=None):
        if not self._done:
            with _transport():
                self._work.wait()
            if self._host is not None and self._tensor is not None:
                self._tensor.copy_(self._host)
            self._done = True
        return True

    def is_completed(self):
        return self._done


def _p2p(kind, tensor, peer, group, start):
    global staged
    g = _group(group)
    _record(kind, tensor, g)
    host = None
    if _host_staged(tensor, g):
        staged += 1
        host = torch.empty(tensor.shape, dtype=tensor.dtype,
                           pin_memory=True)
        if kind == "send":
            host.copy_(tensor)
    with _transport():
        work = start(tensor if host is None else host, int(peer), g.pg)
    return _Task(work, tensor if kind == "recv" else None, host)


def isend(tensor, dst=0, group=None):
    """Post a send of ``tensor`` to global rank ``dst``; returns a task."""
    return _p2p("send", tensor.contiguous(), dst, group,
                lambda t, p, pg: dist.isend(t, p, group=pg))


def irecv(tensor, src=0, group=None):
    """Post a receive from global rank ``src`` into ``tensor``; the
    tensor holds it once the returned task's ``wait()`` returns."""
    return _p2p("recv", tensor, src, group,
                lambda t, p, pg: dist.irecv(t, p, group=pg))


def send(tensor, dst=0, group=None, sync_op=True):
    isend(tensor, dst, group).wait()


def recv(tensor, src=0, group=None, sync_op=True, timeout=None):
    irecv(tensor, src, group).wait()
    return tensor


def barrier(group=None):
    g = _group(group)
    with _transport():
        dist.barrier(group=g.pg)


def wait(tensor, group=None, use_calc_stream=True):
    """The reference's stream wait: the card's work queued so far on
    ``tensor``'s device is done when it returns."""
    if isinstance(tensor, torch.Tensor) and tensor.is_cuda:
        torch.cuda.current_stream(tensor.device).synchronize()


def destroy_process_group(group=None):
    """Drop ``group`` (a Group from :func:`new_group`), or every group and
    the process group itself (None)."""
    if group is None:
        _groups.clear()
        _next_gid[0] = 1
        if dist.is_initialized():
            dist.destroy_process_group()
        return
    g = _group(group)
    _groups.pop(g.id, None)
    if g.pg is not None:
        dist.destroy_process_group(g.pg)


def split(x, size, operation, axis=0, num_partitions=1, gather_out=True,
          weight_attr=None, bias_attr=None, name=None):
    """A model-parallel linear or embedding in one call, over the model
    parallel group of ``fleet.init``: builds the parallel layer (this
    rank's slice of it) and applies it to ``x``."""
    from .fleet.meta_parallel import (ColumnParallelLinear,
                                      RowParallelLinear,
                                      VocabParallelEmbedding)

    if operation == "embedding":
        return VocabParallelEmbedding(size[0], size[1],
                                      weight_attr=weight_attr)(x)
    if operation != "linear":
        raise ValueError(f"unsupported operation {operation!r}")
    if axis == 1:
        layer = ColumnParallelLinear(size[0], size[1], weight_attr=weight_attr,
                                     has_bias=bias_attr is not False,
                                     gather_output=gather_out)
    elif axis == 0:
        layer = RowParallelLinear(size[0], size[1], weight_attr=weight_attr,
                                  has_bias=bias_attr is not False)
    else:
        raise ValueError("axis must be 0 (row) or 1 (column)")
    return layer(x)
