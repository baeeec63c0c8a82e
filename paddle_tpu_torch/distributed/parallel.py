"""``DataParallel`` — the port of ``paddle_tpu/distributed/parallel.py``.

The reference's wrapper passes calls through: its step is one GSPMD
program over the whole batch, whose gradients XLA reduces. The port's
ranks are processes, each with its share of the batch, so the wrapper
makes the same result happen: when the backward through its output ends,
every gradient is averaged over the data-parallel group
(:func:`average_gradients`), in buckets of ``comm_buffer_size`` MB in a
fixed order, one all-reduce a bucket. Then every rank holds the full
batch's mean gradient, which is what the reference computes. The
reductions run after the backward, not overlapped with it (overlap is
speed work).

Every rank must start from the same weights (the same seed, or the same
loaded state).
"""
from __future__ import annotations

import torch

from ..nn.layer import Layer
from . import collective as C

__all__ = ["DataParallel", "average_gradients", "grad_buckets",
           "bucket_plan"]


def bucket_plan(items, bucket_bytes: int) -> list:
    """``items``: ``(nbytes, dtype)`` of each gradient in order; the index
    lists of the buckets: consecutive gradients of one dtype, at most
    ``bucket_bytes`` a bucket (a larger gradient is a bucket of its
    own)."""
    buckets, cur, size, dtype = [], [], 0, None
    for i, (nb, dt) in enumerate(items):
        if cur and (dt != dtype or size + nb > bucket_bytes):
            buckets.append(cur)
            cur, size = [], 0
        cur.append(i)
        size += nb
        dtype = dt
    if cur:
        buckets.append(cur)
    return buckets


def grad_buckets(params, bucket_bytes: int) -> list:
    """The parameters with a gradient, in order, in the buckets of
    :func:`bucket_plan`."""
    live = [p for p in params if p.grad is not None]
    plan = bucket_plan([(p.grad.numel() * p.grad.element_size(),
                         p.grad.dtype) for p in live], bucket_bytes)
    return [[live[i] for i in b] for b in plan]


def average_gradients(params, group, bucket_mb: float = 25.0,
                      divisor: int | None = None) -> int:
    """Average every gradient of ``params`` over ``group`` (sum, then
    divide by ``divisor``, the group's size by default), bucket by bucket:
    the bucket's gradients are flattened into one buffer, all-reduced and
    copied back. Returns the number of all-reduces."""
    g = C._group(group)
    n = g.nranks if divisor is None else divisor
    if g.nranks == 1 and n == 1:
        return 0
    buckets = grad_buckets(params, int(bucket_mb * 2 ** 20))
    with torch.no_grad():
        for bucket in buckets:
            grads = [p.grad for p in bucket]
            flat = torch.cat([t.reshape(-1) for t in grads])
            if g.nranks > 1:
                C.all_reduce(flat, group=g)
            flat.div_(n)
            off = 0
            for t in grads:
                t.copy_(flat[off:off + t.numel()].view_as(t))
                off += t.numel()
    return len(buckets)


class DataParallel(Layer):
    """Wrap ``layers``: the forward is theirs; after the backward through
    its output the gradients are averaged over ``group`` (None: the
    whole process group). ``apply_collective_grads()`` runs the average
    by hand (the reference's name)."""

    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None):
        super().__init__()
        self._layers = layers
        self.find_unused_parameters = find_unused_parameters
        self.group = group
        self.comm_buffer_size = comm_buffer_size
        self.last_comm_buffer_size = last_comm_buffer_size
        self._queued = False

    def forward(self, *inputs, **kwargs):
        out = self._layers(*inputs, **kwargs)
        if torch.is_grad_enabled() and C.dist.is_initialized():
            first = next((t for t in _tensors(out) if t.requires_grad),
                         None)
            if first is not None:
                first.register_hook(self._on_grad)
        return out

    def _on_grad(self, grad):
        # the average runs once the whole backward has ended
        if not self._queued:
            self._queued = True
            torch.autograd.Variable._execution_engine.queue_callback(
                self._after_backward)
        return grad

    def _after_backward(self):
        self._queued = False
        self.apply_collective_grads()

    def apply_collective_grads(self):
        average_gradients(self._layers.parameters(), self.group,
                          self.comm_buffer_size)

    def scale_loss(self, loss):
        return loss

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.set_state_dict(state_dict, *args, **kwargs)

    @property
    def _inner(self):
        return self._layers


def _tensors(out):
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _tensors(o)]
    if isinstance(out, dict):
        return [t for o in out.values() for t in _tensors(o)]
    return []
