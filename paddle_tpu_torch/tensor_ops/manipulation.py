"""Shape and layout functions — the port of
``paddle_tpu/tensor_ops/manipulation.py``.

Paddle's conventions hold: ``reshape`` takes 0 for "this input dim",
``split`` a count or section sizes (one of them -1), ``squeeze`` ignores
a named axis whose size is not 1, ``scatter`` with ``overwrite=False``
zeroes the target rows before adding every update. Functions whose
output shape depends on the values (``masked_select``, ``unique``,
``unique_consecutive``, ``where`` with one argument) read the values,
as the reference does on its host."""
from __future__ import annotations

import numpy as np
import torch

from ..core.dtype import to_torch_dtype
from ..core.tensor import as_port, as_tensor_arg, to_tensor

__all__ = [
    "reshape", "reshape_", "transpose", "concat", "split", "stack",
    "unstack", "squeeze", "unsqueeze", "flatten", "expand", "expand_as",
    "tile", "broadcast_to", "gather", "gather_nd", "scatter",
    "scatter_nd_add", "slice", "index_select", "masked_select", "where",
    "roll", "flip", "chunk", "unbind", "cast", "t", "moveaxis",
    "tensordot", "repeat_interleave", "take_along_axis", "put_along_axis",
    "flatten_", "rot90", "as_complex", "as_real", "tolist",
    "strided_slice", "unique", "broadcast_shape", "squeeze_", "unsqueeze_",
    "broadcast_tensors", "diagonal", "reverse", "crop", "scatter_nd",
    "shard_index", "unique_consecutive", "scatter_", "put_along_axis_",
]

_t = as_tensor_arg
_slice = slice


def _int(v) -> int:
    return int(v.item()) if isinstance(v, torch.Tensor) else int(v)


def _shape_list(shape) -> tuple:
    if isinstance(shape, torch.Tensor):
        return tuple(int(v) for v in shape.tolist())
    return tuple(_int(s) for s in shape)


def reshape(x, shape, name=None):
    x = _t(x)
    shp = tuple(x.shape[i] if s == 0 else s
                for i, s in enumerate(_shape_list(shape)))
    return as_port(torch.reshape(x, shp))


def _into(x, out):
    """Make ``x`` hold ``out`` (its shape and values), for the ``*_``
    shape functions."""
    x.data = out.detach().contiguous().clone()
    return x


def reshape_(x, shape, name=None):
    return _into(x, reshape(x, shape))


def transpose(x, perm, name=None):
    return as_port(torch.permute(_t(x), tuple(int(p) for p in perm)))


def t(x, name=None):
    x = _t(x)
    return as_port(x.t() if x.dim() <= 2 else x.permute(
        *range(x.dim() - 1, -1, -1)))


def moveaxis(x, source, destination, name=None):
    return as_port(torch.movedim(_t(x), source, destination))


def concat(x, axis=0, name=None):
    ts = [_t(v) for v in x]
    return as_port(torch.cat(ts, dim=_int(axis)))


def stack(x, axis=0, name=None):
    return as_port(torch.stack([_t(v) for v in x], dim=int(axis)))


def unstack(x, axis=0, num=None, name=None):
    return [as_port(v) for v in torch.unbind(_t(x), dim=int(axis))]


def split(x, num_or_sections, axis=0, name=None):
    x = _t(x)
    axis = _int(axis) % x.dim()
    dim = x.shape[axis]
    if isinstance(num_or_sections, int):
        sections = [dim // num_or_sections] * num_or_sections
    else:
        sections = [_int(s) for s in num_or_sections]
        neg = [i for i, s in enumerate(sections) if s < 0]
        if neg:
            sections[neg[0]] = dim - sum(s for s in sections if s >= 0)
    return [as_port(v) for v in torch.split(x, sections, dim=axis)]


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis)


def unbind(x, axis=0, name=None):
    return unstack(x, axis)


def squeeze(x, axis=None, name=None):
    x = _t(x)
    if axis is None:
        return as_port(torch.squeeze(x))
    ax = axis if isinstance(axis, (list, tuple)) else [axis]
    ax = tuple(a for a in ax if x.shape[a] == 1)
    return as_port(torch.squeeze(x, ax) if ax else x)


def squeeze_(x, axis=None, name=None):
    return _into(x, squeeze(x, axis))


def unsqueeze(x, axis, name=None):
    x = _t(x)
    ax = axis if isinstance(axis, (list, tuple)) else [axis]
    out = x
    for d in sorted(_int(a) for a in ax):
        out = torch.unsqueeze(out, d if d >= 0 else d + out.dim() + 1)
    return as_port(out)


def unsqueeze_(x, axis, name=None):
    return _into(x, unsqueeze(x, axis))


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    return as_port(torch.flatten(_t(x), start_axis, stop_axis))


def flatten_(x, start_axis=0, stop_axis=-1, name=None):
    return _into(x, flatten(x, start_axis, stop_axis))


def expand(x, shape, name=None):
    x = _t(x)
    shp = _shape_list(shape)
    tgt = tuple(x.shape[i - (len(shp) - x.dim())] if s == -1 else s
                for i, s in enumerate(shp))
    return as_port(x.expand(tgt))


def expand_as(x, y, name=None):
    return as_port(_t(x).expand(_t(y).shape))


def broadcast_to(x, shape, name=None):
    return as_port(torch.broadcast_to(_t(x), _shape_list(shape)))


def broadcast_shape(x_shape, y_shape):
    return list(np.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def broadcast_tensors(inputs, name=None):
    return [as_port(v) for v in torch.broadcast_tensors(
        *[_t(v) for v in inputs])]


def tile(x, repeat_times, name=None):
    return as_port(torch.tile(_t(x), _shape_list(repeat_times)))


def gather(x, index, axis=0, name=None):
    x = _t(x)
    idx = _t(index, like=x).long().reshape(-1)
    return as_port(torch.index_select(x, _int(axis), idx))


def index_select(x, index, axis=0, name=None):
    return gather(x, index, axis)


def _nd_index(idx):
    return tuple(idx.long().movedim(-1, 0))


def gather_nd(x, index, name=None):
    x = _t(x)
    return as_port(x[_nd_index(_t(index, like=x))])


def scatter(x, index, updates, overwrite=True, name=None):
    """Rows ``index`` of ``x`` replaced by ``updates`` (the last write
    of a repeated row wins); ``overwrite=False``: those rows zeroed, then
    every update added."""
    x = _t(x)
    idx = _t(index, like=x).long().reshape(-1)
    upd = _t(updates, like=x).to(x.dtype)
    if overwrite:
        return as_port(x.index_put((idx,), upd))
    zeroed = x.index_put((idx,), torch.zeros_like(upd))
    return as_port(zeroed.index_put((idx,), upd, accumulate=True))


def scatter_(x, index, updates, overwrite=True, name=None):
    out = scatter(x, index, updates, overwrite=overwrite)
    return torch.Tensor.copy_(x, out)


def scatter_nd_add(x, index, updates, name=None):
    x = _t(x)
    return as_port(x.index_put(_nd_index(_t(index, like=x)),
                               _t(updates, like=x).to(x.dtype),
                               accumulate=True))


def scatter_nd(index, updates, shape, name=None):
    upd = _t(updates)
    z = torch.zeros(tuple(int(s) for s in shape), dtype=upd.dtype,
                    device=upd.device)
    return as_port(z.index_put(_nd_index(_t(index, like=upd)), upd,
                               accumulate=True))


def slice(x, axes, starts, ends, name=None):
    x = _t(x)
    idx = [_slice(None)] * x.dim()
    for ax, st, en in zip(axes, starts, ends):
        idx[ax] = _slice(_int(st), _int(en))
    return as_port(x[tuple(idx)])


def strided_slice(x, axes, starts, ends, strides, name=None):
    """Positive strides (torch has no negative step)."""
    x = _t(x)
    idx = [_slice(None)] * x.dim()
    for ax, st, en, sd in zip(axes, starts, ends, strides):
        idx[ax] = _slice(_int(st), _int(en), _int(sd))
    return as_port(x[tuple(idx)])


def crop(x, shape=None, offsets=None, name=None):
    x = _t(x)
    n = x.dim()

    def ints(v, default):
        if v is None:
            return [default] * n
        if isinstance(v, torch.Tensor):
            v = v.tolist()
        return [int(e) for e in v]

    shp, offs = ints(shape, -1), ints(offsets, 0)
    shp = [x.shape[i] - offs[i] if s == -1 else s for i, s in enumerate(shp)]
    return as_port(x[tuple(_slice(o, o + s) for o, s in zip(offs, shp))])


def masked_select(x, mask, name=None):
    x = _t(x)
    return as_port(torch.masked_select(x, _t(mask, like=x).bool()))


def where(condition, x=None, y=None, name=None):
    c = _t(condition)
    if x is None and y is None:
        return tuple(as_port(v) for v in torch.nonzero(c, as_tuple=True))
    x = _t(x, like=c)
    return as_port(torch.where(c.bool(), x, _t(y, like=x)))


def roll(x, shifts, axis=None, name=None):
    return as_port(torch.roll(_t(x), shifts, dims=axis))


def flip(x, axis, name=None):
    ax = axis if isinstance(axis, (list, tuple)) else [axis]
    return as_port(torch.flip(_t(x), dims=tuple(ax)))


def reverse(x, axis, name=None):
    return flip(x, axis)


def rot90(x, k=1, axes=(0, 1), name=None):
    return as_port(torch.rot90(_t(x), k, tuple(axes)))


def cast(x, dtype):
    return as_port(_t(x).to(to_torch_dtype(dtype)))


def tensordot(x, y, axes=2, name=None):
    if isinstance(axes, torch.Tensor):
        axes = axes.tolist()
    return as_port(torch.tensordot(_t(x), _t(y), dims=axes))


def repeat_interleave(x, repeats, axis=None, name=None):
    x = _t(x)
    r = repeats if isinstance(repeats, int) else _t(repeats, like=x).long()
    return as_port(torch.repeat_interleave(x, r, dim=axis))


def take_along_axis(arr, indices, axis, name=None):
    a = _t(arr)
    idx = _t(indices, like=a).long()
    if idx.dim() == a.dim():  # broadcast the index over the other axes
        shape = [max(n, m) for n, m in zip(a.shape, idx.shape)]
        shape[axis] = idx.shape[axis]
        idx = idx.expand(shape)
    return as_port(torch.gather(a, axis, idx))


def put_along_axis(arr, indices, values, axis, reduce="assign", name=None):
    a = _t(arr)
    idx = _t(indices, like=a).long()
    v = _t(values, like=a).to(a.dtype)
    v = torch.broadcast_to(v, idx.shape)
    if reduce == "add":
        return as_port(torch.scatter_add(a, axis, idx, v))
    return as_port(torch.scatter(a, axis, idx, v))


def put_along_axis_(arr, indices, values, axis, reduce="assign", name=None):
    return torch.Tensor.copy_(arr, put_along_axis(arr, indices, values, axis,
                                                  reduce))


def as_complex(x, name=None):
    x = _t(x)
    return as_port(torch.complex(x[..., 0], x[..., 1]))


def as_real(x, name=None):
    x = _t(x)
    return as_port(torch.stack([x.real, x.imag], dim=-1))


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, name=None):
    """The sorted distinct values (through numpy on the host, as the
    reference); the index, inverse and counts as int64."""
    x = _t(x)
    res = np.unique(x.detach().cpu().numpy(), return_index=return_index,
                    return_inverse=return_inverse,
                    return_counts=return_counts, axis=axis)
    if isinstance(res, tuple):
        return tuple(to_tensor(r, place=x.device) for r in res)
    return to_tensor(res, place=x.device)


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, dtype="int64", name=None):
    x = _t(x)
    out = torch.unique_consecutive(x, return_inverse=return_inverse,
                                   return_counts=return_counts, dim=axis)
    if not isinstance(out, tuple):
        return as_port(out)
    dt = to_torch_dtype(dtype)
    return (as_port(out[0]),) + tuple(as_port(o.to(dt)) for o in out[1:])


def tolist(x):
    return _t(x).tolist()


def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    return as_port(torch.diagonal(_t(x), offset, axis1, axis2))


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    """Global ids to this shard's local ids (``ignore_value`` elsewhere)."""
    if not 0 <= shard_id < nshards:
        raise ValueError(f"shard_id {shard_id} out of range for {nshards} "
                         f"shards")
    a = _t(input)
    size = (index_num + nshards - 1) // nshards
    return as_port(torch.where(a // size == shard_id, a % size,
                               torch.full_like(a, ignore_value)))
