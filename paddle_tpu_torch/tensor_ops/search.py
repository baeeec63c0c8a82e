"""Search and sort functions — the port of
``paddle_tpu/tensor_ops/search.py``. Indices are int64; ``mode`` breaks
a tie toward the largest of the most frequent values and its last
position, as the reference's kernel."""
from __future__ import annotations

import torch

from ..core.dtype import to_torch_dtype
from ..core.tensor import as_port, as_tensor_arg

__all__ = ["argmax", "argmin", "argsort", "sort", "topk", "nonzero",
           "kthvalue", "mode", "index_sample", "searchsorted", "median"]

_t = as_tensor_arg


def _arg(fn, x, axis, keepdim, dtype):
    x = _t(x).detach()
    if axis is None:
        out = fn(x.reshape(-1))
        if keepdim:
            out = out.reshape((1,) * x.dim())
    else:
        out = fn(x, dim=axis, keepdim=keepdim)
    return as_port(out.to(to_torch_dtype(dtype)))


def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg(torch.argmax, x, axis, keepdim, dtype)


def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg(torch.argmin, x, axis, keepdim, dtype)


def argsort(x, axis=-1, descending=False, name=None):
    """Ascending stable order; ``descending`` its reverse, as the
    reference flips it."""
    idx = torch.argsort(_t(x).detach(), dim=axis, stable=True)
    return as_port(torch.flip(idx, dims=(axis,)) if descending else idx)


def sort(x, axis=-1, descending=False, name=None):
    s = torch.sort(_t(x), dim=axis, stable=True).values
    return as_port(torch.flip(s, dims=(axis,)) if descending else s)


def topk(x, k, axis=-1, largest=True, sorted=True, name=None):
    out = torch.topk(_t(x), int(k.item() if isinstance(k, torch.Tensor)
                                else k), dim=axis, largest=largest,
                     sorted=True)
    return as_port(out.values), as_port(out.indices)


def nonzero(x, as_tuple=False):
    nz = torch.nonzero(_t(x))
    if as_tuple:
        return tuple(as_port(nz[:, i:i + 1]) for i in range(nz.shape[1]))
    return as_port(nz)


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    x = _t(x)
    s, i = torch.sort(x, dim=axis, stable=True)
    vals = s.select(axis, k - 1)
    idx = i.select(axis, k - 1)
    if keepdim:
        vals, idx = vals.unsqueeze(axis), idx.unsqueeze(axis)
    return as_port(vals), as_port(idx)


def mode(x, axis=-1, keepdim=False, name=None):
    """The most frequent value along ``axis`` and its last index."""
    x = _t(x)
    am = x.movedim(axis, -1)
    n = am.shape[-1]
    s = torch.sort(am, dim=-1).values
    new_run = torch.cat([torch.ones(am.shape[:-1] + (1,), dtype=torch.bool,
                                    device=x.device),
                         s[..., 1:] != s[..., :-1]], dim=-1)
    pos = torch.arange(n, device=x.device)
    run_start = torch.cummax(torch.where(new_run, pos, 0), dim=-1).values
    run_count = pos - run_start + 1
    best = (n - 1) - torch.argmax(run_count.flip(-1), dim=-1)
    vals = torch.gather(s, -1, best[..., None])[..., 0]
    idx = (n - 1) - torch.argmax((am == vals[..., None]).flip(-1).int(),
                                 dim=-1)
    if keepdim:
        vals, idx = vals.unsqueeze(axis), idx.unsqueeze(axis)
    return as_port(vals), as_port(idx)


def index_sample(x, index):
    x = _t(x)
    return as_port(torch.gather(x, 1, _t(index, like=x).long()))


def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    s = _t(sorted_sequence).detach()
    return as_port(torch.searchsorted(s, _t(values, like=s).detach(),
                                      right=right, out_int32=out_int32))


def median(x, axis=None, keepdim=False, name=None):
    """The mean of the two middle values for an even count, as the
    reference (torch's own ``median`` takes the lower one)."""
    x = _t(x)
    if axis is None:
        out = torch.quantile(x.reshape(-1).to(
            x.dtype if x.is_floating_point() else torch.float32), 0.5)
        return as_port(out.reshape((1,) * x.dim()) if keepdim else out)
    return as_port(torch.quantile(x, 0.5, dim=axis, keepdim=keepdim))
