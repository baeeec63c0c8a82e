"""Creation functions — the port of ``paddle_tpu/tensor_ops/creation.py``.

Dtypes follow the reference: ``zeros``/``ones``/``eye``/``linspace``
make the default dtype (float32) unless told; ``full`` makes bool for a
bool fill, int64 for an int fill; ``arange`` int64 when every bound is
an int. New tensors go to ``set_device``'s place."""
from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from ..core.dtype import get_default_dtype, to_torch_dtype
from ..core.tensor import as_port, as_tensor_arg, to_tensor

__all__ = [
    "to_tensor", "zeros", "ones", "full", "zeros_like", "ones_like",
    "full_like", "empty", "empty_like", "arange", "linspace", "eye",
    "tril", "triu", "diag", "diagflat", "meshgrid", "assign", "clone",
    "numel", "one_hot", "logspace", "tril_indices", "triu_indices",
    "complex",
]


def _dt(dtype, default=None):
    return to_torch_dtype(dtype if dtype is not None
                          else default or get_default_dtype())


def _scalar(v):
    return v.item() if isinstance(v, torch.Tensor) else v


def _shape(shape) -> tuple:
    if isinstance(shape, torch.Tensor):
        return tuple(int(s) for s in shape.tolist())
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(_scalar(s)) for s in shape)


def _new(fn, *args, dtype, **kw):
    return as_port(fn(*args, dtype=dtype, device=resolve_device(None), **kw))


def zeros(shape, dtype=None, name=None):
    return _new(torch.zeros, _shape(shape), dtype=_dt(dtype))


def ones(shape, dtype=None, name=None):
    return _new(torch.ones, _shape(shape), dtype=_dt(dtype))


def full(shape, fill_value, dtype=None, name=None):
    fill_value = _scalar(fill_value)
    if dtype is None and isinstance(fill_value, bool):
        dtype = "bool"
    elif dtype is None and isinstance(fill_value, (int, np.integer)):
        dtype = "int64"
    return _new(torch.full, _shape(shape), fill_value, dtype=_dt(dtype))


def zeros_like(x, dtype=None, name=None):
    return as_port(torch.zeros_like(as_tensor_arg(x),
                                    dtype=to_torch_dtype(dtype)))


def ones_like(x, dtype=None, name=None):
    return as_port(torch.ones_like(as_tensor_arg(x),
                                   dtype=to_torch_dtype(dtype)))


def full_like(x, fill_value, dtype=None, name=None):
    return as_port(torch.full_like(as_tensor_arg(x), _scalar(fill_value),
                                   dtype=to_torch_dtype(dtype)))


def empty(shape, dtype=None, name=None):
    """Zero-filled, as the reference (it has no uninitialised memory)."""
    return zeros(shape, dtype)


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype)


def arange(start=0, end=None, step=1, dtype=None, name=None):
    start, end, step = _scalar(start), _scalar(end), _scalar(step)
    if end is None:
        start, end = 0, start
    if dtype is None:
        dtype = ("int64" if all(isinstance(v, (int, np.integer))
                                for v in (start, end, step))
                 else get_default_dtype())
    return _new(torch.arange, start, end, step, dtype=_dt(dtype))


def linspace(start, stop, num, dtype=None, name=None):
    return _new(torch.linspace, float(_scalar(start)), float(_scalar(stop)),
                int(_scalar(num)), dtype=_dt(dtype))


def logspace(start, stop, num, base=10.0, dtype=None, name=None):
    return _new(torch.logspace, float(_scalar(start)), float(_scalar(stop)),
                int(_scalar(num)), base=float(base),
                dtype=to_torch_dtype(dtype) or torch.float32)


def eye(num_rows, num_columns=None, dtype=None, name=None):
    n = int(num_rows)
    return _new(torch.eye, n, n if num_columns is None else int(num_columns),
                dtype=_dt(dtype))


def tril(x, diagonal=0, name=None):
    return as_port(torch.tril(as_tensor_arg(x), diagonal))


def triu(x, diagonal=0, name=None):
    return as_port(torch.triu(as_tensor_arg(x), diagonal))


def diag(x, offset=0, padding_value=0, name=None):
    """1-D: the square matrix with ``x`` on diagonal ``offset`` (off the
    main diagonal filled with ``padding_value``, as the reference fills
    it); 2-D: diagonal ``offset`` of ``x``."""
    x = as_tensor_arg(x)
    if x.dim() == 1:
        d = torch.diag(x, offset)
        if padding_value != 0:
            keep = torch.eye(*d.shape, dtype=torch.bool, device=d.device)
            d = torch.where(keep, d, torch.full_like(d, padding_value))
        return as_port(d)
    return as_port(torch.diagonal(x, offset))


def diagflat(x, offset=0, name=None):
    return as_port(torch.diagflat(as_tensor_arg(x), offset))


def meshgrid(*args, **kwargs):
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        args = tuple(args[0])
    ts = [as_tensor_arg(a) for a in args]
    return [as_port(t) for t in torch.meshgrid(*ts, indexing="ij")]


def assign(x, output=None):
    """A copy of ``x``; with ``output``, ``x`` written into it (cast to
    its dtype) and ``output`` returned."""
    if output is not None:
        src = as_tensor_arg(x, like=output)
        with torch.no_grad():
            torch.Tensor.copy_(output, src.to(output.dtype))
        return output
    if isinstance(x, torch.Tensor):
        return as_port(x.clone())
    return to_tensor(x)


def clone(x, name=None):
    return as_port(as_tensor_arg(x).clone())


def numel(x, name=None):
    x = as_tensor_arg(x)
    return as_port(torch.tensor(x.numel(), dtype=torch.int64,
                                device=x.device))


def one_hot(x, num_classes, name=None):
    """float32 ``[..., num_classes]``: row ``x`` of the identity."""
    x = as_tensor_arg(x)
    eye_ = torch.eye(int(num_classes), dtype=torch.float32, device=x.device)
    return as_port(eye_[x.long()])


def tril_indices(row, col=None, offset=0, dtype="int64"):
    col = row if col is None else col
    return as_port(torch.tril_indices(
        int(row), int(col), int(offset), dtype=to_torch_dtype(dtype),
        device=resolve_device(None)))


def triu_indices(row, col=None, offset=0, dtype="int64"):
    col = row if col is None else col
    return as_port(torch.triu_indices(
        int(row), int(col), int(offset), dtype=to_torch_dtype(dtype),
        device=resolve_device(None)))


def complex(real, imag, name=None):
    real = as_tensor_arg(real)
    return as_port(torch.complex(real, as_tensor_arg(imag, like=real)))
