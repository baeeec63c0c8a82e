"""Comparison and logical functions — the port of
``paddle_tpu/tensor_ops/logic.py``. A Python number is compared in the
tensor's dtype; outputs take no gradient."""
from __future__ import annotations

import torch

from ..core.tensor import as_port, as_tensor_arg

__all__ = [
    "equal", "not_equal", "greater_than", "greater_equal", "less_than",
    "less_equal", "logical_and", "logical_or", "logical_not",
    "logical_xor", "allclose", "isclose", "equal_all", "is_empty",
    "is_tensor", "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
]


def _pair(x, y):
    x = as_tensor_arg(x).detach()
    if isinstance(y, torch.Tensor):
        return x, y.detach()
    if isinstance(y, (bool, int, float)):
        return x, torch.tensor(y, dtype=x.dtype, device=x.device)
    return x, as_tensor_arg(y, like=x).detach()


def _cmp(op_name, f):
    def op(x, y, name=None):
        return as_port(f(*_pair(x, y)))

    op.__name__ = op_name
    return op


equal = _cmp("equal", torch.eq)
not_equal = _cmp("not_equal", torch.ne)
greater_than = _cmp("greater_than", torch.gt)
greater_equal = _cmp("greater_equal", torch.ge)
less_than = _cmp("less_than", torch.lt)
less_equal = _cmp("less_equal", torch.le)
logical_and = _cmp("logical_and", torch.logical_and)
logical_or = _cmp("logical_or", torch.logical_or)
logical_xor = _cmp("logical_xor", torch.logical_xor)
bitwise_and = _cmp("bitwise_and", torch.bitwise_and)
bitwise_or = _cmp("bitwise_or", torch.bitwise_or)
bitwise_xor = _cmp("bitwise_xor", torch.bitwise_xor)


def logical_not(x, name=None):
    return as_port(torch.logical_not(as_tensor_arg(x).detach()))


def bitwise_not(x, name=None):
    return as_port(torch.bitwise_not(as_tensor_arg(x).detach()))


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    x, y = _pair(x, y)
    return as_port(torch.tensor(torch.allclose(x, y.to(x.dtype), rtol, atol,
                                               equal_nan), device=x.device))


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    x, y = _pair(x, y)
    return as_port(torch.isclose(x, y.to(x.dtype), rtol, atol, equal_nan))


def equal_all(x, y, name=None):
    x, y = _pair(x, y)
    return as_port(torch.tensor(torch.equal(x, y.to(x.dtype))
                                if x.shape == y.shape else False,
                                device=x.device))


def is_empty(x, name=None):
    x = as_tensor_arg(x)
    return as_port(torch.tensor(x.numel() == 0, device=x.device))


def is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)
