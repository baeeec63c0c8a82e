"""Math functions — the port of ``paddle_tpu/tensor_ops/math.py``.

A Python number operand stays a number (torch's promotion keeps the
tensor's dtype, as the reference's weak types do); ``axis`` takes an
int, a list or None (every axis). The in-place ``*_`` functions write
into their first operand (torch's in-place rules: not on a leaf that
requires a gradient)."""
from __future__ import annotations

import builtins

import numpy as np
import torch

from ..core.dtype import to_torch_dtype
from ..core.tensor import as_port, as_tensor_arg

__all__ = [
    "add", "subtract", "multiply", "divide", "floor_divide", "remainder",
    "mod", "pow", "matmul", "sqrt", "rsqrt", "exp", "expm1", "log", "log2",
    "log10", "log1p", "abs", "neg", "sign", "sin", "cos", "tan", "sinh",
    "cosh", "tanh", "asin", "acos", "atan", "atan2", "floor", "ceil",
    "round", "trunc", "clip", "maximum", "minimum", "fmax", "fmin", "sum",
    "mean", "max", "min", "prod", "cumsum", "cumprod", "std", "var",
    "square", "reciprocal", "erf", "add_n", "logsumexp", "isnan", "isinf",
    "isfinite", "all", "any", "scale", "increment", "dot", "outer",
    "inner", "multiplex", "logit", "lerp", "rad2deg", "deg2rad", "amax",
    "amin", "nanmean", "nansum", "count_nonzero", "frac", "diff", "angle",
    "stanh", "multiply_", "add_", "clip_", "scale_", "subtract_",
    "acosh", "asinh", "atanh", "conj", "digamma", "lgamma", "erfinv",
    "real", "imag", "gcd", "lcm", "heaviside", "kron", "floor_mod",
    "tanh_", "trace", "addmm", "quantile", "nanquantile", "renorm", "rank",
    "is_complex", "is_floating_point", "is_integer", "bincount", "exp_",
    "ceil_", "floor_", "round_", "sqrt_", "rsqrt_", "reciprocal_",
    "erfinv_", "lerp_",
]

_t = as_tensor_arg


def _operand(y, x):
    """``y`` beside tensor ``x``: a number stays a number."""
    if isinstance(y, torch.Tensor) or isinstance(y, (bool, int, float,
                                                     builtins.complex)):
        return y
    return as_tensor_arg(y, like=x)


def _binary(op_name, f):
    def op(x, y, name=None):
        x = _t(x)
        return as_port(f(x, _operand(y, x)))

    op.__name__ = op_name
    return op


def _unary(op_name, f):
    def op(x, name=None, **_):
        return as_port(f(_t(x)))

    op.__name__ = op_name
    return op


def _axis(axis, x):
    """``axis`` as a tuple of dims (None: every dim)."""
    if axis is None:
        return tuple(range(x.dim()))
    if isinstance(axis, torch.Tensor):
        axis = axis.tolist()
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return (int(axis),)


add = _binary("add", torch.add)
subtract = _binary("subtract", torch.sub)
multiply = _binary("multiply", torch.mul)
divide = _binary("divide", torch.true_divide)
floor_divide = _binary("floor_divide", torch.floor_divide)
remainder = _binary("remainder", torch.remainder)
mod = floor_mod = remainder
maximum = _binary("maximum", lambda a, b: torch.maximum(a, _t(b, like=a)))
minimum = _binary("minimum", lambda a, b: torch.minimum(a, _t(b, like=a)))
fmax = _binary("fmax", lambda a, b: torch.fmax(a, _t(b, like=a)))
fmin = _binary("fmin", lambda a, b: torch.fmin(a, _t(b, like=a)))
atan2 = _binary("atan2", lambda a, b: torch.atan2(a, _t(b, like=a)))
gcd = _binary("gcd", lambda a, b: torch.gcd(a, _t(b, like=a)))
lcm = _binary("lcm", lambda a, b: torch.lcm(a, _t(b, like=a)))
heaviside = _binary("heaviside", lambda a, b: torch.heaviside(
    a, _t(b, like=a).to(a.dtype)))
kron = _binary("kron", lambda a, b: torch.kron(a, _t(b, like=a)))


def pow(x, y, name=None):
    x = _t(x)
    return as_port(torch.pow(x, _operand(y, x)))


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    a, b = _t(x), _t(y)
    if transpose_x and a.dim() >= 2:
        a = a.transpose(-1, -2)
    if transpose_y and b.dim() >= 2:
        b = b.transpose(-1, -2)
    return as_port(torch.matmul(a, b))


def _imag(a):
    return torch.imag(a) if a.is_complex() else torch.zeros_like(a)


sqrt = _unary("sqrt", torch.sqrt)
rsqrt = _unary("rsqrt", torch.rsqrt)
exp = _unary("exp", torch.exp)
expm1 = _unary("expm1", torch.expm1)
log = _unary("log", torch.log)
log2 = _unary("log2", torch.log2)
log10 = _unary("log10", torch.log10)
log1p = _unary("log1p", torch.log1p)
abs = _unary("abs", torch.abs)
neg = _unary("neg", torch.neg)
sign = _unary("sign", torch.sign)
sin = _unary("sin", torch.sin)
cos = _unary("cos", torch.cos)
tan = _unary("tan", torch.tan)
sinh = _unary("sinh", torch.sinh)
cosh = _unary("cosh", torch.cosh)
tanh = _unary("tanh", torch.tanh)
asin = _unary("asin", torch.asin)
acos = _unary("acos", torch.acos)
atan = _unary("atan", torch.atan)
acosh = _unary("acosh", torch.acosh)
asinh = _unary("asinh", torch.asinh)
atanh = _unary("atanh", torch.atanh)
floor = _unary("floor", torch.floor)
ceil = _unary("ceil", torch.ceil)
round = _unary("round", torch.round)  # half to even, as the reference
trunc = _unary("trunc", torch.trunc)
square = _unary("square", torch.square)
reciprocal = _unary("reciprocal", lambda a: 1.0 / a)
erf = _unary("erf", torch.erf)
erfinv = _unary("erfinv", torch.erfinv)
digamma = _unary("digamma", torch.digamma)
lgamma = _unary("lgamma", torch.lgamma)
isnan = _unary("isnan", torch.isnan)
isinf = _unary("isinf", torch.isinf)
isfinite = _unary("isfinite", torch.isfinite)
frac = _unary("frac", lambda a: a - torch.trunc(a))
rad2deg = _unary("rad2deg", torch.rad2deg)
deg2rad = _unary("deg2rad", torch.deg2rad)
angle = _unary("angle", torch.angle)
logit = _unary("logit", lambda a: torch.log(a / (1 - a)))
stanh = _unary("stanh", lambda a: 1.7159 * torch.tanh(0.66667 * a))
conj = _unary("conj", lambda a: torch.conj(a).resolve_conj())
real = _unary("real", lambda a: torch.real(a).clone())
imag = _unary("imag", _imag)


def clip(x, min=None, max=None, name=None):
    return as_port(torch.clamp(_t(x), min=min, max=max))


def sum(x, axis=None, dtype=None, keepdim=False, name=None):
    x = _t(x)
    return as_port(torch.sum(x, dim=_axis(axis, x), keepdim=keepdim,
                             dtype=to_torch_dtype(dtype)))


def mean(x, axis=None, keepdim=False, name=None):
    x = _t(x)
    return as_port(torch.mean(x, dim=_axis(axis, x), keepdim=keepdim))


def max(x, axis=None, keepdim=False, name=None):
    x = _t(x)
    return as_port(torch.amax(x, dim=_axis(axis, x), keepdim=keepdim))


def min(x, axis=None, keepdim=False, name=None):
    x = _t(x)
    return as_port(torch.amin(x, dim=_axis(axis, x), keepdim=keepdim))


amax, amin = max, min


def prod(x, axis=None, keepdim=False, dtype=None, name=None):
    x = _t(x)
    out = x.to(to_torch_dtype(dtype)) if dtype is not None else x
    for d in sorted((a % builtins.max(x.dim(), 1) for a in _axis(axis, x)),
                    reverse=True):
        out = torch.prod(out, dim=d, keepdim=keepdim)
    return as_port(out)


def nanmean(x, axis=None, keepdim=False, name=None):
    x = _t(x)
    return as_port(torch.nanmean(x, dim=_axis(axis, x), keepdim=keepdim))


def nansum(x, axis=None, dtype=None, keepdim=False, name=None):
    x = _t(x)
    return as_port(torch.nansum(x, dim=_axis(axis, x), keepdim=keepdim))


def count_nonzero(x, axis=None, keepdim=False, name=None):
    x = _t(x)
    return as_port(torch.sum(x != 0, dim=_axis(axis, x), keepdim=keepdim,
                             dtype=torch.int64))


def cumsum(x, axis=None, dtype=None, name=None):
    x = _t(x)
    if axis is None:
        return as_port(torch.cumsum(x.reshape(-1), 0))
    return as_port(torch.cumsum(x, int(axis)))


def cumprod(x, dim=None, dtype=None, name=None):
    x = _t(x)
    if dim is None:
        return as_port(torch.cumprod(x.reshape(-1), 0))
    return as_port(torch.cumprod(x, int(dim)))


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    x = _t(x)
    return as_port(torch.std(x, dim=_axis(axis, x), keepdim=keepdim,
                             correction=1 if unbiased else 0))


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    x = _t(x)
    return as_port(torch.var(x, dim=_axis(axis, x), keepdim=keepdim,
                             correction=1 if unbiased else 0))


def add_n(inputs, name=None):
    if isinstance(inputs, torch.Tensor):
        return as_port(inputs)
    ts = [_t(v) for v in inputs]
    out = ts[0]
    for t in ts[1:]:
        out = out + t
    return as_port(out)


def logsumexp(x, axis=None, keepdim=False, name=None):
    x = _t(x)
    return as_port(torch.logsumexp(x, dim=_axis(axis, x), keepdim=keepdim))


def all(x, axis=None, keepdim=False, name=None):
    x = _t(x).bool()
    out = x
    for d in sorted((a % builtins.max(x.dim(), 1) for a in _axis(axis, x)),
                    reverse=True):
        out = torch.all(out, dim=d, keepdim=keepdim)
    return as_port(out)


def any(x, axis=None, keepdim=False, name=None):
    x = _t(x).bool()
    out = x
    for d in sorted((a % builtins.max(x.dim(), 1) for a in _axis(axis, x)),
                    reverse=True):
        out = torch.any(out, dim=d, keepdim=keepdim)
    return as_port(out)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    s = scale.item() if isinstance(scale, torch.Tensor) else scale
    x = _t(x)
    return as_port(x * s + bias if bias_after_scale else (x + bias) * s)


def increment(x, value=1.0, name=None):
    """``x += value`` in place; returns ``x``."""
    return x.add_(value)


def dot(x, y, name=None):
    return as_port(torch.sum(_t(x) * _t(y), dim=-1))


def outer(x, y, name=None):
    return as_port(torch.outer(_t(x).reshape(-1), _t(y).reshape(-1)))


def inner(x, y, name=None):
    return as_port(torch.inner(_t(x), _t(y)))


def multiplex(inputs, index, name=None):
    """Row ``i`` of ``inputs[index[i]]``."""
    stacked = torch.stack([_t(v) for v in inputs], 0)
    idx = _t(index).long().reshape(1, -1, *([1] * (stacked.dim() - 2)))
    idx = idx.expand(1, -1, *stacked.shape[2:])
    return as_port(torch.gather(stacked, 0, idx)[0])


def lerp(x, y, weight, name=None):
    """``x + weight * (y - x)``, the reference's formula."""
    x = _t(x)
    y = _t(y, like=x)
    w = weight if not isinstance(weight, (list, np.ndarray)) \
        else _t(weight, like=x)
    return as_port(x + w * (y - x))


def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    return as_port(torch.diff(_t(x), n=n, dim=axis))


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return as_port(torch.diagonal(_t(x), offset, axis1, axis2).sum(-1))


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    return as_port(beta * _t(input) + alpha * (_t(x) @ _t(y)))


def _quantile(fn, x, q, axis, keepdim):
    x = _t(x)
    a = x if x.dtype == torch.float64 else x.float()
    qv = q.to(a) if isinstance(q, torch.Tensor) else torch.as_tensor(
        q, dtype=a.dtype, device=a.device)
    if axis is None:
        out = fn(a.reshape(-1), qv, dim=0)
        return as_port(out.reshape(qv.shape + (1,) * a.dim()) if keepdim
                       else out)
    return as_port(fn(a, qv, dim=int(axis), keepdim=keepdim))


def quantile(x, q, axis=None, keepdim=False, name=None):
    return _quantile(torch.quantile, x, q, axis, keepdim)


def nanquantile(x, q, axis=None, keepdim=False, name=None):
    return _quantile(torch.nanquantile, x, q, axis, keepdim)


def renorm(x, p, axis, max_norm, name=None):
    """Scale each sub-tensor along ``axis`` whose ``p``-norm exceeds
    ``max_norm`` down to it (the reference's ``1e-7`` guard)."""
    x = _t(x)
    red = tuple(i for i in range(x.dim()) if i != axis % x.dim())
    norms = torch.sum(torch.abs(x) ** p, dim=red, keepdim=True) ** (1.0 / p)
    factor = torch.where(norms > max_norm, max_norm / (norms + 1e-7),
                         torch.ones_like(norms))
    return as_port(x * factor)


def rank(input, name=None):
    x = _t(input)
    return as_port(torch.tensor(x.dim(), dtype=torch.int32,
                                device=x.device))


def is_complex(x) -> bool:
    return _t(x).is_complex()


def is_floating_point(x) -> bool:
    return _t(x).is_floating_point()


def is_integer(x) -> bool:
    x = _t(x)
    return not (x.is_floating_point() or x.is_complex()) \
        and x.dtype != torch.bool


def bincount(x, weights=None, minlength=0, name=None):
    x = _t(x)
    w = None if weights is None else _t(weights, like=x)
    if w is not None and not w.is_floating_point():
        w = w.double()
    return as_port(torch.bincount(x.reshape(-1), weights=w,
                                  minlength=int(minlength)))


# -------------------------------------------------------------- in place
def _inplace(fn, fn_name):
    def op(x, *args, name=None, **kw):
        return torch.Tensor.copy_(x, fn(x, *args, **kw))

    op.__name__ = fn_name
    return op


def multiply_(x, y, name=None):
    return x.mul_(_operand(y, x))


def add_(x, y, name=None):
    return x.add_(_operand(y, x))


def subtract_(x, y, name=None):
    return x.sub_(_operand(y, x))


def clip_(x, min=None, max=None, name=None):
    return x.clamp_(min=min, max=max)


def scale_(x, scale=1.0, bias=0.0, name=None):
    return x.mul_(scale).add_(bias)


def tanh_(x, name=None):
    return x.tanh_()


exp_ = _inplace(exp, "exp_")
ceil_ = _inplace(ceil, "ceil_")
floor_ = _inplace(floor, "floor_")
round_ = _inplace(round, "round_")
sqrt_ = _inplace(sqrt, "sqrt_")
rsqrt_ = _inplace(rsqrt, "rsqrt_")
reciprocal_ = _inplace(reciprocal, "reciprocal_")
erfinv_ = _inplace(erfinv, "erfinv_")
lerp_ = _inplace(lerp, "lerp_")
