"""Weight initializers — the port of ``paddle_tpu/nn/initializer.py``.

An initializer is called with ``(shape, dtype)`` and returns a new tensor
on ``set_device``'s place (else the card). The random ones take the next
key of the port's key schedule (``core.rng.next_rng_key``) — one key a
call, in the order the layers are built, as the reference's do — and
draw from it with the port's threefry (``tensor_ops.random``), so for
the same ``paddle.seed`` the initial weights are the reference's: bit for
bit for the uniform ones (``Uniform``, ``XavierUniform``,
``KaimingUniform``), within float32 rounding for the normal ones
(``Normal``, ``TruncatedNormal``, ``XavierNormal``, ``KaimingNormal``,
``Orthogonal``), whose ``erfinv`` (and ``erf``, QR) are torch's, not
XLA's. A dtype other than float32 and float64 is drawn in float32 and
cast.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .._device import resolve_device
from ..core.dtype import to_torch_dtype
from ..core.rng import next_rng_key
from ..tensor_ops.random import _normal, _uniform

__all__ = [
    "Bilinear", "set_global_initializer",
    "Initializer", "Constant", "Normal", "TruncatedNormal", "Uniform",
    "XavierNormal", "XavierUniform", "KaimingNormal", "KaimingUniform",
    "Assign", "Orthogonal", "Dirac", "calculate_gain",
]


def _fans(shape):
    shape = tuple(shape)
    if len(shape) < 1:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    # conv kernels [out_c, in_c, *k]
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


def calculate_gain(nonlinearity, param=None):
    if nonlinearity == "tanh":
        return 5.0 / 3
    if nonlinearity == "relu":
        return math.sqrt(2.0)
    if nonlinearity == "leaky_relu":
        a = 0.01 if param is None else param
        return math.sqrt(2.0 / (1 + a**2))
    if nonlinearity == "selu":
        return 3.0 / 4
    return 1.0


def _dtype(dtype) -> torch.dtype:
    return to_torch_dtype(dtype or "float32")


def _draw_dtype(dt: torch.dtype) -> torch.dtype:
    return dt if dt in (torch.float32, torch.float64) else torch.float32


def _scaled(z, scale, shift, dt):
    """``z * scale + shift`` in ``z``'s dtype (a Python scale rounded to
    it, as the reference's weakly typed product), cast to ``dt``."""
    return (z * scale + shift).to(dt) if shift else (z * scale).to(dt)


class Initializer:
    def __call__(self, shape, dtype):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype):
        return torch.full(tuple(shape), self.value, dtype=_dtype(dtype),
                          device=resolve_device(None))


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype):
        dt = _dtype(dtype)
        z = _normal(next_rng_key(), tuple(shape), _draw_dtype(dt))
        return _scaled(z, self.std, self.mean, dt)


class TruncatedNormal(Initializer):
    """Normal draws truncated to two standard deviations: the reference's
    ``sqrt(2) * erfinv(u)``, ``u`` uniform between ``erf(-sqrt(2))`` and
    ``erf(sqrt(2))``, clipped to the open interval."""

    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype):
        dt = _dtype(dtype)
        draw = _draw_dtype(dt)
        npdt = np.float32 if draw == torch.float32 else np.float64
        sqrt2 = npdt(np.sqrt(2))
        lo = torch.erf(torch.tensor(npdt(-2.0) / sqrt2, dtype=draw))
        hi = torch.erf(torch.tensor(npdt(2.0) / sqrt2, dtype=draw))
        u = _uniform(next_rng_key(), tuple(shape), draw, float(lo),
                     float(hi))
        z = torch.erfinv(u) * torch.tensor(sqrt2, dtype=draw,
                                           device=u.device)
        z = torch.clamp(z, float(np.nextafter(npdt(-2.0), npdt(np.inf))),
                        float(np.nextafter(npdt(2.0), npdt(-np.inf))))
        return _scaled(z, self.std, self.mean, dt)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def __call__(self, shape, dtype):
        dt = _dtype(dtype)
        return _uniform(next_rng_key(), tuple(shape), dt, float(self.low),
                        float(self.high))


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype):
        fi, fo = _fans(shape)
        fi = self.fan_in or fi
        fo = self.fan_out or fo
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        dt = _dtype(dtype)
        z = _normal(next_rng_key(), tuple(shape), _draw_dtype(dt))
        return _scaled(z, std, 0.0, dt)


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype):
        fi, fo = _fans(shape)
        fi = self.fan_in or fi
        fo = self.fan_out or fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return _uniform(next_rng_key(), tuple(shape), _dtype(dtype), -limit,
                        limit)


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype):
        fi, _ = _fans(shape)
        fi = self.fan_in or fi
        gain = calculate_gain(self.nonlinearity, self.negative_slope)
        dt = _dtype(dtype)
        z = _normal(next_rng_key(), tuple(shape), _draw_dtype(dt))
        return _scaled(z, gain / math.sqrt(fi), 0.0, dt)


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype):
        fi, _ = _fans(shape)
        fi = self.fan_in or fi
        gain = calculate_gain(self.nonlinearity, self.negative_slope)
        limit = gain * math.sqrt(3.0 / fi)
        return _uniform(next_rng_key(), tuple(shape), _dtype(dtype), -limit,
                        limit)


class Assign(Initializer):
    """A given value (a tensor, array or list), reshaped to ``shape``."""

    def __init__(self, value):
        self.value = value

    def _array(self) -> np.ndarray:
        v = self.value
        if isinstance(v, torch.Tensor):
            v = v.detach().float().cpu().numpy() \
                if v.dtype == torch.bfloat16 else v.detach().cpu().numpy()
        return np.asarray(v)

    def __call__(self, shape, dtype):
        t = torch.as_tensor(self._array()).to(
            device=resolve_device(None), dtype=_dtype(dtype))
        if tuple(t.shape) != tuple(shape):
            t = t.reshape(tuple(shape))
        return t


class Orthogonal(Initializer):
    """The reference's (``jax.nn.initializers.orthogonal``): a normal
    ``[max(r, c), min(r, c)]`` draw (``r`` the product of all dimensions
    but the last, ``c`` the last), its QR's ``Q`` times the signs of
    ``R``'s diagonal, transposed when ``r < c``, times ``gain``."""

    def __init__(self, gain=1.0):
        self.gain = gain

    def __call__(self, shape, dtype):
        shape = tuple(int(s) for s in shape)
        if len(shape) < 2:
            raise ValueError("orthogonal initializer requires at least a 2D "
                             "shape")
        dt = _dtype(dtype)
        draw = _draw_dtype(dt)
        n_cols = shape[-1]
        n_rows = int(np.prod(shape)) // n_cols
        z = _normal(next_rng_key(), (max(n_rows, n_cols),
                                     min(n_rows, n_cols)), draw)
        q, r = torch.linalg.qr(z)
        q = q * torch.sign(torch.diagonal(r))[None, :]
        if n_rows < n_cols:
            q = q.T
        q = q.reshape(shape[:-1] + (n_cols,))
        return (torch.tensor(self.gain, dtype=draw, device=q.device)
                * q).to(dt)


class Dirac(Initializer):
    def __init__(self, groups=1):
        self.groups = groups

    def __call__(self, shape, dtype):
        w = np.zeros(shape, dtype=np.float32)
        oc, ic = shape[0], shape[1]
        k = [s // 2 for s in shape[2:]]
        for i in range(min(oc, ic * self.groups)):
            w[(i, i % ic) + tuple(k)] = 1.0
        return torch.from_numpy(w).to(device=resolve_device(None),
                                      dtype=_dtype(dtype))


class Bilinear(Initializer):
    """Bilinear-upsample kernels for a transposed convolution: every
    ``(out, in)`` channel pair of a ``[c_out, c_in, kh, kw]`` weight gets
    the same separable triangular kernel."""

    def __call__(self, shape, dtype="float32", key=None):
        shape = tuple(int(s) for s in shape)
        if len(shape) != 4:
            raise ValueError(
                f"Bilinear initializer needs 4-D conv weights, got {shape}")
        kh, kw = shape[2], shape[3]

        def tri(k):
            f = np.ceil(k / 2.0)
            c = (2 * f - 1 - f % 2) / (2.0 * f)
            x = np.arange(k)
            return 1 - np.abs(x / f - c)

        kernel = np.outer(tri(kh), tri(kw)).astype(np.float32)
        w = np.zeros(shape, np.float32)
        w[:, :] = kernel
        return torch.from_numpy(w).to(device=resolve_device(None),
                                      dtype=_dtype(dtype))


_GLOBAL_INIT = [None, None]  # (weight_init, bias_init)


def set_global_initializer(weight_init, bias_init=None):
    """Default initializers for parameters made afterwards: they beat a
    layer's own default, and a ``ParamAttr``'s initializer beats them.
    ``None`` clears."""
    if weight_init is not None and not isinstance(weight_init, Initializer):
        raise TypeError("weight_init must be an Initializer or None")
    if bias_init is not None and not isinstance(bias_init, Initializer):
        raise TypeError("bias_init must be an Initializer or None")
    _GLOBAL_INIT[0] = weight_init
    _GLOBAL_INIT[1] = bias_init


def _global_default(is_bias=False):
    return _GLOBAL_INIT[1 if is_bias else 0]
