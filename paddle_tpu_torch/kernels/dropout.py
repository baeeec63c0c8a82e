"""Dropout with the reference's random bits — a kernel of the port with no
Pallas counterpart: the reference computes ``dropout``
(``paddle_tpu/nn/functional.py:688``) in XLA.

Three things live here, as for every kernel of the port:

- ``dropout``: the wrapper, differentiable. A CUDA tensor launches the
  hand-written Hopper kernel (``csrc/dropout.cu``, built by
  :mod:`._build` at first use) in the forward and again on the output
  gradient in the backward, each regenerating the mask from the key; a
  CPU tensor takes the plain version. Anything the kernel does not take
  raises.
- ``dropout_reference``: the plain PyTorch version, the reference's
  ``jnp.where(bernoulli(key, 1 - p, shape), a / (1 - p), 0).astype(a.dtype)``
  over ``random.bernoulli``. The CPU path and the tests use it; nothing on
  the CUDA training path calls it.
- the counters: ``fwd_launches`` and ``bwd_launches`` grow by one where
  the kernel is launched for a forward or a backward and nowhere else,
  ``reference_calls`` at every call of the plain version.

A key is two 32-bit words (``core.rng.next_rng_key()``), handed to the
kernel as launch arguments. :func:`launch_args` gives every argument the
kernel takes from ``(key, p, dtype, mode)``: the keep threshold
``ceil((1 - p) * 2**52)`` on the 52-bit word of the reference's float64
uniform, and the divisor ``1 - p`` rounded to the activation's dtype, as
the reference's weakly typed ``a / (1.0 - p)`` rounds it.

The mask has the shape of ``x`` or, with the reference's ``axis``, a
broadcast shape (1 along every dimension not in ``axis``); its random
bits are those of that shape's flat index.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from .. import random as prng

__all__ = ["dropout", "dropout_reference", "dropout_apply", "launch_args",
           "mask_shape", "SOURCE", "REPLACES"]

# Read and reset the counters through the module (``dropout.fwd_launches``):
# a name imported from here is a copy of the value at import time.
#: forward kernel launches made by the wrapper
fwd_launches = 0
#: backward kernel launches (the same kernel on the output gradient)
bwd_launches = 0
#: calls of the plain version, on any device
reference_calls = 0

#: the analysis.kernelcheck entries that certify this module's kernel
KERNELCHECK_CERTS = ("dropout",)
SOURCE = "paddle_tpu_torch/kernels/csrc/dropout.cu"
REPLACES = "paddle_tpu/nn/functional.py:688 (XLA, no Pallas kernel)"

MODES = ("upscale_in_train", "downscale_in_infer")
MAX_DIMS = 8
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}
_fn = None  # the loaded C entry point, with its argtypes declared


def mask_shape(shape, axis) -> tuple:
    """The mask's shape: ``shape``, or with ``axis`` (an int or a list of
    them) 1 along every dimension whose index is not in it, as the
    reference forms it (a negative axis matches no index)."""
    shape = tuple(int(s) for s in shape)
    if axis is None:
        return shape
    axes = list(axis) if isinstance(axis, (list, tuple)) else [axis]
    return tuple(s if i in axes else 1 for i, s in enumerate(shape))


@functools.lru_cache(maxsize=256)
def _rate_args(p: float, dtype, mode: str):
    """``(threshold, q, upscale)`` of :func:`launch_args`, once per rate."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}; got {mode!r}")
    keep = 1.0 - float(p)  # a Python float, as the reference's
    threshold = max(0, math.ceil(keep * 2.0 ** 52))
    q = torch.tensor(keep, dtype=torch.float64).to(dtype).item()
    return threshold, q, mode == "upscale_in_train"


def launch_args(key, p: float, dtype, mode: str = "upscale_in_train"):
    """``(k1, k2, threshold, q, upscale)``: the key's words, the keep
    threshold on the 52-bit word (``keep = word < threshold``, exactly the
    reference's ``uniform < 1 - p`` in float64), the divisor ``1 - p``
    rounded to ``dtype`` (as a Python float) and whether kept values are
    divided by it."""
    k1, k2 = key
    return (int(k1) & 0xFFFFFFFF, int(k2) & 0xFFFFFFFF,
            *_rate_args(float(p), dtype, mode))


def dropout_reference(x, key, p: float, mode: str = "upscale_in_train",
                      axis=None):
    """The plain version: the reference's ``dropout`` of ``x`` under
    ``key`` (two 32-bit words). The division is a true division by the
    dtype's ``1 - p`` in float32 (a tensor divisor: a Python-number one is
    a multiply by its reciprocal on CUDA), rounded once to x's dtype; in
    float64 for a float64 ``x``, as the reference divides it."""
    global reference_calls
    reference_calls += 1
    *_, q, upscale = launch_args(key, p, x.dtype, mode)
    keys = torch.tensor([int(w) for w in key], dtype=torch.int64,
                        device=x.device)
    keep = prng.bernoulli(keys, 1.0 - float(p), mask_shape(x.shape, axis))
    if upscale and x.dtype == torch.float64:
        kept = x / torch.tensor(q, dtype=torch.float64, device=x.device)
    elif upscale:
        div = torch.tensor(q, dtype=torch.float32, device=x.device)
        kept = (x.float() / div).to(x.dtype)
    else:
        kept = x
    return torch.where(keep, kept, torch.zeros((), dtype=x.dtype,
                                                device=x.device))


def _broadcast_args(shape, mshape):
    """``(ndim, dims, mask strides)`` for the kernel: ``ndim = 0`` when the
    mask is the whole shape; else adjacent dimensions that are both kept
    or both broadcast are merged (at most ``MAX_DIMS`` remain)."""
    if tuple(mshape) == tuple(shape):
        return 0, [], []
    dims, bcast = [], []
    for s, m in zip(shape, mshape):
        if s == 1:
            continue  # a unit dimension moves no index
        b = m == 1
        if dims and bcast[-1] == b:
            dims[-1] *= s
        else:
            dims.append(s)
            bcast.append(b)
    if not dims:
        return 0, [], []
    strides, run = [0] * len(dims), 1
    for d in range(len(dims) - 1, -1, -1):
        if not bcast[d]:
            strides[d] = run
            run *= dims[d]
    if len(dims) > MAX_DIMS:
        raise ValueError(f"the kernel takes a broadcast mask of at most "
                         f"{MAX_DIMS} alternating dimensions; got {shape} "
                         f"with mask {mshape}")
    return len(dims), dims, strides


def _entry_point():
    global _fn
    if _fn is None:
        from ._build import load

        fn = load("dropout").dropout
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [ptr, ptr, i64, i32, ctypes.c_uint, ctypes.c_uint,
                       ctypes.c_ulonglong, ctypes.c_double, i32, i32,
                       ctypes.POINTER(i64), ctypes.POINTER(i64), ptr]
        fn.restype = i32
        _fn = fn
    return _fn


def _launch(x, key, p, mode, axis, backward: bool):
    """The kernel over CUDA ``x``: a new tensor."""
    global fwd_launches, bwd_launches
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"the dropout kernel takes float32, bfloat16 or "
                        f"float64; got {x.dtype}")
    x = x.contiguous()
    y = torch.empty_like(x)
    if x.numel():
        k1, k2, threshold, q, upscale = launch_args(key, p, x.dtype, mode)
        ndim, dims, strides = _broadcast_args(x.shape,
                                              mask_shape(x.shape, axis))
        arr = ctypes.c_longlong * max(ndim, 1)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = _entry_point()(x.data_ptr(), y.data_ptr(), x.numel(),
                                 _DTYPE_CODE[x.dtype], k1, k2, threshold, q,
                                 int(upscale), ndim, arr(*dims),
                                 arr(*strides), stream)
        if err:
            raise RuntimeError(f"dropout kernel launch failed with CUDA "
                               f"error {err} (x {tuple(x.shape)}, "
                               f"{x.dtype})")
        if backward:
            bwd_launches += 1
        else:
            fwd_launches += 1
    return y


def dropout_apply(x, key, p: float, mode: str = "upscale_in_train",
                  axis=None, backward: bool = False):
    """The mask of ``key`` applied to ``x`` (no autograd): the kernel on a
    CUDA tensor (counted as a forward or, with ``backward``, a backward
    launch), the plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return dropout_reference(x, key, p, mode, axis)
    if x.device.type != "cuda":
        raise ValueError(f"no dropout kernel for device {x.device}")
    return _launch(x, key, p, mode, axis, backward)


class _Dropout(torch.autograd.Function):
    """The mask applied forward and, regenerated from the key, to the
    output gradient backward: the reference's VJP, ``where(keep, g / q,
    0)``. Nothing but the key is saved."""

    @staticmethod
    def forward(ctx, x, key, p, mode, axis):
        ctx.args = (key, p, mode, axis)
        return dropout_apply(x, key, p, mode, axis)

    @staticmethod
    def backward(ctx, dy):
        return (dropout_apply(dy, *ctx.args, backward=True),
                None, None, None, None)


def dropout(x, key, p: float, mode: str = "upscale_in_train", axis=None):
    """``x`` with each element (or each element of the broadcast mask of
    ``axis``) kept with probability ``1 - p`` under ``key`` (two 32-bit
    words): kept values divided by ``1 - p`` (``upscale_in_train``) or
    left as they are (``downscale_in_infer``), dropped ones 0;
    differentiable in ``x``."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}; got {mode!r}")
    key = tuple(int(w) & 0xFFFFFFFF for w in key)
    if torch.is_grad_enabled() and x.requires_grad:
        return _Dropout.apply(x, key, float(p), mode, axis)
    return dropout_apply(x, key, float(p), mode, axis)
