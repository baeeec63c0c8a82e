"""Dropout with the reference's random bits — a kernel of the port with no
Pallas counterpart: the reference computes ``dropout``
(``paddle_tpu/nn/functional.py:688``) in XLA.

Three things live here, as for every kernel of the port:

- ``dropout``: the wrapper, differentiable. A CUDA tensor launches the
  hand-written Hopper kernels (``csrc/dropout.cu``, built by
  :mod:`._build` at first use): the forward generates the mask from the
  key and, where autograd records, writes it as bits (one an element of
  the mask's own shape); the backward applies those bits to the output
  gradient and takes no key. A CPU tensor takes the plain versions.
  Anything the kernels do not take raises.
- the plain PyTorch versions: ``dropout_reference``, the reference's
  ``jnp.where(bernoulli(key, 1 - p, shape), a / (1 - p), 0).astype(
  a.dtype)`` over ``random.bernoulli``; ``dropout_forward_reference``,
  the same with the mask packed by ``pack_mask``; and
  ``dropout_backward_reference``, the packed mask applied to an output
  gradient. The CPU path and the tests use them; nothing on the CUDA
  training path calls them.
- the counters: ``fwd_launches`` and ``bwd_launches`` grow by one for
  each kernel launched for a forward (two for a broadcast mask: its bits,
  then their application) or a backward, and nowhere else;
  ``reference_calls`` at every call of a plain version.

A key is two 32-bit words (``core.rng.next_rng_key()``), handed to the
kernel as launch arguments. :func:`launch_args` gives every argument the
kernel takes from ``(key, p, dtype, mode)``: the keep threshold
``ceil((1 - p) * 2**52)`` on the 52-bit word of the reference's float64
uniform, and the divisor ``1 - p`` rounded to the activation's dtype, as
the reference's weakly typed ``a / (1.0 - p)`` rounds it.

The mask has the shape of ``x`` or, with the reference's ``axis``, a
broadcast shape (1 along every dimension not in ``axis``); its random
bits are those of that shape's flat index, and its packed form holds the
keep of mask index ``j`` in bit ``j % 8`` of byte ``j // 8``.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from .. import random as prng

__all__ = ["dropout", "dropout_reference", "dropout_forward_reference",
           "dropout_backward_reference", "dropout_forward",
           "dropout_backward", "dropout_apply", "pack_mask", "unpack_mask",
           "launch_args", "mask_shape", "SOURCE", "REPLACES"]

# Read and reset the counters through the module (``dropout.fwd_launches``):
# a name imported from here is a copy of the value at import time.
#: kernel launches made for a forward (the mask generated from the key)
fwd_launches = 0
#: kernel launches made for a backward (the stored bits applied)
bwd_launches = 0
#: calls of the plain version, on any device
reference_calls = 0

#: the analysis.kernelcheck entries that certify this module's kernel
KERNELCHECK_CERTS = ("dropout", "dropout_backward")
SOURCE = "paddle_tpu_torch/kernels/csrc/dropout.cu"
REPLACES = "paddle_tpu/nn/functional.py:688 (XLA, no Pallas kernel)"

MODES = ("upscale_in_train", "downscale_in_infer")
MAX_DIMS = 8
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}
_fns = None  # the loaded C entry points, with their argtypes declared


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


def _keep_reference(shape, key, p: float, axis, device):
    """The reference's keep mask of ``key`` in the mask's shape."""
    keys = torch.tensor([int(w) for w in key], dtype=torch.int64,
                        device=device)
    return prng.bernoulli(keys, 1.0 - float(p), mask_shape(shape, axis))


def _apply_reference(x, keep, p: float, mode: str):
    """``keep`` (broadcast to x) applied as the reference applies it. The
    division is a true division by the dtype's ``1 - p`` in float32 (a
    tensor divisor: a Python-number one is a multiply by its reciprocal
    on CUDA), rounded once to x's dtype; in float64 for a float64 ``x``,
    as the reference divides it."""
    *_, q, upscale = launch_args((0, 0), p, x.dtype, mode)
    if upscale and x.dtype == torch.float64:
        kept = x / torch.tensor(q, dtype=torch.float64, device=x.device)
    elif upscale:
        div = torch.tensor(q, dtype=torch.float32, device=x.device)
        kept = (x.float() / div).to(x.dtype)
    else:
        kept = x
    return torch.where(keep, kept, torch.zeros((), dtype=x.dtype,
                                                device=x.device))


def pack_mask(keep):
    """A boolean mask as bits: keep of flat index ``j`` in bit ``j % 8`` of
    byte ``j // 8`` (uint8, ``ceil(numel / 8)`` bytes; the last byte's
    unused bits 0), the layout the kernels write and read."""
    flat = keep.reshape(-1).to(torch.int32)
    pad = -flat.numel() % 8
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    shifts = torch.arange(8, dtype=torch.int32, device=keep.device)
    return (flat.view(-1, 8) << shifts).sum(1).to(torch.uint8)


def unpack_mask(bits, shape):
    """The boolean mask of ``shape`` that :func:`pack_mask` packed."""
    n = math.prod(shape)
    if bits.numel() != -(-n // 8):
        raise ValueError(f"{bits.numel()} mask bytes for a mask of shape "
                         f"{tuple(shape)} ({n} elements)")
    shifts = torch.arange(8, dtype=torch.int32, device=bits.device)
    flat = (bits.to(torch.int32)[:, None] >> shifts) & 1
    return flat.reshape(-1)[:n].reshape(shape).bool()


def dropout_reference(x, key, p: float, mode: str = "upscale_in_train",
                      axis=None):
    """The plain version: the reference's ``dropout`` of ``x`` under
    ``key`` (two 32-bit words); see :func:`_apply_reference` for the
    division."""
    global reference_calls
    reference_calls += 1
    return _apply_reference(
        x, _keep_reference(x.shape, key, p, axis, x.device), p, mode)


def dropout_forward_reference(x, key, p: float,
                              mode: str = "upscale_in_train", axis=None):
    """``(y, bits)``: :func:`dropout_reference`'s output and its mask,
    packed by :func:`pack_mask` in the mask's own shape."""
    global reference_calls
    reference_calls += 1
    keep = _keep_reference(x.shape, key, p, axis, x.device)
    return _apply_reference(x, keep, p, mode), pack_mask(keep)


def dropout_backward_reference(dy, bits, p: float,
                               mode: str = "upscale_in_train", axis=None):
    """The output gradient through the packed mask ``bits``:
    ``where(keep, dy / q, 0)`` (``dy`` kept as it is for
    ``downscale_in_infer``), the reference's VJP."""
    global reference_calls
    reference_calls += 1
    keep = unpack_mask(bits, mask_shape(dy.shape, axis))
    return _apply_reference(dy, keep, p, mode)


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


def _entry_points():
    global _fns
    if _fns is None:
        from ._build import load

        lib = load("dropout")
        ptr, i32, i64, u32 = (ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_longlong, ctypes.c_uint)
        arr = ctypes.POINTER(i64)
        fwd = lib.dropout_forward
        fwd.argtypes = [ptr, ptr, ptr, i64, i32, u32, u32, u32, u32,
                        ctypes.c_double, i32, i32, arr, arr, i64, ptr]
        fwd.restype = i32
        bwd = lib.dropout_backward
        bwd.argtypes = [ptr, ptr, ptr, i64, i32, ctypes.c_double, i32, i32,
                        arr, arr, ptr]
        bwd.restype = i32
        _fns = (fwd, bwd)
    return _fns


def _kernel_args(x, axis):
    """``(x contiguous, ndim, dims, mask strides, mask elements)``, after
    the kernels' own checks."""
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"the dropout kernels take float32, bfloat16 or "
                        f"float64; got {x.dtype}")
    if x.device.type != "cuda":
        raise ValueError(f"no dropout kernel for device {x.device}")
    mshape = mask_shape(x.shape, axis)
    ndim, dims, strides = _broadcast_args(x.shape, mshape)
    arr = ctypes.c_longlong * max(ndim, 1)
    return (x.contiguous(), ndim, arr(*dims), arr(*strides),
            math.prod(mshape))


def _raise_on(err: int, what: str, x) -> None:
    if err:
        raise RuntimeError(f"dropout {what} kernel launch failed with CUDA "
                           f"error {err} (x {tuple(x.shape)}, {x.dtype})")


def dropout_forward(x, key, p: float, mode: str = "upscale_in_train",
                    axis=None, mask: bool = False):
    """``(y, bits)``: the mask of ``key`` applied to ``x`` and, with
    ``mask`` (autograd records), the mask packed as :func:`pack_mask`
    packs it, else None. CUDA tensors launch the forward kernel (for a
    broadcast mask also the application of its bits, which then are
    written whatever ``mask`` says); CPU tensors take the plain
    versions."""
    global fwd_launches
    if x.device.type == "cpu":
        if mask:
            return dropout_forward_reference(x, key, p, mode, axis)
        return dropout_reference(x, key, p, mode, axis), None
    x, ndim, dims, strides, m = _kernel_args(x, axis)
    y = torch.empty_like(x)
    bits = (torch.empty(-(-m // 8), dtype=torch.uint8, device=x.device)
            if mask or ndim else None)
    if x.numel():
        k1, k2, threshold, q, upscale = launch_args(key, p, x.dtype, mode)
        t_hi = min(threshold >> 20, 0xFFFFFFFF)
        fwd, _ = _entry_points()
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = fwd(x.data_ptr(), y.data_ptr(),
                      None if bits is None else bits.data_ptr(), x.numel(),
                      _DTYPE_CODE[x.dtype], k1, k2, t_hi,
                      threshold - (t_hi << 20), q, int(upscale), ndim, dims,
                      strides, m, stream)
        _raise_on(err, "forward", x)
        fwd_launches += 2 if ndim else 1
    return y, bits if mask else None


def dropout_backward(dy, bits, p: float, mode: str = "upscale_in_train",
                     axis=None):
    """The output gradient through the forward's ``bits``: ``where(keep,
    dy / q, 0)`` (``dy`` for ``downscale_in_infer``). CUDA tensors launch
    the backward kernel, which reads the bits and takes no key; CPU
    tensors take the plain version."""
    global bwd_launches
    if dy.device.type == "cpu":
        return dropout_backward_reference(dy, bits, p, mode, axis)
    dy, ndim, dims, strides, m = _kernel_args(dy, axis)
    if bits.dtype != torch.uint8 or bits.numel() != -(-m // 8) or \
            bits.device != dy.device:
        raise ValueError(f"bits must be uint8 [{-(-m // 8)}] on "
                         f"{dy.device}; got {bits.dtype} "
                         f"{tuple(bits.shape)} on {bits.device}")
    dx = torch.empty_like(dy)
    if dy.numel():
        *_, q, upscale = launch_args((0, 0), p, dy.dtype, mode)
        _, bwd = _entry_points()
        with torch.cuda.device(dy.device):
            stream = torch.cuda.current_stream(dy.device).cuda_stream
            err = bwd(dy.data_ptr(), dx.data_ptr(), bits.data_ptr(),
                      dy.numel(), _DTYPE_CODE[dy.dtype], q, int(upscale),
                      ndim, dims, strides, stream)
        _raise_on(err, "backward", dy)
        bwd_launches += 1
    return dx


def dropout_apply(x, key, p: float, mode: str = "upscale_in_train",
                  axis=None, backward: bool = False):
    """The mask of ``key`` applied to ``x`` (no autograd): on a CUDA tensor
    the forward kernel, or with ``backward`` the path a backward takes
    (the forward kernel writes the bits, the backward kernel applies them
    to ``x``); the plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return dropout_reference(x, key, p, mode, axis)
    if not backward:
        return dropout_forward(x, key, p, mode, axis)[0]
    bits = dropout_forward(x, key, p, mode, axis, mask=True)[1]
    return dropout_backward(x, bits, p, mode, axis)


class _Dropout(torch.autograd.Function):
    """The mask applied forward, its bits kept, and applied to the output
    gradient backward: the reference's VJP, ``where(keep, g / q, 0)``.

    The bits stay on the context rather than going through
    ``save_for_backward``: under ``torch.utils.checkpoint`` a saved tensor
    of a block's last dropout would make the recompute run the block
    through it (and, without a selective policy, through fc2's product)
    only to write the same bits again, where the kept ones cost n / 8
    bytes a site. A recomputed dropout writes its own bits, which the
    backward does not read: the key is the same, and so are they."""

    @staticmethod
    def forward(ctx, x, key, p, mode, axis):
        y, ctx.bits = dropout_forward(x, key, p, mode, axis, mask=True)
        ctx.args = (p, mode, axis)
        return y

    @staticmethod
    def backward(ctx, dy):
        return (dropout_backward(dy, ctx.bits, *ctx.args), None, None, None,
                None)


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
