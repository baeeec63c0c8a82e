"""The global gradient norm and its clip scale — a kernel of the port with no
Pallas counterpart: the reference computes ``ClipGradByGlobalNorm``
(``paddle_tpu/utils/clip_grad.py:60``) in XLA.

Three things live here, as for every kernel of the port:

- ``global_norm_scale``: the wrapper. For CUDA gradients it launches the
  hand-written Hopper kernels (``csrc/global_norm.cu``, built by
  :mod:`._build` at first use): the sums of squares of every gradient in
  the launches of :func:`norm_launch_plan` (one, where the toolkit takes
  32,764 bytes of kernel parameters), then one launch that reduces them
  and forms the scale, on the device; for CPU gradients the plain
  version. It returns float32 device scalars ``(total, scale)`` and reads
  nothing back to the host: the fused Adam kernel takes ``scale``
  (``fused_adam_update_many(scale=)``) and rounds ``g * scale`` to g's
  dtype in its own pass.
- ``global_norm_scale_reference``: the plain PyTorch version, the
  reference's arithmetic: each gradient's float32 sum of squares, their
  sum, ``min(1, clip / (sqrt(total) + 1e-6))`` in float32.
- ``launches`` / ``reference_calls``: the first grows by the launches
  made (the plan's plus the reduction), the second at every call of the
  plain version.

The kernel sums in another order than the plain version (per chunk of
``NORM_CHUNK`` elements, then the chunks in float64), so the two agree
within float32 rounding of the norm, not bit for bit.

A hybrid-parallel norm (``reduce=``) splits the work at the partial
sums: the sums launches write this rank's float32 partials (one a chunk
on the card, one a gradient in the plain version), ``reduce(partials,
ranges)`` combines them over the ranks (``ranges[i]``: gradient i's
entries) and returns the vector to total, and the reduction launch forms
the scale from it. The launch count is the single-device one.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

__all__ = ["global_norm_scale", "global_norm_scale_reference",
           "norm_launch_plan", "norm_chunks", "norm_table_capacity",
           "kernel_param_bytes", "NORM_CHUNK", "SOURCE", "REPLACES"]

# Read and reset the counters through the module (``global_norm.launches``):
# a name imported from here is a copy of the value at import time.
#: kernel launches made by the wrapper (the plan's and the reduction)
launches = 0
#: calls of the plain version, on any device
reference_calls = 0

#: the analysis.kernelcheck entries that certify this module's kernel
KERNELCHECK_CERTS = ("global_norm",)
SOURCE = "paddle_tpu_torch/kernels/csrc/global_norm.cu"
REPLACES = "paddle_tpu/utils/clip_grad.py:60 (XLA, no Pallas kernel)"

#: elements a block sums into one partial, as ``csrc/global_norm.cu``
NORM_CHUNK = 16384
NORM_ENTRY_BYTES = 28  # pointer, n, dtype, padding; the first chunk
NORM_FIXED_BYTES = 16
PARAM_BYTES = 32764
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_fn = None  # the loaded C entry point, with its argtypes declared
_split_fns: list = []  # global_norm_sums, global_norm_finish
_param_bytes = None


def norm_table_capacity(param_bytes: int = PARAM_BYTES) -> int:
    """Gradients one launch's table holds: 1,169 at 32,764 bytes of kernel
    parameters, 145 at 4,096."""
    return (param_bytes - NORM_FIXED_BYTES) // NORM_ENTRY_BYTES


def norm_chunks(sizes) -> int:
    """The partial sums (chunks of ``NORM_CHUNK`` elements) of tensors of
    ``sizes`` elements."""
    return sum(-(-int(n) // NORM_CHUNK) for n in sizes)


def norm_launch_plan(sizes, param_bytes: int = PARAM_BYTES) -> list:
    """The sum-of-squares launches over tensors of ``sizes`` elements:
    ``(start, stop)`` ranges of at most :func:`norm_table_capacity`
    consecutive tensors, in order (one for a training step's 292 at
    32,764 bytes, three at 4,096). The reduction is one more launch.
    Raises on a tensor of no elements."""
    sizes = list(sizes)
    if not sizes or any(int(n) <= 0 for n in sizes):
        raise ValueError("every tensor needs at least one element")
    cap = norm_table_capacity(param_bytes)
    return [(i, min(i + cap, len(sizes))) for i in range(0, len(sizes), cap)]


def _f32(x) -> float:
    return float(np.float32(x))


def _scale_of(total, clip_norm: float):
    """``min(1, clip / (sqrt(total) + 1e-6))`` in float32 on total's
    device, each operation rounded once (tensor operands: a Python-number
    divisor or dividend is a reciprocal multiply on CUDA)."""
    full = lambda v: torch.full((), v, dtype=torch.float32,  # noqa: E731
                                device=total.device)
    ratio = full(_f32(clip_norm)) / (torch.sqrt(total) + full(_f32(1e-6)))
    return torch.minimum(full(1.0), ratio)


def global_norm_scale_reference(grads, clip_norm: float, reduce=None):
    """The plain version: ``(total, scale)`` as float32 scalars, total the
    sum over ``grads`` of each one's float32 sum of squares (those sums
    passed through ``reduce`` first, when given)."""
    global reference_calls
    reference_calls += 1
    sq = torch.stack([torch.sum(g.float() ** 2) for g in grads])
    if reduce is not None:
        sq = reduce(sq, [(i, i + 1) for i in range(len(grads))])
    total = torch.sum(sq)
    return total, _scale_of(total, clip_norm)


def _entry_point():
    global _fn, _param_bytes
    if _fn is None:
        from ._build import load

        lib = load("global_norm")
        if lib.global_norm_chunk() != NORM_CHUNK:
            raise RuntimeError(f"csrc/global_norm.cu cuts chunks of "
                               f"{lib.global_norm_chunk()} elements; the "
                               f"plan assumes {NORM_CHUNK}")
        fn = lib.global_norm
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        table = [i32, ctypes.POINTER(ptr), ctypes.POINTER(ctypes.c_longlong),
                 ctypes.POINTER(i32), ctypes.POINTER(i32), i32, ptr, i32]
        fn.argtypes = table + [ctypes.c_float, ptr, ptr]
        fn.restype = i32
        lib.global_norm_sums.argtypes = table + [ptr]
        lib.global_norm_sums.restype = i32
        lib.global_norm_finish.argtypes = [ptr, i32, ctypes.c_float, ptr, ptr]
        lib.global_norm_finish.restype = i32
        _split_fns[:] = [lib.global_norm_sums, lib.global_norm_finish]
        _param_bytes = lib.global_norm_param_bytes()
        _fn = fn
    return _fn


def kernel_param_bytes() -> int:
    """The kernel-parameter bytes the built library plans with (32,764
    from CUDA 12.1, else 4,096); builds and loads it on first use."""
    _entry_point()
    return _param_bytes


def global_norm_scale(grads, clip_norm: float, reduce=None):
    """``(total, scale)``: float32 scalars on the gradients' device, the
    sum of squares of every gradient and ``min(1, clip_norm /
    (sqrt(total) + 1e-6))``. CUDA gradients (float32 or bfloat16,
    contiguous) launch the kernels and raise on anything they do not take;
    CPU gradients take the plain version. ``reduce``: the hybrid-parallel
    hook between the sums and the scale (module docstring)."""
    global launches
    grads = list(grads)
    if not grads:
        raise ValueError("no gradients")
    dev = grads[0].device
    if any(g.device != dev for g in grads):
        raise ValueError("all gradients must be on one device")
    if dev.type == "cpu":
        return global_norm_scale_reference(grads, clip_norm, reduce)
    if dev.type != "cuda":
        raise ValueError(f"no global norm kernel for device {dev}")
    for g in grads:
        if g.dtype not in _DTYPE_CODE:
            raise TypeError(f"the kernel takes float32 or bfloat16 "
                            f"gradients; got {g.dtype}")
        if not g.is_contiguous():
            raise ValueError("every gradient must be contiguous")
    fn = _entry_point()
    sizes = [g.numel() for g in grads]
    plan = norm_launch_plan(sizes, _param_bytes)
    n_part = norm_chunks(sizes)
    scratch = torch.empty(n_part + 2, dtype=torch.float32, device=dev)
    k = len(grads)
    bounds = (ctypes.c_int * (len(plan) + 1))(
        *(start for start, _ in plan), plan[-1][1])
    table = (k, (ctypes.c_void_p * k)(*(g.data_ptr() for g in grads)),
             (ctypes.c_longlong * k)(*sizes),
             (ctypes.c_int * k)(*(_DTYPE_CODE[g.dtype] for g in grads)),
             bounds, len(plan), scratch.data_ptr() + 8, n_part)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if reduce is None:
            err = fn(*table, _f32(clip_norm), scratch.data_ptr(), stream)
        else:
            sums, finish = _split_fns
            err = sums(*table, stream)
            if not err:
                first = np.cumsum([0] + [-(-n // NORM_CHUNK) for n in sizes])
                parts = reduce(scratch[2:], list(zip(first[:-1].tolist(),
                                                     first[1:].tolist())))
                parts = parts.contiguous()
                err = finish(parts.data_ptr(), parts.numel(),
                             _f32(clip_norm), scratch.data_ptr(), stream)
    if err:
        raise RuntimeError(f"global norm kernel launch failed with CUDA "
                           f"error {err} ({k} tensors in {len(plan)} "
                           f"launches)")
    launches += len(plan) + 1
    return scratch[0], scratch[1]
