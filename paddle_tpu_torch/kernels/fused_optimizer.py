"""Fused Adam update — the port of ``paddle_tpu/kernels/fused_optimizer.py``
(``_adam_kernel`` via ``fused_adam_update``).

Three things live here, as for every kernel of the port:

- ``fused_adam_update`` (one tensor) and ``fused_adam_update_many`` (a
  list of tensors — an optimizer step updates a few hundred): the
  wrappers. CUDA tensors launch the hand-written Hopper kernel
  (``csrc/fused_adam.cu``, built by :mod:`._build` at first use) on the
  current stream, every tensor of the call in the launches of
  :func:`adam_launch_plan` (one, where the toolkit takes 32,764 bytes of
  kernel parameters); CPU tensors take the plain version. Anything the
  kernel does not take raises.
- ``fused_adam_update_reference``: the plain PyTorch version, the math of
  ``Adam._apply_dense`` (``paddle_tpu/optimizer/optimizers.py:78-83``) in
  the same order of operations. The CPU path and the tests use it;
  nothing on the CUDA training path calls it.
- ``launches`` / ``tensors`` / ``reference_calls``: plain integer
  counters — the first grows by one for each kernel launch and nowhere
  else, the second by the tensors those launches updated, the third at
  every call of the plain version.

Both update ``p``, ``m`` and ``v`` in place (the JAX function returns new
arrays; in place saves a copy of every optimizer buffer per step). They
also take AdamW's decoupled decay factor (``p`` is scaled by it before the
update, as ``functional_update`` scales the master), for a bfloat16
parameter kept with a float32 master write the parameter's new value in
the same pass (``p_out``), and take a global-norm clip's ``scale`` (a
float32 scalar on the device, from ``kernels.global_norm``): the update
then reads ``(g * scale)`` rounded to g's dtype, the reference's clipped
gradient, with no pass of its own.

The TPU kernel ran only on float32 buffers of at least 65,536 elements in
whole (8, 1024) tiles (``maybe_fused_adam``); that gate was a TPU tiling
rule, so the Hopper kernel takes any length. Replaces
``paddle_tpu/kernels/fused_optimizer.py:33`` (``pallas_call`` at ``:73``);
it is bound by device-memory bytes, see the source's header.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

__all__ = ["fused_adam_update", "fused_adam_update_many",
           "fused_adam_update_reference", "adam_launch_plan",
           "adam_chunk_ranges", "adam_table_capacity", "kernel_param_bytes",
           "ADAM_CHUNK", "PARAM_BYTES", "SOURCE", "REPLACES"]

# Read and reset the counters through the module
# (``fused_optimizer.launches``): a name imported from here is a copy of
# the value at import time.
#: kernel launches made by the wrappers (the plan's count per call)
launches = 0
#: tensors those launches updated
tensors = 0
#: calls of the plain version, on any device
reference_calls = 0

#: the analysis.kernelcheck entries that certify this module's kernel
KERNELCHECK_CERTS = ("fused_adam",)
SOURCE = "paddle_tpu_torch/kernels/csrc/fused_adam.cu"
REPLACES = "paddle_tpu/kernels/fused_optimizer.py:33"

_G_CODE = {torch.float32: 0, torch.bfloat16: 1}
_fn = None  # the loaded C entry point, with its argtypes declared
_param_bytes = None  # the kernel-parameter bytes the library was built for

# The multi-tensor launch, as ``csrc/fused_adam.cu`` lays it out: each
# tensor is cut into chunks of ADAM_CHUNK elements (a multiple of 4, so
# every chunk starts 16-byte aligned), and a launch's table of tensors is
# a kernel parameter of ADAM_ENTRY_BYTES a tensor (five pointers, n,
# decay, the g dtype, its first chunk) plus ADAM_FIXED_BYTES (the chunk
# total, the count, alignment, the hyperparameters, the scale pointer).
ADAM_CHUNK = 16384
ADAM_ENTRY_BYTES = 60
ADAM_FIXED_BYTES = 64
#: kernel-parameter bytes of CUDA 12.1 and later; older toolkits take 4,096
PARAM_BYTES = 32764


def adam_table_capacity(param_bytes: int = PARAM_BYTES) -> int:
    """Tensors one launch's table holds within ``param_bytes`` of kernel
    parameters: 545 at 32,764 bytes, 67 at 4,096."""
    return (param_bytes - ADAM_FIXED_BYTES) // ADAM_ENTRY_BYTES


def adam_chunk_ranges(n: int) -> list:
    """The ``(begin, end)`` element ranges of a tensor of ``n`` elements,
    one a chunk, in the kernel's order."""
    return [(b, min(b + ADAM_CHUNK, n)) for b in range(0, n, ADAM_CHUNK)]


def adam_launch_plan(sizes, g_dtypes, param_bytes: int = PARAM_BYTES):
    """The launches that update tensors of ``sizes`` elements with
    gradients of ``g_dtypes`` (float32 or bfloat16, mixed freely: the
    kernel reads each tensor's dtype from its table entry): ``(start,
    stop)`` ranges of at most :func:`adam_table_capacity` consecutive
    tensors, in order, so ``ceil(len(sizes) / capacity)`` launches — one
    for a training step's 292 tensors at 32,764 bytes, five at 4,096.
    Raises on a tensor of no elements or a gradient dtype the kernel does
    not take."""
    sizes, g_dtypes = list(sizes), list(g_dtypes)
    if len(sizes) != len(g_dtypes):
        raise ValueError(f"{len(sizes)} sizes but {len(g_dtypes)} gradient "
                         f"dtypes")
    for n, dt in zip(sizes, g_dtypes):
        if n <= 0:
            raise ValueError(f"every tensor needs at least one element; got "
                             f"{n}")
        if dt not in _G_CODE:
            raise TypeError(f"g must be float32 or bfloat16; got {dt}")
    cap = adam_table_capacity(param_bytes)
    if cap < 1:
        raise ValueError(f"{param_bytes} bytes of kernel parameters hold no "
                         f"table entry")
    return [(i, min(i + cap, len(sizes)))
            for i in range(0, len(sizes), cap)]


def _f32(x) -> float:
    """``x`` rounded to float32, as a Python float."""
    return float(np.float32(x))


def fused_adam_update_reference(p, g, m, v, lr, bc1, bc2, *, beta1, beta2,
                                eps, decay=1.0, p_out=None, scale=None):
    """The plain version, in place: ``g = (g * scale)`` rounded to g's
    dtype (when a ``scale`` tensor is given), ``p *= decay`` (when not 1),
    then ``m = b1*m + (1-b1)*g``, ``v = b2*v + (1-b2)*g*g`` and
    ``p -= lr*(m/bc1) / (sqrt(v/bc2) + eps)``, each operation rounded to
    float32 on its own; ``p_out`` (if given) receives ``p`` in its dtype."""
    global reference_calls
    reference_calls += 1
    if scale is not None:
        g = (g.float() * scale).to(g.dtype)
    g = g.float()
    if decay != 1.0:
        p.mul_(decay)
    m.copy_(beta1 * m + (1 - beta1) * g)
    v.copy_(beta2 * v + (1 - beta2) * (g * g))
    # a Python-number divisor is applied on CUDA as a multiply by its
    # reciprocal; a tensor divisor is a true division, as in the reference
    # and the kernel
    m_hat = m / torch.tensor(bc1, dtype=torch.float32, device=m.device)
    v_hat = v / torch.tensor(bc2, dtype=torch.float32, device=m.device)
    p.sub_(lr * m_hat / (torch.sqrt(v_hat) + eps))
    if p_out is not None:
        p_out.copy_(p.view(p_out.shape))


def _check(p, g, m, v, p_out) -> None:
    """The contract both paths share."""
    f32 = torch.float32
    if p.dtype != f32 or m.dtype != f32 or v.dtype != f32:
        raise TypeError(f"p, m and v must be float32 (the parameter or its "
                        f"float32 master); got {p.dtype}, {m.dtype}, "
                        f"{v.dtype}")
    if g.dtype not in _G_CODE:
        raise TypeError(f"g must be float32 or bfloat16; got {g.dtype}")
    n = p.numel()
    if g.numel() != n or m.numel() != n or v.numel() != n or (
            p_out is not None and p_out.numel() != n):
        raise ValueError(f"p, g, m, v{', p_out' if p_out is not None else ''}"
                         f" must hold {n} elements each")
    dev = p.device
    if g.device != dev or m.device != dev or v.device != dev or (
            p_out is not None and p_out.device != dev):
        raise ValueError("all operands must be on one device")


def _check_kernel(p, g, m, v, p_out) -> None:
    if p_out is not None and p_out.dtype != torch.bfloat16:
        raise TypeError(f"the kernel writes a bfloat16 parameter copy; "
                        f"p_out is {p_out.dtype}")
    for name, t in (("p", p), ("g", g), ("m", m), ("v", v), ("p_out", p_out)):
        if t is None:
            continue
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernel "
                             f"moves 16 bytes per load)")


def _entry_point():
    global _fn, _param_bytes
    if _fn is None:
        from ._build import load

        lib = load("fused_adam")
        if lib.fused_adam_chunk() != ADAM_CHUNK:
            raise RuntimeError(f"csrc/fused_adam.cu cuts chunks of "
                               f"{lib.fused_adam_chunk()} elements; the "
                               f"plan assumes {ADAM_CHUNK}")
        fn = lib.fused_adam
        ptrs = ctypes.POINTER(ctypes.c_void_p)
        ints = ctypes.POINTER(ctypes.c_int)
        fn.argtypes = ([ctypes.c_int] + [ptrs] * 5
                       + [ctypes.POINTER(ctypes.c_longlong), ints,
                          ctypes.POINTER(ctypes.c_float), ints, ctypes.c_int]
                       + [ctypes.c_float] * 8 + [ctypes.c_void_p] * 2)
        fn.restype = ctypes.c_int
        _param_bytes = lib.fused_adam_param_bytes()
        _fn = fn
    return _fn


def kernel_param_bytes() -> int:
    """The kernel-parameter bytes the built library plans with (32,764
    from CUDA 12.1, else 4,096); builds and loads it on first use."""
    _entry_point()
    return _param_bytes


def fused_adam_update_many(groups, lr, bc1, bc2, *, beta1, beta2, eps,
                           scale=None):
    """One Adam step for every ``(p, g, m, v, decay, p_out)`` in
    ``groups``, as :func:`fused_adam_update` does for one, each gradient
    clipped by ``scale`` when given (a float32 scalar tensor on the
    tensors' device). On CUDA the tensors are updated in the launches of
    :func:`adam_launch_plan`, all from one host call; on the CPU each
    takes the plain version."""
    global launches, tensors
    groups = list(groups)
    for p, g, m, v, _, p_out in groups:
        _check(p, g, m, v, p_out)
    if not groups:
        return
    dev = groups[0][0].device
    if any(grp[0].device != dev for grp in groups):
        raise ValueError("all tensors of one update must be on one device")
    if scale is not None and (scale.numel() != 1 or scale.device != dev
                              or scale.dtype != torch.float32):
        raise ValueError(f"scale must be one float32 value on {dev}")
    if dev.type == "cpu":
        for p, g, m, v, decay, p_out in groups:
            fused_adam_update_reference(p, g, m, v, lr, bc1, bc2,
                                        beta1=beta1, beta2=beta2, eps=eps,
                                        decay=decay, p_out=p_out,
                                        scale=scale)
        return
    if dev.type != "cuda":
        raise ValueError(f"no fused Adam for device {dev}")
    for p, g, m, v, _, p_out in groups:
        _check_kernel(p, g, m, v, p_out)
    k = len(groups)
    arr = ctypes.c_void_p * k
    cols = list(zip(*groups))
    ptrs = [arr(*(t.data_ptr() for t in col)) for col in cols[:4]]
    outs = arr(*(None if t is None else t.data_ptr() for t in cols[5]))
    sizes = (ctypes.c_longlong * k)(*(p.numel() for p in cols[0]))
    codes = (ctypes.c_int * k)(*(_G_CODE[g.dtype] for g in cols[1]))
    decays = (ctypes.c_float * k)(*(_f32(d) for d in cols[4]))
    fn = _entry_point()
    plan = adam_launch_plan(sizes, (g.dtype for g in cols[1]), _param_bytes)
    bounds = (ctypes.c_int * (len(plan) + 1))(
        *(start for start, _ in plan), plan[-1][1])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(k, *ptrs, outs, sizes, codes, decays, bounds, len(plan),
                 _f32(lr), _f32(bc1), _f32(bc2), _f32(beta1),
                 _f32(1 - beta1), _f32(beta2), _f32(1 - beta2), _f32(eps),
                 None if scale is None else scale.data_ptr(), stream)
    if err:
        raise RuntimeError(f"fused_adam kernel launch failed with CUDA error "
                           f"{err} ({k} tensors in {len(plan)} launches)")
    launches += len(plan)
    tensors += k


def fused_adam_update(p, g, m, v, lr, bc1, bc2, *, beta1, beta2, eps,
                      decay=1.0, p_out=None):
    """One Adam step over float32 ``p`` (a parameter or its master), ``m``
    and ``v`` in place, from the gradient ``g`` (float32 or bfloat16).
    ``lr``, ``bc1``, ``bc2`` and ``decay`` are rounded to float32, as are
    the betas, ``1 - beta`` and ``eps``. ``p_out``: the bfloat16 parameter
    whose value is ``p``, written in the same pass.

    CUDA tensors launch the Hopper kernel and raise on anything it cannot
    take; CPU tensors take the plain version."""
    fused_adam_update_many([(p, g, m, v, decay, p_out)], lr, bc1, bc2,
                           beta1=beta1, beta2=beta2, eps=eps)
