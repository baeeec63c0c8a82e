"""Fused LayerNorm, forward and input gradient — the port of
``paddle_tpu/kernels/fused_layernorm.py`` (``_ln_fwd_kernel`` via
``_call_fwd``, ``_ln_dx_kernel`` via ``_call_dx``, and the custom VJP
``fused_layer_norm``).

Three things live here, as for every kernel of the port:

- ``fused_layer_norm``: the differentiable entry point, a
  ``torch.autograd.Function`` that saves ``x``, ``gamma``, ``mu`` and
  ``rstd``. Its forward calls ``layer_norm_forward`` and its backward
  ``layer_norm_dx``: on CUDA tensors each launches its hand-written Hopper
  kernel (``csrc/fused_layernorm.cu``, built by :mod:`._build` at first
  use) on the current stream; on CPU tensors each takes its plain
  version. Anything a kernel does not take raises. ``dgamma`` and
  ``dbeta`` are plain float32 sums over rows, cast to gamma's dtype, as
  the reference leaves them to XLA.
- ``fused_layer_norm_reference`` and ``layer_norm_dx_reference``: the
  plain PyTorch versions, the reference's formulas written out (never
  ``torch.nn.functional.layer_norm``). The CPU path and the tests use
  them; nothing on the CUDA path calls them.
- the counters: ``fwd_launches`` and ``dx_launches`` grow by one where
  each kernel is launched and nowhere else, ``reference_calls`` at every
  call of a plain version.

The TPU kernel ran on whole blocks of 8 rows with ``d`` a multiple of the
128-lane tile and at least 64 rows, and ``maybe_fused_layer_norm`` fell
back to XLA on any other shape or on any kernel error. Those were TPU
tiling rules and a quiet fallback; here the kernel takes any row count
and any ``d`` up to ``MAX_D``, and raises outside that. Replaces
``paddle_tpu/kernels/fused_layernorm.py:32`` and ``:47`` (``pallas_call``
at ``:69`` and ``:93``); bound by bytes, see the source's header.
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["fused_layer_norm", "fused_layer_norm_reference",
           "layer_norm_dx_reference", "layer_norm_forward", "layer_norm_dx",
           "MAX_D", "SOURCE", "REPLACES_FWD", "REPLACES_DX"]

# Read and reset the counters through the module
# (``fused_layernorm.fwd_launches``): a name imported from here is a copy
# of the value at import time.
#: forward kernel launches made by the wrapper
fwd_launches = 0
#: input-gradient kernel launches made by the wrapper
dx_launches = 0
#: calls of the plain versions (forward or dx), on any device
reference_calls = 0

SOURCE = "paddle_tpu_torch/kernels/csrc/fused_layernorm.cu"
REPLACES_FWD = "paddle_tpu/kernels/fused_layernorm.py:32"
REPLACES_DX = "paddle_tpu/kernels/fused_layernorm.py:47"

#: the largest normalised width the kernels take
MAX_D = 65536
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_fns = None  # the loaded C entry points, with their argtypes declared


def fused_layer_norm_reference(x2, gamma, beta, eps):
    """The plain forward over rows ``x2 [rows, d]``: ``(y, mu, rstd)``
    with ``mu = mean(x)``, ``var = mean((x - mu)²)``, ``rstd = 1 /
    sqrt(var + eps)`` and ``y = (x - mu) * rstd * gamma + beta``, all in
    float32; ``y`` in x's dtype, ``mu`` and ``rstd`` float32 ``[rows, 1]``."""
    global reference_calls
    reference_calls += 1
    x = x2.float()
    mu = x.mean(-1, keepdim=True)
    xc = x - mu
    var = (xc * xc).mean(-1, keepdim=True)
    rstd = 1.0 / torch.sqrt(var + eps)
    y = xc * rstd * gamma.float() + beta.float()
    return y.to(x2.dtype), mu, rstd


def layer_norm_dx_reference(x2, gamma, mu, rstd, dy2):
    """The plain input gradient over rows: ``rstd * (wdy - mean(wdy) -
    xhat * mean(wdy * xhat))`` with ``xhat = (x - mu) * rstd`` and
    ``wdy = dy * gamma``, in float32; returned in x's dtype."""
    global reference_calls
    reference_calls += 1
    xhat = (x2.float() - mu) * rstd
    wdy = dy2.float() * gamma.float()
    c1 = wdy.mean(-1, keepdim=True)
    c2 = (wdy * xhat).mean(-1, keepdim=True)
    return (rstd * (wdy - c1 - xhat * c2)).to(x2.dtype)


def _check(x2, gamma, *vecs) -> None:
    """The contract both paths share."""
    if x2.dim() != 2:
        raise ValueError(f"x must be [rows, d]; got {tuple(x2.shape)}")
    d = x2.shape[1]
    for t in (gamma, *vecs):
        if tuple(t.shape) != (d,):
            raise ValueError(f"gamma and beta must be [{d}]; got "
                             f"{tuple(t.shape)}")
        if t.dtype != gamma.dtype:
            raise TypeError(f"gamma and beta must share one dtype; got "
                            f"{gamma.dtype}, {t.dtype}")
    if len({x2.device, gamma.device} | {t.device for t in vecs}) != 1:
        raise ValueError("all operands must be on one device")


def _check_kernel(named) -> None:
    """What the CUDA kernels additionally need."""
    x2 = named[0][1]
    rows, d = x2.shape
    if x2.dtype not in _DTYPE_CODE or named[1][1].dtype not in _DTYPE_CODE:
        raise TypeError(f"the kernels take x and gamma in float32 or "
                        f"bfloat16; got {x2.dtype}, {named[1][1].dtype}")
    if not 1 <= d <= MAX_D or rows < 1 or rows >= 2 ** 31:
        raise ValueError(f"the kernels take 1 <= d <= {MAX_D} and "
                         f"1 <= rows < 2**31; got [{rows}, {d}]")
    for name, t in named:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _entry_points():
    global _fns
    if _fns is None:
        from ._build import load

        lib = load("fused_layernorm")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fwd = lib.ln_forward
        fwd.argtypes = [ptr] * 6 + [i32, i32, ctypes.c_float, i32, i32, ptr]
        fwd.restype = i32
        dx = lib.ln_dx
        dx.argtypes = [ptr] * 6 + [i32] * 4 + [ptr]
        dx.restype = i32
        _fns = (fwd, dx)
    return _fns


def _raise_on(err: int, what: str, x2) -> None:
    if err:
        raise RuntimeError(f"fused layer norm {what} kernel launch failed "
                           f"with CUDA error {err} (x {tuple(x2.shape)}, "
                           f"{x2.dtype})")


def layer_norm_forward(x2, gamma, beta, eps):
    """``(y, mu, rstd)`` over rows ``x2 [rows, d]`` (see
    :func:`fused_layer_norm_reference`). CUDA tensors launch the forward
    kernel; CPU tensors take the plain version."""
    global fwd_launches
    _check(x2, gamma, beta)
    if x2.device.type == "cpu":
        return fused_layer_norm_reference(x2, gamma, beta, eps)
    if x2.device.type != "cuda":
        raise ValueError(f"no fused layer norm for device {x2.device}")
    _check_kernel((("x", x2), ("gamma", gamma), ("beta", beta)))
    rows, d = x2.shape
    y = torch.empty_like(x2)
    mu = torch.empty((rows, 1), dtype=torch.float32, device=x2.device)
    rstd = torch.empty_like(mu)
    fwd, _ = _entry_points()
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream(x2.device).cuda_stream
        err = fwd(x2.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                  y.data_ptr(), mu.data_ptr(), rstd.data_ptr(), rows, d,
                  float(eps), _DTYPE_CODE[x2.dtype], _DTYPE_CODE[gamma.dtype],
                  stream)
    _raise_on(err, "forward", x2)
    fwd_launches += 1
    return y, mu, rstd


def layer_norm_dx(x2, gamma, mu, rstd, dy2):
    """The input gradient over rows (see :func:`layer_norm_dx_reference`)
    in x's dtype. CUDA tensors launch the dx kernel; CPU tensors take the
    plain version."""
    global dx_launches
    _check(x2, gamma)
    rows = x2.shape[0]
    for name, t in (("mu", mu), ("rstd", rstd)):
        if tuple(t.shape) != (rows, 1) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 [{rows}, 1]; got "
                             f"{t.dtype} {tuple(t.shape)}")
    if dy2.shape != x2.shape or dy2.dtype != x2.dtype:
        raise ValueError(f"dy must match x {tuple(x2.shape)} {x2.dtype}; got "
                         f"{tuple(dy2.shape)} {dy2.dtype}")
    if x2.device.type == "cpu":
        return layer_norm_dx_reference(x2, gamma, mu, rstd, dy2)
    if x2.device.type != "cuda":
        raise ValueError(f"no fused layer norm for device {x2.device}")
    _check_kernel((("x", x2), ("gamma", gamma), ("mu", mu), ("rstd", rstd),
                   ("dy", dy2)))
    dx = torch.empty_like(x2)
    _, fn = _entry_points()
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream(x2.device).cuda_stream
        err = fn(x2.data_ptr(), gamma.data_ptr(), mu.data_ptr(),
                 rstd.data_ptr(), dy2.data_ptr(), dx.data_ptr(), rows,
                 x2.shape[1], _DTYPE_CODE[x2.dtype], _DTYPE_CODE[gamma.dtype],
                 stream)
    _raise_on(err, "dx", x2)
    dx_launches += 1
    return dx


class _FusedLayerNorm(torch.autograd.Function):
    """The forward kernel under autograd: saves ``(x, gamma, mu, rstd)``;
    the backward runs the dx kernel and sums dgamma and dbeta over rows in
    float32."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        x2 = x.reshape(-1, x.shape[-1]).contiguous()
        y, mu, rstd = layer_norm_forward(x2, gamma, beta, eps)
        ctx.save_for_backward(x2, gamma, mu, rstd)
        ctx.shape, ctx.beta_dtype = x.shape, beta.dtype
        return y.view(x.shape)

    @staticmethod
    def backward(ctx, dy):
        x2, gamma, mu, rstd = ctx.saved_tensors
        dy2 = dy.reshape(x2.shape).contiguous()
        dx = dgamma = dbeta = None
        if ctx.needs_input_grad[0]:
            dx = layer_norm_dx(x2, gamma, mu, rstd, dy2).view(ctx.shape)
        if ctx.needs_input_grad[1]:  # sum over rows of dy * xhat
            prod = (x2.float() - mu).mul_(rstd).mul_(dy2)
            dgamma = prod.sum(0).to(gamma.dtype)
        if ctx.needs_input_grad[2]:
            dbeta = dy2.sum(0, dtype=torch.float32).to(ctx.beta_dtype)
        return dx, dgamma, dbeta, None


def fused_layer_norm(x, gamma, beta, eps=1e-5):
    """LayerNorm of ``x [..., d]`` over its last dimension with ``gamma``
    and ``beta`` ``[d]`` (one dtype), differentiable in all three.

    CUDA tensors launch the Hopper kernels (forward and, in the backward,
    dx) and raise on anything they cannot take (a dtype other than
    float32 or bfloat16, ``d`` above ``MAX_D``); CPU tensors take the plain
    versions. With no gradient to record (serving) the forward is called
    directly, without the autograd function's cost on the host."""
    if torch.is_grad_enabled() and (x.requires_grad or gamma.requires_grad
                                    or beta.requires_grad):
        return _FusedLayerNorm.apply(x, gamma, beta, float(eps))
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    return layer_norm_forward(x2, gamma, beta, float(eps))[0].view(x.shape)
