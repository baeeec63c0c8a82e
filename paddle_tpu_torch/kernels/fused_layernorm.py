"""Fused LayerNorm, forward and backward — the port of
``paddle_tpu/kernels/fused_layernorm.py`` (``_ln_fwd_kernel`` via
``_call_fwd``, ``_ln_dx_kernel`` via ``_call_dx``, and the custom VJP
``fused_layer_norm`` with its XLA sums of dgamma and dbeta).

Three things live here, as for every kernel of the port:

- ``fused_layer_norm``: the differentiable entry point, a
  ``torch.autograd.Function`` that saves ``x``, ``gamma``, ``mu`` and
  ``rstd``. Its forward calls ``layer_norm_forward`` and its backward
  ``layer_norm_backward``: on CUDA tensors each launches hand-written
  Hopper kernels (``csrc/fused_layernorm.cu``, built by :mod:`._build` at
  first use) on the current stream — the backward one pass that writes dx
  and float32 column partials, then a reduction of the partials into
  dgamma and dbeta in a fixed order, and no PyTorch compute launch; on
  CPU tensors each takes its plain version. Anything a kernel does not
  take raises.
- ``fused_layer_norm_reference`` and ``layer_norm_backward_reference``:
  the plain PyTorch versions, the reference's formulas written out (never
  ``torch.nn.functional.layer_norm``). The CPU path and the tests use
  them; nothing on the CUDA path calls them.
- the counters: ``fwd_launches``, ``dx_launches`` (the backward kernel:
  dx and the column partials) and ``reduce_launches`` (the reduction
  into dgamma and dbeta) grow by one where each kernel is launched and
  nowhere else, ``reference_calls`` at every call of a plain version.

The TPU kernel ran on whole blocks of 8 rows with ``d`` a multiple of the
128-lane tile and at least 64 rows, and ``maybe_fused_layer_norm`` fell
back to XLA on any other shape or on any kernel error. Those were TPU
tiling rules and a quiet fallback; here the kernels take any row count
and any ``d`` up to ``MAX_D``, and raise outside that. Replaces
``paddle_tpu/kernels/fused_layernorm.py:32`` and ``:47`` (``pallas_call``
at ``:69`` and ``:93``) and the sums of ``_vjp_bwd`` (``:130-142``);
bound by bytes, see the source's header.
"""
from __future__ import annotations

import ctypes
import functools

import torch

__all__ = ["fused_layer_norm", "fused_layer_norm_reference",
           "layer_norm_backward_reference", "layer_norm_forward",
           "layer_norm_backward", "layer_norm_dx", "backward_plan", "MAX_D",
           "SOURCE", "REPLACES_FWD", "REPLACES_DX", "REPLACES_SUMS"]

# Read and reset the counters through the module
# (``fused_layernorm.fwd_launches``): a name imported from here is a copy
# of the value at import time.
#: forward kernel launches made by the wrapper
fwd_launches = 0
#: backward kernel launches made by the wrapper (dx and column partials)
dx_launches = 0
#: reduction kernel launches (the partials into dgamma and dbeta)
reduce_launches = 0
#: calls of the plain versions (forward or dx), on any device
reference_calls = 0

#: the analysis.kernelcheck entries that certify this module's kernel
KERNELCHECK_CERTS = ("layernorm_forward", "layernorm_dx",
                     "layernorm_backward")
SOURCE = "paddle_tpu_torch/kernels/csrc/fused_layernorm.cu"
REPLACES_FWD = "paddle_tpu/kernels/fused_layernorm.py:32"
REPLACES_DX = "paddle_tpu/kernels/fused_layernorm.py:47"
#: the sums the reference leaves to XLA, which the backward's partials
#: and reduction compute
REPLACES_SUMS = "paddle_tpu/kernels/fused_layernorm.py:130-142"

#: the largest normalised width the kernels take
MAX_D = 65536
#: the backward's rows program: d a multiple of ROW_COLS up to
#: ROW_COLS * 32 * ROW_STEPS, ROW_WARPS warps a block (csrc's kRowCols,
#: kMaxRowSteps, kRowWarps)
ROW_COLS, ROW_STEPS, ROW_WARPS = 8, 4, 16
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


def layer_norm_backward_reference(x2, gamma, mu, rstd, dy2):
    """The plain backward over rows: ``(dx, dgamma, dbeta)`` with ``dx =
    rstd * (wdy - mean(wdy) - xhat * mean(wdy * xhat))``, ``xhat = (x - mu)
    * rstd``, ``wdy = dy * gamma``, ``dgamma = sum(dy * xhat, 0)`` and
    ``dbeta = sum(dy, 0)``, in float32; dx in x's dtype, dgamma and dbeta
    in gamma's."""
    global reference_calls
    reference_calls += 1
    dy = dy2.float()
    xhat = (x2.float() - mu) * rstd
    wdy = dy * gamma.float()
    c1 = wdy.mean(-1, keepdim=True)
    c2 = (wdy * xhat).mean(-1, keepdim=True)
    dx = (rstd * (wdy - c1 - xhat * c2)).to(x2.dtype)
    return (dx, (dy * xhat).sum(0).to(gamma.dtype),
            dy.sum(0).to(gamma.dtype))


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
        bwd = lib.ln_backward
        bwd.argtypes = [ptr] * 9 + [i32] * 5 + [ptr]
        bwd.restype = i32
        _fns = (fwd, bwd)
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


def backward_plan(rows: int, d: int, dtype, aligned: bool,
                  sm_count: int) -> tuple:
    """``(program, parts)`` of the backward kernel at these shapes, as
    ``csrc/fused_layernorm.cu``'s ``bwd_plan`` chooses: the ``rows``
    program (its steps of 256 columns a warp) where every pointer is
    16-byte aligned and ``d`` is a multiple of ``ROW_COLS`` up to 1,024,
    one persistent block of ``ROW_WARPS`` warps an SM, a row to a group of
    ``ceil(d / 256)`` warps (the program's N); else the ``strips``
    program, a block each 8 rows (vectors of 16 bytes where aligned and
    ``d`` allows). ``parts`` is the grid: the partial rows the reduction
    adds."""
    cols = ROW_COLS * 32
    if aligned and d % ROW_COLS == 0 and d <= cols * ROW_STEPS:
        warps = -(-d // cols)  # a row's group; ROW_WARPS // warps groups
        return ("rows", warps), min(-(-rows // (ROW_WARPS // warps)),
                                    sm_count)
    item = torch.empty((), dtype=dtype).element_size()
    return ("strips", aligned and d % (16 // item) == 0), -(-rows // 8)


@functools.lru_cache(maxsize=8)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_backward(x2, gamma, mu, rstd, dy2) -> None:
    _check(x2, gamma)
    rows = x2.shape[0]
    for name, t in (("mu", mu), ("rstd", rstd)):
        if tuple(t.shape) != (rows, 1) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 [{rows}, 1]; got "
                             f"{t.dtype} {tuple(t.shape)}")
    if dy2.shape != x2.shape or dy2.dtype != x2.dtype:
        raise ValueError(f"dy must match x {tuple(x2.shape)} {x2.dtype}; got "
                         f"{tuple(dy2.shape)} {dy2.dtype}")


def layer_norm_backward(x2, gamma, mu, rstd, dy2, dx: bool = True,
                        params: bool = True):
    """``(dx, dgamma, dbeta)`` over rows (see
    :func:`layer_norm_backward_reference`), each None where not asked
    for (``dx``; ``params``: dgamma and dbeta). CUDA tensors launch the
    backward kernel and, for the parameters, the reduction; CPU tensors
    take the plain version."""
    global dx_launches, reduce_launches
    _check_backward(x2, gamma, mu, rstd, dy2)
    if not (dx or params):
        return None, None, None
    if x2.device.type == "cpu":
        gx, gg, gb = layer_norm_backward_reference(x2, gamma, mu, rstd, dy2)
        return (gx if dx else None, gg if params else None,
                gb if params else None)
    if x2.device.type != "cuda":
        raise ValueError(f"no fused layer norm for device {x2.device}")
    _check_kernel((("x", x2), ("gamma", gamma), ("mu", mu), ("rstd", rstd),
                   ("dy", dy2)))
    rows, d = x2.shape
    gx = torch.empty_like(x2) if dx else None
    gg = gb = parts = None
    n_parts = 0
    if params:
        aligned = all(t.data_ptr() % 16 == 0
                      for t in (x2, gamma, dy2, gx) if t is not None)
        _, n_parts = backward_plan(rows, d, x2.dtype, aligned,
                                   _sm_count(x2.device.index or 0))
        parts = torch.empty((2, n_parts, d), dtype=torch.float32,
                            device=x2.device)
        gg, gb = torch.empty((2, d), dtype=gamma.dtype,
                             device=x2.device).unbind(0)
    _, fn = _entry_points()
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream(x2.device).cuda_stream
        err = fn(x2.data_ptr(), gamma.data_ptr(), mu.data_ptr(),
                 rstd.data_ptr(), dy2.data_ptr(),
                 gx.data_ptr() if dx else None,
                 parts.data_ptr() if params else None,
                 gg.data_ptr() if params else None,
                 gb.data_ptr() if params else None, rows, d, n_parts,
                 _DTYPE_CODE[x2.dtype], _DTYPE_CODE[gamma.dtype], stream)
    _raise_on(err, "backward", x2)
    dx_launches += 1
    if params:
        reduce_launches += 1
    return gx, gg, gb


def layer_norm_dx(x2, gamma, mu, rstd, dy2):
    """The input gradient alone (:func:`layer_norm_backward` without the
    parameters): one launch of the backward kernel on CUDA tensors."""
    return layer_norm_backward(x2, gamma, mu, rstd, dy2, params=False)[0]


class _FusedLayerNorm(torch.autograd.Function):
    """The forward kernel under autograd: saves ``(x, gamma, mu, rstd)``;
    the backward runs the backward kernels for what is asked of it: dx,
    dgamma and dbeta (the reduction when either parameter needs one)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        x2 = x.reshape(-1, x.shape[-1]).contiguous()
        y, mu, rstd = layer_norm_forward(x2, gamma, beta, eps)
        ctx.save_for_backward(x2, gamma, mu, rstd)
        ctx.shape = x.shape
        return y.view(x.shape)

    @staticmethod
    def backward(ctx, dy):
        x2, gamma, mu, rstd = ctx.saved_tensors
        dy2 = dy.reshape(x2.shape).contiguous()
        need_x, need_g, need_b = ctx.needs_input_grad[:3]
        dx, dgamma, dbeta = layer_norm_backward(
            x2, gamma, mu, rstd, dy2, dx=need_x, params=need_g or need_b)
        return (dx.view(ctx.shape) if need_x else None,
                dgamma if need_g else None, dbeta if need_b else None, None)


def fused_layer_norm(x, gamma, beta, eps=1e-5):
    """LayerNorm of ``x [..., d]`` over its last dimension with ``gamma``
    and ``beta`` ``[d]`` (one dtype), differentiable in all three.

    CUDA tensors launch the Hopper kernels (the forward; in the backward
    one pass for dx and the column partials, then their reduction) and raise on anything they cannot take (a dtype other than
    float32 or bfloat16, ``d`` above ``MAX_D``); CPU tensors take the plain
    versions. With no gradient to record (serving) the forward is called
    directly, without the autograd function's cost on the host."""
    if torch.is_grad_enabled() and (x.requires_grad or gamma.requires_grad
                                    or beta.requires_grad):
        return _FusedLayerNorm.apply(x, gamma, beta, float(eps))
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    return layer_norm_forward(x2, gamma, beta, float(eps))[0].view(x.shape)
