"""Flash attention, forward and backward — the port of
``paddle_tpu/kernels/flash_attention.py`` (``_flash`` with its custom VJP,
and the causal splash route ``_splash``).

Three things live here, as for every kernel of the port:

- ``flash_attention``: the wrapper. A CUDA tensor runs the hand-written
  Hopper kernels (``csrc/flash_attention.cu``, built by :mod:`._build` at
  first use) under a ``torch.autograd.Function`` whose backward is the
  kernel's backward; a CPU tensor takes the plain version. Anything the
  kernel does not take raises.
- ``flash_attention_reference``: the plain PyTorch version,
  ``sdpa_reference`` under autograd. The CPU path and the tests use it;
  nothing on the CUDA training path calls it.
- the counters: ``fwd_launches`` grows by one where the forward kernel is
  launched, ``bwd_launches`` by one where a backward runs its kernels
  (float32: delta, dk/dv and dq; bfloat16: prep, the fused dk/dv/dq
  kernel and the dq rounding — one backward), and ``reference_calls`` at
  every call of the plain version — so a run can show which one served.

Causal attention aligns the diagonal bottom-right (query ``i`` sees keys
``j <= i + s_k - s_q``), as ``sdpa_reference`` and the splash kernel do.
The JAX package's library flash kernel aligns it top-left when
``s_q != s_k``; the port follows ``sdpa_reference``, which is what the JAX
package computes on the CPU. On the training path ``s_q == s_k``, where
the two agree.

There is no tiling gate and no padding route: the TPU kernel's
``supports_shape``, ``flash_route``, ``pad_seq_to_block`` and tuned block
table are TPU tiling rules. The Hopper kernel masks its own tails, so any
``s_q, s_k >= 1`` runs; it is built for head_dim 64 and 128 in float32 and
bfloat16.

Replaces ``paddle_tpu/kernels/flash_attention.py:152`` (``_flash``,
``_flash_fwd``, ``_flash_bwd``) and ``:208`` (``_splash``: the causal tile
skip). At the training shape the forward is bound by bytes (by a little)
and the backward by operations; see the source's header for the design.
``forward_tile_schedule`` mirrors the bf16 forward's tile schedule per
work item (which K/V tiles each group of 64 queries visits, and which of
them take the masked path), so the CPU tests can hold it against the
plain version's mask.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .attention import default_scale, sdpa_reference

__all__ = ["flash_attention", "flash_attention_reference",
           "flash_attention_forward", "flash_attention_backward",
           "forward_tile_schedule", "FwdBlock", "FwdGroup",
           "SOURCE", "REPLACES", "REPLACES_SPLASH"]

# Read and reset the counters through the module
# (``flash_attention.fwd_launches``): a name imported from here is a copy
# of the value at import time.
#: forward kernel launches made by the wrapper
fwd_launches = 0
#: backward runs (each launches the delta, dk/dv and dq kernels)
bwd_launches = 0
#: calls of the plain version, on any device
reference_calls = 0

#: the analysis.kernelcheck entries that certify this module's kernel
KERNELCHECK_CERTS = ("flash_attention_forward", "flash_attention_backward")
SOURCE = "paddle_tpu_torch/kernels/csrc/flash_attention.cu"
REPLACES = "paddle_tpu/kernels/flash_attention.py:152"
REPLACES_SPLASH = "paddle_tpu/kernels/flash_attention.py:208"

HEAD_DIMS = (64, 128)
#: query rows per tile of the bf16 backward (its statistics are padded to it)
BWD_TILE = 64
#: queries per work item of the bf16 forward (two consumer warpgroups),
#: per consumer warpgroup, and keys per K/V tile
FWD_ITEM_ROWS, FWD_GROUP_ROWS, FWD_KEY_TILE = 128, 64, 64


class FwdGroup(NamedTuple):
    """A consumer warpgroup's query rows ``r0 .. r0 + 63`` and the K/V
    tiles it computes: ``(first key, masked path)`` each, in order."""
    r0: int
    tiles: list


class FwdBlock(NamedTuple):
    """A work item of the bf16 forward: queries ``q0 .. q0 + 127`` of one
    (batch, head), the unit it belongs to, the K/V tiles the producer
    loads for it (keys ``0 .. 64 n_tiles - 1``) and its two groups."""
    q0: int
    unit: int
    n_tiles: int
    groups: list


def _keys_needed(q0, q_last, s_k, off, causal):
    """Keys a causal query range [q0, q_last] needs (``keys_needed`` in
    the source): none past its last row's diagonal; every key when its
    first row sees none."""
    if not causal or q0 + off < 0:
        return s_k
    return min(s_k, q_last + off + 1)


def forward_tile_schedule(s_q, s_k, causal):
    """The bf16 forward kernel's tile schedule for one (batch, head),
    mirrored from ``flash_fwd_wgmma_kernel`` for these shapes (either
    head_dim). Items come in the kernel's order: units of two query
    blocks, the i-th from the end (first) and the i-th from the start,
    whose causal work sums to the same for every unit of a square shape
    (an odd count's middle block is a unit alone). A group visits the
    tiles its rows below ``s_q`` need (none when it has no such row); a
    tile takes the mask-free path when every row of the group is below
    ``s_q``, every key of the tile below ``s_k`` and, causal, the group's
    first row sees the tile's last key (the kernel also needs
    ``scale > 0`` for it); tiles past a group's last are loaded for the
    other group and skipped."""
    keys = FWD_KEY_TILE
    off = s_k - s_q
    rows = FWD_ITEM_ROWS
    n_qblocks = -(-s_q // rows)
    order = []
    for p in range((n_qblocks + 1) // 2):
        order += [(p, n_qblocks - 1 - p)] + (
            [(p, p)] if p != n_qblocks - 1 - p else [])
    blocks = []
    for unit, qb in order:
        q0 = qb * rows
        groups = []
        for r0 in range(q0, q0 + rows, FWD_GROUP_ROWS):
            n = 0 if r0 >= s_q else -(-_keys_needed(
                r0, min(r0 + FWD_GROUP_ROWS, s_q) - 1, s_k, off,
                causal) // keys)
            full_rows = r0 + FWD_GROUP_ROWS <= s_q
            groups.append(FwdGroup(r0, [
                (i * keys, not (full_rows and (i + 1) * keys <= s_k and (
                    not causal or (i + 1) * keys - 1 <= r0 + off)))
                for i in range(n)]))
        blocks.append(FwdBlock(q0, unit, max(len(g.tiles) for g in groups),
                               groups))
    return blocks


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_fns = None  # the loaded C entry points, with their argtypes declared


def flash_attention_reference(q, k, v, *, causal=False, scale=None):
    """The plain version: ``sdpa_reference`` (float32 logits, masked
    logits ``-1e30``, probabilities cast to ``q.dtype`` before PV), whose
    gradient autograd takes."""
    global reference_calls
    reference_calls += 1
    return sdpa_reference(q, k, v, is_causal=causal, scale=scale)


def _check(q, k, v) -> None:
    """The contract both paths share: shapes, dtypes, one device."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k, v must be [b, h, s, d]; got {tuple(q.shape)}"
                         f", {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, _, d = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != d:
        raise ValueError(f"k and v must be [{b}, {h}, s_k, {d}]; got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one dtype of float32 or "
                        f"bfloat16; got {q.dtype}, {k.dtype}, {v.dtype}")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError(f"q, k, v must be on one device; got {q.device}, "
                         f"{k.device}, {v.device}")


def _check_kernel(*named) -> None:
    """What the CUDA kernels additionally need."""
    d = named[0][1].shape[-1]
    if d not in HEAD_DIMS:
        raise ValueError(f"the flash kernel is built for head_dim "
                         f"{HEAD_DIMS}; got {d}")
    for name, t in named:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernel "
                             f"stages tiles with 16-byte copies)")


def _entry_points():
    global _fns
    if _fns is None:
        from ._build import load

        lib = load("flash_attention")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fwd = lib.flash_attention_forward
        fwd.argtypes = [ptr] * 5 + [i32] * 5 + [ctypes.c_float, i32, i32, ptr]
        fwd.restype = i32
        bwd = lib.flash_attention_backward
        bwd.argtypes = [ptr] * 12 + [i32] * 5 + [ctypes.c_float, i32, i32,
                                                  ptr]
        bwd.restype = i32
        _fns = (fwd, bwd)
    return _fns


def _raise_on(err: int, what: str, q, k) -> None:
    if err:
        raise RuntimeError(f"flash attention {what} kernel launch failed with "
                           f"CUDA error {err} (q {tuple(q.shape)}, k "
                           f"{tuple(k.shape)}, {q.dtype})")


def flash_attention_forward(q, k, v, *, causal=False, scale=None):
    """The forward kernel on CUDA tensors: ``(o, lse)`` with ``o`` in q's
    dtype and the float32 row logsumexp ``lse [b, h, s_q]`` the backward
    needs. No autograd; :func:`flash_attention` is the differentiable
    entry point."""
    global fwd_launches
    _check(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"the flash kernel runs on CUDA tensors; got "
                         f"{q.device}")
    _check_kernel(("q", q), ("k", k), ("v", v))
    b, h, s_q, d = q.shape
    scale = default_scale(d) if scale is None else float(scale)
    fwd, _ = _entry_points()
    o = torch.empty_like(q)
    lse = torch.empty((b, h, s_q), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                  lse.data_ptr(), b, h, s_q, k.shape[2], d, scale,
                  int(bool(causal)), _DTYPE_CODE[q.dtype], stream)
    _raise_on(err, "forward", q, k)
    fwd_launches += 1
    return o, lse


def flash_attention_backward(q, k, v, o, lse, dout, *, causal=False,
                             scale=None):
    """The backward kernels on CUDA tensors: ``(dq, dk, dv)`` in q's
    dtype from the forward's ``o`` and ``lse`` and the output gradient.

    In bfloat16 the key tiles add their parts of dq into a float32 buffer
    in no fixed order, so dq may differ between two runs on the same
    inputs by float32 reassociation before its one bf16 rounding (at most
    one bf16 step where that rounding flips); dk and dv do not."""
    global bwd_launches
    _check(q, k, v)
    if o.shape != q.shape or dout.shape != q.shape or o.dtype != q.dtype \
            or dout.dtype != q.dtype:
        raise ValueError(f"o and dout must match q {tuple(q.shape)} "
                         f"{q.dtype}; got {tuple(o.shape)} {o.dtype}, "
                         f"{tuple(dout.shape)} {dout.dtype}")
    if lse.shape != q.shape[:3] or lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32 {tuple(q.shape[:3])}; got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    _check_kernel(("q", q), ("k", k), ("v", v), ("o", o), ("lse", lse),
                  ("dout", dout))
    b, h, s_q, d = q.shape
    scale = default_scale(d) if scale is None else float(scale)
    _, bwd = _entry_points()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # the float32 scratch of the dtype's kernels, written before it is read
    delta = dq_acc = stats = None
    if q.dtype == torch.float32:
        scratch = torch.empty_like(lse)
        delta = scratch.data_ptr()
    else:  # the dq accumulator, then the padded per-tile lse / delta
        n_stats = b * h * -(-s_q // BWD_TILE) * 2 * BWD_TILE
        scratch = torch.empty(q.numel() + n_stats, dtype=torch.float32,
                              device=q.device)
        dq_acc = scratch.data_ptr()
        stats = dq_acc + 4 * q.numel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                  lse.data_ptr(), dout.data_ptr(), delta, dq_acc, stats,
                  dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                  b, h, s_q, k.shape[2], d, scale, int(bool(causal)),
                  _DTYPE_CODE[q.dtype], stream)
    _raise_on(err, "backward", q, k)
    bwd_launches += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The kernels under autograd: the forward saves ``(q, k, v, o, lse)``
    and the backward runs the backward kernels on them."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, lse = flash_attention_forward(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(
            q, k, v, o, lse, dout.contiguous(), causal=ctx.causal,
            scale=ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal=False, scale=None):
    """``softmax(q kᵀ · scale [causal]) v`` over ``[b, h, s, d]`` without
    forming the score matrix, differentiable in q, k and v. ``scale``
    defaults to ``1 / sqrt(d)``; causal aligns the diagonal bottom-right.

    CUDA tensors launch the Hopper kernels and raise on anything they
    cannot take (head_dim other than 64 or 128, non-contiguous inputs);
    CPU tensors take the plain version."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention for device {q.device}")
    return _FlashAttention.apply(q, k, v, bool(causal), scale)
