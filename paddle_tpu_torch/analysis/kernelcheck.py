"""Certification of the port's CUDA kernels — the port of
``paddle_tpu/analysis/kernelcheck.py``.

The reference traces each kernel entry to its jaxpr and certifies every
``pallas_call``: VMEM budget, tiling, a write-race proof over the grid,
a banked roofline. The port's kernels are CUDA C++ launched through
ctypes, so the same contract is checked on what a launch is made of:

- **Launch plan** — each registered entry has a Python plan of the
  launches one call makes at given shapes: the kernel, its grid, threads
  a block, dynamic shared memory, and for each output it writes the map
  from a grid point (or, for a persistent or grid-stride kernel, a work
  unit) to the output tiles it writes. The plans mirror the ``.cu``
  launch code; on the card each source's ``*_geometry`` C entry (built
  from ``csrc/launch_record.cuh``) reports the geometry its launch code
  computes, and :func:`certify` holds the plan equal to it.
- **Budget** — :class:`KernelBudget`: a block's shared memory (static,
  from ptxas, plus dynamic) at most the H100's 227 KiB, at most 255
  registers a thread and 1,024 threads a block, registers x threads
  within the 65,536 of an SM, and spill bytes no more than the frozen
  per-kernel values (today's ptxas: every kernel spills nothing but the
  float32 split program at head_dim 192, 8 bytes each way).
- **Write races** — each output map is evaluated over the whole grid and
  proven injective (no two points write one tile), and where the kernel
  writes every element it covers the output exactly once — the
  reference's ``_eval_index_map`` proof. An accumulating output (the
  flash backward's float32 dq, added by every key tile) is declared and
  exempt from the injectivity proof.
- **Roofline** — each entry's ``bound_ms`` at its main-path shapes (the
  bytes it must move over 3.35 TB/s against its operations over the
  H100 SXM's peak for their type, the formulas of ``chip_smoke.py``) is
  banked to ``kernelcheck_bank.json`` beside this module and diffed on
  the next run, with the reference's ``predicted_speedup`` for each
  kernel A/B label the entry serves (:data:`AB_LABELS`): the bytes its
  plain version materializes (arguments, intermediates and outputs,
  counted on meta tensors by :func:`materialized_bytes`) over the bytes
  the kernel must move. The serving engine seeds its
  ``serving_kernel_speedup_*{kernel=}`` gauges from these
  (``obs.attribution.load_banked_kernel_speedups``).
- **Coverage** — :func:`coverage_report` maps which ``ServingConfig``
  and training options reach which kernel and ragged program.

``python -m paddle_tpu_torch.analysis kernelcheck`` certifies every
entry at its main-path and odd shapes on the CPU (plans, budgets without
ptxas, races, the bank); on the card ``chip_smoke.py`` adds the C
geometry and the ptxas rows. A module that builds a kernel
(``_build.load``) declares ``KERNELCHECK_CERTS`` naming its entries here
(lint rule PT011).
"""
from __future__ import annotations

import ctypes
import itertools
import json
import math
import os
import re
from dataclasses import dataclass, field

__all__ = ["KernelBudget", "KernelFinding", "KernelCertReport",
           "KernelCheckError", "Launch", "Output", "KernelSpec", "REGISTRY",
           "certify", "c_geometry", "spill_budget_findings", "bound",
           "bank_path", "diff_banked", "run_kernel", "coverage_report",
           "main", "SMEM_CAP", "PEAK_BYTES_PER_S", "PEAK_FLOPS",
           "AB_LABELS", "materialized_bytes", "predicted_speedup",
           "banked_predictions"]


class KernelCheckError(RuntimeError):
    """A kernel failed certification."""


# ------------------------------------------------------------------ budgets
#: H100: shared memory a block can opt into (227 KiB), registers a
#: thread, threads a block, registers an SM (so a block's threads x
#: registers must fit)
SMEM_CAP = 227 * 1024
MAX_REGISTERS = 255
MAX_THREADS = 1024
SM_REGISTERS = 65536
#: H100 SXM data sheet: HBM3 bytes/s, dense FLOP/s by dtype, and INT32
#: instructions/s (64 lanes an SM a clock: a quarter of float32's rate).
#: "tf32x3": float32-accurate products on the tensor cores, three TF32
#: products each (495 / 3 TFLOP/s) — the float32 flash kernels' rate;
#: "fp32" (the CUDA cores) bounds every other float32 kernel
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12, "int32": 67e12 / 4,
              "tf32x3": 495e12 / 3}
#: ptxas spill bytes frozen at today's build (the float32 split program at
#: head_dim 192 spills 8 bytes each way; nothing else spills)
FROZEN_SPILLS = {"ragged_split_kernel<float, float, 192>": 8}


@dataclass(frozen=True)
class KernelBudget:
    """Frozen per-entry certification contract. ``spills``: ptxas spill
    bytes (stores and loads each) allowed per kernel symbol — a symbol not
    named may spill nothing."""
    max_smem_bytes: int = SMEM_CAP
    max_registers: int = MAX_REGISTERS
    max_threads: int = MAX_THREADS
    spills: tuple = tuple(FROZEN_SPILLS.items())
    max_race_points: int = 1 << 21

    def spill_cap(self, symbol: str) -> int:
        return dict(self.spills).get(symbol, 0)


# ----------------------------------------------------------------- findings
@dataclass(frozen=True)
class KernelFinding:
    kind: str      # smem | registers | threads | spill | race | coverage
    severity: str  # "error" | "warn"
    message: str

    def __str__(self) -> str:
        return f"[{self.kind}/{self.severity}] {self.message}"


@dataclass(frozen=True)
class Output:
    """One output a launch writes: ``tiles(point)`` the tile ids grid point
    (or work unit) ``point`` writes, ``n_tiles`` the output's tiles when
    the launch writes every one of them (None: no coverage claim),
    ``accumulates``: tiles are added into by several points (a declared
    reduction, exempt from the race proof)."""
    name: str
    tiles: object = field(repr=False)
    n_tiles: int | None = None
    accumulates: bool = False


@dataclass(frozen=True)
class Launch:
    """One kernel launch of a plan. ``work``: the index space the outputs
    map over when it is not the grid (a persistent kernel's work units)."""
    kernel: str
    grid: tuple
    threads: int
    smem: int
    outputs: tuple = ()
    work: tuple | None = None

    def geometry(self) -> tuple:
        return (*self.grid, self.threads, self.smem)


@dataclass(frozen=True)
class KernelCertReport:
    name: str
    shape: str
    launches: tuple = ()
    findings: tuple = ()

    @property
    def errors(self) -> tuple:
        return tuple(f for f in self.findings if f.severity == "error")

    @property
    def ok(self) -> bool:
        return not self.errors

    def enforce(self) -> "KernelCertReport":
        if self.errors:
            raise KernelCheckError(
                f"kernelcheck({self.name!r}, {self.shape}): "
                + "; ".join(str(f) for f in self.errors))
        return self

    def summary(self) -> str:
        grids = ", ".join(f"{lc.kernel}{list(lc.grid)}x{lc.threads}"
                          f"+{lc.smem}B" for lc in self.launches)
        state = "OK" if self.ok else f"{len(self.errors)} violation(s)"
        return f"kernelcheck {self.name} [{self.shape}]: {grids}; {state}"


# ----------------------------------------------------------------- helpers
def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _rows(lo: int, hi: int, base: int = 0):
    return range(base + lo, base + hi)


def _stride_tiles(block: int, blocks: int, total: int, offset: int = 0):
    """The tiles a grid-stride loop gives block ``block``: ``block,
    block + blocks, ...`` below ``total``."""
    return range(offset + block, offset + total, blocks)


def _itemsize(dtype: str) -> int:
    return {"fp64": 8, "fp32": 4, "bf16": 2, "int8": 1}[dtype]


def _cxx(dtype: str) -> str:
    return {"fp64": "double", "fp32": "float", "bf16": "__nv_bfloat16",
            "int8": "signed char"}[dtype]


# --------------------------------------------------------- ragged attention
def _ragged_smem(program: str, kv: str, d: int, chunk: int) -> int:
    """Dynamic shared memory of a ragged program (``csrc/
    ragged_paged_attention.cu``'s Layout, SplitLayout, MmaLayout)."""
    item = _itemsize(kv)
    quant = kv == "int8"
    vec = 16 // item
    stride = d + vec
    if program == "warp":
        stage = 2 * 32 * stride
        scales = 2 * 32 if quant else 0
        return 2 * stage * item + 2 * scales * 4 + 8 * d * 4
    if program == "split":
        row = stride * item
        tile_n = 64 if 2 * 64 * row <= 40 * 1024 else \
            32 if 2 * 32 * row <= 40 * 1024 else 16
        stage = 2 * tile_n * stride
        scales = 2 * tile_n if quant else 0
        one = (stage * item + 2 * scales * 4 + 8 * d * 4 + 8 * tile_n * 4
               + 3 * 8 * 4)
        return one if chunk <= tile_n else one + stage * item
    tile = 64 * (d + 8)  # mma
    if quant:
        return 3 * tile * 2 + 2 * (2 * 64 * (d + 16)) + 2 * 2 * 64 * 4
    return 5 * tile * 2


def ragged_plan(b, h, s, d, page_size=16, pps=64, dtype="bf16",
                quant=False, sm_count=132) -> list:
    """The launches of one ``ragged_paged_attention`` call: the program
    ``launch_plan`` chooses from the shapes, its grid and shared memory,
    and the rows of ``out [b, h, s, d]`` (or the split partials) each
    block writes."""
    import torch

    from ..kernels import ragged_paged_attention as rpa

    tdt = {"bf16": torch.bfloat16, "fp32": torch.float32}[dtype]
    program, splits, chunk = rpa.launch_plan((b, h, s, d), tdt, page_size,
                                             pps, sm_count)
    kv = "int8" if quant else dtype
    sym = f"<{_cxx(dtype)}, {_cxx(kv)}, {d}>"
    smem = _ragged_smem(program, kv, d, chunk)
    rows = b * h * s
    if program == "warp":
        nw = min(s, 8)

        def tiles(p):
            x, hh, bb = p
            return _rows(x * nw, min(s, (x + 1) * nw), (bb * h + hh) * s)
        return [Launch(f"ragged_warp_kernel{sym}", (_cdiv(s, nw), h, b),
                       nw * 32, smem, (Output("out", tiles, rows),))]
    if program == "mma":
        gx = _cdiv(s, 64)

        def tiles(p):  # the heaviest query tile first
            x, hh, bb = p
            t0 = (gx - 1 - x) * 64
            return _rows(t0, min(t0 + 64, s), (bb * h + hh) * s)
        return [Launch(f"ragged_mma_kernel<{_cxx(kv)}, {d}>", (gx, h, b),
                       128, smem, (Output("out", tiles, rows),))]
    if splits == 1:
        def tiles(p):
            _, hh, bb = p
            return _rows(0, s, (bb * h + hh) * s)
        return [Launch(f"ragged_split_kernel{sym}", (1, h, b), 128, smem,
                       (Output("out", tiles, rows),))]

    def parts(p):  # partial [b, h, s, splits] slots of split x
        x, hh, bb = p
        return (((bb * h + hh) * s + t) * splits + x for t in range(s))
    return [Launch(f"ragged_split_kernel{sym}", (splits, h, b), 128, smem,
                   (Output("partials", parts, rows * splits),)),
            Launch(f"ragged_merge_kernel<{_cxx(dtype)}>", (rows, 1, 1), 128,
                   0, (Output("out", lambda p: (p[0],), rows),))]


def _ragged_bound(b, h, s, d, ctx, page_size=16, pps=64, dtype="bf16",
                  quant=False, **_) -> tuple:
    """``chip_smoke.py``'s ``bound``: the visible K/V prefix of every row
    at the pool's element size (int8: plus each page's two scales), q
    read and out written, the table and contexts, against the score and
    PV products."""
    total = pps * page_size
    kv_item = 1 if quant else _itemsize(dtype)
    positions = [min(c + s, total) for c in ctx]
    visible = sum(min(c + t + 1, total) for c in ctx for t in range(s))
    nbytes = (2 * sum(positions) * h * d * kv_item
              + 2 * b * h * s * d * _itemsize(dtype) + b * pps * 4 + b * 4)
    if quant:
        nbytes += 2 * sum(_cdiv(p, page_size) for p in positions) * h * 4
    return nbytes, 4 * h * d * visible, dtype


# ----------------------------------------------------------- flash attention
def _tile_elems(d: int) -> int:
    return 64 * (d + 4)  # a float32 Tile<float, D>: 64 rows, padded


def _bwd_q_tiles(k_tile, s_q, s_k, causal) -> range:
    """The 64-row query tiles the backward's key block ``k_tile`` walks
    (both dtypes): from the first that sees its keys (causal, ``s_q <=
    s_k``; every tile when some row sees no key, ``s_q > s_k``) to the
    last."""
    off = s_k - s_q
    first = max(0, k_tile * 64 - off) // 64 if causal and off >= 0 else 0
    return range(first, _cdiv(s_q, 64))


def flash_plan(b, h, s_q, s_k, d, dtype="bf16", causal=True, backward=False,
               sm_count=132) -> list:
    """The launches of one flash forward (or backward) call."""
    bh = b * h
    if dtype == "bf16" and not backward:
        nqb = _cdiv(s_q, 128)
        n_pairs = (nqb + 1) // 2
        units = bh * n_pairs
        tile = 64 * d * 2
        alloc = 2 * tile + 2 * tile + 4 * tile * 2 + (2 * 4 + 2) * 8 + 1024

        def tiles(p):  # work unit -> its query blocks n-1-q and q
            u = p[0]
            q, unit_bh = u % n_pairs, u // n_pairs
            qbs = {nqb - 1 - q, q}
            return (unit_bh * nqb + qb for qb in sorted(qbs))
        return [Launch(f"flash_fwd_wgmma_kernel<{d}>",
                       (min(units, sm_count), 1, 1), 384, alloc,
                       (Output("o", tiles, bh * nqb),), work=(units,))]
    if not backward:  # float32: 128 queries a block, heaviest first
        nqb = _cdiv(s_q, 128)
        smem = 6 * _tile_elems(d) * 4  # q (128 rows), two stages of K, V
        return [Launch(f"flash_fwd_tf32_kernel<{d}>", (nqb, h, b), 256, smem,
                       (Output("o", lambda p: (
                           (p[2] * h + p[1]) * nqb + nqb - 1 - p[0],),
                           bh * nqb),))]
    nqt, nkt = _cdiv(s_q, 64), _cdiv(s_k, 64)
    kgrid = (nkt, h, b)

    def ktile(p):
        return ((p[2] * h + p[1]) * nkt + p[0],)

    def qtiles(p):  # the query tiles key block p adds its part of dq into
        return ((p[2] * h + p[1]) * nqt + t
                for t in _bwd_q_tiles(p[0], s_q, s_k, causal))
    if dtype == "bf16":
        padded = bh * nqt * 64
        tile = 64 * d * 2
        alloc = (2 * tile + 2 * 2 * tile + 64 * 64 * 2 + 64 * d * 4
                 + 2 * 2 * 64 * 4 + (2 * 2 + 1) * 8 + 1024)
        n4 = bh * s_q * d // 4
        return [
            Launch(f"flash_bwd_prep_kernel<{d}>", (_cdiv(padded, 8), 1, 1),
                   256, 0, (Output("stats", lambda p: (p[0],),
                                   _cdiv(padded, 8)),)),
            Launch(f"flash_bwd_wgmma_kernel<{d}>", kgrid, 160, alloc,
                   (Output("dk_dv", ktile, bh * nkt),
                    # every key tile adds into the query tiles it sees
                    Output("dq_acc", qtiles, None, accumulates=True))),
            Launch("flash_bwd_dq_round_kernel", (_cdiv(n4, 256), 1, 1), 256,
                   0, (Output("dq", lambda p: (p[0],), _cdiv(n4, 256)),))]
    # float32: delta and dq zeroed, then one fused pass (K, V, two stages
    # of q and do, dS^T 64 x 68, two stages of lse and delta)
    rows = bh * s_q
    smem = (6 * _tile_elems(d) + 64 * 68 + 4 * 64) * 4
    return [
        Launch(f"flash_bwd_prep_fp32_kernel<{d}>", (_cdiv(rows, 8), 1, 1),
               256, 0, (Output("delta", lambda p: (p[0],),
                               _cdiv(rows, 8)),)),
        Launch(f"flash_bwd_tf32_kernel<{d}>", kgrid, 256, smem,
               (Output("dk_dv", ktile, bh * nkt),
                Output("dq", qtiles, None, accumulates=True)))]


def _flash_bound(b, h, s_q, s_k, d, dtype="bf16", causal=True,
                 backward=False, **_) -> tuple:
    """``chip_smoke.py``'s ``flash_bound``: the visible (query, key)
    pairs (causal bottom-right), 4 d operations a pair forward, 10 d
    backward, against q, k, v, o (and do, dq, dk, dv) and the row
    statistics; float32's products at the 3xTF32 rate."""
    item = _itemsize(dtype)
    kind = "tf32x3" if dtype == "fp32" else dtype
    if causal:
        pairs = sum(s_k if i + s_k - s_q < 0 else
                    min(max(i + s_k - s_q + 1, 0), s_k) for i in range(s_q))
    else:
        pairs = s_q * s_k
    pairs *= b * h
    if backward:
        return ((4 * s_q + 4 * s_k) * d * b * h * item + 4 * b * h * s_q,
                10 * d * pairs, kind)
    return ((2 * s_q + 2 * s_k) * d * b * h * item + 4 * b * h * s_q,
            4 * d * pairs, kind)


# ---------------------------------------------- LayerNorm, dropout, Adam, norm
def layernorm_plan(rows, d, dtype="bf16", w_dtype="bf16", dx=False,
                   params=False, sm_count=132, **_) -> list:
    """The forward: the program ``fused_layernorm.forward_plan`` chooses
    (the rows program's persistent blocks of 16 warps, at most one an SM,
    a row to a group of N = ceil(d / 256) warps, for d a multiple of 8 up
    to 2,048; else the strips program, a block each 8 rows, a warp a row),
    writing y. The backward (``dx``; with ``params`` also dgamma and
    dbeta): the program ``fused_layernorm.backward_plan`` chooses (the
    same two layouts, the rows program up to d 1,024), writing dx and a
    partial row a block, then with ``params`` the reduction, 32 columns a
    block (``csrc/fused_layernorm.cu``). Each is held equal to the C
    entry's ``ln_geometry`` on the card."""
    import torch

    from ..kernels import fused_layernorm as fl

    sym = f"{_cxx(dtype)}, {_cxx(w_dtype)}"
    tdt = {"bf16": torch.bfloat16, "fp32": torch.float32}[dtype]
    plan = fl.backward_plan if dx else fl.forward_plan
    (program, arg), grid = plan(rows, d, tdt, True, sm_count)
    stage = "bwd" if dx else "fwd"
    if program == "rows":
        kernel = f"ln_{stage}_rows_kernel<{sym}, {arg}>"
        groups, threads, smem = fl.ROW_WARPS // arg, fl.ROW_WARPS * 32, 0

        def out_rows(p):  # group g of block b: rows b * G + g, every
            return (r for g in range(groups)  # grid * G rows further
                    for r in range(p[0] * groups + g, rows, grid * groups))
    else:
        kernel = (f"ln_{stage}_strips_kernel<{sym}, "
                  f"{'true' if arg else 'false'}>")
        threads, smem = 256, 0

        def out_rows(p):
            return _rows(p[0] * 8, min(rows, p[0] * 8 + 8))
    if not dx:
        return [Launch(kernel, (grid, 1, 1), threads, smem,
                       (Output("y", out_rows, rows),))]
    outs = (Output("dx", out_rows, rows),)
    if not params:
        return [Launch(kernel, (grid, 1, 1), threads, smem, outs)]
    return [Launch(kernel, (grid, 1, 1), threads, smem,  # a partial row
                   outs + (Output("partials", lambda p: (p[0],), grid),)),
            Launch(f"ln_bwd_reduce_kernel<{_cxx(w_dtype)}>",
                   (_cdiv(d, 32), 1, 1), 256, 0,
                   (Output("dgamma_dbeta", lambda p: (p[0],),
                           _cdiv(d, 32)),))]


def _layernorm_bound(rows, d, dtype="bf16", dx=False, params=False,
                     **_) -> tuple:
    item = _itemsize(dtype)
    if dx and params:  # x, dy read, dx written; gamma, mu, rstd read;
        # dgamma, dbeta written (the partials are the kernel's own)
        return 3 * rows * d * item + 3 * d * item + 8 * rows, \
            16 * rows * d, "fp32"
    if dx:  # x, dy read, dx written; gamma, mu, rstd read
        return 3 * rows * d * item + d * item + 8 * rows, 13 * rows * d, \
            "fp32"
    return 2 * rows * d * item + 2 * d * item + 8 * rows, 8 * rows * d, \
        "fp32"


#: instructions a mask element of the dropout forward on its busiest pipe,
#: the INT32 ALU pipe (LOP3, SHF, IADD3, ISETP, SEL, P2R of the hash, its
#: compare and the mask byte; ptxas moves the hash's other additions to
#: the FMA pipe as IMAD.IADD and VIADD): counted in the compiled code on
#: the card by chip_smoke.py phase 2b, which fails where it differs
DROPOUT_INT_OPS = 48.5


def _dropout_grid(n, sm_count):
    groups = _cdiv(n, 8)  # 8 elements a thread a step: a byte of the mask
    return groups, min(_cdiv(groups, 256), sm_count * 8)


def dropout_plan(n, dtype="bf16", sm_count=132, **_) -> list:
    """The forward with its mask's bits: a grid-stride loop of 8 elements
    a thread a step, 256 threads a block, at most 8 blocks an SM
    (``csrc/dropout.cu``)."""
    groups, blocks = _dropout_grid(n, sm_count)
    index = "unsigned int" if n < 2 ** 31 else "unsigned long long"
    tiles = lambda p: _stride_tiles(p[0], blocks, groups)  # noqa: E731
    return [Launch(f"dropout_fwd_kernel<{_cxx(dtype)}, {index}, true>",
                   (blocks, 1, 1), 256, 0,
                   (Output("y", tiles, groups), Output("bits", tiles,
                                                       groups)))]


def dropout_backward_plan(n, dtype="bf16", sm_count=132, **_) -> list:
    """The stored bits applied to the output gradient: the forward's
    grid-stride layout (``csrc/dropout.cu``)."""
    groups, blocks = _dropout_grid(n, sm_count)
    return [Launch(f"dropout_apply_kernel<{_cxx(dtype)}, false>",
                   (blocks, 1, 1), 256, 0, (Output(
                       "dx", lambda p: _stride_tiles(p[0], blocks, groups),
                       groups),))]


def _dropout_bound(n, dtype="bf16", **_) -> tuple:
    # x read, y and the bits written; the hashes
    return 2 * n * _itemsize(dtype) + _cdiv(n, 8), DROPOUT_INT_OPS * n, \
        "int32"


def _dropout_backward_bound(n, dtype="bf16", **_) -> tuple:
    # dy and the bits read, dx written; a select (and a division) an element
    return 2 * n * _itemsize(dtype) + _cdiv(n, 8), n, "fp32"


def _chunked(sizes, plan, chunk, per_sm, sm_count, name, threads=256):
    """Launches of a multi-tensor grid-stride kernel over the plan's
    tensor ranges: each launch's chunks split over at most ``per_sm``
    blocks an SM, chunk ids global across launches."""
    out, offset = [], 0
    for start, stop in plan:
        chunks = sum(_cdiv(int(n), chunk) for n in sizes[start:stop])
        blocks = min(chunks, sm_count * per_sm)
        out.append(Launch(name, (blocks, 1, 1), threads, 0, (Output(
            "chunks", lambda p, b=blocks, c=chunks, o=offset:
            _stride_tiles(p[0], b, c, o), None),)))
        offset += chunks
    return out, offset


def adam_plan(sizes, g_dtypes=None, sm_count=132, **_) -> list:
    import torch

    from ..kernels import fused_optimizer as fo

    g_dtypes = g_dtypes or [torch.bfloat16] * len(sizes)
    launches, total = _chunked(list(sizes), fo.adam_launch_plan(
        sizes, g_dtypes), fo.ADAM_CHUNK, 4, sm_count,
        "fused_adam_multi_kernel")
    return _cover(launches, total)


def _adam_bound(sizes, **_) -> tuple:
    n = sum(sizes)  # p, m, v, g in; p, m, v, bf16 p out
    return n * (3 * 4 + 2 + 3 * 4 + 2), 10 * n, "fp32"


def norm_plan(sizes, sm_count=132, **_) -> list:
    from ..kernels import global_norm as gn

    launches, total = _chunked(list(sizes), gn.norm_launch_plan(sizes),
                               gn.NORM_CHUNK, 4, sm_count, "sumsq_kernel")
    return _cover(launches, total) + [Launch(
        "finalize_kernel", (1, 1, 1), 1024, 0,
        (Output("out", lambda p: (0,), 1),))]


def _norm_bound(sizes, **_) -> tuple:
    n = sum(sizes)
    return 2 * n, 2 * n, "fp32"


def _cover(launches, total) -> list:
    """Launches whose chunk outputs together cover ``total`` chunks: one
    shared output name, each launch's own ids."""
    return [Launch(lc.kernel, lc.grid, lc.threads, lc.smem, (Output(
        lc.outputs[0].name, lc.outputs[0].tiles, total),)) for lc in launches]


# ------------------------------------------------------------------ registry
def _train_sizes() -> list:
    """The 292 parameter sizes of bench.py's training step (gpt3-350m:
    hidden 1024, 24 layers, vocab 50304, 1024 positions)."""
    h, L, V, S = 1024, 24, 50304, 1024
    block = [h, h, 3 * h * h, 3 * h, h * h, h, h, h, 4 * h * h, 4 * h,
             4 * h * h, h]
    return [V * h, S * h] + block * L + [h, h]


_ODD_SIZES = [1, 3, 4095, 16384, 16385, 1_000_003]
#: the decode batch's contexts over the served range (phase 3: 229-523)
DECODE_CTX = (229, 271, 313, 355, 397, 439, 481, 523)


@dataclass(frozen=True)
class KernelSpec:
    """A certifiable kernel entry: ``plan(**shape)`` its launches,
    ``shapes`` the main-path shapes (the first is the banked one),
    ``odd`` shapes off the main path, ``bound(**shape)`` (bytes,
    operations, their dtype)."""
    name: str
    source: str   # the library (``csrc/<source>.cu``)
    plan: object = field(repr=False)
    shapes: dict = field(repr=False)
    odd: dict = field(repr=False, default_factory=dict)
    bound: object = field(repr=False, default=None)


def _ragged_shapes(quant: bool) -> dict:
    base = dict(h=16, d=128, page_size=16, pps=64, dtype="bf16",
                quant=quant)
    main = {
        "decode": dict(base, b=8, s=1, ctx=DECODE_CTX),
        "prefill": dict(base, b=1, s=512, ctx=(0,)),
        "verify": dict(base, b=8, s=5, ctx=DECODE_CTX),
        "tp2_decode": dict(base, b=8, s=1, h=8, ctx=DECODE_CTX),
        "tp2_prefill": dict(base, b=1, s=512, h=8, ctx=(0,)),
    }
    if not quant:
        main.update({
            "decode_b1": dict(base, b=1, s=1, ctx=(1023,)),
            "prefix_tail": dict(base, b=1, s=64, ctx=(200,)),
            "chunk": dict(base, b=1, s=128, ctx=(256,))})
    odd = {f"{dt}-d{d}-s{s}": dict(base, b=3, s=s, d=d, pps=5, dtype=dt,
                                   ctx=(0, 7, 19))
           for dt in ("fp32", "bf16") for d in (64, 96)
           for s in (1, 7, 13, 17)}
    return main, odd


_FLASH = [("train", 8, 16, 1024, 1024, 64, True),
          ("causal-d128", 2, 16, 512, 512, 128, True),
          ("noncausal", 2, 4, 384, 384, 64, False),
          ("causal-tail", 2, 8, 1000, 1000, 64, True),
          ("rect-tail-d128", 1, 8, 200, 333, 128, True),
          ("splash-offset", 2, 16, 256, 640, 128, True),
          ("splash-route", 1, 16, 4096, 4096, 64, True)]


def _flash_shapes(backward: bool) -> tuple:
    main = {label: dict(b=b, h=h, s_q=sq, s_k=sk, d=d, causal=c,
                        dtype="bf16", backward=backward)
            for label, b, h, sq, sk, d, c in _FLASH}
    odd = {f"fp32-{label}": dict(b=b, h=h, s_q=sq, s_k=sk, d=d, causal=c,
                                 dtype="fp32", backward=backward)
           for label, b, h, sq, sk, d, c in _FLASH[1:5]}
    return main, odd


_LN = [("train", 8192, 1024), ("prefill-1.3b", 4096, 2048),
       ("decode-1.3b", 8, 2048), ("rows-1001-d64", 1001, 64),
       ("elementwise-d99", 37, 99), ("elementwise-d20", 3, 20),
       ("d8192", 5, 8192), ("bert", 8192, 768),
       ("transformer-base", 8192, 512), ("rows-1001-d2048", 1001, 2048),
       ("rows-1001-d1032", 1001, 1032)]


def _ln_shapes(dx: bool, params: bool = False) -> tuple:
    flags = dict(dx=dx, params=params)
    main = {label: dict(rows=r, d=d, **flags) for label, r, d in _LN[:3]}
    odd = {label: dict(rows=r, d=d, dtype=dt, w_dtype=dt, **flags)
           for label, r, d in _LN[3:] for dt in ("bf16",)}
    odd.update({f"fp32-{label}": dict(rows=r, d=d, dtype="fp32",
                                      w_dtype="fp32", **flags)
                for label, r, d in _LN})
    if params:  # gamma's dtype apart from x's, as the kernels take it
        odd.update({f"{dt}-{wdt}-{label}": dict(rows=r, d=d, dtype=dt,
                                                 w_dtype=wdt, **flags)
                    for label, r, d in _LN[:1] + _LN[3:5]
                    for dt, wdt in (("bf16", "fp32"), ("fp32", "bf16"))})
    return main, odd


_DROPOUT_SHAPES = ({"hidden": dict(n=8 * 1024 * 1024),
                    "attention": dict(n=8 * 16 * 1024 * 64)},
                   {"one": dict(n=1), "odd": dict(n=1_000_003),
                    "fp32": dict(n=1_000_003, dtype="fp32"),
                    "fp64": dict(n=1_000_003, dtype="fp64")})

REGISTRY: dict[str, KernelSpec] = {s.name: s for s in (
    KernelSpec("ragged_paged_attention", "ragged_paged_attention",
               ragged_plan, *_ragged_shapes(False), bound=_ragged_bound),
    KernelSpec("ragged_paged_attention_int8", "ragged_paged_attention",
               ragged_plan, *_ragged_shapes(True), bound=_ragged_bound),
    KernelSpec("flash_attention_forward", "flash_attention", flash_plan,
               *_flash_shapes(False), bound=_flash_bound),
    KernelSpec("flash_attention_backward", "flash_attention", flash_plan,
               *_flash_shapes(True), bound=_flash_bound),
    KernelSpec("fused_adam", "fused_adam", adam_plan,
               {"train": dict(sizes=_train_sizes())},
               {"odd": dict(sizes=_ODD_SIZES)}, bound=_adam_bound),
    KernelSpec("layernorm_forward", "fused_layernorm", layernorm_plan,
               *_ln_shapes(False), bound=_layernorm_bound),
    KernelSpec("layernorm_dx", "fused_layernorm", layernorm_plan,
               *_ln_shapes(True), bound=_layernorm_bound),
    KernelSpec("layernorm_backward", "fused_layernorm", layernorm_plan,
               *_ln_shapes(True, True), bound=_layernorm_bound),
    KernelSpec("dropout", "dropout", dropout_plan, *_DROPOUT_SHAPES,
               bound=_dropout_bound),
    KernelSpec("dropout_backward", "dropout", dropout_backward_plan,
               *_DROPOUT_SHAPES, bound=_dropout_backward_bound),
    KernelSpec("global_norm", "global_norm", norm_plan,
               {"train": dict(sizes=_train_sizes())},
               {"odd": dict(sizes=_ODD_SIZES)}, bound=_norm_bound),
)}


# ----------------------------------------------------------------- certify
def _plan_args(shape: dict) -> dict:
    return {k: v for k, v in shape.items() if k != "ctx"}


def _shape_text(shape: dict) -> str:
    return " ".join(f"{k}={v}" for k, v in shape.items()
                    if k not in ("sizes", "ctx"))


def _races(launches, max_points: int) -> list[KernelFinding]:
    """The injectivity and coverage proof of every output."""
    found: list[KernelFinding] = []
    covered: dict[str, set] = {}
    claims: dict[str, int] = {}
    for lc in launches:
        space = lc.work or lc.grid
        n = math.prod(space)
        if n > max_points:
            found.append(KernelFinding(
                "race", "error", f"{lc.kernel}: {n} grid points exceed the "
                f"proof's bound of {max_points}"))
            continue
        for out in lc.outputs:
            seen = covered.setdefault(out.name, set())
            if out.n_tiles is not None:
                claims[out.name] = out.n_tiles
            if out.accumulates:
                continue
            points = itertools.product(*(range(g) for g in space))
            tiles = [t for point in points for t in out.tiles(point)]
            fresh = set(tiles)
            if len(fresh) == len(tiles) and seen.isdisjoint(fresh):
                seen |= fresh   # no tile written twice
                continue
            # a tile written twice: the walk in grid order names the first
            for point in itertools.product(*(range(g) for g in space)):
                for t in out.tiles(point):
                    if t in seen:
                        found.append(KernelFinding(
                            "race", "error",
                            f"{lc.kernel}: output {out.name!r} tile {t} is "
                            f"written twice (again by grid point {point}) "
                            f"— a write race"))
                        return found
                    seen.add(t)
    for name, n in claims.items():
        got = covered[name]
        if got != set(range(n)):
            missing = n - len(got & set(range(n)))
            found.append(KernelFinding(
                "coverage", "error",
                f"output {name!r}: {missing} of {n} tiles never written, "
                f"{len(got - set(range(n)))} written out of range"))
    return found


def certify(name: str, shapes: dict, *, budget: KernelBudget | None = None,
            ptxas=None, geometry=None) -> KernelCertReport:
    """Certify entry ``name`` at ``shapes``: the plan's launches within the
    budget (with ``ptxas`` — ``(kernel, registers, static smem, spill
    stores, spill loads)`` rows of the entry's library — the registers,
    the static shared memory and the spills too), every output map
    injective and covering, and with ``geometry`` (the C entry's launches,
    5 ints each) the plan equal to the launch code."""
    spec = REGISTRY[name]
    budget = budget or KernelBudget()
    launches = tuple(spec.plan(**_plan_args(shapes)))
    found: list[KernelFinding] = []
    rows = list(ptxas or ())
    for lc in launches:
        if lc.threads > budget.max_threads:
            found.append(KernelFinding(
                "threads", "error", f"{lc.kernel}: {lc.threads} threads a "
                f"block > {budget.max_threads}"))
        mine = [r for r in rows if _symbol(r[0]) == lc.kernel]
        static = max((r[2] for r in mine), default=0)
        if lc.smem + static > budget.max_smem_bytes:
            found.append(KernelFinding(
                "smem", "error", f"{lc.kernel}: {lc.smem} B dynamic + "
                f"{static} B static shared memory > "
                f"{budget.max_smem_bytes} B a block"))
        regs = max((r[1] for r in mine), default=0)
        if regs * lc.threads > SM_REGISTERS:
            found.append(KernelFinding(
                "registers", "error", f"{lc.kernel}: {regs} registers x "
                f"{lc.threads} threads > the SM's {SM_REGISTERS}"))
    found += spill_budget_findings(rows, budget)
    if geometry is not None:
        want = [lc.geometry() for lc in launches]
        got = [tuple(g) for g in geometry]
        if want != got:
            found.append(KernelFinding(
                "geometry", "error", f"the Python plan {want} differs from "
                f"the C launch {got}"))
    found += _races(launches, budget.max_race_points)
    return KernelCertReport(name, _shape_text(shapes), launches,
                            tuple(found))


def _symbol(demangled: str) -> str:
    """A ptxas row's kernel as the plans name it: ``ragged_split_kernel<
    float, float, 192>`` from ``void (anonymous namespace)::ragged_split_
    kernel<float, float, 192>(float const*, ...)``."""
    name = demangled.replace("(anonymous namespace)::", "")
    return re.sub(r"^void ", "", name).split("(")[0]


def spill_budget_findings(rows, budget: KernelBudget | None = None) -> list:
    """Every ptxas row of a library against the register cap and the
    frozen spill bytes."""
    budget = budget or KernelBudget()
    found = []
    for kernel, regs, static, st, ld in rows:
        sym = _symbol(kernel)
        if regs is not None and regs > budget.max_registers:
            found.append(KernelFinding(
                "registers", "error", f"{sym}: {regs} registers > "
                f"{budget.max_registers}"))
        cap = budget.spill_cap(sym)
        if st > cap or ld > cap:
            found.append(KernelFinding(
                "spill", "error", f"{sym}: spills {st} B stored / {ld} B "
                f"loaded > the frozen {cap} B"))
    return found


# --------------------------------------------------------------- C geometry
def c_geometry(name: str, shapes: dict) -> list:
    """The launches the entry's C code computes at ``shapes`` (its
    ``*_geometry`` query: nothing is launched). Needs the built library
    (the card's toolkit)."""
    from ..kernels import _build

    spec = REGISTRY[name]
    # the certifier loads each certified library for its query
    lib = _build.load(spec.source)  # lint: disable=PT011
    s = _plan_args(shapes)
    out = (ctypes.c_int * (5 * 64))()
    code = {"fp32": 0, "bf16": 1}
    if spec.source == "ragged_paged_attention":
        import torch

        from ..kernels import ragged_paged_attention as rpa
        tdt = {"bf16": torch.bfloat16, "fp32": torch.float32}[s["dtype"]]
        program, splits, chunk = rpa.launch_plan(
            (s["b"], s["h"], s["s"], s["d"]), tdt, s["page_size"], s["pps"],
            s.get("sm_count", 132))
        n = lib.ragged_paged_attention_geometry(
            s["b"], s["h"], s["s"], s["d"], s["page_size"], s["pps"],
            rpa._PROGRAM_CODE[program], splits, chunk, code[s["dtype"]],
            int(s["quant"]), out, 64)
    elif spec.source == "flash_attention":
        n = lib.flash_attention_geometry(
            int(s["backward"]), s["b"], s["h"], s["s_q"], s["s_k"], s["d"],
            int(s["causal"]), code[s["dtype"]], out, 64)
    elif spec.source == "fused_layernorm":
        mode = 2 if s.get("params") else int(s["dx"])
        n = lib.ln_geometry(mode, s["rows"], s["d"],
                            code[s.get("dtype", "bf16")],
                            code[s.get("w_dtype", "bf16")], out, 64)
    elif spec.source == "dropout":
        lib.dropout_geometry.argtypes = [ctypes.c_int, ctypes.c_longlong,
                                         ctypes.c_int, ctypes.c_void_p,
                                         ctypes.c_int]
        n = lib.dropout_geometry(int(name == "dropout_backward"), s["n"],
                                 {**code, "fp64": 2}[s.get("dtype", "bf16")],
                                 out, 64)
    else:
        import torch

        from ..kernels import fused_optimizer as fo
        from ..kernels import global_norm as gn
        sizes = list(s["sizes"])
        if spec.source == "fused_adam":
            plan = fo.adam_launch_plan(sizes, [torch.bfloat16] * len(sizes))
        else:
            plan = gn.norm_launch_plan(sizes)
        nn = (ctypes.c_longlong * len(sizes))(*sizes)
        bounds = (ctypes.c_int * (len(plan) + 1))(
            *[a for a, _ in plan], plan[-1][1])
        if spec.source == "fused_adam":
            n = lib.fused_adam_geometry(len(sizes), nn, bounds, len(plan),
                                        out, 64)
        else:
            n = lib.global_norm_geometry(len(sizes), nn, bounds, len(plan),
                                         gn.norm_chunks(sizes), out, 64)
    if n < 0:
        raise KernelCheckError(f"{name}: the C geometry query failed with "
                               f"CUDA error {-n} at {_shape_text(shapes)}")
    return [tuple(out[5 * i:5 * i + 5]) for i in range(n)]


# ------------------------------------------------------------------ roofline
def bound(name: str, shapes: dict) -> dict:
    """``{"bound_ms", "bound_by", "bytes", "operations"}`` of one call."""
    nbytes, ops, kind = REGISTRY[name].bound(**shapes)
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = ops / PEAK_FLOPS[kind]
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": int(nbytes), "operations": int(ops)}


# ---------------------------------------------------- predicted speed-ups
#: the reference's kernel A/B labels (``serving_kernel_speedup_*{kernel=}``,
#: the names of its bank) -> the port's entry and main-path shape that
#: does the same work: the one place the two vocabularies meet. The
#: library paged decode is closed by the ragged kernel at one query
#: (``decode_b1``); splash is the flash kernel's causal route at 4,096.
AB_LABELS = {
    "ragged_paged": ("ragged_paged_attention", "decode"),
    "ragged_paged_q8": ("ragged_paged_attention_int8", "decode"),
    "ragged_paged_verify": ("ragged_paged_attention", "verify"),
    "ragged_paged_prefill": ("ragged_paged_attention", "prefill"),
    "paged_decode": ("ragged_paged_attention", "decode_b1"),
    "flash_fwd": ("flash_attention_forward", "train"),
    "splash_fwd": ("flash_attention_forward", "splash-route"),
    "fused_adam": ("fused_adam", "train"),
    "fused_layernorm_fwd": ("layernorm_forward", "train"),
    "fused_layernorm_dx": ("layernorm_backward", "train"),
}


def materialized_bytes(fn, args) -> int:
    """The bytes a plain version materializes: every distinct tensor
    argument once, plus every fresh (non-aliasing) output of each ATen
    operation it runs — the reference's composite ``argument + temp +
    output`` bytes. ``fn`` runs on meta tensors, so nothing is allocated
    and no value is read."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class _Tally(TorchDispatchMode):
        nbytes = 0

        def __torch_dispatch__(self, func, types, a=(), kw=None):
            out = func(*a, **(kw or {}))
            outs = out if isinstance(out, (tuple, list)) else (out,)
            for ret, o in zip(func._schema.returns, outs):
                if isinstance(o, torch.Tensor) and ret.alias_info is None:
                    self.nbytes += o.numel() * o.element_size()
            return out

    seen, nbytes = set(), 0
    for a in args:
        if isinstance(a, torch.Tensor) and id(a) not in seen:
            seen.add(id(a))
            nbytes += a.numel() * a.element_size()
    with _Tally() as tally:
        fn(*args)
    return nbytes + tally.nbytes


def _plain_call(name: str, shape: dict):
    """The plain version of entry ``name`` and its meta arguments at
    ``shape``. A ragged pool holds exactly the table's pages (plus the
    null page), so its argument bytes are what the table addresses."""
    import torch

    from ..kernels import fused_layernorm as fl
    from ..kernels import fused_optimizer as fo
    from ..kernels import flash_attention as fa
    from ..kernels import ragged_paged_attention as rpa

    meta = dict(device="meta")
    tdt = {"bf16": torch.bfloat16, "fp32": torch.float32}
    if name.startswith("ragged"):
        b, h, s, d = shape["b"], shape["h"], shape["s"], shape["d"]
        pps, ps = shape["pps"], shape["page_size"]
        q = torch.empty(b, h, s, d, dtype=tdt[shape["dtype"]], **meta)
        kv = torch.int8 if shape["quant"] else q.dtype
        pool = (b * pps + 1, ps, h, d)
        k, v = (torch.empty(pool, dtype=kv, **meta) for _ in range(2))
        table = torch.empty(b, pps, dtype=torch.int32, **meta)
        ctx = torch.empty(b, dtype=torch.int32, **meta)
        if not shape["quant"]:
            return rpa.ragged_paged_attention_reference, (q, k, v, table,
                                                          ctx)
        ks, vs = (torch.empty(pool[0], h, dtype=torch.float32, **meta)
                  for _ in range(2))
        return (lambda *a: rpa.ragged_paged_attention_reference(
            *a[:5], k_scale=a[5], v_scale=a[6]),
            (q, k, v, table, ctx, ks, vs))
    if name == "flash_attention_forward":
        dt = tdt[shape["dtype"]]
        q = torch.empty(shape["b"], shape["h"], shape["s_q"], shape["d"],
                        dtype=dt, **meta)
        k, v = (torch.empty(shape["b"], shape["h"], shape["s_k"],
                            shape["d"], dtype=dt, **meta) for _ in range(2))
        return (lambda q, k, v: fa.flash_attention_reference(
            q, k, v, causal=shape["causal"]), (q, k, v))
    if name.startswith("layernorm"):
        rows, d = shape["rows"], shape["d"]
        dt, wdt = (tdt[shape.get(k, "bf16")] for k in ("dtype", "w_dtype"))
        x = torch.empty(rows, d, dtype=dt, **meta)
        g, bta = (torch.empty(d, dtype=wdt, **meta) for _ in range(2))
        if not shape["dx"]:
            return (lambda x, g, bta: fl.fused_layer_norm_reference(
                x, g, bta, 1e-5), (x, g, bta))
        mu, rstd = (torch.empty(rows, 1, dtype=torch.float32, **meta)
                    for _ in range(2))
        dy = torch.empty(rows, d, dtype=dt, **meta)
        return fl.layer_norm_backward_reference, (x, g, mu, rstd, dy)
    if name == "fused_adam":
        # the training step: float32 masters and moments, bf16 gradients
        # and parameters written back
        groups = [tuple(torch.empty(n, dtype=t, **meta) for t in (
            torch.float32, torch.bfloat16, torch.float32, torch.float32,
            torch.bfloat16)) for n in shape["sizes"]]

        def adam(*flat):
            for i in range(0, len(flat), 5):
                p, g, m, v, p_out = flat[i:i + 5]
                fo.fused_adam_update_reference(
                    p, g, m, v, 1e-4, 0.1, 0.001, beta1=0.9, beta2=0.999,
                    eps=1e-8, p_out=p_out)
        return adam, tuple(t for grp in groups for t in grp)
    raise KeyError(f"{name}: no plain version to count")


def predicted_speedup(name: str, shape: dict) -> float:
    """The reference's analytic ``predicted_speedup`` for the port: the
    bytes the plain version materializes at ``shape`` over the bytes the
    kernel must move there (its roofline's), rounded to 3 places."""
    from ..kernels import fused_layernorm as fl
    from ..kernels import fused_optimizer as fo
    from ..kernels import flash_attention as fa
    from ..kernels import ragged_paged_attention as rpa

    mods = (rpa, fa, fl, fo)
    calls = [m.reference_calls for m in mods]
    try:  # a count, not a run: the plain versions' counters stay put
        fn, args = _plain_call(name, shape)
        comp = materialized_bytes(fn, args)
    finally:
        for m, c in zip(mods, calls):
            m.reference_calls = c
    return round(comp / bound(name, shape)["bytes"], 3)


def banked_predictions(name: str) -> dict:
    """``{reference label: predicted_speedup}`` for the labels of
    :data:`AB_LABELS` that entry ``name`` serves."""
    spec = REGISTRY[name]
    return {label: predicted_speedup(name, spec.shapes[shape])
            for label, (entry, shape) in sorted(AB_LABELS.items())
            if entry == name}


def run_kernel(name: str, ptxas=None, card: bool = False) -> tuple:
    """Certify one entry at every main-path and odd shape (with ``card``:
    against the C geometry too); returns ``(reports, record)`` where the
    record is the bankable contract of its first main-path shape."""
    spec = REGISTRY[name]
    reports = []
    for label, shapes in {**spec.shapes, **spec.odd}.items():
        geometry = c_geometry(name, shapes) if card else None
        reports.append(certify(name, shapes, ptxas=ptxas,
                               geometry=geometry))
    label, shapes = next(iter(spec.shapes.items()))
    launches = spec.plan(**_plan_args(shapes))
    b = bound(name, shapes)
    record = {"shape": label,
              "launches": [list(lc.geometry()) for lc in launches],
              "bound_ms": round(b["bound_ms"], 9), "bound_by": b["bound_by"],
              "bytes": b["bytes"], "operations": b["operations"]}
    predicted = banked_predictions(name)
    if predicted:
        record["predicted_speedup"] = predicted
    return reports, record


# --------------------------------------------------------------------- bank
#: analytic record fields frozen by the bank: drift is a violation
ANALYTIC_KEYS = ("shape", "launches", "bound_ms", "bound_by", "bytes",
                 "operations", "predicted_speedup")


def bank_path() -> str:
    """``paddle_tpu_torch/analysis/kernelcheck_bank.json``."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "kernelcheck_bank.json")


def diff_banked(records: dict, banked: dict) -> list[KernelFinding]:
    """Each analytic field that moved from the bank is an error naming
    both values; a missing entry asks for ``--bank``."""
    found = []
    for name, rec in sorted(records.items()):
        old = banked.get(name)
        if old is None:
            found.append(KernelFinding(
                "drift", "error", f"{name}: no banked entry — run `python -m "
                f"paddle_tpu_torch.analysis kernelcheck --bank`"))
            continue
        for key in ANALYTIC_KEYS:
            if old.get(key) != rec.get(key):
                found.append(KernelFinding(
                    "drift", "error", f"{name}: {key!r} drifted from the "
                    f"banked {old.get(key)!r} to {rec.get(key)!r}"))
    return found


# ----------------------------------------------------------------- coverage
def coverage_report() -> dict:
    """Which serving and training options reach which kernel (and which
    ragged program), from the predicates the dispatch itself calls. On a
    CUDA tensor every listed path launches its kernel; ``plain_on_card``
    lists any that would take a plain version there (empty: none does —
    a shape a kernel cannot take raises instead). On a CPU tensor every
    path takes its plain version."""
    import torch

    from ..kernels import flash_attention as fa
    from ..kernels import ragged_paged_attention as rpa

    rows = []
    for kv in ("float32", "int8"):
        for dt, dname in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
            for mode, s in (("decode", 1), ("verify[K+1=5]", 5),
                            ("prefill[8]", 8), ("prefill[16]", 16),
                            ("chunk[128]", 128), ("prefill[512]", 512)):
                program = rpa.choose_program(s, 128, dt)
                rows.append({
                    "family": "ragged_paged_attention"
                              + ("_int8" if kv == "int8" else ""),
                    "config": f"ServingConfig(kv_dtype={kv!r}) {dname} "
                              f"{mode} head_dim 128",
                    "kernel": "ragged_paged_attention", "program": program,
                    "path": "kernel"})
    for dname in ("bf16", "fp32"):
        for d in fa.HEAD_DIMS:
            for which in ("forward", "backward"):
                rows.append({
                    "family": f"flash_attention_{which}",
                    "config": f"train step {dname} head_dim {d} causal",
                    "kernel": f"flash_attention_{which}", "program": None,
                    "path": "kernel"})
    for family, config in (
            ("layernorm_forward", "every GPT LayerNorm (serving, training)"),
            ("layernorm_dx", "a backward that needs dx alone"),
            ("layernorm_backward", "training backward (dx, dgamma, dbeta)"),
            ("fused_adam", "AdamW step"),
            ("dropout", "training with dropout > 0 (forward, its bits)"),
            ("dropout_backward", "training with dropout > 0 (backward)"),
            ("global_norm", "grad_clip=ClipGradByGlobalNorm")):
        rows.append({"family": family, "config": config, "kernel": family,
                     "program": None, "path": "kernel"})
    plain = [f"{r['family']}: {r['config']}" for r in rows
             if r["path"] != "kernel"]
    return {"rows": rows, "plain_on_card": plain}


# ---------------------------------------------------------------------- CLI
def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.analysis kernelcheck",
        description="Certify the port's CUDA kernels: launch plans within "
                    "their budgets, output maps injective and covering, "
                    "the roofline bank.")
    parser.add_argument("--kernel", action="append", default=None,
                        metavar="NAME")
    parser.add_argument("--list", action="store_true")
    parser.add_argument("--bank", action="store_true",
                        help="(re)write the bank from this run")
    parser.add_argument("--coverage", action="store_true",
                        help="print the dispatch coverage report")
    args = parser.parse_args(argv)
    if args.list:
        for s in REGISTRY.values():
            print(f"{s.name}  ({s.source}.cu; {len(s.shapes)} main-path, "
                  f"{len(s.odd)} odd shapes)")
        return 0
    names = args.kernel or list(REGISTRY)
    unknown = [n for n in names if n not in REGISTRY]
    if unknown:
        print(f"unknown kernel(s): {', '.join(unknown)}")
        return 2
    failed = 0
    records = {}
    for name in names:
        reports, records[name] = run_kernel(name)
        bad = [r for r in reports if not r.ok]
        for r in bad:
            print(f"FAIL {r.summary()}: "
                  + "; ".join(str(f) for f in r.errors))
        failed += len(bad)
        rec = records[name]
        print(f"kernelcheck {name}: {len(reports)} shape(s) certified"
              f"{'' if not bad else f', {len(bad)} failed'}; bound "
              f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}) at "
              f"{rec['shape']}")
    if args.coverage:
        rep = coverage_report()
        for r in rep["rows"]:
            prog = f" ({r['program']})" if r["program"] else ""
            print(f"  {r['family']}: {r['config']} -> {r['kernel']}{prog}")
        print(f"plain versions on the card: {rep['plain_on_card'] or 'none'}")
    path = bank_path()
    if args.bank:
        if failed:
            print("not banking: violations above")
        else:
            merged = dict(records)
            if os.path.exists(path):
                with open(path) as fh:
                    merged = {**json.load(fh), **records}
            with open(path, "w") as fh:
                json.dump(dict(sorted(merged.items())), fh, indent=1,
                          sort_keys=True)
                fh.write("\n")
            print(f"banked {len(records)} entry(s) -> {path}")
    else:
        banked = {}
        if os.path.exists(path):
            with open(path) as fh:
                banked = json.load(fh)
        for f in diff_banked(records, banked):
            print(f"FAIL {f}")
            failed += 1
    print(f"{failed} violation(s)" if failed
          else f"kernelcheck clean: {len(names)} kernel(s) certified")
    return 1 if failed else 0
