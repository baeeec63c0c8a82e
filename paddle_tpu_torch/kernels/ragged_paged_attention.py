"""Ragged paged attention — the port of
``paddle_tpu/kernels/ragged_paged_attention.py`` (``_ragged_kernel``,
float pools and int8 pools).

One call serves every serving attention mode: ``s`` new-token queries per
row entering at positions ``ctx_lens[b] .. ctx_lens[b] + s - 1`` against
that row's paged KV prefix — decode (s = 1), prefill (s = pad bucket,
queries at the prefix-cache hit width) and the K+1 verify shape. With
``k_scale``/``v_scale`` the pools are int8 codes under per-page-per-head
float32 scales (``serving/kv_cache.py`` ``kv_dtype="int8"``),
dequantised inside the kernel's page gather as ``paged_gather_quant``
does: ``code * (scale / 127)``, rounded to q's dtype.

Three things live here, as for every kernel of the port:

- ``ragged_paged_attention``: the wrapper. A CUDA tensor launches the
  hand-written Hopper kernel (``csrc/ragged_paged_attention.cu``, built
  by :mod:`._build` at first use) on the current stream; a CPU tensor
  takes the plain version. Anything the kernel does not take raises.
- ``ragged_paged_attention_reference``: the plain PyTorch version
  (``paged_gather`` or ``paged_gather_quant`` + ``ragged_mask`` +
  ``sdpa_reference``). The CPU path and the tests use it; nothing on the
  CUDA serving path calls it.
- ``launches`` / ``int8_launches`` / ``reference_calls``: plain integer
  counters — the first grows by one where the kernel is launched over
  float pools, the second where it is launched over int8 pools, and
  nowhere else; the third at every call of the plain version — so a run
  can show which one served. ``split_launches`` / ``mma_launches`` /
  ``warp_launches`` count the same launches by program.

The kernel has three programs, chosen by :func:`choose_program` from the
shapes and dtypes alone (never from ``ctx_lens``, which stays on the
card):

- ``split`` (``s <= SPLIT_MAX_QUERIES``: decode and verify, any dtype):
  split-KV. :func:`split_plan` cuts the table width into chunks so that
  ``b * h * splits`` blocks fill the card; each writes float32 partials
  and a second kernel merges them by log-sum-exp.
- ``mma`` (bf16 q, ``s >= MMA_MIN_QUERIES``, head_dim at most
  ``MMA_MAX_HEAD_DIM``: prefill and prefix tail): the score and PV
  products on the tensor cores.
- ``warp``: everything else (float32 q past ``SPLIT_MAX_QUERIES``
  queries, bf16 between the two thresholds or at a wider head): the
  CUDA-core program, a warp per query.

Replaces ``paddle_tpu/kernels/ragged_paged_attention.py:275``
(``_ragged_kernel``, ``pallas_call`` at ``:508``). On the H100 it is
bound by device-memory bytes at decode (each row's KV prefix is read once
for 4*d operations per position) and by the score and PV products' latency
at a prefill. See the source's header for the design.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .attention import default_scale, sdpa_reference
from .paged_attention import paged_gather, paged_gather_quant, ragged_mask

__all__ = ["ragged_paged_attention", "ragged_paged_attention_reference",
           "choose_program", "split_plan", "launch_plan", "SOURCE",
           "REPLACES"]

# Read and reset the counters through the module
# (``ragged_paged_attention.launches``): a name imported from here is a
# copy of the value at import time.
#: kernel launches over float pools (the serving path's proof of use)
launches = 0
#: kernel launches over int8 pools
int8_launches = 0
#: calls of the plain version, on any device
reference_calls = 0
#: launches by program (float and int8 pools together)
split_launches = 0
mma_launches = 0
warp_launches = 0

#: the analysis.kernelcheck entries that certify this module's kernel
KERNELCHECK_CERTS = ("ragged_paged_attention", "ragged_paged_attention_int8")
SOURCE = "paddle_tpu_torch/kernels/csrc/ragged_paged_attention.cu"
REPLACES = "paddle_tpu/kernels/ragged_paged_attention.py:275"

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_PROGRAM_CODE = {"warp": 0, "split": 1, "mma": 2}
_fn = None  # the loaded C entry point, with its argtypes declared
_sm_counts: dict = {}  # device index -> streaming multiprocessors

#: the split program serves calls of at most this many queries per row
SPLIT_MAX_QUERIES = 8
#: a split's chunk is a multiple of this many positions (and of the
#: kernel's stage tile)
SPLIT_QUANTUM = 64
#: split blocks wanted per SM: enough 4-warp blocks with a tile in flight
#: to keep the memory system busy when part of the table is past ctx (16
#: gave the lowest batch-8 and batch-1 decode times on the H100, PERF.md)
SPLIT_BLOCKS_PER_SM = 16
#: the most splits a call takes (the merge keeps every split's weight)
SPLIT_MAX_SPLITS = 256
#: bf16 calls of at least this many queries take the tensor cores (from
#: 16 queries on the tensor-core program is at least as fast as the
#: CUDA-core one on the H100, PERF.md)
MMA_MIN_QUERIES = 16
#: the tensor-core program's widest head (its float32 accumulator rows
#: and the score tile share a thread's registers)
MMA_MAX_HEAD_DIM = 128


def choose_program(s: int, d: int, dtype: torch.dtype) -> str:
    """The kernel program for ``s`` queries per row of head_dim ``d``
    with q in ``dtype``: ``"split"``, ``"mma"`` or ``"warp"``."""
    if s <= SPLIT_MAX_QUERIES:
        return "split"
    if dtype == torch.bfloat16 and s >= MMA_MIN_QUERIES \
            and d <= MMA_MAX_HEAD_DIM:
        return "mma"
    return "warp"


def split_plan(b: int, h: int, width: int, sm_count: int) -> tuple:
    """``(splits, chunk)`` for the split program: the table width of
    ``width`` positions cut into ``splits`` chunks of ``chunk`` positions
    (a multiple of ``SPLIT_QUANTUM``), as many as it takes for
    ``b * h * splits`` blocks to reach ``SPLIT_BLOCKS_PER_SM`` per SM, no
    more than one chunk per quantum and at most ``SPLIT_MAX_SPLITS``.
    Shapes only: the contexts on the card are never read here."""
    want = math.ceil(SPLIT_BLOCKS_PER_SM * sm_count / (b * h))
    splits = max(1, min(want, math.ceil(width / SPLIT_QUANTUM),
                        SPLIT_MAX_SPLITS))
    chunk = math.ceil(math.ceil(width / splits) / SPLIT_QUANTUM) \
        * SPLIT_QUANTUM
    return math.ceil(width / chunk), chunk


def launch_plan(q_shape, dtype, page_size: int, pages_per_seq: int,
                sm_count: int) -> tuple:
    """``(program, splits, chunk)`` for a call with q of ``q_shape``
    (``[b, h, s, d]``) and ``dtype`` over a table of ``pages_per_seq``
    pages of ``page_size``: from the shapes alone (``chunk`` is 0 off the
    split program)."""
    b, h, s, d = q_shape
    program = choose_program(s, d, dtype)
    if program != "split":
        return program, 1, 0
    return (program, *split_plan(b, h, pages_per_seq * page_size, sm_count))


def _sm_count(device) -> int:
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    if index not in _sm_counts:
        _sm_counts[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _sm_counts[index]


def ragged_paged_attention_reference(q, k_pool, v_pool, page_table, ctx_lens,
                                     *, scale=None, k_scale=None,
                                     v_scale=None):
    """The plain version: gather every page of each row (dequantised to
    ``q.dtype`` for int8 pools), mask ``j <= ctx_lens[b] + t`` to
    ``-1e30``, float32 softmax, probabilities cast to ``q.dtype`` before
    PV."""
    global reference_calls
    reference_calls += 1
    if k_scale is not None:
        k_all = paged_gather_quant(k_pool, k_scale, page_table, q.dtype)
        v_all = paged_gather_quant(v_pool, v_scale, page_table, q.dtype)
    else:
        k_all = paged_gather(k_pool, page_table)
        v_all = paged_gather(v_pool, page_table)
    mask = ragged_mask(ctx_lens, k_all.shape[2], q.shape[2])
    return sdpa_reference(q, k_all, v_all, mask=mask, scale=scale)


def _check(q, k_pool, v_pool, page_table, ctx_lens, k_scale,
           v_scale) -> None:
    """The contract both paths share: shapes, dtypes, one device."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale come together (int8 pools) "
                         "or not at all")
    if q.dim() != 4 or k_pool.dim() != 4:
        raise ValueError(f"q must be [b, h, s, d] and the pools "
                         f"[num_pages, page_size, h, d]; got q "
                         f"{tuple(q.shape)}, pool {tuple(k_pool.shape)}")
    b, h, s, d = q.shape
    if v_pool.shape != k_pool.shape or k_pool.shape[2:] != (h, d):
        raise ValueError(f"pools {tuple(k_pool.shape)} / "
                         f"{tuple(v_pool.shape)} do not match q heads {h}, "
                         f"head_dim {d}")
    if page_table.dim() != 2 or page_table.shape[0] != b \
            or tuple(ctx_lens.shape) != (b,):
        raise ValueError(f"page_table must be [{b}, pages_per_seq] and "
                         f"ctx_lens [{b}]; got {tuple(page_table.shape)}, "
                         f"{tuple(ctx_lens.shape)}")
    pool_dtype = q.dtype if k_scale is None else torch.int8
    if q.dtype not in _DTYPE_CODE or k_pool.dtype != pool_dtype \
            or v_pool.dtype != pool_dtype:
        raise TypeError(f"q must be float32 or bfloat16 and the pools "
                        f"{pool_dtype}; got q {q.dtype}, pools {k_pool.dtype}"
                        f"/{v_pool.dtype}")
    scales = () if k_scale is None else (k_scale, v_scale)
    for sc in scales:
        if tuple(sc.shape) != (k_pool.shape[0], h) \
                or sc.dtype != torch.float32:
            raise ValueError(f"k_scale and v_scale must be float32 "
                             f"[{k_pool.shape[0]}, {h}]; got {sc.dtype} "
                             f"{tuple(sc.shape)}")
    if page_table.dtype != torch.int32 or ctx_lens.dtype != torch.int32:
        raise TypeError(f"page_table and ctx_lens must be int32; got "
                        f"{page_table.dtype}, {ctx_lens.dtype}")
    devices = {t.device for t in (q, k_pool, v_pool, page_table, ctx_lens,
                                  *scales)}
    if len(devices) != 1:
        raise ValueError(f"all operands must be on one device; got {devices}")


def _check_kernel(q, k_pool, v_pool, page_table, ctx_lens, k_scale,
                  v_scale) -> None:
    """What the CUDA kernel additionally needs."""
    d = q.shape[-1]
    if d % 32 or not 32 <= d <= 256:
        raise ValueError(f"the kernel takes head_dim a multiple of 32 up to "
                         f"256; got {d}")
    named = [("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
             ("page_table", page_table), ("ctx_lens", ctx_lens)]
    if k_scale is not None:
        named += [("k_scale", k_scale), ("v_scale", v_scale)]
    for name, t in named:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernel "
                             f"stages pages with 16-byte loads)")


def _entry_point():
    global _fn
    if _fn is None:
        from ._build import load

        fn = load("ragged_paged_attention").ragged_paged_attention
        ptr = ctypes.c_void_p
        fn.argtypes = [ptr] * 10 + [ctypes.c_int] * 9 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ptr]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def ragged_paged_attention(q, k_pool, v_pool, page_table, ctx_lens, *,
                           scale=None, k_scale=None, v_scale=None):
    """Attention of ``q [b, h, s, d]`` against each row's paged prefix:
    query ``t`` of row ``b`` sees pool positions ``j <= ctx_lens[b] + t``
    through ``page_table [b, pages_per_seq]`` (int32), up to the table
    width. Pools ``[num_pages, page_size, h, d]`` share q's dtype (float32
    or bfloat16), or with ``k_scale``/``v_scale`` (float32 ``[num_pages,
    h]``, both or neither) are int8 codes. Returns ``[b, h, s, d]`` in q's
    dtype.

    CUDA tensors launch the Hopper kernel (the program
    :func:`choose_program` names) and raise on anything it cannot take;
    CPU tensors take the plain version."""
    _check(q, k_pool, v_pool, page_table, ctx_lens, k_scale, v_scale)
    if q.device.type == "cpu":
        return ragged_paged_attention_reference(
            q, k_pool, v_pool, page_table, ctx_lens, scale=scale,
            k_scale=k_scale, v_scale=v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"no ragged paged attention for device {q.device}")
    _check_kernel(q, k_pool, v_pool, page_table, ctx_lens, k_scale, v_scale)
    program, splits, chunk = launch_plan(
        q.shape, q.dtype, k_pool.shape[1], page_table.shape[1],
        _sm_count(q.device))
    return _launch(program, splits, chunk, q, k_pool, v_pool, page_table,
                   ctx_lens, scale, k_scale, v_scale)


def _launch(program, splits, chunk, q, k_pool, v_pool, page_table,
            ctx_lens, scale, k_scale, v_scale):
    """One launch of ``program`` on checked CUDA operands; counts it."""
    global launches, int8_launches, split_launches, mma_launches, \
        warp_launches
    b, h, s, d = q.shape
    if scale is None:
        scale = default_scale(d)
    page_size, pps = k_pool.shape[1], page_table.shape[1]
    part_o = part_ml = None
    if program == "split" and splits > 1:
        # one buffer: [b, h, s, splits, d] accumulators, then (m, l) pairs
        n = b * h * s * splits
        part = torch.empty(n * (d + 2), dtype=torch.float32, device=q.device)
        part_o = part.data_ptr()
        part_ml = part_o + n * d * part.element_size()
    fn = _entry_point()
    out = torch.empty_like(q)
    quant = k_scale is not None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 k_scale.data_ptr() if quant else None,
                 v_scale.data_ptr() if quant else None,
                 page_table.data_ptr(), ctx_lens.data_ptr(), out.data_ptr(),
                 part_o, part_ml,
                 b, h, s, d, page_size, pps, _PROGRAM_CODE[program], splits,
                 chunk, float(scale), _DTYPE_CODE[q.dtype], int(quant),
                 stream)
    if err:
        raise RuntimeError(f"ragged_paged_attention kernel ({program} "
                           f"program) launch failed with CUDA error {err} "
                           f"(q {tuple(q.shape)}, pool "
                           f"{tuple(k_pool.shape)} {k_pool.dtype}, "
                           f"{q.dtype})")
    if quant:
        int8_launches += 1
    else:
        launches += 1
    if program == "split":
        split_launches += 1
    elif program == "mma":
        mma_launches += 1
    else:
        warp_launches += 1
    return out
