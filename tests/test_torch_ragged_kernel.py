"""The port's ragged paged-attention kernel and its plain version, over
float pools and over int8 pools (codes under per-page scales, written by
``paged_write_quant``).

This file imports no JAX, so it runs on the card too:
``python -m pytest --noconftest tests/test_torch_ragged_kernel.py -q``
(``--noconftest`` skips the suite's JAX-only conftest). Here on the CPU
the plain version is held against a per-query numpy loop, and the CUDA
cases skip with the reason; on the card they hold the Hopper kernel
against the plain version at the serving path's shapes.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import paged_attention as pa
from paddle_tpu_torch.kernels import ragged_paged_attention as rpa


def pool_case(seed, b=3, h=4, d=16, page_size=4, pps=6, s=1, ctx=None):
    """Random pools, a random page table whose last row is an inactive
    slot (all null page, ctx 0), ctx lens and q — numpy, from ``seed``."""
    rng = np.random.default_rng(seed)
    num_pages = 1 + b * pps
    k_pool = rng.standard_normal((num_pages, page_size, h, d), np.float32)
    v_pool = rng.standard_normal((num_pages, page_size, h, d), np.float32)
    table = np.zeros((b, pps), np.int32)
    perm = rng.permutation(np.arange(1, num_pages)).astype(np.int32)
    for r in range(b - 1):
        table[r] = perm[r * pps:(r + 1) * pps]
    if ctx is None:
        ctx = rng.integers(0, pps * page_size - s + 1, size=b)
    ctx = np.broadcast_to(np.asarray(ctx, np.int32), (b,)).copy()
    ctx[-1] = 0
    q = rng.standard_normal((b, h, s, d), np.float32)
    return q, k_pool, v_pool, table, ctx


def _loop_oracle(q, k_pool, v_pool, table, ctx):
    """Query by query in float64: softmax over the visible positions."""
    b, h, s, d = q.shape
    ps = k_pool.shape[1]
    total = table.shape[1] * ps
    out = np.zeros_like(q, dtype=np.float64)
    for r in range(b):
        pages = table[r]
        for t in range(s):
            n = min(ctx[r] + t + 1, total)
            j = np.arange(n)
            k = k_pool[pages[j // ps], j % ps].astype(np.float64)  # [n, h, d]
            v = v_pool[pages[j // ps], j % ps].astype(np.float64)
            for hh in range(h):
                logits = k[:, hh] @ q[r, hh, t] / np.sqrt(d)
                p = np.exp(logits - logits.max())
                out[r, hh, t] = (p / p.sum()) @ v[:, hh]
    return out


@pytest.mark.parametrize("s,ctx", [(1, None), (4, None), (6, 0), (3, 9)],
                         ids=["decode", "verify", "prefill", "prefix_tail"])
def test_plain_version_matches_loop(s, ctx):
    arrays = pool_case(40 + s, s=s, ctx=ctx)
    got = rpa.ragged_paged_attention_reference(
        *(torch.from_numpy(a) for a in arrays))
    # float32 logits and softmax against a float64 loop
    np.testing.assert_allclose(got.numpy(), _loop_oracle(*arrays),
                               atol=1e-5, rtol=0)


def int8_case(seed, device="cpu", b=3, h=4, d=32, page_size=4, pps=6, s=1,
              ctx=None):
    """``pool_case``'s layout with int8 pools: every position of every
    row's table written through ``paged_write_quant`` from standard normal
    K/V, then a third of them written again at 3x the magnitude, so those
    pages' scales grow and their resident codes are rescaled. Returns
    ``(q, k_pool, v_pool, table, ctx, k_scale, v_scale)`` as tensors on
    ``device``; q float32."""
    q, k_f, _, table, ctx = pool_case(seed, b, h, d, page_size, pps, s, ctx)
    num_pages = k_f.shape[0]
    codes = [torch.zeros((num_pages, page_size, h, d), dtype=torch.int8,
                         device=device) for _ in range(2)]
    scales = [torch.zeros((num_pages, h), device=device) for _ in range(2)]
    total = pps * page_size
    pos = np.arange(total)
    pid = torch.from_numpy(table[:, pos // page_size]).to(device)
    off = torch.from_numpy(np.broadcast_to(pos % page_size,
                                           (b, total)).copy()).to(device)
    rng = np.random.default_rng(seed + 1)
    for mag, n in ((1.0, total), (3.0, total // 3)):
        k_new, v_new = (torch.from_numpy(
            mag * rng.standard_normal((b, n, h, d), np.float32)).to(device)
            for _ in range(2))
        pa.paged_write_quant(*codes, *scales, k_new, v_new, pid[:, :n],
                             off[:, :n])
    dev = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return (dev(q), *codes, dev(table), dev(ctx), *scales)


@pytest.mark.parametrize("s,ctx", [(1, None), (4, None), (6, 0), (3, 9)],
                         ids=["decode", "verify", "prefill", "prefix_tail"])
def test_int8_plain_version_matches_loop(s, ctx):
    q, k_pool, v_pool, table, ctx_lens, k_sc, v_sc = int8_case(60 + s, s=s,
                                                               ctx=ctx)
    got = rpa.ragged_paged_attention(q, k_pool, v_pool, table, ctx_lens,
                                     k_scale=k_sc, v_scale=v_sc)
    # the loop reads the pools dequantised as code * (scale / 127)
    deq = [(p.float() * (sc / 127.0)[:, None, :, None]).numpy()
           for p, sc in ((k_pool, k_sc), (v_pool, v_sc))]
    np.testing.assert_allclose(
        got.numpy(), _loop_oracle(q.numpy(), *deq, table.numpy(),
                                  ctx_lens.numpy()), atol=1e-5, rtol=0)


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernel has no CPU mode "
                    "(chip_smoke.py and this file on the card run it)")


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("head_dim", [64, 128])
@pytest.mark.parametrize("s,ctx", [(1, None), (5, None), (64, 200), (512, 0)],
                         ids=["decode", "verify", "prefix_tail", "prefill"])
def test_kernel_matches_plain_on_cuda(s, ctx, head_dim, dtype, atol):
    _cuda_or_skip()
    arrays = pool_case(3 + s, b=4, h=16, d=head_dim, page_size=16, pps=64,
                       s=s, ctx=ctx)
    q, k_pool, v_pool = (torch.from_numpy(a).to("cuda", dtype)
                         for a in arrays[:3])
    table, ctx_lens = (torch.from_numpy(a).cuda() for a in arrays[3:])
    launches = rpa.launches
    got = rpa.ragged_paged_attention(q, k_pool, v_pool, table, ctx_lens)
    torch.cuda.synchronize()
    assert rpa.launches == launches + 1
    want = rpa.ragged_paged_attention_reference(q, k_pool, v_pool, table,
                                                ctx_lens)
    # fp32: summation order differs (rtol 1e-4); bf16: the plain version
    # rounds probabilities to bf16 before PV, the kernel keeps them fp32
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=1e-4 if dtype == torch.float32 else 0)


# int8 pools, the criteria of chip_smoke.py: q float32, the kernel against
# the plain version (summation order, atol 2e-5 + rtol 1e-4); q bf16, the
# kernel and the plain version each against the plain version with q in
# float32, the kernel's max abs error at most twice the plain one's plus
# 1e-3 (the plain version rounds the probabilities to bf16 before PV)
BF16_ERR_RATIO, BF16_ERR_FLOOR = 2.0, 1e-3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("head_dim", [64, 128])
@pytest.mark.parametrize("s,ctx", [(1, None), (5, None), (64, 200), (512, 0)],
                         ids=["decode", "verify", "prefix_tail", "prefill"])
def test_int8_kernel_matches_plain_on_cuda(s, ctx, head_dim, dtype):
    _cuda_or_skip()
    q, *rest = int8_case(5 + s, "cuda", b=4, h=16, d=head_dim, page_size=16,
                         pps=64, s=s, ctx=ctx)
    pools, scales = rest[:4], dict(k_scale=rest[4], v_scale=rest[5])
    launches = (rpa.launches, rpa.int8_launches)
    got = rpa.ragged_paged_attention(q.to(dtype), *pools, **scales)
    torch.cuda.synchronize()
    assert (rpa.launches, rpa.int8_launches) == (launches[0], launches[1] + 1)
    want = rpa.ragged_paged_attention_reference(q.to(dtype), *pools, **scales)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-4)
        return
    exact = rpa.ragged_paged_attention_reference(q, *pools, **scales)
    e_kernel = (got.float() - exact).abs().max().item()
    e_plain = (want.float() - exact).abs().max().item()
    assert e_kernel <= BF16_ERR_RATIO * e_plain + BF16_ERR_FLOOR, (
        f"kernel {e_kernel:.3e}, plain bf16 {e_plain:.3e} against float32")


def test_kernel_raises_on_unsupported_head_dim_on_cuda():
    _cuda_or_skip()
    q, k_pool, v_pool, table, ctx = (torch.from_numpy(a).cuda()
                                     for a in pool_case(5, d=16))
    with pytest.raises(ValueError):
        rpa.ragged_paged_attention(q, k_pool, v_pool, table, ctx)


# ---------------------------------------------------------------------------
# the kernel's programs (split-KV decode/verify, tensor-core prefill, the
# CUDA-core program) at their edges, on the card


def card_case(seed, *, b, s, ctx, d=128, dtype=torch.bfloat16, h=16,
              page_size=16, pps=64, inactive=()):
    """Float pools on the card: a table of distinct random pages per row,
    rows in ``inactive`` all null page with ctx 0 (inactive slots)."""
    rng = np.random.default_rng(seed)
    num_pages = 1 + b * pps
    shape = (num_pages, page_size, h, d)
    k_pool, v_pool = (torch.from_numpy(rng.standard_normal(shape, np.float32))
                      .to("cuda", dtype) for _ in range(2))
    q = torch.from_numpy(rng.standard_normal((b, h, s, d), np.float32)).to(
        "cuda", dtype)
    table = (rng.permutation(num_pages - 1)[:b * pps] + 1).reshape(b, pps)
    ctx = np.broadcast_to(np.asarray(ctx), (b,)).astype(np.int32).copy()
    for r in inactive:
        table[r] = 0
        ctx[r] = 0
    return (q, k_pool, v_pool, torch.from_numpy(table.astype(np.int32)).cuda(),
            torch.from_numpy(ctx).cuda())


def _program_counts():
    return (rpa.split_launches, rpa.mma_launches, rpa.warp_launches)


def _check_against_plain(args, program, **scales):
    """The kernel once (its program's counter grows by one, the others
    not) against the plain version: float32 q by TOL_FP32; bf16 q, the
    kernel and the plain version each against the plain version with q in
    float32, the kernel's error at most BF16_ERR_RATIO times the plain
    one's plus BF16_ERR_FLOOR."""
    q = args[0]
    assert rpa.choose_program(q.shape[2], q.shape[3], q.dtype) == program
    before = _program_counts()
    got = rpa.ragged_paged_attention(*args, **scales)
    torch.cuda.synchronize()
    grown = tuple(a - b for a, b in zip(_program_counts(), before))
    assert grown == tuple(int(p == program) for p in ("split", "mma", "warp"))
    assert torch.isfinite(got).all()
    want = rpa.ragged_paged_attention_reference(*args, **scales)
    if q.dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-4)
        return
    pools = args[1:3] if scales else (args[1].float(), args[2].float())
    exact = rpa.ragged_paged_attention_reference(q.float(), *pools,
                                                 *args[3:], **scales)
    e_kernel = (got.float() - exact).abs().max().item()
    e_plain = (want.float() - exact).abs().max().item()
    assert e_kernel <= BF16_ERR_RATIO * e_plain + BF16_ERR_FLOOR, (
        f"{program}: kernel {e_kernel:.3e}, plain bf16 {e_plain:.3e}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("s", [1, 5], ids=["decode", "verify"])
def test_split_at_batch_1_up_to_the_full_table_on_cuda(s, dtype):
    _cuda_or_skip()
    # one row whose last query sees every position of its 1,024
    args = card_case(11 + s, b=1, s=s, ctx=64 * 16 - s, dtype=dtype)
    _check_against_plain(args, "split")


@pytest.mark.parametrize("s", [1, 5], ids=["decode", "verify"])
def test_split_at_chunk_boundaries_and_inactive_rows_on_cuda(s):
    _cuda_or_skip()
    b, h, width = 8, 16, 64 * 16
    splits, chunk = rpa.split_plan(
        b, h, width, torch.cuda.get_device_properties(0).multi_processor_count)
    assert splits > 1
    # the last query's last position at a chunk's end, one past it, and
    # one past the first chunk; rows 6 and 7 inactive
    ctx = [chunk - s, chunk - s + 1, 2 * chunk - s, 2 * chunk - s + 1,
           chunk - 1, 0, 0, 0]
    args = card_case(21 + s, b=b, h=h, s=s, ctx=ctx, inactive=(6, 7))
    _check_against_plain(args, "split")


@pytest.mark.parametrize("s,program", [
    (rpa.MMA_MIN_QUERIES - 1, "warp"), (rpa.MMA_MIN_QUERIES, "mma"),
    (rpa.MMA_MIN_QUERIES + 1, "mma"), (100, "mma")],
    ids=["threshold-1", "threshold", "threshold+1", "s100"])
@pytest.mark.parametrize("head_dim", [64, 128])
def test_prefill_programs_at_the_threshold_on_cuda(s, program, head_dim):
    _cuda_or_skip()
    args = card_case(31 + s + head_dim, b=2, s=s, ctx=0, d=head_dim,
                     inactive=(1,))
    _check_against_plain(args, program)


@pytest.mark.parametrize("s,program", [(64, "mma"), (5, "split"),
                                       (300, "mma")])
def test_prefix_tail_off_the_page_grid_on_cuda(s, program):
    _cuda_or_skip()
    # 203 cached positions: the tail starts mid-page
    args = card_case(41 + s, b=3, s=s, ctx=[203, 37, 0], inactive=(2,))
    _check_against_plain(args, program)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("s,ctx", [(1, None), (5, None), (64, 203), (100, 0)],
                         ids=["decode", "verify", "prefix_tail", "prefill"])
def test_int8_garbage_scales_do_not_leak_on_cuda(s, ctx, dtype):
    """inf / NaN scales on the null page and on every page past a row's
    last visible position: no program reads them, so the active rows
    equal the kernel's output with those scales made finite."""
    _cuda_or_skip()
    b, ps, pps = 4, 16, 64
    q, k_pool, v_pool, table, ctx_lens, k_sc, v_sc = int8_case(
        71 + s, "cuda", b=b, h=16, d=128, page_size=ps, pps=pps, s=s,
        ctx=ctx)
    q = q.to(dtype)
    dirty_k, dirty_v = k_sc.clone(), v_sc.clone()
    dirty_k[0], dirty_v[0] = float("inf"), float("nan")
    tab, ctxs = table.cpu().numpy(), ctx_lens.cpu().numpy()
    for r in range(b - 1):  # the last row is inactive: all null page
        last_page = (ctxs[r] + s - 1) // ps
        dirty_k[tab[r, last_page + 1:]] = float("nan")
        dirty_v[tab[r, last_page + 1:]] = float("inf")
    rest = (k_pool, v_pool, table, ctx_lens)
    program = rpa.choose_program(s, 128, dtype)
    before = _program_counts()
    got = rpa.ragged_paged_attention(q, *rest, k_scale=dirty_k,
                                     v_scale=dirty_v)
    clean = rpa.ragged_paged_attention(q, *rest, k_scale=k_sc, v_scale=v_sc)
    torch.cuda.synchronize()
    grown = tuple(a - b for a, b in zip(_program_counts(), before))
    assert grown == tuple(2 * int(p == program)
                          for p in ("split", "mma", "warp"))
    active = slice(0, b - 1)
    assert torch.isfinite(got[active]).all()
    torch.testing.assert_close(got[active], clean[active], atol=0, rtol=0)
    _check_against_plain((q, *rest), program, k_scale=k_sc, v_scale=v_sc)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("s", [1, 5, 40], ids=["decode", "verify", "s40"])
@pytest.mark.parametrize("page_size,pps", [(4, 64), (32, 8)],
                         ids=["page4", "page32"])
@pytest.mark.parametrize("head_dim", [32, 96, 160, 256])
def test_every_head_dim_and_page_size_on_cuda(head_dim, page_size, pps, s,
                                              dtype):
    """The contract's other widths: head_dim 32-256 and pages of 4 and 32
    positions, over a 256-position table (programs by shape: split for
    s <= 8; for s = 40 mma in bf16 up to head_dim 128, warp otherwise)."""
    _cuda_or_skip()
    args = card_case(51 + head_dim + page_size + s, b=3, h=4, s=s,
                     ctx=[256 - s, 77, 0], d=head_dim, dtype=dtype,
                     page_size=page_size, pps=pps, inactive=(2,))
    _check_against_plain(args, rpa.choose_program(s, head_dim, dtype))


@pytest.mark.parametrize("s,ctx", [(1, None), (40, 23)],
                         ids=["decode", "prefix_tail"])
@pytest.mark.parametrize("head_dim", [32, 256])
def test_int8_at_the_narrowest_and_widest_head_on_cuda(head_dim, s, ctx):
    _cuda_or_skip()
    q, *rest = int8_case(81 + head_dim + s, "cuda", b=3, h=4, d=head_dim,
                         page_size=8, pps=16, s=s, ctx=ctx)
    program = rpa.choose_program(s, head_dim, torch.bfloat16)
    _check_against_plain((q.bfloat16(), *rest[:4]), program,
                         k_scale=rest[4], v_scale=rest[5])
