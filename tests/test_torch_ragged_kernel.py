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
