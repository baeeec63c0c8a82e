"""The port's ragged paged-attention kernel and its plain version.

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


def test_kernel_raises_on_unsupported_head_dim_on_cuda():
    _cuda_or_skip()
    q, k_pool, v_pool, table, ctx = (torch.from_numpy(a).cuda()
                                     for a in pool_case(5, d=16))
    with pytest.raises(ValueError):
        rpa.ragged_paged_attention(q, k_pool, v_pool, table, ctx)
