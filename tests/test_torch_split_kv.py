"""The ragged kernel's launch plan and its split-KV arithmetic, on the CPU.

The kernel's split program cuts each row's table width into chunks, has
every chunk write float32 partials (its running max ``m``, its sum ``l``
and its unnormalised accumulator) and merges them by log-sum-exp. The
chunking comes from the shapes alone (``launch_plan``), never from the
contexts on the card. ``split_merge`` below is that arithmetic in plain
PyTorch; it is held against the unsplit plain version and against the JAX
package's composite ``paged_attention`` path (what the JAX package runs
on the CPU), on the same numpy inputs, within float32 atol 1e-5 (the
implementations sum in other orders).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import paged_attention as jpa
from paddle_tpu_torch.kernels import ragged_paged_attention as rpa
from paddle_tpu_torch.kernels.paged_attention import (paged_gather,
                                                      paged_gather_quant)
from test_torch_ragged_kernel import int8_case, pool_case

ATOL = 1e-5
H100_SMS = 132


@pytest.mark.parametrize("s,d,dtype,program", [
    (1, 128, torch.bfloat16, "split"), (1, 64, torch.float32, "split"),
    (rpa.SPLIT_MAX_QUERIES, 128, torch.bfloat16, "split"),
    (rpa.SPLIT_MAX_QUERIES + 1, 128, torch.bfloat16, "warp"),
    (rpa.MMA_MIN_QUERIES, 128, torch.bfloat16, "mma"),
    (512, 64, torch.bfloat16, "mma"), (512, 128, torch.float32, "warp"),
    (512, rpa.MMA_MAX_HEAD_DIM + 32, torch.bfloat16, "warp")])
def test_program_follows_shapes_and_dtype(s, d, dtype, program):
    assert rpa.choose_program(s, d, dtype) == program
    want_split = program == "split"
    plan = rpa.launch_plan((8, 16, s, d), dtype, 16, 64, H100_SMS)
    assert plan[0] == program and (plan[2] > 0) == want_split


@pytest.mark.parametrize("b,h,width", [(8, 16, 1024), (1, 16, 1024),
                                       (64, 32, 2048), (3, 5, 100),
                                       (1, 1, 1 << 20), (2, 16, 64)])
def test_split_plan_covers_the_table_in_whole_quanta(b, h, width):
    splits, chunk = rpa.split_plan(b, h, width, H100_SMS)
    assert chunk % rpa.SPLIT_QUANTUM == 0
    assert splits * chunk >= width > (splits - 1) * chunk
    assert 1 <= splits <= rpa.SPLIT_MAX_SPLITS
    # as many blocks as wanted, unless the quanta or the cap run out
    enough = b * h * splits >= rpa.SPLIT_BLOCKS_PER_SM * H100_SMS
    assert enough or splits >= min(-(-width // rpa.SPLIT_QUANTUM),
                                   rpa.SPLIT_MAX_SPLITS) - 1


def test_split_plan_at_the_serving_shapes():
    # the decode batch and one row at gpt3-1.3b's table: 16 chunks of 64
    assert rpa.split_plan(8, 16, 1024, H100_SMS) == (16, 64)
    assert rpa.split_plan(1, 16, 1024, H100_SMS) == (16, 64)
    # a batch that fills the card on its own takes one chunk
    assert rpa.split_plan(128, 32, 2048, H100_SMS) == (1, 2048)


def test_launch_plan_reads_no_context():
    # the plan takes shapes, a dtype and the SM count: there is no way for
    # ctx_lens (on the card) to reach it
    import inspect
    params = list(inspect.signature(rpa.launch_plan).parameters)
    assert params == ["q_shape", "dtype", "page_size", "pages_per_seq",
                      "sm_count"]


def split_merge(q, k_all, v_all, ctx_lens, chunk, scale=None):
    """The split program's arithmetic over gathered K/V ``[b, h, W, d]``:
    per chunk of positions and query, m = the max visible score (-inf when
    none is visible), l = sum exp(score - m), acc = sum exp(score - m) v;
    then out = sum_i exp(m_i - M) acc_i / sum_i exp(m_i - M) l_i. Also
    returns every chunk's m, ``[b, h, s, splits]``."""
    b, h, s, d = q.shape
    width = k_all.shape[2]
    scale = d ** -0.5 if scale is None else scale
    t = torch.arange(s)[None, :, None]
    j = torch.arange(width)[None, None, :]
    visible = j <= ctx_lens[:, None, None].long() + t  # [b, s, W]
    scores = torch.einsum("bhsd,bhwd->bhsw", q.float(), k_all.float()) * scale
    scores = scores.masked_fill(~visible[:, None], float("-inf"))
    ms, ls, accs = [], [], []
    for j0 in range(0, width, chunk):
        part = scores[..., j0:j0 + chunk]
        m = part.amax(-1)
        p = torch.where(torch.isinf(part), torch.zeros_like(part),
                        torch.exp(part - m[..., None]))
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bhsw,bhwd->bhsd", p,
                                 v_all[:, :, j0:j0 + chunk].float()))
    m_all = torch.stack(ms, -1)
    big = m_all.amax(-1, keepdim=True)  # finite: chunk 0 holds position 0
    w = torch.where(torch.isinf(m_all), torch.zeros_like(m_all),
                    torch.exp(m_all - big))
    num = sum(w[..., i, None] * accs[i] for i in range(len(accs)))
    den = (w * torch.stack(ls, -1)).sum(-1)
    return (num / den[..., None]).to(q.dtype), m_all


@pytest.mark.parametrize("chunk", [4, 8, 24])
@pytest.mark.parametrize("s,ctx", [(1, None), (5, None), (3, 9)],
                         ids=["decode", "verify", "prefix_tail"])
def test_split_merge_matches_plain_and_reference(s, ctx, chunk):
    q, k_pool, v_pool, table, ctx_lens = pool_case(200 + s + chunk, b=4,
                                                   d=16, s=s, ctx=ctx)
    args = [torch.from_numpy(a) for a in (q, k_pool, v_pool, table,
                                          ctx_lens)]
    got, m_all = split_merge(args[0], paged_gather(args[1], args[3]),
                             paged_gather(args[2], args[3]), args[4], chunk)
    plain = rpa.ragged_paged_attention_reference(*args)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=ATOL, rtol=0)
    want = np.asarray(jpa.paged_attention(
        jnp.asarray(q), jnp.asarray(k_pool), jnp.asarray(v_pool),
        jnp.asarray(table), jnp.asarray(ctx_lens)))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    # the chunks a query sees anything in are a prefix, so the kernel's
    # merge reads partials only up to the first -inf
    seen = ~torch.isinf(m_all)
    assert seen[..., 0].all()
    assert (seen.int().cummin(-1).values == seen.int()).all()


@pytest.mark.parametrize("chunk", [8, 24])
@pytest.mark.parametrize("s,ctx", [(1, None), (4, None)],
                         ids=["decode", "verify"])
def test_split_merge_over_int8_pools_matches_reference(s, ctx, chunk):
    q, k_pool, v_pool, table, ctx_lens, k_sc, v_sc = int8_case(
        300 + s + chunk, b=4, d=32, s=s, ctx=ctx)
    got, _ = split_merge(q, paged_gather_quant(k_pool, k_sc, table, q.dtype),
                         paged_gather_quant(v_pool, v_sc, table, q.dtype),
                         ctx_lens, chunk)
    plain = rpa.ragged_paged_attention_reference(
        q, k_pool, v_pool, table, ctx_lens, k_scale=k_sc, v_scale=v_sc)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=ATOL, rtol=0)
    want = np.asarray(jpa.paged_attention(
        *(jnp.asarray(t.numpy()) for t in (q, k_pool, v_pool, table,
                                           ctx_lens)),
        k_scale=jnp.asarray(k_sc.numpy()), v_scale=jnp.asarray(v_sc.numpy())))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
