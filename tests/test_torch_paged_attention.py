"""The port's paged attention (``paddle_tpu_torch.kernels``) against the
JAX package's (``paddle_tpu.kernels.paged_attention``, composite path —
what the JAX package runs on the CPU).

Inputs are made with numpy from a fixed seed and handed to both. Pool
writes and masks must be exactly equal; attention agrees within float32
atol 1e-5 (the two softmax/matmul implementations sum in other orders).
The Hopper kernel itself runs only on a CUDA device: its test is in
``test_torch_ragged_kernel.py``, which imports no JAX so that it also runs
on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import paged_attention as jpa
from paddle_tpu_torch.kernels import paged_attention as tpa
from paddle_tpu_torch.kernels import ragged_paged_attention as rpa
from test_torch_ragged_kernel import pool_case

ATOL = 1e-5


def test_paged_write_equals_reference():
    rng = np.random.default_rng(0)
    pool_shape = (7, 4, 2, 8)
    k_pool = rng.standard_normal(pool_shape, np.float32)
    v_pool = rng.standard_normal(pool_shape, np.float32)
    k_new = rng.standard_normal((2, 5, 2, 8), np.float32)
    v_new = rng.standard_normal((2, 5, 2, 8), np.float32)
    # distinct destinations, one of them in the null page
    flat = rng.choice(7 * 4, size=10, replace=False)
    flat[0] = 0
    page_ids = (flat // 4).reshape(2, 5).astype(np.int32)
    offsets = (flat % 4).reshape(2, 5).astype(np.int32)
    jk, jv = jpa.paged_write(jnp.asarray(k_pool), jnp.asarray(v_pool),
                             jnp.asarray(k_new), jnp.asarray(v_new),
                             jnp.asarray(page_ids), jnp.asarray(offsets))
    tk, tv = torch.from_numpy(k_pool.copy()), torch.from_numpy(v_pool.copy())
    assert tpa.paged_write(tk, tv, torch.from_numpy(k_new),
                           torch.from_numpy(v_new), torch.from_numpy(page_ids),
                           torch.from_numpy(offsets)) is None  # in place
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("s", [1, 5, 8])
def test_ragged_mask_equals_reference(s):
    ctx = np.array([0, 3, 17], np.int32)
    want = np.asarray(jpa.ragged_mask(jnp.asarray(ctx), 24, s))
    got = tpa.ragged_mask(torch.from_numpy(ctx), 24, s).numpy()
    np.testing.assert_array_equal(got, want)


def test_paged_gather_equals_reference():
    q, k_pool, _, table, _ = pool_case(1)
    want = np.asarray(jpa.paged_gather(jnp.asarray(k_pool),
                                       jnp.asarray(table)))
    got = tpa.paged_gather(torch.from_numpy(k_pool),
                           torch.from_numpy(table)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("head_dim", [16, 64])
@pytest.mark.parametrize("s,ctx", [(1, None), (5, None), (8, 0), (8, 11)],
                         ids=["decode", "verify", "prefill", "prefix_tail"])
def test_paged_attention_matches_reference(s, ctx, head_dim):
    q, k_pool, v_pool, table, ctx_lens = pool_case(
        100 + s + head_dim, d=head_dim, s=s, ctx=ctx)
    want = np.asarray(jpa.paged_attention(
        jnp.asarray(q), jnp.asarray(k_pool), jnp.asarray(v_pool),
        jnp.asarray(table), jnp.asarray(ctx_lens)))
    launches = rpa.launches
    got = tpa.paged_attention(torch.from_numpy(q), torch.from_numpy(k_pool),
                              torch.from_numpy(v_pool),
                              torch.from_numpy(table),
                              torch.from_numpy(ctx_lens))
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    assert rpa.launches == launches  # CPU tensors never launch


def test_cpu_tensors_take_the_plain_version():
    q, k_pool, v_pool, table, ctx = (torch.from_numpy(a)
                                     for a in pool_case(7, s=3))
    calls, launches = rpa.reference_calls, rpa.launches
    out = rpa.ragged_paged_attention(q, k_pool, v_pool, table, ctx)
    ref = rpa.ragged_paged_attention_reference(q, k_pool, v_pool, table, ctx)
    assert torch.equal(out, ref)
    assert rpa.reference_calls == calls + 2
    assert rpa.launches == launches


def test_wrapper_rejects_what_it_does_not_take():
    q, k_pool, v_pool, table, ctx = (torch.from_numpy(a)
                                     for a in pool_case(8, s=2))
    with pytest.raises(TypeError):
        rpa.ragged_paged_attention(q.half(), k_pool.half(), v_pool.half(),
                                   table, ctx)
    with pytest.raises(TypeError):
        rpa.ragged_paged_attention(q, k_pool, v_pool, table.long(), ctx)
    with pytest.raises(TypeError):
        rpa.ragged_paged_attention(q, k_pool.bfloat16(), v_pool, table, ctx)
    with pytest.raises(ValueError):
        rpa.ragged_paged_attention(q[:, :2], k_pool, v_pool, table, ctx)
    with pytest.raises(ValueError):
        rpa.ragged_paged_attention(q, k_pool, v_pool, table[:1], ctx)
