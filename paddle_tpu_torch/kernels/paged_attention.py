"""Paged attention over a fixed page pool — the port of
``paddle_tpu/kernels/paged_attention.py`` (float pools).

Pool layout is ``[num_pages, page_size, num_heads, head_dim]`` per layer
(serving/kv_cache.py owns allocation). Page 0 is the null page: writes
from padding and inactive rows go there, so the write needs no branch.

The JAX package updates its pools functionally and donates them to the
jitted step, so XLA writes in place. Here the write is an in-place
``index_put_`` on the pool tensor itself — the same memory behaviour,
stated directly.

Dispatch (``paged_attention``): every call goes to
:func:`.ragged_paged_attention.ragged_paged_attention`. On a CUDA tensor
that wrapper launches the hand-written Hopper kernel; on a CPU tensor it
takes the kernel's plain version (``paged_gather`` + ``ragged_mask`` +
``sdpa_reference``). There is no eligibility gate and no fallback: a
kernel that cannot launch raises.
"""
from __future__ import annotations

import torch

__all__ = ["paged_write", "ragged_mask", "paged_gather", "paged_attention"]


def paged_write(k_pool, v_pool, k_new, v_new, page_ids, offsets) -> None:
    """Write new K/V into the pools, in place.

    k_new/v_new: ``[batch, tokens, heads, head_dim]``; page_ids/offsets:
    ``[batch, tokens]`` integer destination coordinates (callers route dead
    writes — padding, inactive slots — to the null page 0)."""
    idx = (page_ids.long(), offsets.long())
    k_pool.index_put_(idx, k_new.to(k_pool.dtype))
    v_pool.index_put_(idx, v_new.to(v_pool.dtype))


def ragged_mask(ctx_lens, total: int, num_query_tokens: int):
    """The ragged causal-prefix mask: query ``t`` of row ``b`` (entering
    at position ``ctx_lens[b] + t``) sees gathered positions
    ``j <= ctx_lens[b] + t``. ``[batch, 1, num_query_tokens, total]``
    bool, broadcast over heads."""
    dev = ctx_lens.device
    j = torch.arange(total, device=dev)[None, None, None, :]
    t = torch.arange(num_query_tokens, device=dev)[None, None, :, None]
    return j <= ctx_lens.long()[:, None, None, None] + t


def paged_gather(pool, page_table):
    """Each row's pages as one contiguous sequence: pool ``[num_pages,
    page_size, heads, head_dim]``, page_table ``[batch, pages_per_seq]`` ->
    ``[batch, heads, pages_per_seq * page_size, head_dim]``."""
    b, n_pages = page_table.shape
    _, ps, h, d = pool.shape
    seq = pool[page_table.long()].reshape(b, n_pages * ps, h, d)
    return seq.transpose(1, 2)


def paged_attention(q, k_pool, v_pool, page_table, ctx_lens, scale=None):
    """Attention of new-token queries against each row's paged KV prefix.

    q: ``[batch, heads, s, head_dim]`` — queries for s new tokens at
    positions ``ctx_lens .. ctx_lens + s - 1`` whose K/V are already in
    the pool (write first, then attend). ctx_lens: ``[batch]`` int32
    tokens resident per row before this call. Query ``t`` of row ``b``
    sees pool positions ``j <= ctx_lens[b] + t``. Returns
    ``[batch, heads, s, head_dim]``.

    ``s`` is 1 for decode and the pad bucket for prefill (the prefix-cache
    tail prefill enters at ``ctx_lens = cached tokens``)."""
    from .ragged_paged_attention import ragged_paged_attention

    return ragged_paged_attention(q, k_pool, v_pool, page_table, ctx_lens,
                                  scale=scale)
