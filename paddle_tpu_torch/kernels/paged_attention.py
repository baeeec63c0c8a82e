"""Paged attention over a fixed page pool — the port of
``paddle_tpu/kernels/paged_attention.py`` (float pools and int8 pools).

Pool layout is ``[num_pages, page_size, num_heads, head_dim]`` per layer
(serving/kv_cache.py owns allocation). Page 0 is the null page: writes
from padding and inactive rows go there, so the write needs no branch.

The JAX package updates its pools functionally and donates them to the
jitted step, so XLA writes in place. Here the write is an in-place
``index_put_`` on the pool tensor itself — the same memory behaviour,
stated directly.

Quantised pools (``kv_dtype="int8"`` in ``serving/kv_cache.py``) hold
int8 codes and a float32 absmax scale per page and head (``[num_pages,
heads]``). ``paged_write_quant`` writes in place in the reference's order:
scatter-max the new tokens' absmax into the page scales (monotone),
rescale the touched pages' resident codes by old/new (exactly 1.0, so
bit-stable, when a scale did not grow), then write the new tokens at the
final scale. ``paged_gather_quant`` dequantises ``code * (scale / 127)``
to the query's dtype; the kernel fuses the same dequant into its gather.

Dispatch (``paged_attention``): every call goes to
:func:`.ragged_paged_attention.ragged_paged_attention`. On a CUDA tensor
that wrapper launches the hand-written Hopper kernel; on a CPU tensor it
takes the kernel's plain version (``paged_gather`` + ``ragged_mask`` +
``sdpa_reference``). There is no eligibility gate and no fallback: a
kernel that cannot launch raises.
"""
from __future__ import annotations

import torch

__all__ = ["QMAX", "paged_write", "paged_write_quant", "paged_write_quant_kv",
           "ragged_mask", "paged_gather", "paged_gather_quant",
           "paged_attention"]

#: symmetric int8 code range: codes in [-127, 127], value = code*scale/127
QMAX = 127.0


def paged_write(k_pool, v_pool, k_new, v_new, page_ids, offsets) -> None:
    """Write new K/V into the pools, in place.

    k_new/v_new: ``[batch, tokens, heads, head_dim]``; page_ids/offsets:
    ``[batch, tokens]`` integer destination coordinates (callers route dead
    writes — padding, inactive slots — to the null page 0)."""
    idx = (page_ids.long(), offsets.long())
    k_pool.index_put_(idx, k_new.to(k_pool.dtype))
    v_pool.index_put_(idx, v_new.to(v_pool.dtype))


def _distinct_pages(page_ids, bound: int):
    """The distinct ids of ``page_ids`` in a ``[bound]`` tensor, padded
    with repeats of one of them, without a host sync (``torch.unique``
    would wait for the device to size its output). ``bound`` must be at
    least the number of distinct ids."""
    srt = torch.sort(page_ids).values
    first = torch.ones_like(srt, dtype=torch.bool)
    first[1:] = srt[1:] != srt[:-1]
    rank = torch.cumsum(first, 0) - 1
    return srt[:1].expand(bound).clone().scatter_(0, rank, srt)


def _write_quant(pools, scales, new, page_ids, offsets) -> None:
    """Quantised writes into ``n`` stacked pools at once, in place:
    ``pools`` int8 ``[n, num_pages, page_size, heads, head_dim]``,
    ``scales`` float32 ``[n, num_pages, heads]``, ``new`` float32 ``[n,
    b, s, heads, head_dim]``; ``page_ids``/``offsets`` ``[b, s]`` long.

    The reference's order (``paddle_tpu/kernels/paged_attention.py:69``):
    read the touched pages' scales, scatter-max the new tokens' absmax
    into them, rescale the touched pages' resident codes by ``old /
    new``, then write the new tokens at the final scale as
    ``clip(round(new / scale * 127))``. The reference rescales one page
    image per token, every duplicate of a page writing the identical
    image; this rescales each distinct page once when a call of ``b``
    rows of ``s`` tokens can touch fewer pages than it has tokens (at
    most ``b * (ceil((s - 1) / page_size) + 1)`` plus the null page) —
    the same bytes."""
    n, _, ps, h, _ = pools.shape
    b, s = page_ids.shape
    flat = page_ids.reshape(-1)
    bound = b * (-(-(s - 1) // ps) + 1) + 1
    pages = flat if bound >= b * s else _distinct_pages(flat, bound)
    old = scales.index_select(1, pages)                  # before the max
    scales.scatter_reduce_(1, flat[None, :, None].expand(n, -1, h),
                           new.abs().amax(-1).reshape(n, -1, h), "amax")
    cur = scales.index_select(1, pages)
    safe = torch.where(cur > 0, cur, 1.0)
    codes = pools.index_select(1, pages).float()
    codes.mul_((old / safe)[:, :, None, :, None]).round_()
    pools.index_copy_(1, pages, codes.to(pools.dtype))
    if pages is not flat:  # each token's final page scale
        tok = scales.index_select(1, flat)
        safe = torch.where(tok > 0, tok, 1.0)
    q = (new / safe.view(n, b, s, h, 1)).mul_(QMAX).round_()
    pools[:, page_ids, offsets] = q.clamp_(-QMAX, QMAX).to(pools.dtype)


def paged_write_quant(k_pool, v_pool, k_scale, v_scale, k_new, v_new,
                      page_ids, offsets) -> None:
    """Quantised twin of :func:`paged_write`, in place: int8 pools
    ``[num_pages, page_size, heads, head_dim]`` and their float32 scales
    ``[num_pages, heads]``; the same coordinate contract (dead writes go
    to the null page 0, whose scale accrues garbage that is only ever read
    masked to zero)."""
    page_ids, offsets = page_ids.long(), offsets.long()
    for pool, scale, new in ((k_pool, k_scale, k_new),
                             (v_pool, v_scale, v_new)):
        _write_quant(pool[None], scale[None], new.float()[None], page_ids,
                     offsets)


def paged_write_quant_kv(pools, scales, kv_new, page_ids, offsets) -> None:
    """:func:`paged_write_quant` for one layer's K and V stacked, as the
    serving cache keeps them: ``pools`` int8 ``[2, num_pages, page_size,
    heads, head_dim]``, ``scales`` ``[2, num_pages, heads]``, ``kv_new``
    ``[2, b, s, heads, head_dim]`` — both pools in one pass of each
    operation."""
    _write_quant(pools, scales, kv_new.float(), page_ids.long(),
                 offsets.long())


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


def paged_gather_quant(pool, scale, page_table, out_dtype=torch.float32):
    """The dequantising gather: int8 codes ``[num_pages, page_size, heads,
    head_dim]`` and scales ``[num_pages, heads]`` -> ``[batch, heads,
    pages_per_seq * page_size, head_dim]`` in ``out_dtype``, each value
    ``code * (scale / 127)`` in float32, then cast."""
    b, n_pages = page_table.shape
    _, ps, h, d = pool.shape
    idx = page_table.long()
    seq = pool[idx].float()                             # [b, n, ps, h, d]
    # a tensor divisor: a Python number divides by multiplying with its
    # reciprocal on CUDA; the reference and the kernel divide
    sc = scale[idx] / scale.new_tensor(QMAX)
    seq = (seq * sc[:, :, None, :, None]).to(out_dtype)
    return seq.reshape(b, n_pages * ps, h, d).transpose(1, 2)


def paged_attention(q, k_pool, v_pool, page_table, ctx_lens, scale=None,
                    k_scale=None, v_scale=None):
    """Attention of new-token queries against each row's paged KV prefix.

    q: ``[batch, heads, s, head_dim]`` — queries for s new tokens at
    positions ``ctx_lens .. ctx_lens + s - 1`` whose K/V are already in
    the pool (write first, then attend). ctx_lens: ``[batch]`` int32
    tokens resident per row before this call. Query ``t`` of row ``b``
    sees pool positions ``j <= ctx_lens[b] + t``. Returns
    ``[batch, heads, s, head_dim]``.

    ``s`` is 1 for decode and the pad bucket for prefill (the prefix-cache
    tail prefill enters at ``ctx_lens = cached tokens``). ``k_scale`` /
    ``v_scale`` (both or neither): the pools are int8 codes under these
    per-page-per-head scales."""
    from .ragged_paged_attention import ragged_paged_attention

    return ragged_paged_attention(q, k_pool, v_pool, page_table, ctx_lens,
                                  scale=scale, k_scale=k_scale,
                                  v_scale=v_scale)
