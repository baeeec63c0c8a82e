"""The port's paged KV cache (``paddle_tpu_torch.serving.kv_cache``)
against the JAX package's: one script of admissions (cold, prefix hit,
full hit with copy-on-write, refused), growth, releases, LRU eviction and
a re-hit, driven through both caches. After every operation the page
tables, refcounts, free and reclaimable lists, cached-token counts and
counters must be identical and both caches' invariants must hold; at the
end the pool bytes (random to start with, then moved by the COW copy)
must be equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.serving.kv_cache import PagedCacheConfig as JCacheConfig
from paddle_tpu.serving.kv_cache import PagedKVCache as JCache
from paddle_tpu_torch.serving.kv_cache import (PageAllocator,
                                               PagedCacheConfig,
                                               PagedKVCache)

LAYERS, HEADS, HEAD_DIM = 2, 2, 4
SHAPE = dict(num_layers=LAYERS, num_heads=HEADS, head_dim=HEAD_DIM,
             num_pages=9, page_size=4, max_batch=3, pages_per_seq=4)


def _caches(seed=0):
    rng = np.random.default_rng(seed)
    pools = rng.standard_normal(
        (LAYERS, 2, 9, 4, HEADS, HEAD_DIM)).astype(np.float32)
    jc = JCache(JCacheConfig(**SHAPE))
    jc.pools = [{"k_pool": jnp.asarray(pools[i, 0]),
                 "v_pool": jnp.asarray(pools[i, 1])} for i in range(LAYERS)]
    tc = PagedKVCache(PagedCacheConfig(**SHAPE), device="cpu")
    tc.pools.copy_(torch.from_numpy(pools))
    return jc, tc


def _state(c):
    a = c.allocator
    return {"table": c.page_table.tolist(), "ref": dict(a._ref),
            "free": list(a._free), "parked": list(a._cached),
            "cached": [c.cached_tokens(s) for s in range(3)],
            "cow": c.cow_copies, "evictions": c.evictions,
            "indexed": sorted(c._page_key)}


def test_cache_script_matches_reference():
    rng = np.random.default_rng(1)
    a, b, c = (rng.integers(1, 50, n) for n in (10, 12, 16))
    script = [
        ("admit", 0, 10, a),          # cold: 3 pages
        ("register", 0, a),           # 2 full blocks indexed
        ("admit", 1, 8, a[:8]),       # full hit -> COW of the last page
        ("grow", 0, 13),              # a 4th page on demand
        ("release", 0),               # indexed pages park reclaimable
        ("admit", 2, 12, b),
        ("register", 2, b),
        ("release", 1),
        ("release", 2),
        ("admit", 0, 16, c),          # LRU-evicts one parked page
        ("admit", 1, 10, a),          # re-hit of the surviving block
        ("grow", 1, 16),              # evicts again
        ("admit", 2, 4, b[:4]),       # nothing left: refused, no change
        ("release", 0),
        ("release", 1),
    ]
    jc, tc = _caches()
    for op in script:
        results = []
        for cache in (jc, tc):
            name, slot, *args = op
            if name == "admit":
                results.append(cache.admit(slot, args[0], tokens=args[1]))
            elif name == "register":
                results.append(cache.register_prefix(slot, args[0]))
            elif name == "grow":
                results.append(cache.grow(slot, args[0]))
            else:
                results.append(cache.release(slot))
            cache.check_invariants()
        assert results[0] == results[1], op[:2]
        assert _state(jc) == _state(tc), op[:2]
    assert tc.cow_copies == 1 and tc.evictions == 4
    assert results == [None, None]
    for layer in range(LAYERS):
        for i, n in enumerate(("k_pool", "v_pool")):
            np.testing.assert_array_equal(tc.pools[layer, i].numpy(),
                                          np.asarray(jc.pools[layer][n]))


def test_cow_copies_every_layer_of_the_page():
    _, tc = _caches(2)
    before = tc.pools.clone()
    tc._copy_page_bytes(3, 7)
    assert (tc.pools[:, :, 7] == before[:, :, 3]).all()
    others = [p for p in range(9) if p != 7]
    assert (tc.pools[:, :, others] == before[:, :, others]).all()


def test_allocator_order_and_errors():
    a = PageAllocator(5)
    assert a.alloc(2) == [1, 2]  # low ids first, page 0 never handed out
    assert a.alloc(3) is None and a.num_free == 2
    a.decref(1, hold=True)
    assert a.num_reclaimable == 1 and a.reclaim_lru() == 1
    with pytest.raises(ValueError):
        a.decref(1)
    with pytest.raises(ValueError):
        PageAllocator(1)


def test_pool_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagedKVCache(PagedCacheConfig(**SHAPE))
