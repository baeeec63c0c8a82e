"""The port's int8 KV pools and host spill tier against the JAX package's.

Module by module, on the same inputs (numpy, from seeds):

- ``paged_write_quant`` / ``paged_gather_quant``
  (``paddle_tpu_torch.kernels.paged_attention``) against
  ``paddle_tpu.kernels.paged_attention``: codes and scales equal to the
  bit, with duplicate pages in one call, a scale that grows, an all-zero
  page and dead writes to the null page 0;
- ``paged_attention`` over int8 pools (the ragged kernel's plain version
  on the CPU) against the reference's composite, float32 atol 1e-5 (two
  softmax implementations summed in other orders);
- ``PagedCacheConfig.kv_bytes_per_token``, copy-on-write of codes and
  scales, and the host tier's spill -> hit -> restore (bit-exact bytes,
  the same spill / restore / hit counts as the reference, the byte bound
  dropping the oldest entry), driven through both caches;
- the int8 engine token for token with the JAX int8 engine, stepped in
  lockstep with equal page tables and refcounts after every step, with
  prefix caching on and off and under recompute preemption; and the
  bench.py KV-quantisation scenario (float pools, int8 pools at the same
  byte budget, int8 pools plus the host tier) with equal outputs and
  equal prefill, eviction, spill, restore and hit counts.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import paged_attention as jpa
from paddle_tpu.serving import ServingConfig as JServingConfig
from paddle_tpu.serving import ServingEngine as JServingEngine
from paddle_tpu.serving.kv_cache import PagedCacheConfig as JCacheConfig
from paddle_tpu.serving.kv_cache import PagedKVCache as JCache
from paddle_tpu.utils import monitor
from paddle_tpu_torch.kernels import paged_attention as tpa
from paddle_tpu_torch.serving import (HostTier, ServingConfig, ServingEngine,
                                      SpilledPage)
from paddle_tpu_torch.serving.kv_cache import PagedCacheConfig, PagedKVCache
from test_torch_gpt import make_pair

ATTN_ATOL = 1e-5


# ------------------------------------------------------------ the writes
def _write_case(seed, b, s, num_pages, ps, h, d):
    """Random int8 pools and scales, new K/V and write coordinates whose
    (page, offset) pairs are unique off the null page; rows 0 and 1 write
    runs of consecutive positions (several tokens per page)."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(-127, 128, (num_pages, ps, h, d)).astype(np.int8)
    scale = (0.5 + rng.random((num_pages, h))).astype(np.float32)
    pid = np.zeros((b, s), np.int32)
    off = np.zeros((b, s), np.int32)
    pages = rng.permutation(np.arange(1, num_pages))
    for r in range(b - 1):  # the last row is an inactive slot: null page
        start = int(rng.integers(0, ps))
        pos = start + np.arange(s)
        pid[r] = pages[r * 3 + pos // ps]
        off[r] = pos % ps
    return pool, scale, pid, off


def _both_writes(pool, scale, k_new, v_new, pid, off):
    jk, jv, jks, jvs = jpa.paged_write_quant(
        jnp.asarray(pool), jnp.asarray(pool), jnp.asarray(scale),
        jnp.asarray(scale), jnp.asarray(k_new), jnp.asarray(v_new),
        jnp.asarray(pid), jnp.asarray(off))
    t = [torch.from_numpy(a.copy()) for a in (pool, pool, scale, scale)]
    tpa.paged_write_quant(*t, torch.from_numpy(k_new),
                          torch.from_numpy(v_new), torch.from_numpy(pid),
                          torch.from_numpy(off))
    # the serving path's K and V stacked write: the same bytes
    kv = [torch.from_numpy(np.stack([a, a])) for a in (pool, scale)]
    tpa.paged_write_quant_kv(*kv, torch.from_numpy(np.stack([k_new, v_new])),
                             torch.from_numpy(pid), torch.from_numpy(off))
    for i, a in enumerate(t):
        stacked = kv[i // 2][i % 2]
        if a.dtype == torch.int8:  # null page 0: see the caller
            a, stacked = a[1:], stacked[1:]
        assert torch.equal(stacked, a)
    return [np.asarray(a) for a in (jk, jv, jks, jvs)], [a.numpy() for a in t]


@pytest.mark.parametrize("case", ["prefill-duplicate-pages", "decode",
                                  "growing-scale", "all-zero-page"])
def test_paged_write_quant_matches_reference(case):
    b, s = (3, 9) if case.startswith("prefill") else (4, 1)
    pool, scale, pid, off = _write_case(7, b, s, 13, 4, 2, 8)
    rng = np.random.default_rng(8)
    k_new = rng.standard_normal((b, s, 2, 8)).astype(np.float32)
    v_new = rng.standard_normal((b, s, 2, 8)).astype(np.float32)
    if case == "growing-scale":  # every touched page's absmax grows
        k_new *= 8.0
        v_new *= 8.0
    if case == "all-zero-page":  # a fresh page: zero codes and scale
        pool[pid[0, 0]] = 0
        scale[pid[0, 0]] = 0.0
        k_new[0] = v_new[0] = 0.0
    want, got = _both_writes(pool, scale, k_new, v_new, pid, off)
    for w, g in zip(want, got):
        # the null page 0's codes take one of several dead writes (which
        # one is unspecified in both packages); its scale is the max of
        # all of them, and equal
        if w.dtype == np.int8:
            np.testing.assert_array_equal(g[1:], w[1:])
        else:
            np.testing.assert_array_equal(g, w)
    if case == "growing-scale":
        touched = np.unique(pid[:-1])
        assert (got[2][touched] > scale[touched]).all()
    if case == "all-zero-page":
        assert got[2][pid[0, 0]].tolist() == [0.0, 0.0]
        assert not got[0][pid[0, 0]].any()


def test_paged_gather_quant_matches_reference():
    pool, scale, pid, _ = _write_case(9, 3, 1, 13, 4, 2, 8)
    table = np.random.default_rng(10).integers(0, 13, (3, 4)).astype(np.int32)
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        want = jpa.paged_gather_quant(jnp.asarray(pool), jnp.asarray(scale),
                                      jnp.asarray(table), jdt)
        got = tpa.paged_gather_quant(torch.from_numpy(pool),
                                     torch.from_numpy(scale),
                                     torch.from_numpy(table), tdt)
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("s,ctx", [(1, [5, 11, 0]), (6, [0, 3, 0]),
                                   (3, [9, 2, 0])],
                         ids=["decode", "prefill", "verify"])
def test_int8_paged_attention_matches_reference(s, ctx):
    rng = np.random.default_rng(11 + s)
    pool, scale, _, _ = _write_case(12 + s, 3, 1, 13, 4, 4, 16)
    v_pool = np.roll(pool, 1, axis=0)
    table = np.array([[1, 2, 3, 4], [5, 6, 7, 8], [0, 0, 0, 0]], np.int32)
    q = rng.standard_normal((3, 4, s, 16)).astype(np.float32)
    ctx = np.asarray(ctx, np.int32)
    want = jpa.paged_attention(jnp.asarray(q), jnp.asarray(pool),
                               jnp.asarray(v_pool), jnp.asarray(table),
                               jnp.asarray(ctx), k_scale=jnp.asarray(scale),
                               v_scale=jnp.asarray(scale[::-1].copy()))
    got = tpa.paged_attention(torch.from_numpy(q), torch.from_numpy(pool),
                              torch.from_numpy(v_pool),
                              torch.from_numpy(table), torch.from_numpy(ctx),
                              k_scale=torch.from_numpy(scale),
                              v_scale=torch.from_numpy(scale[::-1].copy()))
    # the inactive row (all null page) is garbage in both: left out
    np.testing.assert_allclose(got.numpy()[:2], np.asarray(want)[:2],
                               atol=ATTN_ATOL, rtol=0)


def test_one_scale_alone_raises():
    pool, scale, _, _ = _write_case(3, 2, 1, 5, 4, 2, 32)
    q = torch.zeros(2, 2, 1, 32)
    table = torch.zeros(2, 1, dtype=torch.int32)
    with pytest.raises(ValueError, match="k_scale and v_scale"):
        tpa.paged_attention(q, torch.from_numpy(pool), torch.from_numpy(pool),
                            table, torch.zeros(2, dtype=torch.int32),
                            k_scale=torch.from_numpy(scale))


# ------------------------------------------------------------ the cache
@pytest.mark.parametrize("kv_dtype,dtype", [
    ("int8", torch.float32), ("float32", torch.float32),
    ("float32", torch.bfloat16)])
@pytest.mark.parametrize("dims", [(24, 16, 128, 16), (2, 4, 16, 4)],
                         ids=["gpt3-1.3b", "small"])
def test_kv_bytes_per_token_matches_reference(kv_dtype, dtype, dims):
    layers, heads, head_dim, ps = dims
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    shape = dict(num_layers=layers, num_heads=heads, head_dim=head_dim,
                 page_size=ps, kv_dtype=kv_dtype)
    got = PagedCacheConfig(dtype=dtype, **shape).kv_bytes_per_token
    assert got == JCacheConfig(dtype=jdt, **shape).kv_bytes_per_token
    if dims[0] == 24:
        assert got == {("int8", torch.float32): 98_496,
                       ("float32", torch.float32): 393_216,
                       ("float32", torch.bfloat16): 196_608}[kv_dtype, dtype]


LAYERS, HEADS, HEAD_DIM, PS = 2, 2, 4, 4
SHAPE = dict(num_layers=LAYERS, num_heads=HEADS, head_dim=HEAD_DIM,
             num_pages=9, page_size=PS, max_batch=3, pages_per_seq=4)


def _random_pools(rng, kv_dtype):
    """Per-layer random pool bytes (and scales for int8), numpy."""
    shape = (LAYERS, 2, 9, PS, HEADS, HEAD_DIM)
    if kv_dtype == "int8":
        return (rng.integers(-127, 128, shape).astype(np.int8),
                (0.5 + rng.random((LAYERS, 2, 9, HEADS))).astype(np.float32))
    return rng.standard_normal(shape).astype(np.float32), None


def _caches(kv_dtype, host_tier_bytes, seed=0):
    pools, scales = _random_pools(np.random.default_rng(seed), kv_dtype)
    kw = dict(SHAPE, kv_dtype=kv_dtype, host_tier_bytes=host_tier_bytes)
    jc = JCache(JCacheConfig(**kw))
    tc = PagedKVCache(PagedCacheConfig(**kw), device="cpu")
    for i in range(LAYERS):
        jc.pools[i]["k_pool"] = jnp.asarray(pools[i, 0])
        jc.pools[i]["v_pool"] = jnp.asarray(pools[i, 1])
        if scales is not None:
            jc.pools[i]["k_scale"] = jnp.asarray(scales[i, 0])
            jc.pools[i]["v_scale"] = jnp.asarray(scales[i, 1])
    tc.pools.copy_(torch.from_numpy(pools))
    if scales is not None:
        tc.scales.copy_(torch.from_numpy(scales))
    return jc, tc


def _state(c):
    a = c.allocator
    return {"table": c.page_table.tolist(), "ref": dict(a._ref),
            "free": list(a._free), "parked": list(a._cached),
            "cached": [c.cached_tokens(s) for s in range(3)],
            "cow": c.cow_copies, "evictions": c.evictions,
            "indexed": sorted(c._page_key),
            "serials": sorted(c._page_serial.items()),
            "spills": getattr(c, "spills", 0),
            "restores": getattr(c, "restores", 0),
            "hits": getattr(c, "host_tier_hits", 0),
            "restored": [c.restored_pages(s) for s in range(3)],
            "tier": ([] if c.host_tier is None else
                     [(k, e.serial) for k, e in c.host_tier._entries.items()]),
            "tier_bytes": 0 if c.host_tier is None else c.host_tier.bytes}


def _pool_bytes(jc, tc):
    """(reference, port) pool bytes per layer and leaf, as numpy, pages 1
    on: the reference's restore pads its fixed-width scatter with the
    null page 0 and zeros, the port writes only the restored pages, and
    page 0 is only ever read masked to zero."""
    names = ["k_pool", "v_pool"] + (["k_scale", "v_scale"]
                                    if tc.scales is not None else [])
    for layer in range(LAYERS):
        for n in names:
            kv = 0 if n.startswith("k") else 1
            t = tc.pools if n.endswith("pool") else tc.scales
            yield np.asarray(jc.pools[layer][n])[1:], t[layer, kv, 1:].numpy()


def _run_script(jc, tc, script):
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


def test_cow_copies_codes_and_scales():
    _, tc = _caches("int8", 0, seed=2)
    pools, scales = tc.pools.clone(), tc.scales.clone()
    tc._copy_page_bytes(3, 7)
    assert torch.equal(tc.pools[:, :, 7], pools[:, :, 3])
    assert torch.equal(tc.scales[:, :, 7], scales[:, :, 3])
    others = [p for p in range(9) if p != 7]
    assert torch.equal(tc.pools[:, :, others], pools[:, :, others])
    assert torch.equal(tc.scales[:, :, others], scales[:, :, others])


@pytest.mark.parametrize("kv_dtype", ["int8", "float32"])
def test_int8_cache_script_with_cow_matches_reference(kv_dtype):
    """Cold admission, a full hit with copy-on-write, growth, eviction:
    both caches agree after every operation, and on every byte (codes and
    scales) at the end."""
    rng = np.random.default_rng(1)
    a, b = (rng.integers(1, 50, n) for n in (10, 16))
    c = rng.integers(1, 50, 16)
    jc, tc = _caches(kv_dtype, 0)
    _run_script(jc, tc, [
        ("admit", 0, 10, a), ("register", 0, a),
        ("admit", 1, 8, a[:8]),        # full hit -> COW of the last page
        ("grow", 0, 13), ("release", 0), ("release", 1),  # 2 pages parked
        ("admit", 2, 16, b),           # 4 of the 6 free pages
        ("admit", 0, 16, c),           # 2 free + the 2 parked, evicted
        ("release", 2), ("release", 0)])
    assert tc.cow_copies == 1 and tc.evictions == 2
    for want, got in _pool_bytes(jc, tc):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kv_dtype", ["int8", "float32"])
def test_host_tier_spill_hit_restore_matches_reference(kv_dtype):
    """A prefix registered, evicted by a cold prompt (spilled), then hit
    again (restored): the same states and counts as the reference after
    every operation, and the restored pages hold exactly the bytes that
    were spilled."""
    rng = np.random.default_rng(3)
    a, b, c = (rng.integers(1, 50, n) for n in (12, 16, 16))
    page_bytes = 2 * LAYERS * PS * HEADS * HEAD_DIM * (
        1 if kv_dtype == "int8" else 4) + (
        2 * LAYERS * HEADS * 4 if kv_dtype == "int8" else 0)
    jc, tc = _caches(kv_dtype, 4 * page_bytes)
    spilled_bytes = {}
    _run_script(jc, tc, [("admit", 0, 12, a), ("register", 0, a),
                         ("release", 0)])
    for page in tc._key_to_page.values():
        spilled_bytes[tc._page_key[page]] = (
            tc.pools[:, :, page].clone(),
            None if tc.scales is None else tc.scales[:, :, page].clone())
    _run_script(jc, tc, [("admit", 1, 16, b),   # 4 of the 5 free pages
                         ("admit", 2, 16, c),   # evicts a's 3: spilled
                         ("release", 1), ("release", 2),
                         ("admit", 0, 12, a),   # full hit from the tier
                         ("release", 0)])
    assert tc.spills == tc.restores == tc.evictions == 3
    assert tc.host_tier_hits == 1 and len(tc.host_tier) == 0
    for key, (pool, scales) in spilled_bytes.items():
        page = tc._key_to_page[key]
        assert torch.equal(tc.pools[:, :, page], pool)
        if scales is not None:
            assert torch.equal(tc.scales[:, :, page], scales)
    for want, got in _pool_bytes(jc, tc):
        np.testing.assert_array_equal(got, want)


def test_host_tier_byte_bound_drops_the_oldest():
    def entry(i, nbytes=100):
        return SpilledPage(key=(0, (i,)), serial=i,
                           k=torch.zeros(nbytes // 2, dtype=torch.int8),
                           v=torch.zeros(nbytes // 2, dtype=torch.int8))
    tier = HostTier(250)
    tier.put(entry(1))
    tier.put(entry(2))
    assert tier.get((0, (1,))) is not None  # a touch makes 1 the newest
    tier.put(entry(3))
    assert len(tier) == 2 and tier.bytes == 200
    assert tier.get((0, (2,)), touch=False) is None
    assert tier.get((0, (1,)), touch=False) is not None
    tier.get((0, (3,)), touch=False)         # a probe does not reorder
    tier.put(entry(4))
    assert tier.get((0, (1,)), touch=False) is None
    tier.put(entry(5, nbytes=300))           # larger than the bound
    assert len(tier) == 2 and tier.bytes == 200


# ------------------------------------------------------------ the engine
SERVE = dict(max_batch=2, num_pages=11, page_size=4, max_prompt_len=16)


def _requests(seed=5):
    """Seven (prompt, max_new_tokens) pairs; four share an 8-token prefix,
    one repeats a whole earlier prompt."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, 97, 8)
    reqs = []
    for i in range(6):
        tail = rng.integers(1, 97, 2 + i)
        prompt = np.concatenate([shared, tail]) if i % 2 == 0 \
            else rng.integers(1, 97, 6 + i)
        reqs.append((prompt.astype(np.int32), 10 + i))
    reqs.append((reqs[0][0].copy(), 9))
    return reqs


def _lockstep(je, te, reqs, max_steps=500):
    """Add ``reqs`` to both engines and step them together, holding page
    tables and refcounts equal after every step; returns both engines'
    outputs in request order."""
    jr = [je.add_request(p, n) for p, n in reqs]
    tr = [te.add_request(p, n) for p, n in reqs]
    for _ in range(max_steps):
        if je.scheduler.all_done and te.scheduler.all_done:
            break
        je.step()
        te.step()
        np.testing.assert_array_equal(te.cache.page_table,
                                      je.cache.page_table)
        assert te.cache.allocator._ref == je.cache.allocator._ref
        te.cache.check_invariants()
    assert je.scheduler.all_done and te.scheduler.all_done
    return ([je.result(r).tolist() for r in jr],
            [te.result(r).tolist() for r in tr])


@pytest.mark.parametrize("prefix_caching", [True, False])
def test_int8_engine_matches_reference(prefix_caching):
    jm, tm = make_pair(seed=6)
    reqs = _requests()
    kw = dict(SERVE, kv_dtype="int8", enable_prefix_caching=prefix_caching)
    je = JServingEngine(jm, JServingConfig(enable_tracing=False, **kw))
    te = ServingEngine(tm, ServingConfig(**kw), device="cpu")
    want, got = _lockstep(je, te, reqs)
    assert got == want
    c = te.counters
    assert c.preemptions == je.scheduler.preemption_count > 0
    assert (c.prefix_hit_tokens > 0) == prefix_caching
    assert te.cache.pools.dtype == torch.int8
    assert c.kv_bytes_per_token == je.cache.cfg.kv_bytes_per_token
    assert te.cache.allocator.pages_in_use == 0


def _kvq_scenario(engine_cls, config_cls, model, kv_dtype, num_pages,
                  host_tier_bytes, extra):
    """bench.py's KV-quantisation scenario at the small model's size: a
    warm system prefix, then three cycles of a warm burst and a burst of
    cold whales that needs the whole float pool."""
    rng = np.random.RandomState(5)
    system = rng.randint(1, 97, (8,))
    warm = [np.concatenate([system, rng.randint(1, 97, (3,))])
            .astype(np.int32) for _ in range(7)]
    whales = [rng.randint(1, 97, (14,)).astype(np.int32) for _ in range(6)]
    engine = engine_cls(model, config_cls(
        max_batch=2, num_pages=num_pages, page_size=4, max_prompt_len=16,
        kv_dtype=kv_dtype, host_tier_bytes=host_tier_bytes, **extra),
        **({} if engine_cls is JServingEngine else {"device": "cpu"}))
    outs = []
    engine.add_request(warm[0], 4)
    outs += [v.tolist() for v in engine.run().values()]
    for cycle in range(3):
        for p in warm[1 + 2 * cycle:3 + 2 * cycle]:
            engine.add_request(p, 4)
        outs += [v.tolist() for v in engine.run().values()]
        for p in whales[2 * cycle:2 * cycle + 2]:
            engine.add_request(p, 4)
        outs += [v.tolist() for v in engine.run().values()]
    return engine, outs


@pytest.mark.parametrize("leg", ["float32", "int8-same-bytes", "int8-tier"])
def test_kvq_scenario_counts_match_reference(leg):
    """Each leg of the scenario through both engines: equal outputs and
    equal prefill-token, eviction, spill, restore and hit counts; the tier
    leg restores pages and prefills no more than the float leg."""
    jm, tm = make_pair(seed=8)
    kv_dtype, num_pages, tier = {
        "float32": ("float32", 10, 0),          # whales fill the pool
        "int8-same-bytes": ("int8", 30, 0),
        "int8-tier": ("int8", 10, 1 << 16)}[leg]
    je, want = _kvq_scenario(JServingEngine, JServingConfig, jm, kv_dtype,
                             num_pages, tier, {"enable_tracing": False})
    # the engine's metrics start from 0 at its construction
    ref_prefill = monitor.stat_get("serving_prefill_tokens_total", 0)
    te, got = _kvq_scenario(ServingEngine, ServingConfig, tm, kv_dtype,
                            num_pages, tier, {})
    assert got == want
    c, jc = te.counters, je.cache
    assert (c.prefill_tokens, c.prefix_evictions, c.host_tier_spills,
            c.host_tier_restores, c.host_tier_hits) == (
        ref_prefill, jc.evictions, jc.spills, jc.restores, jc.host_tier_hits)
    if leg == "float32":
        assert c.prefix_evictions > 0 and c.host_tier_restores == 0
    if leg == "int8-tier":
        assert c.host_tier_restores > 0 and c.host_tier_pages > 0
    te.cache.check_invariants()


def test_restore_failure_retires_the_request_failed(monkeypatch):
    """A system prefix spilled by two whales, then asked for again while
    the copy back to the device fails: that request is retired FAILED,
    its tier entries dropped, and the request behind it is served."""
    _, tm = make_pair(seed=8)
    te = ServingEngine(tm, ServingConfig(
        max_batch=2, num_pages=10, page_size=4, max_prompt_len=16,
        kv_dtype="int8", host_tier_bytes=1 << 16), device="cpu")
    rng = np.random.default_rng(9)
    system = rng.integers(1, 97, 8)
    te.add_request(np.concatenate([system, [5, 6, 7]]).astype(np.int32), 4)
    te.run()
    for _ in range(2):
        te.add_request(rng.integers(1, 97, 14).astype(np.int32), 4)
    te.run()
    key = (0, tuple(int(t) for t in system[:4]))
    assert te.cache.host_tier.get(key, touch=False) is not None

    def broken(pages, entries):
        raise RuntimeError("copy to the card failed")

    monkeypatch.setattr(te.cache, "_write_pages", broken)
    rid = te.add_request(np.concatenate([system, [7, 8, 9]]).astype(np.int32),
                         4)
    other = te.add_request(np.arange(1, 12, dtype=np.int32), 4)
    done = te.run()
    assert set(done) == {other} and set(te.failed) == {rid}
    assert "copy to the card failed" in str(te.failed[rid])
    assert te.counters.failed == 1 and te.counters.host_tier_restores == 0
    assert te.cache.host_tier.get(key, touch=False) is None  # dropped
    te.cache.check_invariants()
    assert te.cache.allocator.pages_in_use == 0


@pytest.mark.parametrize("kw,match", [
    (dict(kv_dtype="int4"), "kv_dtype"),
    (dict(host_tier_bytes=-1), "host_tier_bytes"),
    (dict(host_tier_bytes=1 << 20, enable_prefix_caching=False),
     "enable_prefix_caching")])
def test_config_validation(kw, match):
    with pytest.raises(ValueError, match=match):
        ServingConfig(**kw)
