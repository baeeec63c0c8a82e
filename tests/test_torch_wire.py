"""The port's fleet currency against the JAX package's: the
``paddle-tpu/wire/v1`` codec (``serving/wire.py``), the prefix digests and
chains of the paged cache, and the seeded lossy channel and transport
(``serving/channel.py``).

- Every frame kind is byte for byte the reference's on the same inputs
  (float32 and int8 pages, with and without the span tail; digests;
  re-home records), and each package's ``decode_frame`` reads the other's.
- Truncated, corrupt and bad-version frames raise the same ``WireError``
  kind in both, over a seeded set of mutations.
- bfloat16 pages (the port's tag 2) round-trip bit for bit; the
  reference reads them as corrupt.
- ``prefix_digest``, ``gossip_digests`` (device index and host tier) and
  the exported prefix chains are equal on two engines served in lockstep.
- For a seed, ``SimChannel``'s fates (drop, corrupt, duplicate, reorder)
  are equal frame by frame, and ``Transport``'s exchanges, retries,
  breaker transitions and timeline equal the reference's under the same
  fault schedule.
"""
import numpy as np
import pytest
import torch

from paddle_tpu.serving import channel as jch
from paddle_tpu.serving import wire as jw
from paddle_tpu.serving.faults import FaultInjector as JFaultInjector
from paddle_tpu.serving.kv_cache import SpilledPage as JSpilledPage
from paddle_tpu.serving.kv_cache import prefix_digest as j_prefix_digest
from paddle_tpu_torch.serving import channel as tch
from paddle_tpu_torch.serving import wire as tw
from paddle_tpu_torch.serving.faults import FaultInjector
from paddle_tpu_torch.serving.kv_cache import SpilledPage, prefix_digest
from test_torch_engine_features import Twin, prompts


def _pages(seed, quantized, layers=2, ps=4, heads=2, hd=8):
    """(reference page, port page) with the same key, serial and planes."""
    rng = np.random.default_rng(seed)
    shape = (layers, ps, heads, hd)
    if quantized:
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
        ks = rng.random((layers, heads)).astype(np.float32)
        vs = rng.random((layers, heads)).astype(np.float32)
    else:
        k = rng.standard_normal(shape).astype(np.float32)
        v = rng.standard_normal(shape).astype(np.float32)
        ks = vs = None
    key = (int(rng.integers(0, 1 << 40)), tuple(int(t) for t in
                                                 rng.integers(0, 50000, ps)))
    serial = int(rng.integers(1, 1 << 50))
    ref = JSpilledPage(key=key, serial=serial, k=k, v=v, k_scale=ks,
                       v_scale=vs)
    port = SpilledPage(
        key=key, serial=serial, k=torch.from_numpy(k.copy()),
        v=torch.from_numpy(v.copy()),
        k_scale=None if ks is None else torch.from_numpy(ks.copy()),
        v_scale=None if vs is None else torch.from_numpy(vs.copy()))
    return ref, port


def _same_page(a, b):
    """A reference-side and a port-side page hold the same key, serial and
    bytes (either may be numpy or torch)."""
    as_np = (lambda t: None if t is None else
             (t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)))
    assert tuple(a.key[1]) == tuple(b.key[1]) and a.key[0] == b.key[0]
    assert a.serial == b.serial
    for x, y in ((a.k, b.k), (a.v, b.v), (a.k_scale, b.k_scale),
                 (a.v_scale, b.v_scale)):
        x, y = as_np(x), as_np(y)
        assert (x is None) == (y is None)
        if x is not None:
            assert x.dtype == y.dtype and x.shape == y.shape
            assert x.tobytes() == y.tobytes()


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("span", [None, 0xDEADBEEF12345678])
def test_page_frames_byte_identical_both_ways(quantized, span):
    ref, port = _pages(11, quantized)
    jframe = jw.encode_page(ref, span=span)
    tframe = tw.encode_page(port, span=span)
    assert tframe == jframe
    kind, value, got_span = tw.decode_frame_span(jframe)
    assert kind == "page" and got_span == span
    _same_page(ref, value)
    jkind, jvalue = jw.decode_frame(tframe)
    assert jkind == "page"
    _same_page(jvalue, port)


@pytest.mark.parametrize("span", [None, 7])
def test_digest_and_rehome_frames_byte_identical(span):
    digests = {3, 1 << 63, 12345678901234567, 0}
    assert tw.encode_digests(digests, span=span) == \
        jw.encode_digests(digests, span=span)
    assert tw.decode_frame(jw.encode_digests(digests)) == \
        ("digests", frozenset(digests))
    prompt = np.array([5, 0, 96, 1 << 20], np.int32)
    for deadline, tenant in ((None, "default"), (123.25, "interactive")):
        args = (9001, prompt, 7, deadline, tenant)
        jf = jw.encode_rehome(*args, span=span)
        assert tw.encode_rehome(*args, span=span) == jf
        kind, rec = tw.decode_frame(jf)
        jkind, jrec = jw.decode_frame(tw.encode_rehome(*args, span=span))
        assert kind == jkind == "rehome"
        for r in (rec, jrec):
            assert (r.rid, r.max_new_tokens, r.deadline, r.tenant) == \
                (9001, 7, deadline, tenant)
            np.testing.assert_array_equal(r.prompt, prompt)


def test_bfloat16_pages_round_trip_in_the_port_only():
    rng = np.random.default_rng(4)
    k = torch.from_numpy(rng.standard_normal((2, 4, 2, 8))
                         .astype(np.float32)).to(torch.bfloat16)
    page = SpilledPage(key=(0, (1, 2, 3, 4)), serial=5, k=k, v=-k)
    frame = tw.encode_page(page)
    _, got = tw.decode_frame(frame)
    assert got.k.dtype == torch.bfloat16
    assert torch.equal(got.k.view(torch.int16), k.view(torch.int16))
    assert torch.equal(got.v.view(torch.int16), (-k).view(torch.int16))
    with pytest.raises(jw.WireError) as e:
        jw.decode_frame(frame)
    assert e.value.kind == "corrupt"  # the reference knows tags 0 and 1
    with pytest.raises(ValueError, match="unsupported page dtype"):
        tw.encode_page(SpilledPage(key=(0, (1,)), serial=1,
                                   k=k.half(), v=k.half()))


def _kind(decode, buf):
    try:
        decode(buf)
    except Exception as e:  # noqa: BLE001 — the kind is what is compared
        assert isinstance(e, (jw.WireError, tw.WireError)), type(e)
        return e.kind
    return None


def test_error_kinds_equal_over_seeded_mutations():
    """Cuts, flips, bad magic and version bytes, trailing bytes and
    foreign objects: both decoders raise the same kind, or both decode."""
    ref, _ = _pages(2, True)
    frames = [jw.encode_page(ref), jw.encode_digests({1, 2, 3}),
              jw.encode_rehome(4, np.arange(3), 2, None, "t")]
    rng = np.random.default_rng(0)
    cases = [b"", b"PTWR", 123]
    for f in frames:
        cases += [f[:n] for n in (0, 5, 11, len(f) // 2, len(f) - 1)]
        cases += [b"XXXX" + f[4:], f[:4] + bytes([2]) + f[5:], f + b"\0"]
        for _ in range(40):
            at = int(rng.integers(0, len(f)))
            cases.append(f[:at] + bytes([f[at] ^ int(rng.integers(1, 256))])
                         + f[at + 1:])
    kinds = set()
    for buf in cases:
        jk, tk = _kind(jw.decode_frame, buf), _kind(tw.decode_frame, buf)
        assert tk == jk, buf[:16]
        kinds.add(tk)
    assert {"truncated", "corrupt", "bad_version"} <= kinds
    assert tw.WIRE_ERROR_KINDS == jw.WIRE_ERROR_KINDS


# ---------------------------------------------------------------- digests
def test_prefix_digest_equal():
    rng = np.random.default_rng(5)
    for n in (0, 3, 4, 17, 64):
        toks = rng.integers(0, 50304, n)
        for ps in (4, 16):
            assert prefix_digest(toks, ps) == j_prefix_digest(toks, ps)


def test_gossip_digests_and_exported_chains_equal_in_lockstep():
    """Two engines served in lockstep (a host tier small enough that
    prefix pages spill): the gossiped digest sets are equal after every
    step, count the same warm tokens as ``cached_prefix_tokens``, and the
    exported chains carry the same keys and serials with pools within
    float32 rounding; a chain imported into a fresh cache's tier restores
    in both as a host-tier hit."""
    tw_ = Twin(wseed=3, max_batch=2, num_pages=12, page_size=4,
               max_prompt_len=24, host_tier_bytes=1 << 20)
    shared = prompts(21, (20, 22, 17), shared=16)
    for p in shared + prompts(22, (22, 22)):
        tw_.add(p, 3)
        for _ in range(40):
            tw_.step()
            j, t = tw_.j.cache, tw_.t.cache
            assert t.gossip_digests() == j.gossip_digests()
            if not tw_.t.scheduler.running and \
                    not tw_.t.scheduler.waiting:
                break
    j, t = tw_.j.cache, tw_.t.cache
    assert t.host_tier.bytes == j.host_tier.bytes > 0
    gossip = t.gossip_digests()
    n = 0
    for d in prefix_digest(shared[0], 4):
        if d not in gossip:
            break
        n += 1
    assert n * 4 == t.cached_prefix_tokens(shared[0]) == \
        j.cached_prefix_tokens(shared[0]) > 0
    jx, tx = j.export_prefix_chain(shared[0]), t.export_prefix_chain(shared[0])
    assert [(e.key, e.serial) for e in tx] == [(e.key, e.serial) for e in jx]
    for a, b in zip(jx, tx):
        np.testing.assert_allclose(b.k.numpy(), np.asarray(a.k), atol=1e-5)
        np.testing.assert_allclose(b.v.numpy(), np.asarray(a.v), atol=1e-5)
    # the chain over the wire into a cold engine's tier, in both packages
    cold = Twin(wseed=3, max_batch=2, num_pages=12, page_size=4,
                max_prompt_len=24, host_tier_bytes=1 << 20)
    frames = [tw.encode_page(e) for e in reversed(tx)]  # any order
    assert cold.t.cache.import_spilled_chain(
        [tw.decode_frame(f)[1] for f in frames]) == len(tx)
    assert cold.j.cache.import_spilled_chain(jx) == len(jx)
    assert cold.t.cache.gossip_digests() == cold.j.cache.gossip_digests()
    rid = cold.add(shared[0], 2)
    cold.run()
    assert cold.t.cache.host_tier_hits == cold.j.cache.host_tier_hits == 1
    assert cold.t.request(rid) is None  # finished on both
    with pytest.raises(ValueError, match="does not match this pool"):
        cold.t.cache.import_spilled_chain(
            [SpilledPage(key=(0, tx[0].key[1]), serial=1,
                         k=tx[0].k.to(torch.int8), v=tx[0].v.to(torch.int8))])


# ------------------------------------------------------- channel, transport
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_sim_channel_fates_equal_frame_by_frame(seed):
    cfg = dict(seed=seed, drop_rate=0.2, corrupt_rate=0.15, dup_rate=0.1,
               reorder_rate=0.3, latency_s=0.01, jitter_s=0.02)
    jc, tc = jch.SimChannel(jch.ChannelConfig(**cfg)), \
        tch.SimChannel(tch.ChannelConfig(**cfg))
    frames = [jw.encode_digests({i, i + 1}) for i in range(12)]
    for peer in (0, 1, 2, 1):
        assert tc.transfer(peer, frames) == jc.transfer(peer, frames)
    for name in ("sent", "delivered", "dropped", "corrupted", "duplicated",
                 "reordered"):
        assert getattr(tc, name) == getattr(jc, name), name
    assert jc.dropped and jc.corrupted and jc.reordered
    assert [tch.unit_hash(seed, i, 3) for i in range(5)] == \
        [jch.unit_hash(seed, i, 3) for i in range(5)]


def test_transport_exchanges_equal_under_faults():
    """Retries with jittered backoff, hedged reads, every wire fault point
    and a peer timed out until its breaker opens, half-opens and closes:
    the values decoded, the accounting of every exchange and the breaker
    timeline equal the reference's."""
    def build(ch, inj_cls):
        inj = inj_cls()
        inj.arm("wire_drop", step=1).arm("wire_corrupt", step=2)
        inj.arm("wire_delay", step=3, delay_s=1.0)
        inj.arm("peer_timeout", rid=2, times=8)
        t = ch.Transport(ch.SimChannel(ch.ChannelConfig(
            seed=3, drop_rate=0.1, corrupt_rate=0.1, dup_rate=0.1,
            reorder_rate=0.2, latency_s=0.005, jitter_s=0.01)),
            ch.TransportConfig(seed=3, timeout_s=0.05, retries=2,
                               breaker_threshold=2, breaker_reset_s=0.2))
        return t.attach(injector=inj)

    jt, tt = build(jch, JFaultInjector), build(tch, FaultInjector)
    ref, _ = _pages(1, False)
    frames = [jw.encode_page(ref), jw.encode_digests({1, 2})]
    for step in range(12):
        for peer in (0, 2):
            hedge = step % 3 == 0
            got_j = jt.exchange(peer, frames, step=step, rid=None,
                                hedge=hedge)
            got_t = tt.exchange(peer, frames, step=step, rid=None,
                                hedge=hedge)
            assert (got_j is None) == (got_t is None)
            if got_j is not None:
                assert [k for k, _ in got_t] == [k for k, _ in got_j]
            a, b = jt.last, tt.last
            assert (b.ok, b.retries, b.timeouts, b.corrupt, b.hedge_win,
                    b.breaker_open, b.attempts, b.tx_bytes, b.rx_bytes) == \
                (a.ok, a.retries, a.timeouts, a.corrupt, a.hedge_win,
                 a.breaker_open, a.attempts, a.tx_bytes, a.rx_bytes)
            assert (b.latency_s, b.backoff_s, b.t_start, b.t_end) == \
                (a.latency_s, a.backoff_s, a.t_start, a.t_end)
    assert tt.breaker_events == jt.breaker_events
    assert {s for _, _, s in tt.breaker_events} == \
        {"open", "half_open", "closed"}
    assert (tt.retries_total, tt.timeouts_total, tt.corrupt_total,
            tt.hedge_wins_total) == (jt.retries_total, jt.timeouts_total,
                                     jt.corrupt_total, jt.hedge_wins_total)
    assert tt.retries_total and tt.corrupt_total
    assert [tt.backoff_for(p, k) for p in (0, 1) for k in (1, 2, 3)] == \
        [jt.backoff_for(p, k) for p in (0, 1) for k in (1, 2, 3)]
