"""The port's engine with the observability layer on, in lockstep with the
JAX engine: tracing, journeys, tenants, watchdogs, the step timeline's
phase attribution, the ``serving_*`` metrics and the SLO chunk-admission
controller — the counterparts of ``tests/test_obs*.py`` and the SLO cases
of ``tests/test_serving_chunked.py``.

Each scenario is an :class:`ObsTwin`: the ``Twin`` of
``test_torch_engine_features.py`` (same weights, configuration, request
ids and fault schedule) with tracing on in both engines and each engine
on its own :class:`VirtualClock`, the reference's test clock that moves
1.0 s at every read. Phase times, trace stamps, histogram buckets and so
the SLO controller's decisions depend on which clock reads happen in which
order, so equal values mean the port reads its clock at the reference's
points. After every step the trace events of every request, the newest
``StepRecord`` (``phase_s`` included), the ``serving_*`` snapshot (less
``REFERENCE_ONLY``) and the journeys must be equal; at the end the
tenant report and the alerts too.
"""
import dataclasses
import json

import numpy as np
import pytest

from paddle_tpu.obs import TenantSLO as JTenantSLO
from paddle_tpu.obs import WatchdogConfig as JWatchdogConfig
from paddle_tpu.obs import validate_flight_record as j_validate_flight_record
from paddle_tpu.obs import validate_journey as j_validate_journey
from paddle_tpu.serving.slo import SLOConfig as JSLOConfig
from paddle_tpu.utils import monitor as jmonitor
from paddle_tpu_torch.obs import (TenantSLO, WatchdogConfig,
                                  validate_flight_record, validate_journey)
from paddle_tpu_torch.serving import ServingConfig, ServingEngine
from paddle_tpu_torch.serving.scheduler import Scheduler
from paddle_tpu_torch.serving.slo import SLOConfig
from paddle_tpu_torch.utils import monitor
from test_torch_engine_features import BASE, SAMPLE, Twin, prompts
from test_torch_gpt import make_pair

#: reference gauges the port does not hold equal, each with its reason
REFERENCE_ONLY = {
    # a rate over the host's perf_counter, not the engine clock: it
    # differs between any two runs of one engine
    "serving_tokens_per_sec":
        "windowed tokens/s on the host's perf_counter",
    # the reference publishes its TPU kernel bank's predictions
    # (profiles/kernelcheck.json); the port does not read that bank
    "serving_kernel_speedup_predicted":
        "the reference's TPU kernel bank",
    "serving_kernel_speedup_measured": "the reference's TPU kernel bank",
    "serving_kernel_speedup_drift": "the reference's TPU kernel bank",
}


class VirtualClock:
    """The reference's obs test clock: 1.0 s per read, so phase sums are
    exact float arithmetic."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


def _kept(snapshot: dict) -> dict:
    return {k: v for k, v in snapshot.items()
            if k.split("{")[0] not in REFERENCE_ONLY}


def _events(trace):
    return [(e.name, e.t, dict(e.args or {})) for e in trace.events]


class ObsTwin(Twin):
    """A Twin with the observability layer on in both engines, each on
    its own VirtualClock. ``tenants``: {name: (ttft_p99_s, tpot_p99_s)};
    ``slo``: SLOConfig fields; ``watchdog``: WatchdogConfig fields;
    ``dumps``: a (JAX, port) pair of ``flight_record_path``s."""

    def __init__(self, tenants=None, slo=None, watchdog=None, dumps=None,
                 **cfg):
        sides = ({}, {})
        if dumps is not None:
            sides[0]["flight_record_path"] = str(dumps[0])
            sides[1]["flight_record_path"] = str(dumps[1])
        if tenants is not None:
            sides[0]["tenants"] = {k: JTenantSLO(*v)
                                   for k, v in tenants.items()}
            sides[1]["tenants"] = {k: TenantSLO(*v)
                                   for k, v in tenants.items()}
        if slo is not None:
            sides[0]["slo"], sides[1]["slo"] = JSLOConfig(**slo), \
                SLOConfig(**slo)
        if watchdog is not None:
            sides[0]["watchdog"] = JWatchdogConfig(**watchdog)
            sides[1]["watchdog"] = WatchdogConfig(**watchdog)
        super().__init__(clocks=(VirtualClock(), VirtualClock()),
                         sides=sides, enable_tracing=True, **cfg)
        self.limits = []  # the SLO controller's chunk_limit, step by step

    def check(self) -> None:
        super().check()
        j, t = self.j, self.t
        for rid in self.rids:
            jt, tt = j.trace(rid), t.trace(rid)
            assert (jt is None) == (tt is None), rid
            if jt is not None:
                assert _events(tt) == _events(jt), rid
            jj, tj = j.journey(rid), t.journey(rid)
            if jj is not None:
                assert tj.to_wire() == jj.to_wire(), rid
        jr, tr = j.timeline.last, t.timeline.last
        assert (jr is None) == (tr is None)
        if jr is not None:
            assert dataclasses.asdict(tr) == dataclasses.asdict(jr)
            assert sum(tr.phase_s.values()) == tr.t_end - tr.t_start
        assert _kept(t.metrics.snapshot()) == _kept(j.metrics.snapshot())
        if j._slo is not None:
            assert t._slo.chunk_limit == j._slo.chunk_limit
            assert t._slo.degraded == j._slo.degraded
            self.limits.append(t._slo.chunk_limit)

    def finish(self) -> None:
        """The end-of-run surfaces: tenant report, alerts, the journey
        book, the Chrome trace; each journey validates under the other
        package's gate."""
        j, t = self.j, self.t
        assert t.tenant_report() == j.tenant_report()
        assert [a.asdict() for a in t.alerts()] == \
            [a.asdict() for a in j.alerts()]
        assert [x.to_wire() for x in t.journeys()] == \
            [x.to_wire() for x in j.journeys()]
        assert t.export_chrome_trace() == j.export_chrome_trace()
        for x in t.journeys():
            j_validate_journey(x.to_wire())
        for x in j.journeys():
            validate_journey(x.to_wire())


def _counters_match_metrics(engine) -> None:
    """EngineCounters against the ``serving_*`` counters they mirror."""
    c, s = engine.counters, engine.metrics.snapshot()
    pairs = {"prefills": "prefills_total",
             "prefill_chunks": "prefill_chunks_total",
             "prefill_tokens": "prefill_tokens_total",
             "decode_steps": "decode_steps", "tokens": "tokens_total",
             "preemptions": "preemptions_total", "swaps_out": "swap_outs",
             "swaps_in": "swap_ins",
             "prefix_hit_tokens": "prefix_tokens_saved",
             "shed": "shed", "rejected": "rejected", "expired": "expired",
             "cancelled": "cancelled", "failed": "failed",
             "spec_proposed": "spec_proposed_tokens_total",
             "spec_accepted": "spec_accepted_tokens_total",
             "kv_bytes_per_token": "kv_bytes_per_token",
             "prefix_evictions": "prefix_evictions",
             "host_tier_pages": "host_tier_pages",
             "host_tier_bytes": "host_tier_bytes",
             "host_tier_hits": "host_tier_hits_total",
             "host_tier_spills": "host_tier_spills_total",
             "host_tier_restores": "host_tier_restores_total"}
    assert {k: getattr(c, k) for k in pairs} == \
        {k: s["serving_" + v] for k, v in pairs.items()}


TENANTS = {"interactive": (30.0, 5.0), "batch": (1e6, 1e6)}


# ------------------------------------------------------------- scenarios
@pytest.mark.parametrize("chunk", [0, 4])
def test_obs_lockstep_tenants_prefix_and_chunks(chunk):
    """Two tenants (one with tight targets, so some retirements are late)
    over shared prefixes, whole or chunked prefill, sampled."""
    tw = ObsTwin(wseed=1, tenants=TENANTS, chunk_size=chunk, **SAMPLE,
                 **BASE)
    ps = prompts(2, (20, 10, 13, 17, 9), shared=8)
    for i, p in enumerate(ps):
        tw.add(p, 4 + i, tenant=("interactive", "batch", "adhoc")[i % 3])
    tw.run()
    tw.finish()
    rep = tw.t.tenant_report()
    assert set(rep) == {"default", "interactive", "batch", "adhoc"}
    late = sum(e["retired"]["ttft_late"] + e["retired"]["tpot_late"]
               for e in rep.values())
    assert late > 0
    snap = tw.t.metrics.snapshot()
    assert sum(e["goodput_tokens"] + e["badput_tokens"]
               for e in rep.values()) == snap["serving_tokens_total"]
    assert snap["serving_step_phase_s_count{phase=admit}"] > 0
    _counters_match_metrics(tw.t)
    tw.drained()


@pytest.mark.parametrize("mode", ["recompute", "swap"])
def test_obs_lockstep_preemption(mode):
    """A pool small enough to preempt: the preempted / swap_out / swap_in
    / resumed events, the evict and swap phases, replayed tokens in the
    tenant ledger (goodput + badput = serving_tokens_total)."""
    tw = ObsTwin(wseed=3, preemption_mode=mode, tenants=TENANTS,
                 **dict(BASE, num_pages=12,
                        chunk_size=8 if mode == "swap" else 0))
    for i, p in enumerate(prompts(4, (9, 14, 7, 11))):
        tw.add(p, 10, tenant="batch" if i % 2 else "interactive")
    tw.run()
    tw.finish()
    c = tw.t.counters
    assert c.preemptions > 0
    names = {e.name for tr in tw.t.traces() for e in tr.events}
    assert "preempted" in names
    assert ("swap_in" in names) == (mode == "swap")
    rep = tw.t.tenant_report()
    assert sum(e["goodput_tokens"] + e["badput_tokens"]
               for e in rep.values()) == c.tokens
    _counters_match_metrics(tw.t)
    tw.drained()


def test_obs_lockstep_ngram_speculation():
    """n-gram speculation: spec_verify events, verify phases, the accepted
    count on each StepRecord, decode marks every 4 tokens."""
    tw = ObsTwin(wseed=5, spec=dict(method="ngram", depth=3),
                 decode_mark_every=4, **BASE)
    rep = np.tile(np.arange(1, 5, dtype=np.int32), 4)
    for p in (rep, prompts(6, (9,))[0], rep[:10]):
        tw.add(p, 12)
    tw.run()
    tw.finish()
    c = tw.t.counters
    assert c.verify_steps > 0 and c.spec_accepted > 0
    assert any(r.accepted for r in tw.t.timeline.records())
    assert any(e.name == "decode_mark" for tr in tw.t.traces()
               for e in tr.events)
    _counters_match_metrics(tw.t)
    tw.drained()


def test_obs_lockstep_shed_expired_cancelled():
    """The non-finished retirements: shed from a full queue, expired by
    its deadline, cancelled mid-prefill — each a tenant-ledger class."""
    tw = ObsTwin(wseed=6, tenants=TENANTS, max_waiting=2,
                 shed_policy="shed-oldest",
                 **dict(BASE, max_batch=1, chunk_size=4))
    ps = prompts(7, (12, 6, 7, 5, 8))
    r0 = tw.add(ps[0], 4, tenant="interactive")
    tw.step()
    r1 = tw.add(ps[1], 3, tenant="batch", deadline_s=3.0)
    tw.add(ps[2], 3)
    tw.add(ps[3], 3, tenant="batch")  # sheds r1, the oldest newcomer
    assert tw.t.status(r1) == "shed"
    r4 = tw.add(ps[4], 3, deadline_s=2.0, tenant="interactive")
    tw.step()
    assert tw.t.cancel(r0) and tw.j.cancel(r0)
    tw.check()
    tw.run()
    tw.finish()
    assert tw.t.status(r4) == "expired"
    classes = {c for e in tw.t.tenant_report().values()
               for c, n in e["retired"].items() if n}
    assert {"shed", "expired", "cancelled"} <= classes
    _counters_match_metrics(tw.t)
    tw.drained()


def test_obs_lockstep_restore_fail_dumps_flight_record(tmp_path):
    """A failed host-tier restore retires the request FAILED and the step
    dumps the flight record automatically, to ``flight_record_path`` too;
    each package's dump validates under the other's gate."""
    jpath, tpath = tmp_path / "jax.json", tmp_path / "port.json"
    tw = ObsTwin(wseed=8, arms=[dict(point="restore_fail")], max_batch=2,
                 num_pages=10, page_size=4, max_prompt_len=16,
                 kv_dtype="int8", host_tier_bytes=1 << 16,
                 dumps=(jpath, tpath))
    rng = np.random.RandomState(5)
    system = rng.randint(1, 97, (8,))
    warm = [np.concatenate([system, rng.randint(1, 97, (3,))])
            .astype(np.int32) for _ in range(2)]
    whales = [rng.randint(1, 97, (14,)).astype(np.int32) for _ in range(2)]
    tw.add(warm[0], 4)
    tw.run()
    for p in whales:  # evict the system prefix into the tier
        tw.add(p, 4)
    tw.run()
    assert tw.t.last_flight_record is None
    r = tw.add(warm[1], 4)
    tw.run()
    tw.finish()
    assert tw.t.status(r) == "failed"
    rec = tw.t.last_flight_record
    assert rec["reason"] == "request-failure"
    events = [e.name for e in tw.t.trace(r).events]
    assert events[-1] == "retired" and "admitted" not in events
    port_dump, jax_dump = (json.loads(p.read_text()) for p in (tpath, jpath))
    j_validate_flight_record(port_dump)
    validate_flight_record(jax_dump)
    assert _kept(port_dump["gauges"]) == _kept(jax_dump["gauges"])
    for key in ("steps", "alerts", "requests", "tenants", "journeys",
                "step", "dumped_at", "reason", "config"):
        assert port_dump[key] == jax_dump[key], key
    tw.drained()


def test_obs_lockstep_slo_controller_and_head_skip_limit():
    """The SLO controller under a target the virtual clock always
    breaches: equal chunk_limit step by step (halved to 1, then held), and
    while degraded admission prefers warm prefix-cache waiters — 16 warm
    newcomers jump a cold head, then the head is admitted by force
    (``HEAD_SKIP_LIMIT``), in the same order in both engines."""
    tw = ObsTwin(wseed=9, slo=dict(ttft_p99_s=1.0, tpot_p99_s=0.5,
                                   window_steps=2),
                 **dict(BASE, num_pages=64, chunk_size=4))
    rng = np.random.default_rng(11)
    system = rng.integers(1, 97, 8).astype(np.int32)
    tw.add(np.concatenate([system, [5, 6]]).astype(np.int32), 3)
    tw.run()
    assert tw.t._slo.degraded
    cold = tw.add(rng.integers(1, 97, 20).astype(np.int32), 1)
    warm = [tw.add(np.concatenate([system, rng.integers(1, 97, 2)])
                   .astype(np.int32), 1)
            for _ in range(Scheduler.HEAD_SKIP_LIMIT + 2)]
    tw.run()
    tw.finish()

    def admit_order(engine):
        stamps = {rid: next(e.t for e in engine.trace(rid).events
                            if e.name == "admitted")
                  for rid in [cold] + warm}
        return sorted(stamps, key=stamps.get)

    order = admit_order(tw.t)
    assert order == admit_order(tw.j)
    assert order.index(cold) == Scheduler.HEAD_SKIP_LIMIT
    assert order[:Scheduler.HEAD_SKIP_LIMIT] == \
        warm[:Scheduler.HEAD_SKIP_LIMIT]
    assert 1 in tw.limits and tw.limits[0] > 1
    snap = tw.t.metrics.snapshot()
    assert snap["serving_slo_throttles_total"] >= 1
    assert snap["serving_chunk_limit"] == tw.t._slo.chunk_limit
    tw.drained()


def test_cached_prefix_tokens_matches_reference():
    """``PagedKVCache.cached_prefix_tokens`` on the same pool: device-index
    hits, the host tier's continuation, misses — and the probe moves no
    refcount and no tier LRU order."""
    tw = Twin(wseed=8, max_batch=2, num_pages=10, page_size=4,
              max_prompt_len=16, host_tier_bytes=1 << 16)
    rng = np.random.RandomState(5)
    system = rng.randint(1, 97, (12,)).astype(np.int32)
    tw.add(np.concatenate([system, [3, 4]]).astype(np.int32), 2)
    tw.run()
    probes = [system, system[:9], np.concatenate([system, [3, 4, 9, 9]]),
              rng.randint(1, 97, (12,)), system[:3]]

    def probe_all():
        jc, tc = tw.j.cache, tw.t.cache
        ref = [jc.cached_prefix_tokens(p) for p in probes]
        assert [tc.cached_prefix_tokens(p) for p in probes] == ref
        return ref

    assert probe_all()[0] == 12
    for p in [rng.randint(1, 97, (14,)).astype(np.int32) for _ in range(2)]:
        tw.add(p, 4)  # evict the system prefix into the tier
    tw.run()
    tier = list(tw.t.cache.host_tier._entries)
    refs = dict(tw.t.cache.allocator._ref)
    assert tw.t.cache.spills > 0 and probe_all()[0] > 0
    assert list(tw.t.cache.host_tier._entries) == tier
    assert tw.t.cache.allocator._ref == refs


# ----------------------------------------------- surfaces on the port alone
def _engine(**kw):
    _, tm = make_pair(seed=2)
    cfg = dict(BASE, **kw)
    return ServingEngine(tm, ServingConfig(**cfg), device="cpu",
                         clock=VirtualClock())


@pytest.mark.parametrize("counter,rule", [
    ("serving_analysis_retraces_total", "retrace_after_warmup"),
    ("serving_pallas_fallback_total", "pallas_fallback")])
def test_quiet_rules_fire_when_their_counter_is_bumped(counter, rule):
    """The port never bumps the retrace and kernel-fallback counters, so
    their rules stay quiet; bumped by hand after the warmup window, each
    fires once (edge-triggered) and counts in serving_alerts_total."""
    te = _engine(watchdog=WatchdogConfig(warmup_steps=2))
    for p in prompts(3, (6, 7)):
        te.add_request(p, 6)
    for _ in range(3):
        te.step()
    assert te.alerts() == []
    monitor.stat_set(counter, 1)
    te.run()
    fired = [a.rule for a in te.alerts()]
    assert fired == [rule]
    assert te.metrics.snapshot()[f"serving_alerts_total{{rule={rule}}}"] \
        == 1


def test_engine_fatal_flushes_partial_step_and_dumps(monkeypatch):
    """An exception escaping the step: the open step is flushed as a
    partial StepRecord naming the fatal, the flight record dumps, and the
    exception is re-raised."""
    te = _engine()
    te.add_request(prompts(3, (6,))[0], 4)
    te.step()

    def boom(*a, **k):
        raise RuntimeError("device lost")

    monkeypatch.setattr(te, "_decode", boom)
    with pytest.raises(RuntimeError, match="device lost"):
        te.step()
    last = te.timeline.last
    assert last.extra == {"fatal": "RuntimeError: device lost"}
    assert sum(last.phase_s.values()) == last.t_end - last.t_start
    rec = te.last_flight_record
    assert rec["reason"] == "engine-fatal: RuntimeError"
    assert rec["steps"][-1]["extra"]["fatal"].startswith("RuntimeError")
    validate_flight_record(rec)


def test_stuck_engine_backstop_dumps():
    te = _engine(max_batch=1)
    te.add_request(prompts(3, (6,))[0], 20)
    with pytest.raises(RuntimeError, match="exceeded 3 steps"):
        te.run(max_steps=3)
    assert te.last_flight_record["reason"] == "stuck-engine"


def test_tracing_off_surfaces_are_empty_and_metrics_still_count():
    """enable_tracing=False: no trace, journey, timeline or tenant report
    (the reference's obs-off contract), the metrics still count, and the
    outputs are the traced engine's."""
    outs = []
    for tracing in (True, False):
        te = _engine(enable_tracing=tracing)
        rids = [te.add_request(p, 5, tenant="batch")
                for p in prompts(3, (6, 9))]
        out = te.run()
        outs.append([out[r].tolist() for r in rids])
        snap = te.metrics.snapshot()
        assert snap["serving_tokens_total"] == 10
        assert snap["serving_tenant_goodput_tokens_total{tenant=batch}"] \
            == (10 if tracing else 0)
    assert outs[0] == outs[1]
    assert te.trace(rids[0]) is None and te.journey(rids[0]) is None
    assert te.timeline is None and te.tenant_report() is None
    assert te.journeys() == [] and te.alerts() == []
    with pytest.raises(ValueError, match="tracing"):
        ServingConfig(**dict(BASE, chunk_size=4, enable_tracing=False),
                      slo=SLOConfig(tpot_p99_s=1.0))


def test_two_engines_share_the_process_registry():
    """monitor is process-global, as in the reference: building a second
    engine resets the serving_* names the first one wrote."""
    a = _engine()
    a.add_request(prompts(3, (6,))[0], 3)
    a.run()
    assert monitor.stat_get("serving_tokens_total") == 3
    _engine()
    assert monitor.stat_get("serving_tokens_total") == 0
    assert a.counters.tokens == 3  # the engine's own counters stay
    assert jmonitor is not monitor  # the reference's registry is its own


def test_prometheus_text_scrape_parses():
    from test_torch_obs import scrape_parse

    te = _engine(tenants={"batch": TenantSLO(1e6, 1e6)})
    te.add_request(prompts(3, (6,))[0], 4, tenant="batch")
    te.run()
    text = te.metrics.prometheus()
    typed = scrape_parse(text)
    assert typed["serving_tenant_retired_total"] == "counter"
    assert typed["serving_step_phase_s"] == "histogram"
    assert 'serving_tenant_retired_total{class="in_slo",tenant="batch"} 1' \
        in text

