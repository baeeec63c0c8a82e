"""The port's observability modules (``paddle_tpu_torch.obs``,
``paddle_tpu_torch.utils.monitor``, ``serving/metrics.py`` and
``serving/slo.py``) against the JAX package's, module by module.

Every test feeds the same inputs — made from a seed with numpy — to the
reference module and to its port, and holds the results equal exactly:
these modules compute on host ints and floats only, in the same order.
Dumps cross over: a journey and a flight record written by either package
pass the other's ``validate_*``, and a corrupt record is refused by both
with the same message, naming the same field. The port's CLI is driven in
process for its exit codes.
"""
import dataclasses
import json
import re

import numpy as np
import pytest

import paddle_tpu.obs as jobs
from paddle_tpu.obs.__main__ import main as j_main
from paddle_tpu.serving import metrics as jmetrics
from paddle_tpu.serving import slo as jslo
from paddle_tpu.utils import monitor as jmonitor
import paddle_tpu_torch.obs as tobs
from paddle_tpu_torch.obs.__main__ import main as t_main
from paddle_tpu_torch.serving import metrics as tmetrics
from paddle_tpu_torch.serving import slo as tslo
from paddle_tpu_torch.utils import monitor as tmonitor

PACKAGES = {"jax": jobs, "port": tobs}


def both(fn):
    """``fn(obs_module)`` for the reference and the port."""
    return fn(jobs), fn(tobs)


# -------------------------------------------------------------- histogram
@pytest.mark.parametrize("seed", range(3))
def test_histogram_percentiles_equal(seed):
    rng = np.random.default_rng(seed)
    samples = np.exp(rng.normal(-3, 3, 500)).tolist() + [0.0, 1e4]
    qs = np.linspace(0, 1, 21).tolist() + [0.999]

    def run(o):
        h = o.Histogram("x", o.LATENCY_EDGES_S)
        for v in samples:
            h.observe(v)
        fam = o.HistogramFamily("serving_f", "phase", o.OCCUPANCY_EDGES,
                                values=("a", "b"))
        for i, v in enumerate(rng_copy(seed).integers(0, 300, 50)):
            fam.observe("ab"[i % 2] if i % 3 else "c", float(v))
        return (h.counts, h.count, h.sum, [h.percentile(q) for q in qs],
                h.snapshot(), h.cumulative_buckets(),
                {k: (c.name, c.counts) for k, c in fam.children().items()},
                o.split_labels("serving_a{x=1,y=2}"))

    j, t = both(run)
    assert t == j


def rng_copy(seed):
    return np.random.default_rng(seed + 100)


def test_percentile_from_counts_equal():
    from paddle_tpu.obs.histogram import percentile_from_counts as jp
    from paddle_tpu_torch.obs.histogram import percentile_from_counts as tp

    rng = np.random.default_rng(7)
    edges = tobs.LATENCY_EDGES_S
    for _ in range(50):
        counts = rng.integers(0, 5, len(edges) + 1).tolist()
        for q in (0.0, 0.5, 0.9, 0.99, 1.0):
            assert tp(edges, counts, q) == jp(edges, counts, q)
    with pytest.raises(ValueError, match="outside"):
        tp(edges, [1] * (len(edges) + 1), 1.5)


# ---------------------------------------------------------------- monitor
def test_monitor_registry_equal():
    """The same operations on both registries, under a prefix no other
    test writes, leave equal values and views."""
    rng = np.random.default_rng(3)
    prefix = "obsparity_"
    ops = [(rng.choice(["add", "set", "max", "reset"]),
            f"{prefix}{rng.integers(0, 5)}", float(rng.integers(-3, 9)))
           for _ in range(200)]

    def run(m):
        out = []
        for op, name, v in ops:
            if op == "add":
                out.append(m.stat_add(name, v))
            elif op == "set":
                m.stat_set(name, v)
            elif op == "max":
                out.append(m.stat_max(name, v))
            else:
                m.stat_reset(name)
            out.append(m.stat_get(name, None))
        view = m.stats_with_prefix(prefix)
        with m.StatTimer(prefix + "timer"):
            pass
        out.append(m.stat_get(prefix + "timer_count"))
        for k in list(m.stats_with_prefix(prefix)):
            m.stat_reset(k)
        return out, view

    assert run(tmonitor) == run(jmonitor)
    assert tmonitor is not jmonitor


# ----------------------------------------------------------------- tracer
def _drive_tracer(o, seed, capacity=6, max_hops=8):
    """A random lifecycle stream through a Tracer with a JourneyBook on
    its journal: more requests than ``capacity`` (eviction) and more hops
    than ``max_hops`` (the cap)."""
    rng = np.random.default_rng(seed)
    t = [0.0]

    def clock():
        t[0] += float(rng.integers(1, 4))
        return t[0]

    step = [0]
    tr = o.Tracer(clock, capacity=capacity, mark_every=2)
    book = o.JourneyBook(lambda: step[0], capacity=capacity,
                         max_hops=max_hops)
    tr.journal = book.on_event
    live = []
    for rid in range(14):
        book.begin(rid, ("default", "batch")[rid % 2])
        tr.begin(rid)
        live.append(rid)
        for r in list(live):
            step[0] += 1
            for name, args in (("admitted", {"slot": 0, "cached_tokens": 4}),
                               ("prefill_start", {"tokens": 5, "cached": 4}),
                               ("prefill_chunk", {"start": 0, "tokens": 3}),
                               ("prefill_end", {"tokens": 5}),
                               ("first_token", {}),
                               ("decode_mark", {"tokens": 2}),
                               ("preempted", {"mode": "swap", "tokens": 2}),
                               ("spec_verify", {"proposed": 3,
                                                "accepted": 1})):
                if rng.random() < 0.4:
                    tr.event(r, name, **args)
            if rng.random() < 0.35:
                tr.event(r, "retired",
                         state=str(rng.choice(["finished", "cancelled",
                                               "failed", "expired"])),
                         tokens=int(rng.integers(0, 9)))
                live.remove(r)
    return tr, book


@pytest.mark.parametrize("seed", range(3))
def test_tracer_event_streams_equal(seed):
    def run(o):
        tr, _ = _drive_tracer(o, seed)
        return ([(x.rid, x.state, [(e.name, e.t, e.args) for e in x.events])
                 for x in tr.traces()], tr.summaries(), tr.evicted, len(tr))

    j, t = both(run)
    assert t == j
    assert t[2] > 0  # terminal traces were evicted


@pytest.mark.parametrize("seed", range(3))
def test_journey_book_eviction_and_hop_cap_equal(seed):
    def run(o):
        _, book = _drive_tracer(o, seed)
        return (book.wire_records(), book.wire_records(limit=3),
                book.evicted, [o.format_journey(w)
                               for w in book.wire_records()])

    j, t = both(run)
    assert t == j
    assert t[2] > 0 and any(w["dropped_hops"] for w in t[0])
    for w in t[0]:
        jobs.validate_journey(w)
        tobs.validate_journey(w)


# ----------------------------------------------------------------- tenant
def test_tenant_ledger_classifies_all_seven_classes():
    rng = np.random.default_rng(4)
    retirements = []
    for _ in range(120):
        tenant = str(rng.choice(["interactive", "batch", "default", "x"]))
        state = str(rng.choice(["finished"] * 4 + ["shed", "expired",
                                                   "cancelled", "failed"]))
        ttft = None if rng.random() < 0.1 else float(rng.uniform(0, 4))
        tpot = None if rng.random() < 0.1 else float(rng.uniform(0, 2))
        retirements.append((tenant, state, ttft, tpot,
                            int(rng.integers(0, 30))))

    def run(o):
        led = o.TenantLedger({"interactive": o.TenantSLO(1.0, 0.5),
                              "batch": o.TenantSLO(3.0, 1.5)})
        classes = [led.on_retire(*r) for r in retirements]
        fam = o.HistogramFamily("serving_ttft_s", "tenant")
        for tenant, _, ttft, *_ in retirements:
            if ttft is not None:
                fam.observe(tenant, ttft)
        rollup = led.rollup({"ttft_s": fam})
        return (classes, led.burn_totals(), led.token_totals(), rollup,
                led.tenants(), o.tenant_table(rollup))

    j, t = both(run)
    assert t == j
    assert set(t[0]) == set(tobs.TENANT_CLASSES)
    for bad in ("", "a b", "x,y", "t" * 65, 3):
        with pytest.raises(ValueError) as je:
            jobs.check_tenant_name(bad)
        with pytest.raises(ValueError) as te:
            tobs.check_tenant_name(bad)
        assert str(te.value) == str(je.value)


# --------------------------------------------------------------- watchdog
def _record(o, step, **kw):
    base = dict(step=step, t_start=float(step), t_end=step + 1.0,
                admitted=0, prefills=0, batch=0, finished=0, preemptions=0,
                queue_depth=0, pages_in_use=0)
    base.update(kw)
    return o.StepRecord(**base)


def _watchdog_feed(seed):
    """Per step (record fields, counters): every rule's onset, its quiet
    while the condition persists (latch) and a re-arm, in a random walk."""
    rng = np.random.default_rng(seed)
    tot = dict(retraces=0, fallbacks=0, proposed=0, accepted=0,
               evictions=0, spills=0)
    burn = {"a": [0, 0], "b": [0, 0]}
    feed = []
    for step in range(120):
        phase = (step // 20) % 2  # alternate bad and healthy stretches
        tot["retraces"] += int(rng.random() < 0.05)
        tot["fallbacks"] += int(rng.random() < 0.05)
        p = int(rng.integers(0, 12))
        tot["proposed"] += p
        tot["accepted"] += int(p * (0.02 if phase == 0 else 0.6))
        if phase == 0:
            tot["evictions"] += int(rng.integers(0, 2))
            tot["spills"] += int(rng.integers(0, 2))
        for tenant, v in burn.items():
            n = int(rng.integers(0, 3))
            v[1] += n
            v[0] += n if phase == 0 and tenant == "a" else 0
        rec = dict(queue_depth=int(rng.integers(0, 3)),
                   admitted=int(phase == 1 and rng.random() < 0.5),
                   batch=int(phase == 1), chunks=0)
        feed.append((rec, dict(tot, tenant_slo={k: tuple(v)
                                                for k, v in burn.items()})))
    return feed


@pytest.mark.parametrize("seed", range(3))
def test_watchdog_rules_onset_latch_rearm_equal(seed):
    feed = _watchdog_feed(seed)

    def run(o):
        wd = o.Watchdog(o.WatchdogConfig(warmup_steps=4,
                                          acceptance_min_proposed=20,
                                          acceptance_window_steps=6,
                                          thrash_window_steps=4,
                                          thrash_events=3, stall_steps=3,
                                          slo_burn_window_steps=5,
                                          slo_burn_min_retired=3),
                        clock=iter(range(10_000)).__next__)
        fired = [[a.asdict() for a in wd.on_step(_record(o, s, **rec), c)]
                 for s, (rec, c) in enumerate(feed)]
        return fired, wd.fired_total, [a.asdict() for a in wd.alerts()]

    j, t = both(run)
    assert t == j
    counts = t[1]
    assert all(counts[r] >= 1 for r in tobs.ALERT_RULES), counts
    # latched rules re-armed: fired more than once over the bad stretches
    assert counts["spec_acceptance_collapse"] >= 2
    assert counts["slo_burn"] >= 2


def test_watchdog_config_validation_equal():
    for bad in (dict(warmup_steps=-1), dict(acceptance_floor=1.5),
                dict(slo_burn_threshold=0.0), dict(stall_steps=0)):
        errs = []
        for o in PACKAGES.values():
            with pytest.raises(ValueError) as e:
                o.WatchdogConfig(**bad).validate()
            errs.append(str(e.value))
        assert errs[0] == errs[1]


# ---------------------------------------------------------- SLO controller
class _Metrics:
    """The two histograms the controller windows, of one package."""

    def __init__(self, o):
        self.hists = {name: o.Histogram("serving_" + name)
                      for name in ("step_duration_s", "tpot_s")}


@pytest.mark.parametrize("seed", range(4))
def test_slo_controller_aimd_trajectories_equal(seed):
    rng = np.random.default_rng(seed)
    samples = [(rng.exponential(0.05 if (s // 30) % 2 else 0.6, 3),
                rng.exponential(0.01 if (s // 30) % 2 else 0.2, 2))
               for s in range(240)]

    def run(o, slo):
        m = _Metrics(o)
        ctl = slo.SLOController(
            slo.SLOConfig(ttft_p99_s=1.0, tpot_p99_s=0.05, window_steps=4,
                          min_chunks_per_step=1, max_chunks_per_step=8),
            m, default_max_chunks=4)
        out = []
        for steps, tpots in samples:
            for v in steps:
                m.hists["step_duration_s"].observe(v)
            for v in tpots:
                m.hists["tpot_s"].observe(v)
            out.append((ctl.on_step(), ctl.chunk_limit, ctl.degraded,
                        list(ctl.last_breach)))
        return out, ctl.throttles, ctl.evaluations

    j, t = run(jobs, jslo), run(tobs, tslo)
    assert t == j
    limits = [x[1] for x in t[0]]
    assert min(limits) == 1 and max(limits) == 8 and t[1] > 1


def test_slo_config_errors_equal():
    for kw in (dict(), dict(tpot_p99_s=1.0, window_steps=0),
               dict(tpot_p99_s=1.0, min_chunks_per_step=0),
               dict(tpot_p99_s=1.0, max_chunks_per_step=-1),
               dict(ttft_p99_s=1.0, step_budget_frac=0.0)):
        errs = []
        for o, slo in ((jobs, jslo), (tobs, tslo)):
            with pytest.raises(ValueError) as e:
                slo.SLOController(slo.SLOConfig(**kw), _Metrics(o), 4)
            errs.append(str(e.value))
        assert errs[0] == errs[1]


# ----------------------------------------------- metrics and the exporters
def _drive_metrics(metrics_mod, seed):
    """One ServingMetrics fed a seeded stream of every update; its
    snapshot and Prometheus text."""
    rng = np.random.default_rng(seed)
    m = metrics_mod.ServingMetrics()
    m.on_tp_degree(1)
    m.on_kv_bytes_per_token(4096)
    m.on_spec_depth(3)
    m.seed_family("alerts_total", jobs.ALERT_RULES)
    m.seed_family("cost_model_drift", ["prefill[8]", "decode"])
    m.seed_tenants(["default", "batch", "weird.name-1"])
    for _ in range(60):
        m.on_prefill(int(rng.integers(0, 30)))
        m.on_prefill_chunk(int(rng.integers(1, 8)))
        m.on_prefix_hit(int(rng.integers(0, 16)))
        m.on_prefix_miss()
        m.on_tokens(int(rng.integers(0, 8)))
        m.on_decode_step()
        m.on_spec(int(rng.integers(0, 12)), int(rng.integers(0, 4)))
        m.on_state(queue_depth=int(rng.integers(0, 9)),
                   active=int(rng.integers(0, 4)),
                   pages_used=int(rng.integers(0, 60)), usable_pages=63,
                   shared_pages=1, cached_pages=2, cow_copies=3,
                   evictions=4, host_tier_pages=5, host_tier_bytes=6,
                   host_tier_hits=7, host_tier_spills=8,
                   host_tier_restores=9)
        m.observe_step(float(rng.exponential(0.1)), int(rng.integers(0, 5)))
        m.on_phase(str(rng.choice(jobs.PHASES)), float(rng.exponential()))
        m.observe_request({"ttft": float(rng.exponential()), "tpot": None,
                           "queue_wait": float(rng.exponential()),
                           "e2e": float(rng.exponential(4))})
        tenant = str(rng.choice(["default", "batch", "weird.name-1"]))
        cls = str(rng.choice(jobs.TENANT_CLASSES))
        m.on_tenant_retire(tenant, cls, int(rng.integers(0, 20)))
        m.observe_tenant(tenant, ttft=float(rng.exponential()), tpot=None,
                         queue_delay=float(rng.exponential()))
        for fn in ("on_preempt", "on_rejected", "on_shed", "on_expired",
                   "on_cancelled", "on_failed", "on_swap_out",
                   "on_swap_in"):
            if rng.random() < 0.3:
                getattr(m, fn)()
        if rng.random() < 0.2:
            m.on_alert(str(rng.choice(jobs.ALERT_RULES)))
        if rng.random() < 0.2:
            m.on_chunk_limit(int(rng.integers(1, 5)), rng.random() < 0.5)
    return m


def _without(text: str, names=("serving_tokens_per_sec",)) -> list:
    return [ln for ln in text.splitlines()
            if not any(n in ln for n in names)]


@pytest.mark.parametrize("seed", range(2))
def test_serving_metrics_snapshot_and_prometheus_line_for_line(seed):
    """The same updates give the same snapshot and the same exposition,
    line for line — less the host-clock rate ``serving_tokens_per_sec``.
    Names, seeds, families and histograms are the reference's."""
    jm = _drive_metrics(jmetrics, seed)
    jsnap, jtext = jm.snapshot(), jm.prometheus()
    tm = _drive_metrics(tmetrics, seed)
    tsnap, ttext = tm.snapshot(), tm.prometheus()
    rate = "serving_tokens_per_sec"
    assert {k: v for k, v in tsnap.items() if k != rate} == \
        {k: v for k, v in jsnap.items() if k != rate}
    assert _without(ttext) == _without(jtext)
    assert tmetrics._SEEDED == jmetrics._SEEDED
    assert tmetrics._FAMILIES == jmetrics._FAMILIES
    assert tmetrics._HISTOGRAMS == jmetrics._HISTOGRAMS
    assert tmetrics.COUNTER_STATS == jmetrics.COUNTER_STATS
    scrape_parse(ttext)


#: the exposition sample grammar of tests/test_obs_journey.py's scrape
_SAMPLE_RE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*'                    # metric name
    r'(\{[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*"'  # first label
    r'(,[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*")*\})?'
    r' -?[0-9.e+Inf]+$')


def scrape_parse(text: str) -> dict:
    """A strict mini scrape parser: every non-comment line matches the
    exposition sample grammar, label keys are sorted, and each ``# TYPE``
    appears at most once per name. Returns {name: type}."""
    typed = {}
    for ln in text.splitlines():
        if not ln:
            continue
        if ln.startswith("# TYPE"):
            _, _, name, typ = ln.split()
            assert name not in typed, f"duplicate TYPE for {name}"
            typed[name] = typ
            continue
        assert _SAMPLE_RE.match(ln), f"unparseable sample line: {ln!r}"
        if "{" in ln:
            keys = re.findall(r'[{,]([a-zA-Z_][a-zA-Z0-9_]*)="', ln)
            assert keys == sorted(keys), f"unsorted labels: {ln!r}"
    return typed


def test_prometheus_text_of_a_dict_equal():
    rng = np.random.default_rng(9)
    stats = {f"m_{i}{{a={i % 3},b=x\"y}}": float(rng.normal())
             for i in range(12)}
    stats.update({"plain": 3.0, 'weird{path=a"b\\c}': 1.0})

    def run(o):
        h = o.Histogram("lat{tenant=t1}")
        for v in rng_copy(1).exponential(0.3, 40):
            h.observe(v)
        return o.prometheus_text(stats, [h], {"plain": "counter"})

    j, t = both(run)
    assert t == j
    scrape_parse(t)


def _obs_inputs(o, seed):
    """Traces, a timeline, alerts and journeys of one package, from one
    seeded stream."""
    tr, book = _drive_tracer(o, seed, capacity=20, max_hops=64)
    tl = o.StepTimeline(4)
    rng = np.random.default_rng(seed)
    for s in range(7):
        tl.append(_record(o, s, batch=int(rng.integers(0, 3)),
                          prefills=int(rng.integers(0, 2)),
                          chunks=int(rng.integers(0, 2)),
                          accepted=int(rng.integers(0, 2)),
                          phase_s={"admit": 0.25, "decode": 0.75},
                          extra={"fatal": "x"} if s == 6 else {}))
    alerts = [o.Alert("queue_stall", 3, 4.5, "stalled", {"queue_depth": 2})]
    return tr, tl, alerts, book


@pytest.mark.parametrize("seed", range(2))
def test_chrome_trace_equal(seed, tmp_path):
    def run(o):
        tr, tl, alerts, book = _obs_inputs(o, seed)
        doc = o.chrome_trace(tr.traces(), tl, alerts, book.journeys())
        path = tmp_path / f"{o.__name__}.json"
        written = o.write_chrome_trace(path, tr.traces(), tl, alerts,
                                       book.wire_records())
        return doc, written, json.loads(path.read_text())

    (jd, jw, jl), (td, tw, tl) = both(run)
    assert td == jd and tw == jw and tl == jl
    assert any(e["ph"] == "C" for e in td["traceEvents"])
    assert any(e["cat"] == "tenant" for e in td["traceEvents"]
               if "cat" in e)


def test_latency_table_and_phase_accumulator_equal():
    def run(o):
        tr, *_ = _obs_inputs(o, 0)
        t = [0.0]

        def clock():
            t[0] += 0.5
            return t[0]

        acc = o.PhaseAccumulator(clock)
        acc.begin()
        for p in ("admit", "prefill", "prefill", "decode", "evict"):
            acc.mark(p)
        roof = o.RooflineTracker(2e12, 1e11, banked_kernels={"k": 2.0})
        roof.on_program("decode", 1e9, 5e8)
        roof.on_call("decode", 0.01)
        roof.on_kernel_call("k", 0.01, True)
        roof.on_kernel_call("k", 0.03, False)
        return (o.latency_table(tr.summaries()), acc.finish(),
                roof.gauges(), o.PHASES)

    j, t = both(run)
    assert t == j


# ----------------------------------------------------- the flight record
def _flight_record(o, seed, tmp_path):
    tr, tl, alerts, book = _obs_inputs(o, seed)
    rng = np.random.default_rng(seed)
    led = o.TenantLedger({"batch": o.TenantSLO(1.0, 0.5)})
    for _ in range(9):
        led.on_retire(str(rng.choice(["batch", "default"])), "finished",
                      float(rng.uniform(0, 2)), float(rng.uniform(0, 1)),
                      int(rng.integers(1, 9)))
    rec = o.build_flight_record(
        reason="manual", now=12.5, step=7, config={"max_batch": 2},
        timeline=tl, alerts=alerts, gauges={"serving_tokens_total": 9},
        programs={}, requests=tr.summaries(), tenants=led.rollup(),
        journeys=book.wire_records(), max_steps=3, max_requests=5,
        max_journeys=4)
    path = tmp_path / f"{o.__name__}-{seed}.json"
    o.dump_flight_record(path, rec)
    return rec, json.loads(path.read_text()), path


@pytest.mark.parametrize("seed", range(2))
def test_flight_record_round_trip_and_cross_validation(seed, tmp_path):
    (jrec, jload, jpath), (trec, tload, tpath) = (
        _flight_record(jobs, seed, tmp_path),
        _flight_record(tobs, seed, tmp_path))
    assert trec == jrec and tload == jload
    assert jpath.read_text() == tpath.read_text()
    for o in PACKAGES.values():
        o.validate_flight_record(jload)
        o.validate_flight_record(tload)
    assert tobs.format_flight_record(tload) == \
        jobs.format_flight_record(jload)
    # a v1 dump (before the tenant layer) stays readable under both
    v1 = {k: v for k, v in tload.items() if k not in ("tenants", "journeys")}
    v1["schema"] = tobs.FLIGHT_RECORD_SCHEMA_V1
    assert jobs.FLIGHT_RECORD_SCHEMA_V1 == tobs.FLIGHT_RECORD_SCHEMA_V1
    for o in PACKAGES.values():
        o.validate_flight_record(v1)


def _corruptions(rec):
    """(label, corrupt copy): each breaks one field of the schema."""
    def edit(fn):
        r = json.loads(json.dumps(rec))
        fn(r)
        return r

    yield "not a dict", []
    yield "schema", edit(lambda r: r.update(schema="paddle-tpu/x/v9"))
    yield "missing key", edit(lambda r: r.pop("gauges"))
    yield "wrong type", edit(lambda r: r.update(steps={}))
    yield "int dumped_at is fine", edit(lambda r: r.update(dumped_at=3))
    yield "step entry", edit(lambda r: r["steps"][0].pop("t_end"))
    yield "alert entry", edit(lambda r: r["alerts"][0].pop("rule"))
    yield "v2 missing tenants", edit(lambda r: r.pop("tenants"))
    yield "journey schema", edit(
        lambda r: r["journeys"][0].update(schema="nope"))
    yield "journey bool", edit(lambda r: r["journeys"][0].update(rid=True))
    yield "journey hop kind", edit(
        lambda r: r["journeys"][0]["hops"][0].update(kind="teleport"))
    yield "journey latency", edit(
        lambda r: r["journeys"][0].update(ttft_s="1s"))


def test_corrupt_records_refused_naming_the_same_field(tmp_path):
    rec, *_ = _flight_record(tobs, 0, tmp_path)
    for label, bad in _corruptions(rec):
        outcomes = []
        for o in PACKAGES.values():
            try:
                o.validate_flight_record(bad)
                outcomes.append("valid")
            except ValueError as e:
                outcomes.append(str(e))
        assert outcomes[0] == outcomes[1], label
        assert (outcomes[1] == "valid") == label.endswith("is fine"), label


# -------------------------------------------------------------- the CLI
def test_cli_exit_codes_in_process(tmp_path, capsys):
    """0 clean, 1 alerts or a failure reason recorded, 2 bad usage or an
    unreadable dump — the reference's codes on the same dumps."""
    rec, _, clean = _flight_record(tobs, 0, tmp_path)
    quiet = dict(rec, alerts=[])
    (tmp_path / "quiet.json").write_text(json.dumps(quiet))
    (tmp_path / "failed.json").write_text(
        json.dumps(dict(quiet, reason="request-failure")))
    v1 = {k: v for k, v in quiet.items() if k not in ("tenants", "journeys")}
    v1["schema"] = tobs.FLIGHT_RECORD_SCHEMA_V1
    (tmp_path / "v1.json").write_text(json.dumps(v1))
    (tmp_path / "junk.json").write_text("{not json")
    rid = rec["journeys"][-1]["rid"]
    q, f = str(tmp_path / "quiet.json"), str(tmp_path / "failed.json")
    cases = [
        (["--flight-record", q], 0),
        (["--flight-record", q, "--prometheus"], 0),
        (["--flight-record", q, "--latency-table"], 0),
        (["--flight-record", q, "--tenant-table"], 0),
        (["--flight-record", q, "--journey", str(rid)], 0),
        (["--flight-record", q, "--journey", "999999"], 2),
        (["--flight-record", str(clean)], 1),  # an alert is recorded
        (["--flight-record", f], 1),
        (["--flight-record", str(tmp_path / "v1.json"), "--tenant-table"], 2),
        (["--flight-record", str(tmp_path / "v1.json"), "--journey", "1"], 2),
        (["--flight-record", str(tmp_path / "junk.json")], 2),
        (["--flight-record", str(tmp_path / "missing.json")], 2),
        ([], 2),
        (["--prometheus"], 0),
        (["--no-such-flag"], 2),
        (["--flight-record", q, "--prometheus", "--latency-table"], 2),
    ]
    for argv, code in cases:
        assert t_main(argv) == code, argv
        tout = capsys.readouterr().out
        assert j_main(argv) == code, argv
        jout = capsys.readouterr().out
        if argv and argv[0] == "--flight-record" and code == 0:
            assert tout == jout, argv  # the same rendering
    # the fleet views (ported with the fleet; their records are in
    # test_torch_fleet.py): a flight record is no fleet record, --span
    # needs one, and the two inputs exclude each other — as the reference
    for argv in (["--fleet-record", q], ["--span", "3"],
                 ["--flight-record", q, "--fleet-record", q]):
        assert t_main(argv) == j_main(argv) == 2, argv
        capsys.readouterr()


def test_step_record_and_alert_shapes_equal():
    def run(o):
        r = _record(o, 3, batch=2, phase_s={"decode": 1.0})
        return (dataclasses.asdict(r), r.duration, r.phase_mix(),
                o.Alert("slo_burn", 1, 2.0, "m", {"t": 1}).asdict(),
                o.ALERT_RULES, o.JOURNEY_SCHEMA, o.FLIGHT_RECORD_SCHEMA)

    j, t = both(run)
    assert t == j
