"""The port's fleet (``serving/fleet.py``, ``fleet_sim.py``, ``chaos.py``,
``obs/fleetscope.py``) in lockstep with the JAX package's.

A :class:`FleetTwin` builds a JAX ``FleetRouter`` and a port one over
models holding one set of weights (the reference fleet tests' size:
vocab 97, hidden 32, 2 layers, 2 heads), with the same configuration,
fault schedule and request ids, each router on its own reference
``VirtualClock`` (1.0 s a read). After every router step the requests
that finished, every route (replica, kind, warm tokens), every status,
the ``serving_*`` snapshot (less ``REFERENCE_ONLY``) and the journey dump
must be equal; at the end the outputs, ``retirement_class_counts`` and,
with a transport, its accounting and breaker timeline. Scenarios: the
affinity and round-robin waves, spill before shed, burn-weighted
admission, ``route_fail``, ``replica_down`` (in process and over the
wire), page fetches over a lossless and a lossy channel. Then a seeded
chaos soak (same schedule, same books), ``fleet_sim`` replays, the
fleetscope record with the CLI's views, and the merged Chrome trace.
"""
import itertools
import json

import numpy as np
import pytest

import paddle_tpu.serving.fleet as jfleet_mod
import paddle_tpu.serving.scheduler as jsched
from paddle_tpu.obs import TenantSLO as JTenantSLO
from paddle_tpu.obs import WatchdogConfig as JWatchdogConfig
from paddle_tpu.obs import fleetscope as jscope
from paddle_tpu.obs.__main__ import main as j_obs_main
from paddle_tpu.serving import FaultInjector as JFaultInjector
from paddle_tpu.serving import FleetConfig as JFleetConfig
from paddle_tpu.serving import FleetRouter as JFleetRouter
from paddle_tpu.serving import ServingConfig as JServingConfig
from paddle_tpu.serving import channel as jch
from paddle_tpu.serving import chaos as jchaos
from paddle_tpu.serving import fleet_sim as jsim
import paddle_tpu_torch.serving.scheduler as tsched
from paddle_tpu_torch.obs import TenantSLO, WatchdogConfig
from paddle_tpu_torch.obs import fleetscope as tscope
from paddle_tpu_torch.obs.__main__ import main as t_obs_main
from paddle_tpu_torch.serving import (FaultInjector, FleetConfig, FleetRouter,
                                      ServingConfig)
from paddle_tpu_torch.serving import channel as tch
from paddle_tpu_torch.serving import chaos as tchaos
from paddle_tpu_torch.serving import fleet_sim as tsim
from test_torch_engine_obs import VirtualClock, _kept
from test_torch_gpt import make_pair

TINY = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=2,
            max_seq_len=48)
ENG = dict(max_batch=2, num_pages=20, page_size=4, max_prompt_len=8)
_rid_base = itertools.count(100_000, 1_000)


def _align_rids():
    """Both packages draw the next rids from the same start."""
    start = next(_rid_base)
    jfleet_mod._rid_counter = itertools.count(start)
    jsched._rid_counter = itertools.count(start)
    tsched._rid_counter = itertools.count(start)


@pytest.fixture(scope="module")
def pair():
    return make_pair(seed=41, **TINY)


def _transports(channel, tcfg):
    return (jch.Transport(jch.SimChannel(jch.ChannelConfig(**channel)),
                          jch.TransportConfig(**tcfg)),
            tch.Transport(tch.SimChannel(tch.ChannelConfig(**channel)),
                          tch.TransportConfig(**tcfg)))


class FleetTwin:
    """A JAX router and a port router driven together. ``sides``: a (JAX,
    port) pair of engine-config dicts for fields whose values are each
    package's own objects; ``wire``: (channel, transport) config dicts,
    which attach a transport to each router; ``arms``: the router's fault
    schedule."""

    def __init__(self, pair, num_replicas=3, eng=None, sides=({}, {}),
                 wire=None, arms=(), **fleet_kw):
        jm, tm = pair
        _align_rids()
        kw = dict(ENG, **(eng or {}))
        jt = tt = None
        if wire is not None:
            jt, tt = _transports(*wire)
        self.jinj, self.tinj = JFaultInjector(), FaultInjector()
        for arm in arms:
            self.jinj.arm(**arm)
            self.tinj.arm(**arm)
        self.j = JFleetRouter(jm, JFleetConfig(
            num_replicas=num_replicas,
            engine=JServingConfig(**kw, **sides[0]), transport=jt,
            **fleet_kw), clock=VirtualClock(), fault_injector=self.jinj)
        self.t = FleetRouter(tm, FleetConfig(
            num_replicas=num_replicas,
            engine=ServingConfig(**kw, **sides[1]), transport=tt,
            **fleet_kw), clock=VirtualClock(), fault_injector=self.tinj,
            device="cpu")
        self.rids = []
        self.outs = {}

    def submit(self, prompt, n, **kw):
        rj, rt = self.j.submit(prompt, n, **kw), self.t.submit(prompt, n, **kw)
        assert rj == rt
        self.rids.append(rt)
        self.check()
        return rt

    def check(self):
        j, t = self.j, self.t
        assert t.routes == j.routes
        for rid in self.rids:
            assert t.status(rid) == j.status(rid), rid
        assert _kept(t.metrics.snapshot()) == _kept(j.metrics.snapshot())
        assert t.journey_dump() == j.journey_dump()
        assert t._live() == j._live()
        assert [p.rid for p in t._pending] == [p.rid for p in j._pending]

    def step(self):
        fj, ft = self.j.step(), self.t.step()
        assert ft == fj
        self.check()

    def busy(self, f):
        return f._pending or any(f.replicas[i].scheduler.running
                                 or f.replicas[i].scheduler.waiting
                                 for i in f._live())

    def run(self, max_steps=300):
        for _ in range(max_steps):
            if not self.busy(self.j):
                break
            self.step()
        assert not self.busy(self.j) and not self.busy(self.t)
        fj, ft = self.j.pop_finished(), self.t.pop_finished()
        assert sorted(ft) == sorted(fj)
        for rid in fj:
            assert ft[rid].tolist() == np.asarray(fj[rid]).tolist(), rid
        self.outs.update(ft)
        # drained outputs leave both routers: their statuses go with them
        self.rids = [r for r in self.rids if r not in ft]
        assert self.t.retirement_class_counts() == \
            self.j.retirement_class_counts()
        if self.t.transport is not None:
            a, b = self.j.transport, self.t.transport
            assert b.breaker_events == a.breaker_events
            assert (b.tx_bytes, b.rx_bytes, b.retries_total,
                    b.timeouts_total, b.corrupt_total, b.hedge_wins_total,
                    b.exchanges_total, b.t) == \
                (a.tx_bytes, a.rx_bytes, a.retries_total, a.timeouts_total,
                 a.corrupt_total, a.hedge_wins_total, a.exchanges_total, a.t)
        return ft


def _prompt(n, seed=0):
    return np.random.RandomState(seed).randint(0, 97, (n,)).astype(np.int32)


# ----------------------------------------------------------------- routing
@pytest.mark.parametrize("routing", ["affinity", "round_robin"])
def test_two_waves_route_and_serve_as_the_reference(pair, routing):
    """Two warm families, then a second wave of repeats: the replica each
    request went to, the tokens, the journeys and the class counts equal
    the reference router's; affinity homes every repeat warm."""
    A, B = _prompt(8, seed=1), _prompt(8, seed=2)
    tw = FleetTwin(pair, routing=routing)
    tw.submit(A, 3)
    tw.submit(B, 3)
    tw.run()
    for p in (A, A, B, B):
        tw.submit(p, 3)
    tw.run()
    snap = tw.t.metrics.snapshot()
    if routing == "affinity":
        assert [(k, n) for _, (_, k, n) in sorted(tw.t.routes.items())][-4:] \
            == [("routed", 8)] * 4
        assert snap["serving_fleet_prefix_affinity_hits_total"] == 4
        assert snap["serving_prefix_hits"] == 4
    else:
        assert snap["serving_fleet_prefix_affinity_hits_total"] == 0
        assert snap["serving_prefix_hits"] == 2


def test_spillover_before_shed(pair):
    tw = FleetTwin(pair, num_replicas=2, max_replica_load=1, max_pending=1)
    A = _prompt(8, seed=1)
    tw.submit(A, 3)
    tw.run()
    r = [tw.submit(A, 4) for _ in range(4)]
    assert tw.t.routes[r[0]][:2] == (0, "routed")
    assert tw.t.routes[r[1]][:2] == (1, "spilled")
    assert tw.t.status(r[2]) == "pending" and tw.t.status(r[3]) == "shed"
    tw.run()
    assert set(tw.t.pop_retired()) == set(tw.j.pop_retired()) == {r[3]}


def test_burn_weighted_admission_and_weighted_drain(pair):
    """A tenant burning an unmeetable SLO gains weight once per onset, in
    both; then with the burning tenant's weight raised its pending
    requests overtake earlier default ones, in both."""
    sides = tuple(dict(tenants={"victim": slo(1e-9, 1e-9)},
                       watchdog=wd(slo_burn_window_steps=16,
                                   slo_burn_min_retired=4))
                  for slo, wd in ((JTenantSLO, JWatchdogConfig),
                                  (TenantSLO, WatchdogConfig)))
    tw = FleetTwin(pair, num_replicas=1, sides=sides)
    for i in range(6):
        tw.submit(_prompt(4, seed=i), 2, tenant="victim")
    tw.run()
    assert tw.t.weight_changes == tw.j.weight_changes
    assert [(t, w) for _, t, w in tw.t.weight_changes] == [("victim", 2.0)]
    tw = FleetTwin(pair, num_replicas=1, max_replica_load=1)
    tw.submit(_prompt(4, seed=0), 2)
    d1 = tw.submit(_prompt(4, seed=1), 2)
    v1 = tw.submit(_prompt(4, seed=2), 2, tenant="vip")
    tw.j._actuate_weight("vip")
    tw.t._actuate_weight("vip")
    tw.run()
    jv = {j["rid"]: j for j in tw.t.journey_dump()}
    assert jv[v1]["hops"][1]["t"] < jv[d1]["hops"][1]["t"]


# ------------------------------------------------------------------ faults
def test_route_fail_and_replica_down(pair):
    tw = FleetTwin(pair, num_replicas=2, arms=[
        dict(point="route_fail", step=0, times=1)])
    shed = tw.submit(_prompt(6, seed=0), 3)
    tw.submit(_prompt(6, seed=1), 3)
    tw.run()
    assert tw.t.status(shed) == "shed"
    tw = FleetTwin(pair, num_replicas=2, max_replica_load=4,
                   eng=dict(max_batch=1),
                   arms=[dict(point="replica_down", step=2, rid=0)])
    rids = [tw.submit(_prompt(6, seed=i), 6) for i in range(4)]
    tw.run()
    assert tw.t.status(rids[0]) == "failed"
    assert tw.t.routes[rids[2]][:2] == (1, "spilled")
    assert tw.t.metrics.snapshot()["serving_fleet_replicas"] == 1
    assert tw.t.last_fleet_record is not None
    tscope.validate_fleet_record(tw.t.last_fleet_record)
    jscope.validate_fleet_record(tw.t.last_fleet_record)


LOSSY = (dict(seed=5, drop_rate=0.2, corrupt_rate=0.15, dup_rate=0.1,
              reorder_rate=0.2, latency_s=0.01, jitter_s=0.01),
         dict(seed=5, timeout_s=0.5, hedge=True))


@pytest.mark.parametrize("wire", [(dict(), dict()), LOSSY],
                         ids=["lossless", "lossy"])
def test_fetch_pages_over_the_wire(pair, wire):
    """A warm family on one replica, its repeats placed elsewhere: the
    prefix pages are fetched over the transport into the destination's
    host tier and restored as host-tier hits (or, where the lossy channel
    kills a fetch, re-prefilled locally); then a replica dies and its
    waiter travels as a re-home frame. All of it equal to the reference,
    transport accounting included."""
    tw = FleetTwin(pair, num_replicas=2, wire=wire, fetch_pages=True,
                   routing="round_robin", max_replica_load=4,
                   eng=dict(host_tier_bytes=1 << 20, max_batch=1),
                   arms=[dict(point="replica_down", step=6, rid=1)])
    A = _prompt(8, seed=1)
    tw.submit(A, 3)
    tw.run()
    for i in range(4):
        tw.submit(A if i % 2 == 0 else _prompt(8, seed=10 + i), 6)
    tw.run()
    hits = sum(e.cache.host_tier_hits for e in tw.t.replicas)
    assert hits == sum(e.cache.host_tier_hits for e in tw.j.replicas)
    if not wire[0]:
        assert hits >= 1  # a lossless fetch always lands
    assert tw.t.transport.exchanges_total > 0
    assert tw.t.scope.records() == tw.j.scope.records()


# -------------------------------------------------------------- chaos soak
@pytest.mark.parametrize("seed", [0, 3])
def test_chaos_soak_same_schedule_same_books(pair, seed):
    jm, tm = pair
    jr, jper = jchaos.build_schedule(jchaos.ChaosConfig(seed=seed))
    tr, tper = tchaos.build_schedule(tchaos.ChaosConfig(seed=seed))
    assert [vars(a) for a in tr._arms] == [vars(a) for a in jr._arms]
    assert [[vars(a) for a in i._arms] for i in tper] == \
        [[vars(a) for a in i._arms] for i in jper]
    _align_rids()
    want = jchaos.soak(jm, jchaos.ChaosConfig(seed=seed))
    _align_rids()
    got = tchaos.soak(tm, tchaos.ChaosConfig(seed=seed), device="cpu")
    assert got == want
    assert got["goodput_tokens"] + got["badput_tokens"] == \
        got["tokens_total"]
    assert tchaos.format_report(got) == jchaos.format_report(want)


# ---------------------------------------------------------------- fleet_sim
def test_fleet_sim_replays_equal(pair, tmp_path, capsys):
    sides = tuple(dict(tenants={"interactive": slo(1e6, 1e6),
                                "batch": slo(1e-9, 1e-9)})
                  for slo in (JTenantSLO, TenantSLO))
    tw = FleetTwin(pair, num_replicas=2, max_replica_load=1, max_pending=1,
                   sides=sides)
    for i in range(3):
        tw.submit(_prompt(6, seed=i), 3, tenant="interactive")
        tw.submit(_prompt(6, seed=10 + i), 3, tenant="batch")
    tw.run()
    dump = tw.t.journey_dump()
    slos = {"interactive": TenantSLO(1e6, 1e6), "batch": TenantSLO(1e-9, 1e-9)}
    jslos = {"interactive": JTenantSLO(1e6, 1e6),
             "batch": JTenantSLO(1e-9, 1e-9)}
    replay = tsim.replay_classes(dump, slos)
    assert replay == jsim.replay_classes(dump, jslos)
    live = tw.t.retirement_class_counts()
    for tenant, row in live.items():
        if any(row.values()):
            assert replay[tenant] == row
    for shape in ((1, 1), (2, 2), (3, 4)):
        assert tsim.simulate(dump, *shape, weights={"batch": 2.0}) == \
            jsim.simulate(dump, *shape, weights={"batch": 2.0})
    path = tmp_path / "dump.json"
    path.write_text(json.dumps(dump))
    argv = [str(path), "--replicas", "2", "--slots", "2", "--slo",
            "batch=0.000000001:0.000000001", "--weight", "batch=2.0"]
    assert tsim.main(argv) == 0
    tout = capsys.readouterr().out
    assert jsim.main(argv) == 0
    assert tout == capsys.readouterr().out


# -------------------------------------------------- fleetscope and the CLI
def test_fleet_record_and_cli_views_equal(pair, tmp_path, capsys):
    """A lossy fleet with page fetches: the fleet records validate under
    both packages; both CLIs render each dump's views alike (the summary,
    a span tree, the merged scrape) and the port's rendering of its own
    dump equals the reference's of its own."""
    tw = FleetTwin(pair, num_replicas=2, wire=LOSSY, fetch_pages=True,
                   routing="round_robin",
                   eng=dict(host_tier_bytes=1 << 20))
    A = _prompt(8, seed=1)
    tw.submit(A, 3)
    tw.run()
    rids = [tw.submit(A, 3) for _ in range(3)]
    tw.run()
    paths = {}
    for name, fl in (("j", tw.j), ("t", tw.t)):
        paths[name] = str(tmp_path / f"{name}.json")
        fl.dump_fleet_record(paths[name])
    for p in paths.values():
        rec = json.load(open(p))
        tscope.validate_fleet_record(rec)
        jscope.validate_fleet_record(rec)
    span_rid = next(r for r in rids if tw.t.spans(r))
    assert tw.t.spans(span_rid) == tw.j.spans(span_rid)
    views = [[], ["--span", str(span_rid)], ["--prometheus"]]
    outs = {}
    for name, p in paths.items():
        for v in views:
            argv = ["--fleet-record", p] + v
            code_t = t_obs_main(argv)
            out_t = capsys.readouterr().out
            code_j = j_obs_main(argv)
            out_j = capsys.readouterr().out
            assert code_t == code_j and out_t == out_j, (name, v)
            outs[name, tuple(v)] = out_t
    for v in views[:2]:
        assert outs["t", tuple(v)] == outs["j", tuple(v)], v
    assert "span " in outs["t", ("--span", str(span_rid))]
    tm = tw.t.fleet_metrics().merged()
    assert all("replica=" in k for k in tm)


def test_chrome_export_one_track_per_replica(pair, tmp_path):
    tw = FleetTwin(pair, num_replicas=2, wire=LOSSY)
    tw.submit(_prompt(6, seed=0), 3)
    tw.submit(_prompt(6, seed=1), 3)
    tw.run()
    jd, td = tw.j.export_chrome_trace(), \
        tw.t.export_chrome_trace(tmp_path / "fleet.json")
    assert {e["pid"] for e in td["traceEvents"]} == \
        {e["pid"] for e in jd["traceEvents"]}
    names = sorted(e["args"]["name"] for e in td["traceEvents"]
                   if e.get("ph") == "M" and e["name"] == "process_name")
    assert names == sorted(e["args"]["name"] for e in jd["traceEvents"]
                           if e.get("ph") == "M"
                           and e["name"] == "process_name")
    assert json.loads((tmp_path / "fleet.json").read_text())["traceEvents"]


def test_fleet_config_validation_messages_equal():
    for kw in (dict(num_replicas=0), dict(routing="random"),
               dict(gossip_every=0), dict(weight_gain=1.0),
               dict(max_pending=-1), dict(fetch_pages=True)):
        with pytest.raises(ValueError) as je:
            JFleetConfig(**kw).validate()
        with pytest.raises(ValueError) as te:
            FleetConfig(**kw).validate()
        assert str(te.value) == str(je.value)
