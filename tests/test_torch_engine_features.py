"""The port's engine features against the JAX package's engine: chunked
prefill, sampling, swap preemption, cancellation and deadlines, the
bounded queue with both shed policies, every engine fault point and
``run(budget_s=)`` — the counterparts of ``tests/test_serving_chunked.py``
and ``tests/test_serving_faults.py``.

Every scenario runs a :class:`Twin`: one JAX engine (tracing off) and one
port engine (``device="cpu"``) over one set of weights (``make_pair``),
with the same configuration, request ids, clock and fault schedule. The
two are driven in lockstep, and after every step the finished ids, every
request's state and tokens, the page tables, the allocator's refcounts
and free list and the preemption counts must be equal; at the end the
outputs are equal token for token and ``pages_in_use`` drains to 0.
"""
import itertools

import numpy as np
import pytest
import torch

from paddle_tpu.serving import EngineOverloaded as JEngineOverloaded
from paddle_tpu.serving import FaultInjector as JFaultInjector
from paddle_tpu.serving import ServingConfig as JServingConfig
from paddle_tpu.serving import ServingEngine as JServingEngine
from paddle_tpu.serving.spec import SpecConfig as JSpecConfig
from paddle_tpu.text.gpt import GPTConfig as JGPTConfig
from paddle_tpu_torch.obs import TenantSLO
from paddle_tpu_torch.serving import (EngineOverloaded, FaultInjector,
                                      InjectedFault, ServingConfig,
                                      ServingEngine, SpecConfig)
from paddle_tpu_torch.serving.slo import SLOConfig
from paddle_tpu.serving.faults import POINTS as J_POINTS
from paddle_tpu_torch.serving.faults import POINTS
from paddle_tpu_torch.text import GPTConfig
from test_torch_gpt import make_pair

_rids = itertools.count(50_000)
SAMPLE = dict(do_sample=True, temperature=0.8, top_k=20, top_p=0.9, seed=5)


class FakeClock:
    """Engine time that moves only when the test says so (or through a
    slow_step fault's skew inside each engine)."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


class Twin:
    """A JAX engine and a port engine on one set of weights, driven
    together; ``wseed`` seeds the weights. ``spec``: a dict of SpecConfig fields (``method="draft"``
    builds a 2-layer draft pair from ``draft_seed``); ``arms``: the fault
    schedule, armed on both engines' injectors. ``clocks``: a (JAX, port)
    pair of engine clocks instead of one shared :class:`FakeClock`;
    ``sides``: a (JAX, port) pair of config dicts for fields whose values
    are each package's own objects. The JAX engine traces only when
    ``enable_tracing`` is passed."""

    def __init__(self, wseed=0, arms=None, spec=None, draft_seed=7,
                 clocks=None, sides=({}, {}), **cfg):
        jm, tm = make_pair(seed=wseed)
        self.clock = FakeClock()
        jclock, tclock = clocks or (self.clock, self.clock)
        jkw, tkw = {}, {}
        if spec is not None:
            spec = dict(spec)
            if spec.get("method") == "draft":
                dkw = dict(vocab_size=97, hidden_size=32, num_layers=2,
                           num_heads=2, max_seq_len=32)
                jd, td = make_pair(seed=draft_seed, **dkw)
                jkw["draft_model"], tkw["draft_model"] = jd, td
                jspec = JSpecConfig(draft=JGPTConfig(**dkw), **spec)
                tspec = SpecConfig(draft=GPTConfig(**dkw), **spec)
            else:
                jspec, tspec = JSpecConfig(**spec), SpecConfig(**spec)
            jkw_cfg, tkw_cfg = dict(spec=jspec), dict(spec=tspec)
        else:
            jkw_cfg = tkw_cfg = {}
        if arms is not None:
            jkw["fault_injector"] = JFaultInjector()
            tkw["fault_injector"] = FaultInjector()
        self.j = JServingEngine(jm, JServingConfig(
            **{"enable_tracing": False, **cfg}, **jkw_cfg, **sides[0]),
            clock=jclock, **jkw)
        self.t = ServingEngine(tm, ServingConfig(**cfg, **tkw_cfg, **sides[1]),
                               device="cpu", clock=tclock, **tkw)
        self.rids: list[int] = []
        for arm in arms or ():
            self.arm(**arm)

    def arm(self, **arm) -> None:
        """Arm one fault on both engines' injectors."""
        self.j._fault_injector.arm(**arm)
        self.t._fault_injector.arm(**arm)

    def add(self, prompt, max_new, **kw) -> int:
        """Queue on both; an EngineOverloaded must be raised by both."""
        rid = next(_rids)
        try:
            self.j.add_request(prompt, max_new, rid=rid, **kw)
        except JEngineOverloaded:
            with pytest.raises(EngineOverloaded):
                self.t.add_request(prompt, max_new, rid=rid, **kw)
            raise
        self.t.add_request(prompt, max_new, rid=rid, **kw)
        self.rids.append(rid)
        return rid

    def check(self) -> None:
        j, t = self.j, self.t
        np.testing.assert_array_equal(t.cache.page_table, j.cache.page_table)
        assert t.cache.allocator._ref == j.cache.allocator._ref
        assert t.cache.allocator._free == j.cache.allocator._free
        assert t.scheduler.preemption_count == j.scheduler.preemption_count
        for rid in self.rids:
            assert t.status(rid) == j.status(rid), rid
            jr, tr = j.request(rid), t.request(rid)
            if jr is not None:
                assert tr.generated == [int(x) for x in jr.generated], rid
                assert tr.prefilled_tokens == jr.prefilled_tokens, rid
        t.cache.check_invariants()

    def step(self) -> list[int]:
        fj, ft = self.j.step(), self.t.step()
        assert ft == fj
        self.check()
        return ft

    def run(self, max_steps=400, budget_s=None) -> dict:
        """Both engines' run() in lockstep, one step at a time: steps both
        until both are done (or, with ``budget_s``, each one's run() has
        returned); returns the port's outputs (every output so far, or
        with ``budget_s`` those of this call) after checking them equal to
        the JAX engine's."""
        if budget_s is not None:
            want = self.j.run(max_steps=max_steps, budget_s=budget_s)
            got = self.t.run(max_steps=max_steps, budget_s=budget_s)
            self.check()
        else:
            for _ in range(max_steps):
                if self.j.scheduler.all_done and self.t.scheduler.all_done:
                    break
                self.step()
            assert self.j.scheduler.all_done and self.t.scheduler.all_done
            want, got = self.j._finished, self.t._finished
        assert sorted(got) == sorted(want)
        for rid in want:
            assert got[rid].tolist() == np.asarray(want[rid]).tolist(), rid
        return got

    def drained(self) -> None:
        assert self.t.cache.allocator.pages_in_use == 0
        assert self.j.cache.allocator.pages_in_use == 0


def prompts(seed, lens, shared=0):
    """Prompts of the given lengths; the first ``shared`` tokens equal
    across all of them (a prefix-cache hit for the later ones)."""
    rng = np.random.default_rng(seed)
    head = rng.integers(1, 97, shared)
    return [np.concatenate([head, rng.integers(1, 97, n - shared)])
            .astype(np.int32) for n in lens]


BASE = dict(max_batch=3, num_pages=32, page_size=4, max_prompt_len=24)


# ----------------------------------------------------------- chunked prefill
@pytest.mark.parametrize("chunk", [4, 8])
def test_chunked_parity_with_prefix_hit(chunk):
    tw = Twin(wseed=1, chunk_size=chunk, **BASE)
    ps = prompts(2, (20, 10, 13, 17), shared=8)
    for p, n in zip(ps[:2], (6, 5)):
        tw.add(p, n)
    tw.run()
    for p, n in zip(ps[2:], (5, 7)):  # find the shared prefix cached
        tw.add(p, n)
    tw.run()
    c = tw.t.counters
    assert c.prefix_hit_tokens > 0 and c.prefill_chunks > c.prefills
    tw.drained()


@pytest.mark.parametrize("mode", ["recompute", "swap"])
def test_sampled_parity_under_preemption(mode):
    """Sampling (temperature, top-k, top-p, seed) through a pool small
    enough to preempt, by recompute (the replay redraws the same keys) and
    by swap; chunked in swap mode."""
    tw = Twin(wseed=3, preemption_mode=mode, **SAMPLE,
              **dict(BASE, num_pages=12,
                     chunk_size=8 if mode == "swap" else 0))
    for p in prompts(4, (9, 14, 7, 11)):
        tw.add(p, 10)
    tw.run()
    c = tw.t.counters
    assert c.preemptions > 0
    assert c.swaps_out == c.swaps_in == (c.preemptions if mode == "swap"
                                         else 0)
    tw.drained()


@pytest.mark.parametrize("mode", ["recompute", "swap"])
def test_mid_prefill_preemption_parity(mode):
    """pool_exhausted while the whale is mid-prefill: recompute replays
    its chunks, swap resumes where it left."""
    tw = Twin(wseed=1, arms=[dict(point="pool_exhausted", step=1)],
              preemption_mode=mode, chunk_size=8,
              **dict(BASE, max_batch=2))
    rid = tw.add(prompts(5, (20,))[0], 6)
    tw.step()
    tw.step()
    assert tw.t.status(rid) == "waiting"
    tw.run()
    c = tw.t.counters
    assert c.prefill_chunks == (5 if mode == "recompute" else 3)
    assert c.swaps_in == c.swaps_out == (1 if mode == "swap" else 0)
    tw.drained()


def test_cancel_and_deadline_mid_prefill():
    tw = Twin(wseed=1, chunk_size=4, **dict(BASE, max_batch=2))
    whale, whale2, short = prompts(6, (20, 18, 4))
    r1 = tw.add(whale, 4)
    r2 = tw.add(short, 4)
    tw.step()
    assert tw.t.status(r1) == "prefilling"
    assert tw.t.cancel(r1) and tw.j.cancel(r1)
    assert not tw.t.cancel(r1)
    tw.check()
    assert tw.t.status(r1) == "cancelled"
    r3 = tw.add(whale2, 4, deadline_s=5.0)
    tw.step()
    assert tw.t.status(r3) == "prefilling"
    tw.clock.t = 60.0
    tw.step()
    assert tw.t.status(r3) == "expired"
    assert set(tw.run()) == {r2}
    c = tw.t.counters
    assert (c.cancelled, c.expired) == (1, 1)
    assert set(tw.t.pop_retired()) == {r1, r3}
    tw.drained()


# ------------------------------------------------------------- bounded queue
def test_full_queue_rejects():
    tw = Twin(wseed=2, max_batch=1, num_pages=24, page_size=4,
              max_prompt_len=8, max_waiting=1, shed_policy="reject")
    p1, p2, p3 = prompts(3, (4, 4, 4))
    tw.add(p1, 4)
    tw.step()
    tw.add(p2, 4)
    with pytest.raises(JEngineOverloaded):
        tw.add(p3, 4)
    assert tw.t.counters.rejected == 1
    assert len(tw.run()) == 2
    tw.drained()


def test_shed_oldest_keeps_fifo_order_for_survivors():
    tw = Twin(wseed=2, max_batch=1, num_pages=24, page_size=4,
              max_prompt_len=8, max_waiting=2, shed_policy="shed-oldest")
    ps = prompts(4, (4, 5, 3, 6))
    r1 = tw.add(ps[0], 4)
    tw.step()
    r2, r3, r4 = (tw.add(p, 4) for p in ps[1:])
    assert tw.t.status(r2) == "shed" and tw.t.counters.shed == 1
    order = []
    while not tw.t.scheduler.all_done:
        order += tw.step()
    assert order == [r1, r3, r4]
    tw.drained()


def test_shed_oldest_never_sheds_a_preemption_victim():
    tw = Twin(wseed=2, arms=[dict(point="pool_exhausted", step=2)],
              max_batch=2, num_pages=24, page_size=4, max_prompt_len=8,
              max_waiting=1, shed_policy="shed-oldest")
    ps = prompts(11, (4, 5, 3))
    r1 = tw.add(ps[0], 6)
    tw.step()
    r2 = tw.add(ps[1], 6)
    tw.step()
    tw.step()  # step 2 preempts one running request
    assert [tw.t.status(r) for r in (r1, r2)].count("waiting") == 1
    with pytest.raises(JEngineOverloaded):
        tw.add(ps[2], 3)  # the queue holds only the victim
    assert set(tw.run()) == {r1, r2}
    tw.drained()


def test_shed_oldest_skips_victim_and_sheds_oldest_newcomer():
    tw = Twin(wseed=2, arms=[dict(point="pool_exhausted", step=2)],
              max_batch=2, num_pages=24, page_size=4, max_prompt_len=8,
              max_waiting=2, shed_policy="shed-oldest")
    ps = prompts(12, (4, 5, 3, 4))
    r1, r2 = tw.add(ps[0], 6), tw.add(ps[1], 6)
    for _ in range(3):
        tw.step()
    r3 = tw.add(ps[2], 3)
    r4 = tw.add(ps[3], 3)
    assert tw.t.status(r3) == "shed"
    assert set(tw.run()) == {r1, r2, r4}
    tw.drained()


# ------------------------------------------------------------------- faults
@pytest.mark.parametrize("point", ["prefill_fail", "chunk_fail",
                                   "decode_fail"])
def test_request_fault_points_retire_only_the_victim(point):
    """The fault retires its request FAILED; the rest are served, equal to
    the reference token for token."""
    ps = prompts(8, (12, 7, 10))
    chunk = 4 if point == "chunk_fail" else 0
    tw = Twin(wseed=4, arms=[], chunk_size=chunk, **BASE)
    rids = [tw.add(p, 6) for p in ps]
    tw.arm(point=point, step=2 if point == "decode_fail" else 1 if chunk
           else 0, rid=rids[0])
    outs = tw.run()
    assert tw.t.status(rids[0]) == "failed"
    assert isinstance(tw.t.request(rids[0]).error, InjectedFault)
    assert set(outs) == set(rids[1:])
    assert tw.t.counters.failed == 1 and set(tw.t.failed) == {rids[0]}
    tw.drained()


def test_pool_exhausted_swap_vs_recompute_parity():
    """The same stream with a pool_exhausted preemption, once per mode:
    each equal to the reference, and swap's outputs equal recompute's."""
    ps = prompts(9, (10, 8, 6))
    outs = {}
    for mode in ("recompute", "swap"):
        tw = Twin(wseed=5, arms=[dict(point="pool_exhausted", step=3)],
                  preemption_mode=mode, **BASE)
        rids = [tw.add(p, 8) for p in ps]
        got = tw.run()
        outs[mode] = [got[r].tolist() for r in rids]
        assert tw.t.counters.preemptions == 1
        tw.drained()
    assert outs["swap"] == outs["recompute"]


def test_restore_fail_retires_the_admission():
    """An int8 pool with the host tier: the first host-tier restore fails;
    that request retires FAILED with the tier entries dropped, and the
    rest are served equal to the reference."""
    tw = Twin(wseed=8, arms=[dict(point="restore_fail")], max_batch=2,
              num_pages=10, page_size=4, max_prompt_len=16, kv_dtype="int8",
              host_tier_bytes=1 << 16)
    rng = np.random.RandomState(5)
    system = rng.randint(1, 97, (8,))
    warm = [np.concatenate([system, rng.randint(1, 97, (3,))])
            .astype(np.int32) for _ in range(3)]
    whales = [rng.randint(1, 97, (14,)).astype(np.int32) for _ in range(2)]
    tw.add(warm[0], 4)
    tw.run()
    for p in whales:  # evict the system prefix into the tier
        tw.add(p, 4)
    tw.run()
    assert tw.t.counters.host_tier_spills > 0
    r = tw.add(warm[1], 4)
    tw.run()
    assert tw.t.status(r) == "failed"
    assert tw.t.counters.failed == 1
    tw.drained()


def test_slow_step_expires_deadlines_and_budget_drains():
    """slow_step skews the engine clock: a deadline passes without a
    sleep. run(budget_s=) pauses admission once the budget is spent and
    drains the running batch; the rest stays queued for a later run."""
    tw = Twin(wseed=6, arms=[dict(point="slow_step", step=1, delay_s=30.0)],
              **dict(BASE, max_batch=1))
    ps = prompts(10, (6, 5, 7))
    r1 = tw.add(ps[0], 5, deadline_s=10.0)
    r2 = tw.add(ps[1], 3)
    r3 = tw.add(ps[2], 3)
    tw.step()
    tw.step()  # the skew lands: r1 expires
    assert tw.t.status(r1) == "expired"
    done = tw.run(budget_s=0.0)  # pause at once: only in-flight work
    assert set(done) == {r2}
    assert tw.t.status(r3) == "waiting" and not tw.t.admit_paused
    assert set(tw.run()) == {r2, r3}
    tw.drained()


def test_fleet_fault_points_wait_for_their_router():
    """The router's and the transport's points arm since the fleet was
    ported (their drills are in ``test_torch_fleet.py``): the port's
    points are the reference's, in its order."""
    assert POINTS == J_POINTS
    for point in ("route_fail", "replica_down", "wire_drop",
                  "wire_corrupt", "wire_delay", "peer_timeout"):
        inj = FaultInjector().arm(point, step=3, rid=1)
        assert inj.hit(point, step=3, rid=1) is not None
    with pytest.raises(ValueError):
        FaultInjector().arm("no_such_point")


def test_unported_tenant_raises():
    """Tenants are served since the observability layer was ported: any
    name that passes the reference's charset check is accepted (and
    seeded on first sight); a malformed one raises the reference's
    ValueError, before anything is queued."""
    _, tm = make_pair()
    te = ServingEngine(tm, ServingConfig(**BASE), device="cpu")
    rid = te.add_request(np.arange(1, 5), 2, tenant="batch")
    assert te.journey(rid).tenant == "batch"
    for bad in ("a b", "x{y}", "", "t" * 65):
        with pytest.raises(ValueError, match="tenant name"):
            te.add_request(np.arange(1, 5), 2, tenant=bad)
    assert te.scheduler.queue_depth == 1


# ------------------------------------------------- one read a step, on host
def test_one_device_read_per_decode_verify_and_completed_prefill(
        monkeypatch):
    """Every read of a tensor's values by the host goes through
    ``Tensor.cpu``, ``.item`` or ``.tolist`` (patched here to count): the
    engine makes exactly one per decode or verify step and one per
    completed prefill; a chunk that does not finish its prompt makes
    none. Sampled, chunked and speculative at once, with the whole
    observability layer on: tracing, two tenants, the watchdogs and an
    SLO controller whose target every step breaches, so it throttles and
    admission probes the prefix cache for warm waiters."""
    reads = []
    for name in ("cpu", "item", "tolist"):
        orig = getattr(torch.Tensor, name)

        def counted(self, *a, _orig=orig, _name=name, **kw):
            reads.append(_name)
            return _orig(self, *a, **kw)

        monkeypatch.setattr(torch.Tensor, name, counted)
    for spec in (None, dict(method="ngram", depth=3)):
        _, tm = make_pair(seed=2)
        te = ServingEngine(tm, ServingConfig(
            chunk_size=4, spec=None if spec is None else SpecConfig(**spec),
            enable_tracing=True, enable_watchdogs=True,
            tenants={"interactive": TenantSLO(1e-9, 1e-9)},
            slo=SLOConfig(ttft_p99_s=1e-9, window_steps=2),
            **SAMPLE, **BASE), device="cpu")
        for i, p in enumerate(prompts(13, (13, 6, 9, 11, 8), shared=4)):
            te.add_request(p, 7, tenant=("interactive", "batch")[i % 2])
        reads.clear()
        te.run()
        assert te._slo.throttles > 0 and te.timeline.total_steps > 0
        assert sum(e["retired"]["ttft_late"]
                   for e in te.tenant_report().values()) > 0
        c = te.counters
        assert c.prefill_chunks > c.prefills  # some chunks did not finish
        assert c.verify_steps == (c.decode_steps if spec else 0)
        assert len(reads) == c.decode_steps + c.prefills, reads
