"""Fleet-wide chaos soak: every fault point armed in one seeded run, the
correctness invariants swept after every step — the port of
``paddle_tpu/serving/chaos.py``.

A fault drill proves one failure mode at a time; a chaos soak proves
they COMPOSE. :func:`build_schedule` turns one integer seed into a
deterministic arming of **every** entry in :data:`.faults.POINTS` —
engine-grain points on per-replica injectors, router/wire-grain points
on the router's — via :func:`.channel.unit_hash`, the one reproducible
randomness source; the same seed arms the same points at the same steps
as the reference's. :func:`soak` then runs a multi-replica
fleet over a lossy, corrupting, duplicating, reordering channel with
that schedule and sweeps, after EVERY router step:

- ``cache.check_invariants()`` on every live replica (the paged-pool
  ref-count/free-list/serial audit),
- ``validate_journey`` on every wire journey in the fleet's books,
- ledger monotonicity: retired goodput + badput tokens never exceed
  ``serving_tokens_total``.

At drain it asserts the terminal books: every submitted rid retired
EXACTLY once (one terminal journey, class counts summing to the submit
count across the 7 ledger classes) and the ledger reconciles exactly —
``goodput + badput == serving_tokens_total``. Any violation raises
:class:`ChaosInvariantError` (an ``AssertionError``: a failed soak IS a
failed assertion about the fleet).

The module import asserts the schedule's point partition covers
``POINTS`` exactly — adding a fault point without teaching the soak to
arm it is a loud failure, not silent shrinkage of coverage.

``soak(model, config, device=)`` runs the replicas on ``device`` (None
= the card), on a sleep-free virtual clock.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..obs.journey import validate_journey
from ..obs.tenant import CLASSES
from .channel import (ChannelConfig, SimChannel, Transport,
                      TransportConfig, unit_hash)
from .engine import ServingConfig
from .faults import POINTS, FaultInjector
from .fleet import FleetConfig, FleetRouter

__all__ = ["ChaosConfig", "ChaosInvariantError", "build_schedule",
           "soak", "format_report"]

# the schedule's partition of POINTS: engine-grain points fire inside a
# replica's own step loop, the rest at the router/transport boundary
ENGINE_POINTS = ("prefill_fail", "chunk_fail", "decode_fail",
                 "verify_fail", "pool_exhausted", "restore_fail",
                 "slow_step")
ROUTER_POINTS = ("route_fail", "replica_down")
WIRE_POINTS = ("wire_drop", "wire_corrupt", "wire_delay", "peer_timeout")

# coverage pin: a new fault point must be placed in exactly one bucket
# before the soak will import — "all points" can never silently shrink
assert set(ENGINE_POINTS) | set(ROUTER_POINTS) | set(WIRE_POINTS) \
    == set(POINTS), "chaos schedule does not cover faults.POINTS"
assert not (set(ENGINE_POINTS) & set(ROUTER_POINTS) & set(WIRE_POINTS))


class ChaosInvariantError(AssertionError):
    """One of the soak's swept invariants failed — the message names
    the invariant, the seed, and the step."""


@dataclass(frozen=True)
class ChaosConfig:
    """One soak's shape. Defaults are the CI-sized run: 2 replicas,
    10 requests, every rate high enough that retries, corruption
    counts, and breaker trips all actually happen."""

    seed: int = 0
    num_replicas: int = 2
    requests: int = 10
    horizon: int = 16        # router steps the fault arms spread over
    max_steps: int = 600     # drain deadline (a hang is a failure)
    drop_rate: float = 0.15
    corrupt_rate: float = 0.08
    dup_rate: float = 0.08
    reorder_rate: float = 0.15
    engine: ServingConfig | None = None  # None -> the tiny CI shape
    # armed -> a ChaosInvariantError auto-dumps the cluster flight
    # recorder (fleet-record/v1) here before the error propagates
    fleet_record_path: str | None = None

    def validate(self) -> None:
        if self.num_replicas < 2:
            raise ValueError("chaos soak needs >= 2 replicas (re-home "
                             f"has nowhere to go), got {self.num_replicas}")
        if self.requests < 1:
            raise ValueError(f"requests {self.requests} < 1")
        if self.horizon < 1 or self.max_steps < self.horizon:
            raise ValueError(f"bad horizon/max_steps "
                             f"{self.horizon}/{self.max_steps}")


class _VirtualClock:
    """1.0 s per read — the serving tests' sleep-free clock."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


def _engine_config() -> ServingConfig:
    """The tiny CI engine, host tier on so page fetches and restores
    are in play."""
    return ServingConfig(max_batch=2, num_pages=20, page_size=4,
                         max_prompt_len=8, host_tier_bytes=1 << 20)


def build_schedule(cfg: ChaosConfig):
    """seed -> (router injector, per-replica injectors) with EVERY
    fault point armed once at a unit_hash-chosen step in
    ``[1, horizon]``: wire/router points on the router's injector
    (where the transport and the routing loop consult), each
    engine-grain point on a unit_hash-chosen replica's own injector.
    ``replica_down`` always targets the LAST replica and
    ``peer_timeout`` a lower-indexed one, so the victim of the outage
    and the victim of the timeout are never trivially the same box."""
    cfg.validate()
    router = FaultInjector()
    per = [FaultInjector() for _ in range(cfg.num_replicas)]
    for pi, point in enumerate(POINTS):
        step = 1 + int(unit_hash(cfg.seed, 101, pi) * cfg.horizon)
        if point == "replica_down":
            router.arm(point, step=step, rid=cfg.num_replicas - 1)
        elif point == "peer_timeout":
            peer = int(unit_hash(cfg.seed, 103, pi)
                       * (cfg.num_replicas - 1))
            # enough consecutive timed-out ATTEMPTS to fail
            # breaker_threshold whole exchanges (1 + retries attempts
            # each, the soak's default TransportConfig) — the breaker
            # must actually open, half-open, and recover in the soak
            router.arm(point, rid=peer,
                       times=3 * (1 + TransportConfig().retries))
        elif point == "wire_delay":
            router.arm(point, step=step, delay_s=10.0)  # >> timeout_s
        elif point in WIRE_POINTS or point in ROUTER_POINTS:
            router.arm(point, step=step)
        else:  # engine-grain: one replica draws it
            r = int(unit_hash(cfg.seed, 107, pi) * cfg.num_replicas)
            kw = dict(step=step)
            if point == "slow_step":
                kw["delay_s"] = 0.25
            per[r].arm(point, **kw)
    return router, per


def _check(cond: bool, cfg: ChaosConfig, step: int, msg: str) -> None:
    if not cond:
        raise ChaosInvariantError(
            f"seed {cfg.seed} step {step}: {msg}")


def _ledger_totals(snap: dict) -> tuple[int, int, int]:
    good = sum(v for k, v in snap.items()
               if k.startswith("serving_tenant_goodput_tokens_total"))
    bad = sum(v for k, v in snap.items()
              if k.startswith("serving_tenant_badput_tokens_total"))
    return int(good), int(bad), int(snap["serving_tokens_total"])


def _sweep(fl: FleetRouter, cfg: ChaosConfig, step: int) -> None:
    """The per-step invariant sweep: pool audit, journey schema,
    ledger monotonicity."""
    for i in fl._live():
        fl.replicas[i].cache.check_invariants()
    for rec in fl.journey_dump():
        validate_journey(rec)
    good, bad, total = _ledger_totals(fl.metrics.snapshot())
    _check(good + bad <= total, cfg, step,
           f"ledger overran the token counter mid-run: "
           f"{good}+{bad} > {total}")


def soak(model, config: ChaosConfig | None = None, device=None) -> dict:
    """Run one fully-armed chaos soak; returns the report dict (see
    :func:`format_report`) or raises :class:`ChaosInvariantError`.
    When ``cfg.fleet_record_path`` is set, an invariant failure dumps
    the cluster flight recorder there before the error propagates —
    the post-mortem ships with the stack trace."""
    cfg = config or ChaosConfig()
    cfg.validate()
    state: dict = {}
    try:
        return _soak_run(model, cfg, state, device)
    except ChaosInvariantError:
        fl = state.get("fleet")
        if fl is not None and cfg.fleet_record_path is not None:
            fl.dump_fleet_record(cfg.fleet_record_path,
                                 reason="chaos_invariant")
        raise


def _soak_run(model, cfg: ChaosConfig, state: dict, device) -> dict:
    router_inj, replica_injs = build_schedule(cfg)
    channel = SimChannel(ChannelConfig(
        seed=cfg.seed, drop_rate=cfg.drop_rate,
        corrupt_rate=cfg.corrupt_rate, dup_rate=cfg.dup_rate,
        reorder_rate=cfg.reorder_rate, latency_s=0.01, jitter_s=0.01))
    transport = Transport(channel, TransportConfig(
        seed=cfg.seed, timeout_s=0.5,
        hedge=unit_hash(cfg.seed, 109) < 0.5))  # both paths soaked
    fleet_cfg = FleetConfig(
        num_replicas=cfg.num_replicas,
        engine=cfg.engine or _engine_config(),
        transport=transport, fetch_pages=True)
    fl = FleetRouter(model, fleet_cfg, clock=_VirtualClock(),
                     fault_injector=router_inj,
                     replica_injectors=replica_injs, device=device)
    state["fleet"] = fl  # soak()'s auto-dump handler reaches it here
    rng = np.random.RandomState(cfg.seed)
    # arrivals trickle across the fault horizon so the fleet still
    # carries traffic when the late-armed points fire — a burst that
    # drains in three steps soaks nothing
    arrivals = sorted(
        (int(unit_hash(cfg.seed, 127, k) * cfg.horizon), k)
        for k in range(cfg.requests))
    rids: list[int] = []

    def _submit(k: int) -> None:
        prompt = rng.randint(0, 97, (2 + k % 5,)).astype(np.int32)
        tenant = ("default", "batch", "interactive")[k % 3]
        # a third of the load carries deadlines, spread wide enough
        # that only the ones the induced delays actually catch expire
        deadline = (40.0 + 400.0 * unit_hash(cfg.seed, 113, k)
                    if k % 3 == 2 else None)
        rids.append(fl.submit(prompt, 1 + k % 4, tenant=tenant,
                              deadline_s=deadline))

    steps = 0
    due = 0
    while due < len(arrivals) or fl._pending or any(
            fl.replicas[i].scheduler.running
            or fl.replicas[i].scheduler.waiting for i in fl._live()):
        while due < len(arrivals) and arrivals[due][0] <= steps:
            _submit(arrivals[due][1])
            due += 1
        _check(steps < cfg.max_steps, cfg, steps,
               f"fleet failed to drain in {cfg.max_steps} steps")
        fl.step()
        steps += 1
        _sweep(fl, cfg, steps)

    # -------------------------------------------------- terminal books
    terminal: dict[int, int] = {}
    for rec in fl.journey_dump():
        if rec["state"] is not None:
            terminal[rec["rid"]] = terminal.get(rec["rid"], 0) + 1
    missing = [r for r in rids if r not in terminal]
    doubled = [r for r, n in terminal.items() if n > 1]
    _check(not missing, cfg, steps,
           f"rids never retired: {missing}")
    _check(not doubled, cfg, steps,
           f"rids retired more than once: {doubled}")
    classes = fl.retirement_class_counts()
    by_class = {c: 0 for c in CLASSES}
    for row in classes.values():
        for c, n in row.items():
            by_class[c] += n
    _check(sum(by_class.values()) == len(rids), cfg, steps,
           f"class counts {by_class} do not sum to {len(rids)} rids")
    good, bad, total = _ledger_totals(fl.metrics.snapshot())
    _check(good + bad == total, cfg, steps,
           f"ledger does not reconcile at drain: {good}+{bad} != {total}")
    return {
        "seed": cfg.seed, "steps": steps, "requests": len(rids),
        "classes": by_class, "tenants": classes,
        "goodput_tokens": good, "badput_tokens": bad,
        "tokens_total": total,
        "wire": {
            "tx_bytes": transport.tx_bytes,
            "rx_bytes": transport.rx_bytes,
            "retries": transport.retries_total,
            "timeouts": transport.timeouts_total,
            "corrupt": transport.corrupt_total,
            "hedge_wins": transport.hedge_wins_total,
            "breaker_transitions": len(transport.breaker_events),
        },
        "channel": {
            "sent": channel.sent, "delivered": channel.delivered,
            "dropped": channel.dropped, "corrupted": channel.corrupted,
            "duplicated": channel.duplicated,
            "reordered": channel.reordered,
        },
        "faults_fired": {
            "router": len(router_inj.fired),
            "replicas": [len(j.fired) for j in replica_injs],
        },
    }


def format_report(rep: dict) -> str:
    """One seed's soak as two compact lines for the CLI."""
    cls = ", ".join(f"{c}={n}" for c, n in sorted(rep["classes"].items())
                    if n)
    w = rep["wire"]
    return (
        f"seed {rep['seed']}: {rep['requests']} requests over "
        f"{rep['steps']} steps — {cls}; ledger {rep['goodput_tokens']}"
        f"+{rep['badput_tokens']} == {rep['tokens_total']}\n"
        f"  wire: {w['tx_bytes']}B tx / {w['rx_bytes']}B rx, "
        f"{w['retries']} retries, {w['timeouts']} timeouts, "
        f"{w['corrupt']} corrupt, {w['hedge_wins']} hedge wins, "
        f"{w['breaker_transitions']} breaker transitions; faults fired "
        f"router={rep['faults_fired']['router']} "
        f"replicas={rep['faults_fired']['replicas']}")
