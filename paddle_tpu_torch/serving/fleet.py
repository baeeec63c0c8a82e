"""Fleet front-end: N engine replicas behind a prefix-affinity router — the
port of ``paddle_tpu/serving/fleet.py``. The replicas are single-card
engines in one process (``device=`` places them all; they may share one
model's weights, each with its own pool); every routing, admission,
gossip and wire decision is host Python equal to the reference's, so the
two routers send the same request to the same replica.

One :class:`~.engine.ServingEngine` is one batch; the
millions-of-users layer puts N of them behind a :class:`FleetRouter`
that makes two decisions per request the single engine cannot:

**Where** — prefix affinity. Every replica's paged KV cache exposes a
compact gossip digest (:meth:`PagedKVCache.gossip_digests`: one chained
FNV-1a value per reachable page-aligned prefix chain, device index +
host tier), refreshed at router step boundaries. The router hashes an
incoming prompt once with the same :func:`prefix_digest` helper the
local probe derives from and counts leading matches per replica — the
replica with the longest warm match serves the request without any
device state crossing the wire (digest disagreement is impossible by
construction: both sides share one key-derivation helper, pinned by a
parity test). A warm replica that is full spills the request to the
least-loaded survivor BEFORE anything is shed; cold requests go
least-loaded directly.

**Who first** — weighted per-tenant admission, the outer loop closing
the tenant ledger, which only observes. Each replica's AIMD SLO controller remains
the inner loop; the router consumes the latched ``slo_burn`` watchdog
alerts (edge-triggered, once per onset per tenant per replica) as its
error signal and multiplies the burning tenant's admission weight by
``weight_gain`` — pending requests drain in descending-weight order
(stable within a weight class, so FIFO is preserved between equals). A
tenant burning its SLO budget therefore gets capacity before one that
is not, fleet-wide, while ``TenantLedger.burn_totals()`` keeps the
books that justify it.

Observability rides the existing substrate unchanged. All replicas in
one process share the ONE monitor registry, so ``serving_*`` counters
are fleet-wide totals and ``goodput + badput == serving_tokens_total``
reconciles across replicas with no new plumbing; the fleet adds the
pre-seeded ``serving_fleet_*`` gauges (replica count, affinity hits,
spills, the per-tenant weight family). Journeys gain ``routed`` /
``spilled`` hops on the serving replica's book (the journey is born at
replica enqueue; router-queue wait shows as the gap to the hop the
router stamps) and requests the router retires unserved get
validate_journey-clean journeys in the router's OWN book (``shed`` hop,
``retired`` terminal). Chrome export merges one process track per
replica (pid = replica index + 1; timestamps are per-replica rebased).

**Wire transport** (``FleetConfig(transport=...)``, a
:class:`~.channel.Transport`): with a transport
attached, everything that crosses a replica boundary travels as
``paddle-tpu/wire/v1`` frames (:mod:`.wire`) instead of method
calls — gossip digest sets, re-homed waiters off a dead replica, and
(``fetch_pages=True``) warm prefix pages fetched from a better-matched
peer into the destination's host tier before dispatch. Every transfer
can die, and every death degrades instead of failing: a failed gossip
exchange keeps the stale digest set; a failed re-home frame falls back
to the in-process hand-off (a lost frame can never lose a request); a
corrupt/timed-out page fetch falls back to local re-prefill — counted
in ``serving_wire_refetch_fallback_total`` and stamped as a
``refetch_fallback`` journey hop, never a FAILED retirement; a peer
behind an open circuit breaker contributes zero affinity, so routing
degrades to least-loaded until the breaker half-opens. Over a lossless
channel the wire fleet is bit-identical (outputs, retirement classes,
host-sync counts) to the in-process ``transport=None`` fleet — pinned
by test; transport time runs on its own deterministic timeline
precisely so the parity can hold.

Fault points (:mod:`.faults`, consulted on the ROUTER's injector):
``route_fail`` sheds one request at its routing decision;
``replica_down`` (armed with ``rid=<replica index>``) kills a replica
at a step boundary — its never-admitted waiters drain back to the
router and re-route to survivors as spills, its in-flight requests
retire FAILED, and the ``serving_fleet_replicas`` gauge drops. With a
transport attached the same injector also drives the wire-grain points
(``wire_drop`` / ``wire_corrupt`` / ``wire_delay`` / ``peer_timeout``).
The whole fleet runs on the deterministic clock: N replicas, faults
and all, fully sleep-free-testable on CPU.

The admission path is the router: ``_try_dispatch`` is the one place a
fleet request reaches a replica's ``add_request``.
"""
from __future__ import annotations

import itertools
import json
from dataclasses import dataclass, field

import numpy as np
import torch

from ..obs import JourneyBook, TenantLedger, check_tenant_name
from ..obs import fleetscope as _fleetscope
from ..utils import monitor
from . import scheduler as _sched
from .engine import ServingConfig, ServingEngine
from .faults import InjectedFault
from .kv_cache import prefix_digest
from .metrics import COUNTER_STATS
from .metrics import PREFIX as _METRIC_PREFIX
from .metrics import TENANT_CLASSES
from .scheduler import EXPIRED, FAILED, SHED, WAITING, EngineOverloaded
from .scheduler import Request as _Request
from .wire import (WIRE_ERROR_KINDS, encode_digests, encode_page,
                   encode_rehome)

__all__ = ["FleetConfig", "FleetRouter"]

ROUTING_POLICIES = ("affinity", "round_robin")


@dataclass(frozen=True)
class FleetConfig:
    """Fleet-level knobs; ``engine`` is the per-replica ServingConfig
    (every replica is identical — heterogeneous fleets are a multi-host
    concern)."""

    num_replicas: int = 3
    engine: ServingConfig = field(default_factory=ServingConfig)
    routing: str = "affinity"  # "affinity" | "round_robin" (the A/B
    # baseline the affinity win is pinned against)
    max_replica_load: int = 0  # waiting + running cap per replica before
    # spill; 0 -> 2 * engine.max_batch
    max_pending: int = 0  # router-queue bound; 0 = unbounded (shedding
    # then only happens through route_fail)
    gossip_every: int = 1  # router steps between digest refreshes (a
    # staler gossip trades routing quality for refresh cost)
    weight_gain: float = 2.0  # admission-weight multiplier per slo_burn
    # onset (the outer-loop gain; weights never decay on their own —
    # the inner AIMD controller is the fast loop)
    transport: object = None  # a channel.Transport; None keeps every
    # replica boundary an in-process method call (the pre-wire fleet,
    # byte-for-byte — the parity baseline)
    fetch_pages: bool = False  # with a transport: fetch a warmer peer's
    # prefix pages into the destination's host tier before dispatch
    # (restores then hit locally); off by default — a fetch turns cold
    # dispatches into host-tier restores, which changes the host-sync
    # profile the lossless parity pin holds fixed
    fleetscope: bool = True  # record cross-replica exchange spans (and
    # carry their ids in the wire frames); off -> scope is None, one
    # attribute check per site, frames byte-identical to plain v1
    fleet_record_path: str | None = None  # when set, fleet records
    # auto-dumped on replica_down land here (chaos arms this too)

    def validate(self) -> None:
        if self.num_replicas < 1:
            raise ValueError(f"num_replicas {self.num_replicas} < 1")
        if self.routing not in ROUTING_POLICIES:
            raise ValueError(f"routing {self.routing!r} not in "
                             f"{ROUTING_POLICIES}")
        if self.max_replica_load < 0:
            raise ValueError(
                f"max_replica_load {self.max_replica_load} < 0")
        if self.max_pending < 0:
            raise ValueError(f"max_pending {self.max_pending} < 0")
        if self.gossip_every < 1:
            raise ValueError(f"gossip_every {self.gossip_every} < 1")
        if self.weight_gain <= 1.0:
            raise ValueError(
                f"weight_gain {self.weight_gain} must be > 1 (a gain "
                f"<= 1 could never grant a burning tenant capacity)")
        if self.fetch_pages and self.transport is None:
            raise ValueError("fetch_pages needs a transport (pages "
                             "move as wire frames, never in-process)")
        if self.fetch_pages and not self.engine.host_tier_bytes:
            raise ValueError(
                "fetch_pages needs engine.host_tier_bytes > 0 — the "
                "host tier is the landing zone fetched pages restore "
                "from")


@dataclass(eq=False)  # identity semantics: the ndarray prompt field
class _Pending:
    """One request the router has accepted but not yet homed."""
    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    deadline: float | None  # ABSOLUTE engine-clock time (shared clock)
    tenant: str
    seq: int          # arrival order (the FIFO tiebreak inside a weight)
    submit_t: float   # router-clock submit time (shed journeys keep it)
    spill: bool = False  # re-homed off a dead replica: lands as a spill


class FleetRouter:
    """N serving replicas behind prefix-affinity routing and
    ledger-weighted admission. Build it, ``submit()`` requests,
    ``run()`` (or ``step()``) until drained, then drain
    ``pop_finished()`` / ``pop_retired()`` exactly like a bare engine.

    All replicas are constructed HERE, before any traffic: each engine's
    metrics reset wipes the process-global registry, so constructing a
    replica after traffic would erase the fleet's counters. ``device``
    (None = the card) is every replica's; ``model`` lives there.
    """

    def __init__(self, model, config: FleetConfig | None = None,
                 clock=None, fault_injector=None,
                 replica_injectors=None, device=None):
        self.config = cfg = config or FleetConfig()
        cfg.validate()
        if replica_injectors is not None \
                and len(replica_injectors) != cfg.num_replicas:
            raise ValueError(
                f"replica_injectors has {len(replica_injectors)} "
                f"entries for {cfg.num_replicas} replicas")
        self.fault_injector = fault_injector
        # every replica before any request: see the class docstring
        self.replicas = [
            ServingEngine(model, cfg.engine, device=device, clock=clock,
                          fault_injector=(replica_injectors[i]
                                          if replica_injectors else None))
            for i in range(cfg.num_replicas)]
        self.metrics = self.replicas[0].metrics
        self._page_size = cfg.engine.page_size
        self._down: set[int] = set()
        self._gossip: list[frozenset] = [frozenset()] * cfg.num_replicas
        self._pending: list[_Pending] = []
        self._retired: dict[int, _Request] = {}
        self._step_idx = 0
        self._seq = itertools.count()
        self._rr_next = 0  # round_robin rotation cursor
        self._alerts_seen = [0] * cfg.num_replicas
        # router-retired requests (shed/expired before reaching any
        # replica) get journeys + ledger entries HERE — the replica books
        # never saw them, but reconciliation must
        self._book = JourneyBook(lambda: self._step_idx,
                                 capacity=cfg.engine.trace_capacity)
        self._ledger = TenantLedger(cfg.engine.tenants)
        #: rid -> (replica index, "routed" | "spilled", affinity tokens)
        self.routes: dict[int, tuple[int, str, int]] = {}
        #: (router step, tenant, new weight) per slo_burn actuation —
        #: the once-per-onset pin reads this
        self.weight_changes: list[tuple[int, str, float]] = []
        self._weights: dict[str, float] = {}
        self.transport = cfg.transport
        #: the fleetscope span recorder (None when cfg.fleetscope is
        #: off — every consult is one attribute check, the tracer-None
        #: idiom) and the most recent fleet record assembled by an
        #: auto-dump
        self.scope = _fleetscope.FleetScope(
            capacity=cfg.engine.trace_capacity) if cfg.fleetscope \
            else None
        self.last_fleet_record: dict | None = None
        self._gossip_step = [0] * cfg.num_replicas
        if self.transport is not None:
            self.transport.attach(metrics=self.metrics,
                                  injector=fault_injector,
                                  scope=self.scope)
        # wire families are pre-seeded whether or not a transport is
        # attached — the presence contract is about
        # dashboards, and a dashboard doesn't know the fleet's config
        self.metrics.seed_family("wire_corrupt_total",
                                 list(WIRE_ERROR_KINDS))
        self.metrics.seed_family("breaker_open_total",
                                 [str(i) for i in range(cfg.num_replicas)])
        self.metrics.seed_family("wire_bytes_total",
                                 ["page", "digests", "rehome"])
        self.metrics.seed_wire_peers(range(cfg.num_replicas))
        self.metrics.on_fleet_replicas(cfg.num_replicas)
        for t in ["default"] + sorted(
                n for n in (cfg.engine.tenants or {}) if n != "default"):
            self._ensure_tenant(t)

    # ----------------------------------------------------------- plumbing
    def now(self) -> float:
        return self.replicas[0].now()

    def _open_span(self, *, kind: str, src, dst=None, rid=None):
        """Begin one fleetscope exchange span (None when the scope is
        detached) — opened on the TRANSPORT timeline, where the child
        spans will land."""
        sc = self.scope
        if sc is None:
            return None
        return sc.open(kind=kind, src=src, dst=dst, rid=rid,
                       step=self._step_idx, t=self.transport.t)

    def _meter_exchange(self, kind: str) -> None:
        """Feed the per-peer transport families from the ExchangeInfo
        the exchange just left in ``transport.last`` — rtt (whole
        exchange, backoffs included), copies sent, and tx bytes by
        frame type."""
        info = self.transport.last
        self.metrics.on_wire_exchange(
            info.peer, rtt_s=info.t_end - info.t_start,
            attempts=info.attempts)
        self.metrics.on_wire_frame_bytes(kind, info.tx_bytes)

    def _live(self) -> list[int]:
        return [i for i in range(len(self.replicas))
                if i not in self._down]

    def _load(self, i: int) -> int:
        s = self.replicas[i].scheduler
        return s.queue_depth + len(s.running)

    def _capacity(self) -> int:
        return self.config.max_replica_load \
            or 2 * self.config.engine.max_batch

    def _ensure_tenant(self, tenant: str) -> None:
        if tenant in self._weights:
            return
        check_tenant_name(tenant)
        self._weights[tenant] = 1.0
        self.metrics.seed_family("fleet_tenant_weight", [tenant])
        self.metrics.on_fleet_tenant_weight(tenant, 1.0)
        self._ledger.ensure(tenant)

    def weight(self, tenant: str) -> float:
        """The tenant's current admission weight (1.0 unless slo_burn
        has actuated it)."""
        return self._weights.get(tenant, 1.0)

    # ------------------------------------------------------------- intake
    def submit(self, prompt, max_new_tokens: int,
               deadline_s: float | None = None,
               tenant: str = "default") -> int:
        """Accept one request into the fleet; returns its rid (drawn
        from the same process-global counter the engines use, so one id
        names the request across every routing hop and re-home). The
        request dispatches immediately when the router queue is empty
        and a replica has room; otherwise it waits in the router's
        pending queue and drains in weighted order at ``step()``. A
        full pending queue (``max_pending``) sheds the NEWCOMER — never
        a request already accepted — and only after spillover across
        every live replica has failed."""
        self._ensure_tenant(tenant)
        if isinstance(prompt, torch.Tensor):
            prompt = prompt.detach().cpu().numpy()
        prompt = np.asarray(prompt)
        if prompt.ndim != 1:
            raise ValueError(f"prompt must be 1-D, got {prompt.shape}")
        if prompt.shape[0] == 0:
            raise ValueError("prompt must contain at least one token")
        if int(max_new_tokens) <= 0:
            raise ValueError("max_new_tokens must be positive")
        if prompt.shape[0] > self.config.engine.max_prompt_len:
            raise ValueError(
                f"prompt_len {prompt.shape[0]} exceeds max_prompt_len "
                f"{self.config.engine.max_prompt_len}")
        p = _Pending(
            rid=next(_sched._rid_counter), prompt=prompt.astype(np.int32),
            max_new_tokens=int(max_new_tokens),
            deadline=(self.now() + float(deadline_s)
                      if deadline_s is not None else None),
            tenant=tenant, seq=next(self._seq), submit_t=self.now())
        if not self._pending and self._try_dispatch(p):
            return p.rid
        if self.config.max_pending \
                and len(self._pending) >= self.config.max_pending:
            # capacity may have freed since the last step: drain first,
            # shed the newcomer only when spillover truly has nowhere
            self._drain_pending()
            if len(self._pending) >= self.config.max_pending:
                self._retire_local(p, SHED, "router_queue_full")
                return p.rid
        self._pending.append(p)
        return p.rid

    # ------------------------------------------------------------ routing
    def _affinity(self, digests: tuple, i: int) -> int:
        """Warm-match tokens replica ``i``'s gossiped digest set holds
        for a prompt with chain ``digests`` — the router-side mirror of
        ``cached_prefix_tokens`` (parity-pinned). A peer behind an OPEN
        circuit breaker contributes zero: its digests are stale by
        definition (every refresh is failing), so affinity routing
        degrades to least-loaded until the breaker half-opens."""
        if self.transport is not None and self.transport.peer_open(i):
            return 0
        n = 0
        for d in digests:
            if d not in self._gossip[i]:
                break
            n += 1
        return n * self._page_size

    def _refresh_gossip(self, i: int) -> frozenset:
        """Replica ``i``'s current digest set, through the transport
        when one is attached (one digests frame each way). A failed
        exchange — loss past the retry budget, timeout, open breaker —
        keeps the STALE set: gossip is advisory, so degradation costs
        at worst a suboptimal route, never a lost refresh loop."""
        digests = self.replicas[i].cache.gossip_digests()
        if self.transport is None:
            return digests
        sid = self._open_span(kind="digests", src=i, rid=None)
        got = self.transport.exchange(
            i, [encode_digests(digests, span=sid)],
            step=self._step_idx, rid=None, span=sid)
        self._meter_exchange("digests")
        if got is None:
            return self._gossip[i]
        return got[0][1]

    def _fetch_pages(self, p: _Pending, dest: int):
        """Cross-replica KV-fabric fetch for one placed request: when a
        live peer's gossiped digests hold a strictly longer warm match
        than the destination, export that peer's prefix chain, move it
        as page frames through the transport (hedged per the transport
        config), and import it into the destination's host tier — the
        admission that follows then restores the pages as an ordinary
        (bit-exact) host-tier hit. Returns ``(donor, ok, info)`` with
        donor None when no fetch was warranted; a failed fetch is the
        caller's cue to stamp ``refetch_fallback`` and dispatch anyway
        (local re-prefill) — NEVER to fail the request."""
        digests = prefix_digest(p.prompt, self._page_size)
        local = self._affinity(digests, dest)
        donors = [j for j in self._live() if j != dest
                  and self._affinity(digests, j) > local]
        if not donors:
            return (None, True, None)
        donor = max(donors, key=lambda j: (self._affinity(digests, j), -j))
        src = self.replicas[donor].cache
        entries = src.export_prefix_chain(
            p.prompt, max_pages=src.cfg.pages_per_seq)
        if not entries:
            return (None, True, None)  # stale gossip: nothing to move
        sid = self._open_span(kind="page", src=donor, dst=dest,
                              rid=p.rid)
        got = self.transport.exchange(
            donor, [encode_page(e, span=sid) for e in entries],
            step=self._step_idx, rid=p.rid, span=sid)
        self._meter_exchange("page")
        info = self.transport.last
        if got is None:
            return (donor, False, info)
        self.replicas[dest].cache.import_spilled_chain(
            [v for _, v in got])
        return (donor, True, info)

    def _place(self, p: _Pending) -> tuple[int, str, int] | None:
        """(replica, kind, affinity_tokens) for one request, or None
        when no live replica has room (the caller keeps it pending).
        Affinity order: longest warm match with room, else spill to the
        least-loaded live replica with room; cold requests go
        least-loaded directly. Round-robin ignores warmth (the A/B
        baseline)."""
        cap = self._capacity()
        live = self._live()
        if not live:
            return None
        room = [i for i in live if self._load(i) < cap]
        if not room:
            return None
        if self.config.routing == "round_robin":
            n = len(self.replicas)
            for off in range(n):
                i = (self._rr_next + off) % n
                if i in room:
                    self._rr_next = (i + 1) % n
                    return (i, "spilled" if p.spill else "routed", 0)
            return None
        digests = prefix_digest(p.prompt, self._page_size)
        warm = max(live, key=lambda i: (self._affinity(digests, i),
                                        -self._load(i), -i))
        tokens = self._affinity(digests, warm)
        least = min(room, key=lambda i: (self._load(i), i))
        if tokens and warm in room:
            return (warm, "spilled" if p.spill else "routed", tokens)
        if tokens:  # warm replica exists but is full: spill before shed
            return (least, "spilled", self._affinity(digests, least))
        return (least, "spilled" if p.spill else "routed", 0)

    def _try_dispatch(self, p: _Pending) -> bool:
        """Route one request now. True when it left the router's hands
        (dispatched OR consumed by a route_fail shed); False keeps it
        pending."""
        inj = self.fault_injector
        if inj is not None and inj.hit("route_fail", step=self._step_idx,
                                       rid=p.rid) is not None:
            self._retire_local(p, SHED, "route_fail")
            return True
        if p.deadline is not None and self.now() >= p.deadline:
            self._retire_local(p, EXPIRED, "deadline")
            return True
        placed = self._place(p)
        if placed is None:
            return False
        i, kind, affinity_tokens = placed
        donor, fetch_ok, fetch_info = (None, True, None)
        if self.transport is not None and self.config.fetch_pages:
            # move a warmer peer's pages BEFORE dispatch so the
            # admission below restores them as a plain host-tier hit;
            # a dead fetch degrades to local re-prefill, stamped below
            donor, fetch_ok, fetch_info = self._fetch_pages(p, i)
        eng = self.replicas[i]
        remaining = None if p.deadline is None \
            else max(p.deadline - self.now(), 0.0)
        try:
            # THE dispatch site: every fleet request passes through the
            # weighted admission above to reach it
            rid = eng.add_request(
                p.prompt, p.max_new_tokens, deadline_s=remaining,
                tenant=p.tenant, rid=p.rid)
        except EngineOverloaded:
            return False  # bounded engine queue raced us: stay pending
        tr = eng._tracer
        if tr is not None:
            tr.event(rid, "routed" if kind == "routed" else "spilled",
                     replica=i, affinity_tokens=affinity_tokens)
            if fetch_info is not None:
                # the journey is born at the enqueue above, so the
                # fetch's transport hops are stamped here, just after.
                # The span ref is a v1-compatible hop extension (hops
                # are open dicts): absent when fleetscope is off
                sp = {} if fetch_info.span is None else {
                    "span": _fleetscope.span_key(fetch_info.span)}
                for k in range(fetch_info.retries):
                    tr.event(rid, "wire_retry", peer=donor,
                             attempt=k + 1, **sp)
                if fetch_info.breaker_open:
                    tr.event(rid, "breaker_open", peer=donor, **sp)
            if not fetch_ok:
                tr.event(rid, "refetch_fallback", peer=donor, **sp)
        if not fetch_ok:
            self.metrics.on_wire_refetch_fallback()
        self.routes[rid] = (i, kind, affinity_tokens)
        if kind == "spilled":
            self.metrics.on_fleet_spill()
        elif affinity_tokens:
            self.metrics.on_fleet_affinity_hit()
        return True

    def _drain_pending(self) -> None:
        """Dispatch what fits, in weighted order: descending tenant
        weight, arrival order inside a weight class (stable — equal
        weights keep FIFO)."""
        if not self._pending:
            return
        order = sorted(self._pending,
                       key=lambda p: (-self._weights.get(p.tenant, 1.0),
                                      p.seq))
        left = []
        for p in order:
            if not self._try_dispatch(p):
                left.append(p)
        left.sort(key=lambda p: p.seq)  # pending stays in arrival order
        self._pending = left

    # ----------------------------------------------------- router retires
    def _retire_local(self, p: _Pending, state: str, reason: str) -> None:
        """Terminal exit for a request that never reached a replica:
        record it, close a validate_journey-clean journey in the
        router's own book, and settle the fleet ledger so per-tenant
        class counts still cover every accepted request."""
        req = _Request(prompt=p.prompt, max_new_tokens=p.max_new_tokens,
                       rid=p.rid, tenant=p.tenant)
        req.state = state
        self._retired[p.rid] = req
        now = self.now()
        self._book.begin(p.rid, p.tenant)
        self._book.on_event(p.rid, "enqueued", p.submit_t, None)
        if state == SHED:
            self._book.on_event(p.rid, "shed_by_router", now,
                                {"reason": reason})
            self.metrics.on_shed()
        else:
            self.metrics.on_expired()
        self._book.on_event(p.rid, "retired", now,
                            {"state": state, "tokens": 0})
        cls = self._ledger.on_retire(p.tenant, state, ttft=None,
                                     tpot=None, tokens=0)
        self.metrics.on_tenant_retire(p.tenant, cls, 0)

    # ------------------------------------------------------- replica death
    def _mark_down(self, i: int) -> None:
        """One replica dies at a step boundary: never-admitted waiters
        drain back to the router (they re-route to survivors as
        spills), in-flight requests — admitted, prefilled, or preempted
        with generated tokens — retire FAILED on the dead replica's
        books, and the replica leaves the routing set."""
        self._down.add(i)
        self._gossip[i] = frozenset()
        eng = self.replicas[i]
        fault = InjectedFault(f"replica_down: replica {i}")
        for req in list(eng.scheduler.waiting):
            if req.state == WAITING and req.preemptions == 0 \
                    and not req.generated:
                # clean waiter: no device state, no emitted tokens —
                # re-home it under its own rid. Its journey on the dead
                # replica stays non-terminal (a spilled hop marks the
                # hand-back); the survivor's book carries the real one.
                tr = eng._tracer
                if tr is not None:
                    tr.event(req.rid, "spilled", replica=i,
                             reason="replica_down")
                eng.scheduler.evict(req)
                eng._requests.pop(req.rid, None)
                pend = _Pending(
                    rid=req.rid, prompt=req.prompt,
                    max_new_tokens=req.max_new_tokens,
                    deadline=req.deadline, tenant=req.tenant,
                    seq=next(self._seq), submit_t=self.now(),
                    spill=True)
                if self.transport is not None:
                    # the waiter travels as a rehome frame; when the
                    # exchange dies the LOCAL copy re-homes instead (a
                    # lost frame can never lose a request — the frame
                    # is the transport, not the custody)
                    sid = self._open_span(kind="rehome", src=i,
                                          rid=req.rid)
                    got = self.transport.exchange(
                        i, [encode_rehome(req.rid, req.prompt,
                                          req.max_new_tokens,
                                          req.deadline, req.tenant,
                                          span=sid)],
                        step=self._step_idx, rid=req.rid, span=sid)
                    self._meter_exchange("rehome")
                    info = self.transport.last
                    if tr is not None:
                        sp = {} if info.span is None else {
                            "span": _fleetscope.span_key(info.span)}
                        for k in range(info.retries):
                            tr.event(req.rid, "wire_retry", peer=i,
                                     attempt=k + 1, **sp)
                        if info.breaker_open:
                            tr.event(req.rid, "breaker_open", peer=i,
                                     **sp)
                    if got is not None:
                        rh = got[0][1]
                        pend = _Pending(
                            rid=rh.rid, prompt=rh.prompt,
                            max_new_tokens=rh.max_new_tokens,
                            deadline=rh.deadline, tenant=rh.tenant,
                            seq=pend.seq, submit_t=pend.submit_t,
                            spill=True)
                self._pending.append(pend)
            else:
                eng._retire(req, FAILED, fault)  # counts serving_failed
        for req in list(eng.scheduler.running.values()):
            eng._retire(req, FAILED, fault)
        self.metrics.on_fleet_replicas(len(self._live()))
        # a replica death is exactly what the cluster flight recorder
        # exists for — capture the fleet's state at the boundary
        self._fleet_auto(f"replica_down: replica {i}")

    # ------------------------------------------------------------ stepping
    def step(self) -> list[int]:
        """One fleet step: consult replica_down, refresh gossip, expire
        + drain the pending queue in weighted order, step every live
        replica with work, then consume new slo_burn alerts into
        admission weights (exactly one gain per onset — the watchdog's
        edge trigger is the dedupe). Returns the rids that finished
        this step, fleet-wide."""
        self._step_idx += 1
        inj = self.fault_injector
        if inj is not None:
            for i in list(self._live()):
                if inj.hit("replica_down", step=self._step_idx,
                           rid=i) is not None:
                    self._mark_down(i)
        if (self._step_idx - 1) % self.config.gossip_every == 0:
            for i in self._live():
                self._gossip[i] = self._refresh_gossip(i)
                self._gossip_step[i] = self._step_idx
        now = self.now()
        expired = [p for p in self._pending
                   if p.deadline is not None and now >= p.deadline]
        if expired:
            self._pending = [p for p in self._pending
                             if p not in expired]
            for p in expired:
                self._retire_local(p, EXPIRED, "deadline")
        self._drain_pending()
        finished: list[int] = []
        for i in self._live():
            eng = self.replicas[i]
            s = eng.scheduler
            if s.running or s.waiting:
                finished.extend(eng.step())
        for i in self._live():
            alerts = self.replicas[i].alerts()
            fresh = alerts[self._alerts_seen[i]:]
            self._alerts_seen[i] = len(alerts)
            for a in fresh:
                if a.rule == "slo_burn":
                    self._actuate_weight(a.data.get("tenant", "default"))
        # fleet goodput roll-up: the sum of every tenant's in-SLO
        # tokens, mirrored once per step (the host_tier mirror idiom)
        self.metrics.on_fleet_goodput(sum(
            int(monitor.stat_get(
                _METRIC_PREFIX
                + f"tenant_goodput_tokens_total{{tenant={t}}}", 0))
            for t in self._weights))
        return finished

    def _actuate_weight(self, tenant: str) -> None:
        self._ensure_tenant(tenant)
        w = self._weights[tenant] * self.config.weight_gain
        self._weights[tenant] = w
        self.metrics.on_fleet_tenant_weight(tenant, w)
        self.weight_changes.append((self._step_idx, tenant, w))

    def run(self, max_steps: int = 100000) -> dict[int, np.ndarray]:
        """Step until the fleet drains (no pending, every live replica
        idle); returns {rid: output tokens} for requests COMPLETED by
        this call — the engine ``run()`` contract, fleet-wide."""
        done: dict[int, np.ndarray] = {}
        steps = 0
        while True:
            if not self._pending and not any(
                    self.replicas[i].scheduler.running
                    or self.replicas[i].scheduler.waiting
                    for i in self._live()):
                break
            for rid in self.step():
                for i in self._live():
                    out = self.replicas[i]._finished.get(rid)
                    if out is not None:
                        done[rid] = out
                        break
            steps += 1
            if steps > max_steps:
                raise RuntimeError(
                    f"fleet loop exceeded {max_steps} steps without "
                    f"draining: pending={len(self._pending)}, loads="
                    f"{[self._load(i) for i in self._live()]}")
        return done

    # -------------------------------------------------------- aggregation
    def status(self, rid: int) -> str:
        """Lifecycle state of a request anywhere in the fleet (router
        pending/retired or any replica). KeyError for unknown rids."""
        if any(p.rid == rid for p in self._pending):
            return "pending"
        if rid in self._retired:
            return self._retired[rid].state
        for eng in self.replicas:
            try:
                return eng.status(rid)
            except KeyError:
                continue
        raise KeyError(f"unknown rid {rid}")

    def pop_finished(self) -> dict[int, np.ndarray]:
        """Drain every completed output, fleet-wide (the bare engine's
        long-lived-server memory contract)."""
        out: dict[int, np.ndarray] = {}
        for eng in self.replicas:
            out.update(eng.pop_finished())
        return out

    def pop_retired(self) -> dict[int, _Request]:
        """Drain every non-completion retirement: replica retirements
        plus the router's own (shed / expired before reaching a
        replica)."""
        out: dict[int, _Request] = {}
        for eng in self.replicas:
            out.update(eng.pop_retired())
        out.update(self._retired)
        self._retired = {}
        return out

    def alerts(self) -> list:
        """Every watchdog alert across the fleet, replica order then
        age order."""
        out = []
        for eng in self.replicas:
            out.extend(eng.alerts())
        return out

    def journeys(self) -> list:
        """Every retained journey: each replica's book (a re-homed
        request appears on the dead replica as a non-terminal record
        AND on its survivor as the real one) plus the router's own
        shed/expired journeys."""
        out = []
        for eng in self.replicas:
            out.extend(eng.journeys())
        out.extend(self._book.journeys())
        return out

    def journey_dump(self) -> list[dict]:
        """The fleet's wire journeys (``paddle-tpu/journey/v1`` dicts) —
        the trace the fleet simulator replays."""
        return [j.to_wire() for j in self.journeys()]

    def retirement_class_counts(self) -> dict[str, dict[str, int]]:
        """{tenant: {class: count}} across the whole fleet, read off the
        shared metric registry (replica ledgers + the router's own) —
        the live side of the simulator's exact-replay pin."""
        out: dict[str, dict[str, int]] = {}
        for tenant in self._weights:
            out[tenant] = {
                cls: int(monitor.stat_get(
                    _METRIC_PREFIX
                    + f"tenant_retired_total{{tenant={tenant},"
                    f"class={cls}}}", 0))
                for cls in TENANT_CLASSES}
        return out

    def fleet_metrics(self) -> "_fleetscope.FleetMetrics":
        """The merged fleet scrape: one registry snapshot per replica,
        each sample gaining a ``replica=`` label. In-process replicas
        share ONE registry, so every replica reports the same snapshot
        — this is the schema (and the exact exposition pipeline) the
        multi-host fleet will fill with genuinely distinct ones."""
        snap = self.metrics.snapshot()
        return _fleetscope.FleetMetrics(
            {i: snap for i in range(len(self.replicas))},
            types={k: "counter" for k in COUNTER_STATS})

    def spans(self, rid) -> list | None:
        """Every recorded exchange span for one request id — None when
        fleetscope is off (the obs-off contract: surfaces go quiet,
        they never raise)."""
        sc = self.scope
        if sc is None:
            return None
        return sc.spans_for(rid)

    # ------------------------------------------------- cluster recorder
    def fleet_record(self, reason: str = "manual") -> dict:
        """Assemble a ``paddle-tpu/fleet-record/v1``: every replica's
        flight record (v2 schema each), router state, the exchange-span
        ring, and the merged replica-attributed alert history."""
        n = len(self.replicas)
        tr = self.transport
        router = {
            "step": self._step_idx,
            "weights": {t: float(w)
                        for t, w in sorted(self._weights.items())},
            "gossip_ages": [self._step_idx - self._gossip_step[i]
                            for i in range(n)],
            "pending": [p.rid for p in self._pending],
            "live": self._live(),
            "down": sorted(self._down),
            "routes": {str(rid): list(v) for rid, v in
                       list(self.routes.items())[-64:]},
            "weight_changes": [list(w) for w in self.weight_changes],
            "breakers": ({str(p): br.state
                          for p, br in sorted(tr.breakers.items())}
                         if tr is not None else {}),
        }
        return _fleetscope.build_fleet_record(
            reason=reason, now=self.now(), step=self._step_idx,
            replicas=[eng.flight_record(reason=f"fleet: {reason}")
                      for eng in self.replicas],
            router=router,
            exchanges=(self.scope.records()
                       if self.scope is not None else []),
            alerts=[dict(a.asdict(), replica=i)
                    for i, eng in enumerate(self.replicas)
                    for a in eng.alerts()])

    def dump_fleet_record(self, path, reason: str = "manual") -> dict:
        """Assemble, validate, and write one fleet record; returns the
        record (also kept as ``last_fleet_record``)."""
        rec = self.fleet_record(reason)
        self.last_fleet_record = rec
        return _fleetscope.dump_fleet_record(path, rec)

    def _fleet_auto(self, reason: str) -> None:
        """Auto-capture on replica_down: the record is always kept in
        memory; ``config.fleet_record_path`` additionally lands it on
        disk."""
        path = self.config.fleet_record_path
        if path:
            self.dump_fleet_record(path, reason)
        else:
            self.last_fleet_record = self.fleet_record(reason)

    def export_chrome_trace(self, path=None) -> dict:
        """The merged fleet Chrome trace: one process per replica
        (pid = index + 1, named ``paddle_tpu.serving/replica<i>``), each
        carrying its engine/request/tenant tracks. Per-replica
        timestamp rebase is preserved — tracks align at each replica's
        own first event, which on the shared deterministic clock is the
        same instant. Writes JSON to ``path`` when given; returns the
        document either way."""
        events = []
        for i, eng in enumerate(self.replicas):
            doc = eng.export_chrome_trace()
            for ev in doc["traceEvents"]:
                ev = dict(ev)
                ev["pid"] = i + 1
                if ev.get("ph") == "M" and ev.get("name") == "process_name":
                    ev["args"] = {
                        "name": f"paddle_tpu.serving/replica{i}"}
                events.append(ev)
        if self.transport is not None and self.transport.breaker_events:
            # circuit-breaker transitions get their own process track —
            # they live on the transport's deterministic timeline, not
            # any replica's clock, so they must not share a rebase
            pid = len(self.replicas) + 1
            events.append({"name": "process_name", "ph": "M",
                           "pid": pid, "tid": 0,
                           "args": {"name":
                                    "paddle_tpu.serving/transport"}})
            for t, peer, state in self.transport.breaker_events:
                events.append({"name": f"breaker:{state}", "ph": "i",
                               "ts": t * 1e6, "pid": pid, "tid": 0,
                               "s": "g", "cat": "transport",
                               "args": {"peer": peer, "state": state}})
        if self.scope is not None and self.scope.records():
            # fleetscope exchange spans: X slices + flow arrows (ph
            # "s"/"f") from the sender's wire lane to the receiver's,
            # on the transport timeline like the breaker instants
            events.extend(_fleetscope.flow_events(
                self.scope.records(),
                transport_pid=len(self.replicas) + 1))
        doc = {"traceEvents": events, "displayTimeUnit": "ms"}
        if path is not None:
            with open(path, "w") as f:
                json.dump(doc, f)
        return doc
