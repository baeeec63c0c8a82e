"""The serving loop: scheduler + paged cache + model — the port of
``paddle_tpu/serving/engine.py``: greedy and sampled decoding, prefix
caching, recompute and swap preemption, float or int8 KV pools, the host
spill tier, chunked prefill, speculative decoding, the bounded waiting
queue with shedding, deadlines, cancellation, fault injection, the
observability layer and the SLO chunk-admission controller.

Each ``step()``: sweep deadlines; admit waiting requests FIFO (a swapped
victim's pages are copied back instead); prefill each newcomer — its
uncached prompt tail right-padded to the smallest pad bucket, queries
entering at ``ctx = cached tokens`` — or, with ``chunk_size``, hold it
PREFILLING and advance the prefilling requests by one chunk each (queries
at ``ctx = tokens already prefilled``, the same ragged contract), at most
the SLO controller's ``chunk_limit`` of them; make sure every decoding
slot has pages for its next token, plus the speculative depth K with
``spec`` (preempting when the pool is dry); then one decode step for the
whole ``[max_batch]`` batch, or with ``spec`` one verify step that
proposes K tokens a row and checks all K + 1 in one ragged pass.
Inactive slots run the same computation against the null page and emit
pad.

Sampling (``do_sample``): token ``t`` of request ``rid`` is drawn from
its logits (temperature, top-k, top-p) under the key
``fold_in(fold_in(key(seed), rid), t)`` of :mod:`..random`, the
reference's threefry: a request's tokens are a function of its identity,
so a recompute replay, a chunked prefill and a speculative verify all
draw the tokens plain decoding draws, and so does the JAX engine.

The JAX engine compiles one program per pad bucket plus the decode and
verify programs and donates the pools to them. PyTorch runs eagerly: the
pad buckets are kept so the two engines compute over the same shapes, and
the pools are written in place by the model. Sampling, proposing and
accepting run on the engine's device inside the step. The host reads the
device once per completed prefill (its first token, ``.item()``), once
per decode step (the batch's tokens, ``.cpu()``) and once per verify step
(the packed ``[batch, K + 2]`` targets and accept counts, ``.cpu()``); a
prefill chunk that does not finish its prompt reads nothing. Swap copies
and host-tier spills and restores are the cache's own copies.

Observability (``enable_tracing``, on by default, :mod:`..obs`): every
request accrues a lifecycle trace and a journey off the engine clock, the
engine keeps a bounded step timeline whose records split each step's wall
time across its phases (admit, swap, prefill, chunk_prefill, decode or
verify, evict, other), a per-tenant goodput ledger
(``add_request(tenant=)``, ``ServingConfig(tenants=)``), edge-triggered
watchdogs and a flight recorder dumped on every FAILED retirement, an
engine-fatal exception and the stuck-engine backstop. ``self.metrics``
(:class:`.metrics.ServingMetrics`) holds the reference's ``serving_*``
gauges and histograms either way. All of it is host work on values the
step already holds: tracing adds no device read. Clock reads happen at
the reference's points and in its order, so under one deterministic clock
both engines record the same events, step records and metric values.
``ServingConfig(slo=)`` closes the loop: the :class:`.slo.SLOController`
windows the step and TPOT histograms and sets how many prefill chunks a
step may run, and while degraded admission prefers warm prefix-cache
waiters.

Faults (``fault_injector=``, :mod:`.faults`) fire before the change they
poison and retire only the requests they name (FAILED, the error kept on
the request); a failed host-tier restore does the same. Any other
exception in a step is the engine's: the port writes its pools in place,
so a forward that raised may have written part of a request's pages, and
the step raises instead of serving on, after flushing the partial step
record and dumping the flight record. The clock (``clock=``, default
``time.monotonic``) plus the ``slow_step`` skew is the time base of
deadlines, ``run(budget_s=)`` and every trace.

Tensor parallelism (``tensor_parallel=N``, :mod:`.tp`): each of N ranks
of a ``torch.distributed`` group (``distributed.init_parallel_env``)
builds the engine with the same full model; the engine keeps the rank's
Megatron shard of it and a pool of the rank's ``heads / N`` heads, and
every paged forward runs inside ``text.gpt.tp_axis``, so a step issues
``2 * num_layers + 1`` all-reduces (``+ 1`` with
``tp_quantized_logits``). Every rank runs the same scheduler, keys and
sampling on the same reduced logits, and reads the device as often as a
single-card engine does. A draft model is replicated and runs with no
reduction.

A ``ServingConfig`` field of the reference the port does not serve yet
(``mesh_topology`` and the debug checks, which only the reference's
compiled-program audits read) is accepted at the reference's default
only; any other value raises NotImplementedError naming the ROADMAP item
that brings it.
"""
from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, fields

import numpy as np
import torch

from .. import random
from .._device import resolve_device
from ..obs import (ALERT_RULES, JourneyBook, PhaseAccumulator,
                   RooflineTracker, StepRecord, StepTimeline, TenantLedger,
                   TenantSLO, Tracer, Watchdog, WatchdogConfig,
                   build_flight_record, check_tenant_name, chrome_trace,
                   write_chrome_trace)
from ..obs.recorder import MAX_FLIGHT_JOURNEYS
from ..obs.recorder import dump_flight_record as _write_flight_record
from ..text.generation import sample_logits
from ..text.gpt import GPTForCausalLM, PagedBatch, tp_axis
from ..utils import monitor
from .faults import InjectedFault
from .kv_cache import KV_DTYPES, PagedCacheConfig, PagedKVCache
from .metrics import ServingMetrics
from .scheduler import (CANCELLED, EXPIRED, FAILED, FINISHED, PREFILLING,
                        RUNNING, SHED, WAITING, EngineOverloaded, Request,
                        Scheduler)
from .slo import SLOConfig, SLOController
from .spec import SpecConfig, accept_counts, draft_window, propose_ngram
from .tp import TPContext

__all__ = ["ServingConfig", "EngineCounters", "ServingEngine",
           "prefill_buckets"]

_AUDITS = "the analysis contracts: ROADMAP Queue 1 item 11"
# Reference ServingConfig fields the port does not serve yet: the only
# value accepted (the reference's default) and where it is planned.
# mesh_topology is read only by the reference's debug_checks audit.
_LATER = {
    "mesh_topology": (None, _AUDITS),
    "debug_checks": (False, _AUDITS),
}


@dataclass(frozen=True)
class ServingConfig:
    """The reference's fields, in its order, with its defaults. Served:
    the batch and pool shape, sampling (``do_sample``, ``temperature``,
    ``top_k``, ``top_p``, ``seed``), eos/pad, the bounded queue
    (``max_waiting``, ``shed_policy`` "reject" | "shed-oldest"),
    ``preemption_mode`` ("recompute" | "swap"), prefix caching,
    ``chunk_size`` (prompt tokens a prefilling request advances a step;
    0 = the whole tail at once), ``kv_dtype`` ("float32" = the model's
    dtype | "int8"), the host tier, ``slo`` (an
    :class:`.slo.SLOConfig`; needs ``chunk_size`` and tracing), ``spec``
    (a :class:`.spec.SpecConfig`) and the observability fields:
    ``enable_tracing``, ``trace_capacity`` (traces and journeys kept),
    ``decode_mark_every`` (tokens between ``decode_mark`` events),
    ``timeline_capacity`` (step records kept), ``enable_watchdogs``,
    ``watchdog`` (an ``obs.WatchdogConfig``), ``peak_flops_per_s`` /
    ``peak_hbm_bytes_per_s`` (0 = the H100 data-sheet peaks),
    ``flight_record_path`` (where automatic dumps go; None keeps the
    newest on ``engine.last_flight_record``), ``flight_record_steps``
    (step records a dump keeps), ``tenants`` (``{name:
    obs.TenantSLO}``) and tensor parallelism (``tensor_parallel``,
    ``tp_quantized_logits``, ``tp_overlap_scheduler``). The rest: see
    ``_LATER``."""
    max_batch: int = 4
    num_pages: int = 64
    page_size: int = 16
    pages_per_seq: int = 0  # 0 -> ceil(max_seq_len / page_size)
    max_prompt_len: int = 32  # the largest prefill pad bucket
    do_sample: bool = False
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    eos_token_id: int | None = None
    pad_token_id: int = 0
    seed: int = 0
    max_waiting: int = 0  # waiting-queue bound; 0 = unbounded
    shed_policy: str = "reject"
    preemption_mode: str = "recompute"
    enable_prefix_caching: bool = True  # cross-request KV page sharing
    tensor_parallel: int = 1
    tp_overlap_scheduler: bool = False
    tp_quantized_logits: bool = False
    mesh_topology: object = None
    chunk_size: int = 0
    kv_dtype: str = "float32"
    host_tier_bytes: int = 0  # host spill tier for evicted prefix pages
    slo: SLOConfig | None = None
    spec: SpecConfig | None = None
    debug_checks: bool = False
    enable_tracing: bool = True
    trace_capacity: int = 2048
    decode_mark_every: int = 32
    timeline_capacity: int = 512
    enable_watchdogs: bool = True
    watchdog: WatchdogConfig | None = None
    peak_flops_per_s: float = 0.0
    peak_hbm_bytes_per_s: float = 0.0
    flight_record_path: str | None = None
    flight_record_steps: int = 64
    tenants: dict | None = None

    def __post_init__(self):
        for f in fields(self):
            if f.name in _LATER:
                default, where = _LATER[f.name]
                if getattr(self, f.name) != default:
                    raise NotImplementedError(
                        f"ServingConfig({f.name}={getattr(self, f.name)!r}) "
                        f"is not ported yet — {where}")
        if self.kv_dtype not in KV_DTYPES:
            raise ValueError(f"kv_dtype {self.kv_dtype!r} not in "
                             f"{KV_DTYPES}")
        if self.host_tier_bytes < 0:
            raise ValueError(f"host_tier_bytes {self.host_tier_bytes} < 0")
        if self.host_tier_bytes and not self.enable_prefix_caching:
            raise ValueError(
                "host_tier_bytes gives evicted indexed prefix pages a second "
                "life — enable_prefix_caching=False would leave nothing to "
                "spill; enable it or drop the tier")
        if self.chunk_size < 0:
            raise ValueError(f"chunk_size {self.chunk_size} < 0")
        if self.chunk_size > self.max_prompt_len:
            raise ValueError(
                f"chunk_size {self.chunk_size} exceeds max_prompt_len "
                f"{self.max_prompt_len} (chunks pad into the prefill "
                f"bucket set)")
        if self.slo is not None and not self.chunk_size:
            raise ValueError(
                "ServingConfig(slo=) adapts chunked prefill admission — "
                "set chunk_size > 0 to enable chunking first")
        if self.slo is not None and not self.enable_tracing:
            raise ValueError(
                "the SLO controller reads the obs step/tpot histograms, "
                "which enable_tracing feeds — it cannot run with tracing "
                "disabled (it would silently never throttle)")
        if self.flight_record_steps < 1:
            raise ValueError(
                f"flight_record_steps {self.flight_record_steps} < 1")
        for tname, slo in (self.tenants or {}).items():
            check_tenant_name(tname)
            if not isinstance(slo, TenantSLO):
                raise ValueError(
                    f"tenants[{tname!r}] must be an obs.TenantSLO, got "
                    f"{type(slo).__name__}")
            slo.validate()


def prefill_buckets(max_prompt_len: int) -> list[int]:
    """The prefill pad buckets: powers of two from 8 up, capped at (and
    always including) ``max_prompt_len``."""
    buckets, b = [], 8
    while b < max_prompt_len:
        buckets.append(b)
        b *= 2
    buckets.append(max_prompt_len)
    return buckets


@dataclass
class EngineCounters:
    """Plain counters of what the engine did, under the reference's metric
    meanings: ``prefills`` completed prefills, ``prefill_chunks`` chunk
    passes, ``prefill_tokens`` prompt tokens prefilled, ``decode_steps``
    decode and verify steps, ``verify_steps`` the verify steps among them,
    ``spec_proposed`` / ``spec_accepted`` candidates proposed (K per
    active slot) and accepted, ``tokens`` tokens emitted (replays
    included), ``preemptions`` (``swaps_out`` of them by swap),
    ``swaps_in`` swap resumes, and the requests ``shed``, ``rejected``
    (EngineOverloaded), ``expired``, ``cancelled`` and ``failed``. The two
    times are host-clock seconds from dispatch through the token fetch
    that ends each prefill (a chunk that does not finish reads nothing,
    so its time is its dispatch) and each decode or verify step. The
    cache's counts (``prefix_evictions`` and the ``host_tier_*`` ones)
    are read after every step. Each count equals its ``serving_*``
    counter in ``metrics`` for an engine alone in its process."""
    prefills: int = 0
    prefill_chunks: int = 0
    decode_steps: int = 0
    verify_steps: int = 0
    spec_proposed: int = 0
    spec_accepted: int = 0
    tokens: int = 0
    preemptions: int = 0
    swaps_out: int = 0
    swaps_in: int = 0
    prefix_hit_tokens: int = 0
    prefill_tokens: int = 0  # prompt tokens actually prefilled
    shed: int = 0
    rejected: int = 0
    expired: int = 0
    cancelled: int = 0
    failed: int = 0  # requests retired FAILED (a fault, a failed restore)
    prefill_seconds: float = 0.0
    decode_seconds: float = 0.0
    kv_bytes_per_token: int = 0
    prefix_evictions: int = 0
    host_tier_pages: int = 0
    host_tier_bytes: int = 0
    host_tier_hits: int = 0
    host_tier_spills: int = 0
    host_tier_restores: int = 0


class ServingEngine:
    """Continuous-batching engine over a port ``GPTForCausalLM``.

    ``device`` (``None`` = the card; raises when there is none) must be
    the device the model lives on; the KV pool is allocated there.
    ``clock`` (default ``time.monotonic``) is the time base of deadlines,
    budgets and traces; ``fault_injector`` a :class:`.faults.FaultInjector`;
    ``draft_model`` the speculative proposer for
    ``SpecConfig(method="draft")`` (built from ``spec.draft`` on the
    engine's device in the model's dtype when not given). With
    ``tensor_parallel=N`` the process must be one of the N ranks of its
    group; ``model`` is the full model, of which the engine keeps this
    rank's shard (``self.model``)."""

    def __init__(self, model, config: ServingConfig | None = None,
                 device=None, clock=None, fault_injector=None,
                 draft_model=None):
        dev = resolve_device(device)
        if model.device.type != dev.type:
            raise ValueError(f"the model lives on {model.device}, the engine "
                             f"was asked for {dev}")
        self.device = model.device
        self.config = cfg = config or ServingConfig()
        mc = model.cfg
        if cfg.tensor_parallel < 1:
            raise ValueError(f"tensor_parallel {cfg.tensor_parallel} < 1")
        # TPContext checks the degree, the process group and divisibility
        self._tp = TPContext(
            cfg.tensor_parallel, mc,
            overlap_scheduler=cfg.tp_overlap_scheduler,
            quantized_logits=cfg.tp_quantized_logits) \
            if cfg.tensor_parallel > 1 else None
        self.model = model.eval() if self._tp is None \
            else self._tp.shard_params(model)
        if draft_model is not None and (
                cfg.spec is None or cfg.spec.method != "draft"):
            raise ValueError(
                "draft_model= is the spec proposer — it needs "
                "ServingConfig(spec=SpecConfig(method='draft', ...))")
        if cfg.max_prompt_len > mc.max_seq_len:
            raise ValueError(
                f"max_prompt_len {cfg.max_prompt_len} exceeds the model's "
                f"max_seq_len {mc.max_seq_len}")
        if cfg.spec is not None:
            cfg.spec.validate(
                mc, draft_model.cfg if draft_model is not None else None)
        pages_per_seq = cfg.pages_per_seq or -(-mc.max_seq_len // cfg.page_size)
        self.cache = PagedKVCache(PagedCacheConfig(
            num_layers=mc.num_layers, num_heads=mc.num_heads,
            head_dim=mc.hidden_size // mc.num_heads,
            num_pages=cfg.num_pages, page_size=cfg.page_size,
            max_batch=cfg.max_batch, pages_per_seq=pages_per_seq,
            dtype=model.dtype,
            enable_prefix_caching=cfg.enable_prefix_caching,
            kv_dtype=cfg.kv_dtype, host_tier_bytes=cfg.host_tier_bytes,
            tp=cfg.tensor_parallel),
            device=self.device)
        self.prefill_buckets = prefill_buckets(cfg.max_prompt_len)
        self.metrics = ServingMetrics()
        self.metrics.on_tp_degree(cfg.tensor_parallel)
        self.metrics.on_kv_bytes_per_token(self.cache.cfg.kv_bytes_per_token)
        self.metrics.on_spec_depth(cfg.spec.depth if cfg.spec else 0)
        self.metrics.seed_family("alerts_total", ALERT_RULES)
        self.metrics.seed_family(
            "cost_model_drift",
            [f"prefill[{b}]" for b in self.prefill_buckets] + ["decode"]
            + (["verify"] if cfg.spec is not None else []))
        self.counters = EngineCounters(
            kv_bytes_per_token=self.cache.cfg.kv_bytes_per_token)
        self._clock = clock or time.monotonic
        self._skew = 0.0  # virtual seconds injected by slow_step faults
        # the observability layer: None with tracing off, so every site
        # costs one attribute check
        if cfg.enable_tracing:
            self._tracer = Tracer(self.now, capacity=cfg.trace_capacity,
                                  mark_every=cfg.decode_mark_every)
            self._timeline = StepTimeline(cfg.timeline_capacity)
            # journeys fold over the tracer's own event stream
            self._journeys = JourneyBook(lambda: self._now_step,
                                         capacity=cfg.trace_capacity)
            self._tracer.journal = self._journeys.on_event
            self._tenants = TenantLedger(cfg.tenants)
            self._attr = PhaseAccumulator(self.now)
            # no per-program predictions in the port yet (the reference's
            # come from its compiled-program audits, ROADMAP Queue 1 item
            # 11), so it publishes nothing and the gauges stay at 0
            self._roofline = RooflineTracker(cfg.peak_flops_per_s,
                                             cfg.peak_hbm_bytes_per_s)
            self._watchdog = (Watchdog(cfg.watchdog or WatchdogConfig(),
                                       clock=self.now)
                              if cfg.enable_watchdogs else None)
        else:
            self._tracer = self._timeline = self._journeys = None
            self._tenants = self._attr = self._roofline = None
            self._watchdog = None
        # the per-tenant families exist for the declared tenants and
        # "default" whether or not tracing is on
        tenant_names = ["default"] + sorted(
            t for t in (cfg.tenants or {}) if t != "default")
        self.metrics.seed_tenants(tenant_names)
        self._seeded_tenants = set(tenant_names)
        self.last_flight_record: dict | None = None  # newest automatic dump
        self._failed_dumped = 0  # counters.failed at the last auto dump
        self._step_stats: dict | None = None  # _step -> step() handoff
        self.scheduler = Scheduler(
            self.cache, cfg.max_batch, max_waiting=cfg.max_waiting,
            shed_policy=cfg.shed_policy, preemption_mode=cfg.preemption_mode,
            tracer=self._tracer)
        self._fault_injector = fault_injector
        if fault_injector is not None and self.cache.host_tier is not None:
            self.cache.restore_fault = self._restore_fault_probe
        if cfg.slo is not None:
            self._slo = SLOController(cfg.slo, self.metrics,
                                      default_max_chunks=cfg.max_batch)
            self.metrics.on_chunk_limit(self._slo.chunk_limit)
        else:
            self._slo = None
        self._key = random.key(cfg.seed, self.device) if cfg.do_sample \
            else None
        b = cfg.max_batch
        self._spec = cfg.spec
        self._hist = self._draft = None
        if cfg.spec is not None:
            # a verify step writes KV at ctx .. ctx + K before the accept
            # count is known: admission and growth reserve those K slots
            self.scheduler.decode_reserve = cfg.spec.depth
            # the host mirror of each slot's known tokens, the proposers'
            # input (shipped with every verify step)
            self._hist = np.zeros((b, mc.max_seq_len), np.int32)
            if cfg.spec.method == "draft":
                if draft_model is None:
                    draft_model = GPTForCausalLM(
                        cfg.spec.draft, device=self.device, dtype=model.dtype)
                if draft_model.device.type != self.device.type:
                    raise ValueError(
                        f"the draft model lives on {draft_model.device}, "
                        f"the engine on {self.device}")
                self._draft = draft_model.eval()
        self._step_idx = 0
        self._now_step = 0  # step index the restore_fail probe matches
        self.admit_paused = False  # run(budget_s=) drain; settable by callers
        self._ctx = np.zeros(b, np.int32)
        self._last_tok = np.full(b, cfg.pad_token_id, np.int32)
        self._active = np.zeros(b, bool)
        self._rids = np.zeros(b, np.int64)  # per-slot rid (key stream id)
        self._gen = np.zeros(b, np.int64)   # per-slot generated-token count
        self._finished: dict[int, np.ndarray] = {}
        self._retired: dict[int, Request] = {}  # cancelled/expired/failed/shed
        self._requests: dict[int, Request] = {}  # live requests by rid

    @property
    def failed(self) -> dict[int, BaseException]:
        """rid -> error of every retired FAILED request not yet drained by
        ``pop_retired``."""
        return {rid: r.error for rid, r in self._retired.items()
                if r.state == FAILED}

    # ------------------------------------------------------------ requests
    def now(self) -> float:
        """Engine time: the clock plus any slow_step fault skew."""
        return self._clock() + self._skew

    def add_request(self, prompt, max_new_tokens: int,
                    deadline_s: float | None = None, tenant: str = "default",
                    rid: int | None = None) -> int:
        """Queue a prompt; returns the request id. ``deadline_s``: seconds
        from now after which a request still waiting or running is retired
        EXPIRED at the next step boundary. ``tenant``: the request's SLO
        class for the goodput ledger, journey and per-tenant latency
        families — observe-only, scheduling never reads it; a tenant not
        in ``ServingConfig(tenants=)`` is served under its own label with
        no targets. ``rid``: an id the caller already drew (a router's);
        None draws one. Raises ValueError when the request could never run
        (empty, too long for the largest bucket, the model, or the whole
        pool) or the tenant name is malformed, and EngineOverloaded when
        the bounded queue is full under "reject"."""
        if tenant not in self._seeded_tenants:
            check_tenant_name(tenant)
            self.metrics.seed_tenants([tenant])
            self._seeded_tenants.add(tenant)
            if self._tenants is not None:
                self._tenants.ensure(tenant)
        if isinstance(prompt, torch.Tensor):
            prompt = prompt.detach().cpu().numpy()
        prompt = np.asarray(prompt)
        if prompt.ndim != 1:
            raise ValueError(f"prompt must be 1-D, got shape {prompt.shape}")
        if prompt.shape[0] == 0:
            raise ValueError("prompt must contain at least one token")
        if int(max_new_tokens) <= 0:
            raise ValueError("max_new_tokens must be positive")
        if prompt.shape[0] > self.config.max_prompt_len:
            raise ValueError(
                f"prompt_len {prompt.shape[0]} exceeds max_prompt_len "
                f"{self.config.max_prompt_len}")
        total = prompt.shape[0] + int(max_new_tokens)
        if total > self.model.cfg.max_seq_len:
            raise ValueError(
                f"prompt_len + max_new_tokens = {total} exceeds max_seq_len "
                f"{self.model.cfg.max_seq_len}")
        req = Request(prompt=prompt.astype(np.int32),
                      max_new_tokens=int(max_new_tokens),
                      deadline=(self.now() + float(deadline_s)
                                if deadline_s is not None else None),
                      tenant=tenant,
                      **({} if rid is None else {"rid": int(rid)}))
        try:
            shed = self.scheduler.add(req)
        except EngineOverloaded:
            self.counters.rejected += 1
            self.metrics.on_rejected()
            raise
        tr = self._tracer
        if tr is not None:
            # the journey first: the tracer's "enqueued" lands on it
            self._journeys.begin(req.rid, tenant)
            tr.begin(req.rid)
        if shed is not None:
            self._requests.pop(shed.rid, None)
            self._retired[shed.rid] = shed
            self.counters.shed += 1
            self.metrics.on_shed()
            self._trace_retire(shed, SHED)
        self._requests[req.rid] = req
        return req.rid

    def cancel(self, rid: int) -> bool:
        """Retire a waiting, prefilling or running request, freeing its
        slot and pages. False for an unknown or already finished one."""
        req = self._requests.get(rid)
        if req is None or req.state not in (WAITING, RUNNING, PREFILLING):
            return False
        self._retire(req, CANCELLED)
        return True

    def status(self, rid: int) -> str:
        """waiting / prefilling / running / finished / cancelled /
        expired / failed / shed. KeyError for an unknown rid."""
        if rid in self._requests:
            return self._requests[rid].state
        if rid in self._finished:
            return FINISHED
        if rid in self._retired:
            return self._retired[rid].state
        raise KeyError(f"unknown request {rid}")

    def request(self, rid: int) -> Request | None:
        """The live or retired Request (e.g. ``.error`` of a FAILED one);
        None for finished or unknown rids."""
        return self._requests.get(rid) or self._retired.get(rid)

    def result(self, rid: int) -> np.ndarray:
        return self._finished[rid]

    def pop_finished(self) -> dict[int, np.ndarray]:
        """Drain and return every completed output (prompt + generated)."""
        done, self._finished = self._finished, {}
        return done

    def pop_retired(self) -> dict[int, Request]:
        """Drain and return every cancelled, expired, failed or shed
        request."""
        done, self._retired = self._retired, {}
        return done

    def _trace_retire(self, req: Request, state: str) -> None:
        """Stamp the ``retired`` event, feed the request-latency
        histograms from the trace's summary and settle the tenant ledger
        (the class, its tokens, the per-tenant latency families)."""
        tr = self._tracer
        if tr is None:
            return
        tr.event(req.rid, "retired", state=state, tokens=len(req.generated))
        trace = tr.get(req.rid)
        if trace is None:
            return
        summary = trace.summary()
        self.metrics.observe_request(summary)
        cls = self._tenants.on_retire(
            req.tenant, state, ttft=summary["ttft"], tpot=summary["tpot"],
            tokens=req.tokens_emitted)
        self.metrics.on_tenant_retire(req.tenant, cls, req.tokens_emitted)
        self.metrics.observe_tenant(req.tenant, ttft=summary["ttft"],
                                    tpot=summary["tpot"],
                                    queue_delay=summary["queue_wait"])

    def _retire(self, req: Request, state: str,
                error: BaseException | None = None) -> None:
        """Terminal exit for a request that did not finish (cancelled,
        expired or failed): out of waiting or running (slot, pages and
        swap handle freed), counted and recorded."""
        slot = self.scheduler.evict(req)
        if slot is not None:
            self._clear_slot(slot)
        req.state, req.error = state, error
        self._requests.pop(req.rid, None)
        self._retired[req.rid] = req
        c, m = self.counters, self.metrics
        if state == FAILED:
            c.failed += 1
            m.on_failed()
        elif state == EXPIRED:
            c.expired += 1
            m.on_expired()
        else:
            c.cancelled += 1
            m.on_cancelled()
        self._trace_retire(req, state)

    def _sweep_deadlines(self) -> None:
        with_deadline = [r for r in self._requests.values()
                         if r.deadline is not None]
        if not with_deadline:
            return
        now = self.now()
        for req in with_deadline:
            if now >= req.deadline and \
                    req.state in (WAITING, RUNNING, PREFILLING):
                self._retire(req, EXPIRED)

    def _restore_fault_probe(self, rid) -> bool:
        inj = self._fault_injector
        return inj is not None and inj.hit(
            "restore_fail", step=self._now_step, rid=rid) is not None

    def _inject(self, point: str, step: int, req: Request) -> bool:
        """Consult ``point`` for ``req``; a hit retires it FAILED."""
        if not self._fault_injector.hit(point, step=step, rid=req.rid):
            return False
        self._retire(req, FAILED, InjectedFault(
            f"{point} injected (step {step}, rid {req.rid})"))
        return True

    # --------------------------------------------------------------- passes
    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _pick(self, logits, rids, gen):
        """The target's token for each row of ``logits [..., vocab]``: the
        argmax, or with ``do_sample`` the sample under the key of
        (seed, rid, token index) — ``rids`` and ``gen`` device int64
        tensors of ``logits.shape[:-1]``. Stays on the device."""
        if not self.config.do_sample:
            return torch.argmax(logits, dim=-1)
        cfg = self.config
        keys = random.fold_in(random.fold_in(
            self._key.expand(*rids.shape, 2), rids), gen)
        return sample_logits(logits, keys, cfg.temperature, cfg.top_k,
                             cfg.top_p)

    def _forward(self, ids, paged: PagedBatch):
        """The target's paged forward; under tensor parallelism inside
        ``tp_axis``, so its row-parallel sums reduce over the group."""
        if self._tp is None:
            return self.model(ids, paged=paged)
        with tp_axis(self._tp.axis,
                     quantized_logits=self._tp.quantized_logits):
            return self.model(ids, paged=paged)

    def _bucket(self, n: int) -> int:
        return next(b for b in self.prefill_buckets if b >= n)

    @torch.no_grad()
    def _prefill_pass(self, req: Request, start: int, n: int, final: bool):
        """Prompt tokens ``start .. start + n`` of ``req`` in one pass,
        right-padded to the smallest bucket, queries entering at ``ctx =
        start``. Returns the first generated token on the device when
        ``final``, else None (nothing is read)."""
        bucket = self._bucket(n)
        padded = np.full(bucket, self.config.pad_token_id, np.int32)
        padded[:n] = req.prompt[start:start + n]
        slot = req.slot
        paged = PagedBatch(
            pools=self.cache.pools,
            page_table=self._to_device(self.cache.page_table[slot:slot + 1]),
            ctx_lens=self._to_device(np.array([start], np.int32)),
            valid=self._to_device(np.arange(bucket) < n)[None, :],
            scales=self.cache.scales)
        logits = self._forward(self._to_device(padded).long()[None, :],
                               paged)
        self.counters.prefill_tokens += n
        if not final:
            return None
        ids = torch.tensor([[req.rid, 0]], device=self.device)
        return self._pick(logits[0, n - 1][None], ids[:, 0], ids[:, 1])[0]

    @torch.no_grad()
    def _decode(self) -> np.ndarray:
        """One token for every slot; inactive slots emit pad."""
        active = self._to_device(self._active)
        paged = PagedBatch(pools=self.cache.pools,
                           page_table=self._to_device(self.cache.page_table),
                           ctx_lens=self._to_device(self._ctx),
                           valid=active[:, None], scales=self.cache.scales)
        logits = self._forward(self._to_device(self._last_tok).long()[:, None],
                               paged)
        toks = self._pick(logits[:, -1], self._to_device(self._rids),
                          self._to_device(self._gen))
        toks = torch.where(active, toks, self.config.pad_token_id)
        return toks.cpu().numpy()  # the step's one device -> host read

    @torch.no_grad()
    def _propose_draft(self, win):
        """The draft proposer: K greedy tokens from a fresh fixed cache
        over ``win [batch, window]`` at window-relative positions. The
        draft is replicated under tensor parallelism: every rank proposes
        the same candidates with no reduction."""
        sp, draft = self._spec, self._draft
        K, W = sp.depth, sp.window
        caches = draft.gpt.init_cache(win.shape[0], W + K)
        with tp_axis(None):
            logits, caches = draft(win, caches=caches, pos=0)
            tok = torch.argmax(logits[:, -1], dim=-1)
            cands = [tok]
            for j in range(1, K):
                logits, caches = draft(tok[:, None], caches=caches,
                                       pos=W + j - 1)
                tok = torch.argmax(logits[:, 0], dim=-1)
                cands.append(tok)
        return torch.stack(cands, dim=1)

    @torch.no_grad()
    def _verify(self) -> np.ndarray:
        """One speculative step for every slot: propose K candidates,
        verify all K + 1 tokens (the pending token and the candidates) in
        one ragged pass, accept on the device. Returns the packed ``[batch,
        K + 2]`` array — the target's token at each of the K + 1
        positions, then the accept count — in the step's one read."""
        cfg, sp = self.config, self._spec
        K = sp.depth
        pad = cfg.pad_token_id
        active = self._to_device(self._active)
        ctx = self._to_device(self._ctx)
        hist = self._to_device(self._hist)
        if sp.method == "draft":
            cand = self._propose_draft(draft_window(hist, ctx + 1, sp.window))
        else:
            cand = propose_ngram(hist, ctx + 1, K, sp.ngram, pad)
        cand = torch.where(active[:, None], cand, pad)
        last = self._to_device(self._last_tok).long()[:, None]
        ids = torch.cat([last, cand], dim=1)
        paged = PagedBatch(pools=self.cache.pools,
                           page_table=self._to_device(self.cache.page_table),
                           ctx_lens=ctx,
                           valid=active[:, None].expand(-1, K + 1),
                           scales=self.cache.scales)
        logits = self._forward(ids, paged)
        offs = torch.arange(K + 1, device=self.device)
        rids = self._to_device(self._rids)[:, None].expand(-1, K + 1)
        gen = self._to_device(self._gen)[:, None] + offs
        target = torch.where(active[:, None], self._pick(logits, rids, gen),
                             pad)
        accepted = torch.where(active, accept_counts(cand, target), 0)
        packed = torch.cat([target, accepted[:, None]], dim=1)
        return packed.cpu().numpy()  # the step's one device -> host read

    # ---------------------------------------------------------------- slots
    def _clear_slot(self, slot: int) -> None:
        self._active[slot] = False
        self._ctx[slot] = 0
        self._last_tok[slot] = self.config.pad_token_id
        self._rids[slot] = 0
        self._gen[slot] = 0
        if self._hist is not None:
            self._hist[slot] = 0

    def _start_decoding(self, req: Request) -> None:
        """The slot's state once ``req`` has its prompt's KV and at least
        one generated token (after a prefill or a swap resume)."""
        slot = req.slot
        self._ctx[slot] = req.tokens_resident - 1
        self._last_tok[slot] = req.generated[-1]
        self._active[slot] = True
        self._rids[slot] = req.rid
        self._gen[slot] = len(req.generated)
        req.state = RUNNING
        req.fresh = True
        if self._hist is not None:
            row = self._hist[slot]
            row[:] = 0
            row[:req.tokens_resident] = req.output()

    def _swapped_in(self, req: Request, tokens: int) -> None:
        """Count and trace a swap resume (``tokens``: the generated or the
        prefilled tokens the restored pages hold)."""
        self.counters.swaps_in += 1
        self.metrics.on_swap_in()
        tr = self._tracer
        if tr is not None:
            tr.event(req.rid, "swap_in", tokens=tokens)
            tr.event(req.rid, "resumed", tokens=tokens)

    def _first_token(self, req: Request, tok: int, hit: int,
                     tokens: int) -> None:
        """Record a completed prefill's first token: ``hit`` prompt tokens
        came from the prefix cache, ``tokens`` were prefilled by this last
        pass and not yet counted (a chunked prefill counts per chunk)."""
        c, m = self.counters, self.metrics
        req.generated.append(tok)
        req.tokens_emitted += 1
        self._start_decoding(req)
        tr = self._tracer
        if tr is not None:
            # the prefill samples the first token: its end IS first-token
            tr.event(req.rid, "prefill_end", tokens=req.prompt_len - hit)
            tr.event(req.rid, "first_token")
        # every full prompt page is now resident: index it for reuse
        self.cache.register_prefix(req.slot, req.prompt)
        c.prefills += 1
        c.tokens += 1
        c.prefix_hit_tokens += hit
        m.on_prefill(tokens)
        if self.config.enable_prefix_caching:
            if hit > 0:
                m.on_prefix_hit(hit)
            else:
                m.on_prefix_miss()
        m.on_tokens(1)

    def _maybe_finish(self, req: Request, tok: int) -> bool:
        eos = self.config.eos_token_id
        if len(req.generated) >= req.max_new_tokens or \
                (eos is not None and tok == eos):
            slot = req.slot
            # index the generated span too (all but the final token, whose
            # KV was never written), then release: indexed pages park
            # reclaimable instead of freed
            self.cache.register_prefix(slot, req.output()[:-1])
            self.scheduler.finish(req)
            self._clear_slot(slot)
            self._finished[req.rid] = req.output()
            self._requests.pop(req.rid, None)
            self._trace_retire(req, FINISHED)
            return True
        return False

    def _preempt_one(self, req: Request, slot: int | None = None) -> None:
        """Vacate a preempted request's slot and count it; ``slot`` is
        the slot the scheduler already vacated, None preempts here."""
        if slot is None:
            slot = self.scheduler.preempt(req)
        self._clear_slot(slot)
        self.counters.preemptions += 1
        self.metrics.on_preempt()
        if self.config.preemption_mode == "swap":
            self.counters.swaps_out += 1
            self.metrics.on_swap_out()

    # ----------------------------------------------------------------- step
    def step(self) -> list[int]:
        """One continuous-batching iteration: sweep deadlines, admit and
        prefill (or swap-resume) joiners, advance the prefilling requests
        by a chunk, one decode or verify step for the batch, retire
        finishers. Returns the ids of the requests that finished. Injected
        faults retire only the requests they name. Then, with tracing on,
        the step's record goes to the timeline and its phases to the
        metrics, the watchdogs read it, a FAILED retirement dumps the
        flight record and the SLO controller takes its turn."""
        try:
            finished = self._step()
        except Exception as e:
            self._on_fatal(e)
            raise
        if self._step_stats is not None:
            st, self._step_stats = self._step_stats, None
            record = StepRecord(**st)
            self._timeline.append(record)
            self.metrics.observe_step(st["t_end"] - st["t_start"],
                                      st["batch"])
            # zero-time phases stay unobserved; the record keeps the split
            for phase, secs in record.phase_s.items():
                if secs > 0:
                    self.metrics.on_phase(phase, secs)
            self._roofline.publish(self.metrics)
            if self._watchdog is not None:
                for alert in self._watchdog.on_step(
                        record, self._watchdog_counters()):
                    self.metrics.on_alert(alert.rule)
        if self.counters.failed != self._failed_dumped:
            self._failed_dumped = self.counters.failed
            self._flight_auto("request-failure")
        if self._slo is not None:
            change = self._slo.on_step()
            if change is not None:
                old, new = change
                self.metrics.on_chunk_limit(new, throttled=new < old)
        return finished

    def _step(self) -> list[int]:
        c = self.counters
        inj = self._fault_injector  # the step's one injector read
        step_idx = self._step_idx
        self._now_step = step_idx
        self._step_idx += 1
        if inj is not None:
            slow = inj.hit("slow_step", step=step_idx)
            if slow is not None:
                self._skew += slow.delay_s
        self._sweep_deadlines()
        # the phase marks: each charges the time since the previous one,
        # so the phases sum to the step's wall time exactly
        att = self._attr
        t_start = att.begin() if att is not None else 0.0
        preempt0 = self.scheduler.preemption_count
        n_prefills = n_active = n_accepted = 0
        finished = []
        tr = self._tracer
        # a paused engine (run(budget_s=) drain) admits no newcomers but
        # still resumes preemption victims: they are in-flight work. While
        # the SLO controller is degraded, warm waiters go first.
        admitted = self.scheduler.admit(
            resume_only=self.admit_paused,
            prefer_cached=self._slo is not None and self._slo.degraded)
        # a failed host-tier restore undid that request's admission
        for req, err in self.scheduler.pop_restore_failures():
            self._retire(req, FAILED, err)
        if att is not None:
            att.mark("admit")
        for req in admitted:
            if req.generated:  # swap resume: the KV came back with it
                req.resumed_from_swap = False
                self._start_decoding(req)
                self._swapped_in(req, len(req.generated))
                if att is not None:
                    att.mark("swap")
                continue
            if inj is not None and self._inject("prefill_fail", step_idx,
                                                req):
                if att is not None:
                    att.mark("admit")
                continue
            if self.config.chunk_size:
                # hold the slot PREFILLING; the chunk phase streams the
                # prompt. fresh spares it from preemption while a decoded
                # victim exists.
                req.state = PREFILLING
                req.fresh = True
                if req.resumed_from_swap:
                    # a mid-prefill swap victim: its pages hold
                    # prefilled_tokens of KV, chunking goes on from there
                    req.resumed_from_swap = False
                    self._swapped_in(req, req.prefilled_tokens)
                else:
                    req.prefilled_tokens = req.cached_tokens
                    req.prefix_hit_tokens = req.cached_tokens
                    if tr is not None:
                        tr.event(req.rid, "prefill_start",
                                 tokens=req.prompt_len - req.prefilled_tokens,
                                 cached=req.cached_tokens, chunked=True)
                if att is not None:
                    att.mark("admit")
                continue
            cached = req.cached_tokens
            n = req.prompt_len - cached
            bucket = self._bucket(n)
            if tr is not None:
                tr.event(req.rid, "prefill_start", tokens=n, cached=cached,
                         bucket=bucket)
            t0 = time.perf_counter()
            tok = self._prefill_pass(req, cached, n,
                                     True).item()  # the prefill's one read
            c.prefill_seconds += time.perf_counter() - t0
            n_prefills += 1
            self._first_token(req, tok, cached, n)
            if att is not None:
                # the dispatch and the first-token read, where the
                # device time lands
                self._roofline.on_call(f"prefill[{bucket}]",
                                       att.mark("prefill"))
            if self._maybe_finish(req, tok):
                finished.append(req.rid)

        n_chunks = 0
        if self.config.chunk_size:
            limit = (self._slo.chunk_limit if self._slo is not None
                     else self.config.max_batch)
            prefilling = sorted((r for r in self.scheduler.running.values()
                                 if r.state == PREFILLING),
                                key=lambda r: r.admit_seq)
            for req in prefilling[:limit]:
                if inj is not None and self._inject("chunk_fail", step_idx,
                                                    req):
                    continue
                tok = self._prefill_chunk(req)
                n_chunks += 1
                if tok is not None:
                    n_prefills += 1
                    self._first_token(req, tok, req.prefix_hit_tokens, 0)
                    if self._maybe_finish(req, tok):
                        finished.append(req.rid)
            if att is not None and (n_chunks or prefilling):
                att.mark("chunk_prefill")

        if inj is not None:
            for slot in np.nonzero(self._active)[0]:
                req = self.scheduler.running.get(int(slot))
                if req is None:
                    continue
                if self._inject("decode_fail", step_idx, req):
                    continue
                if self._spec is not None:
                    self._inject("verify_fail", step_idx, req)
            if self.scheduler.running and \
                    inj.hit("pool_exhausted", step=step_idx):
                self._preempt_one(self.scheduler.pick_victim())

        for req, slot in self.scheduler.ensure_decode_pages():
            self._preempt_one(req, slot)
        if att is not None:
            att.mark("evict")  # faults, preemption and eviction pressure

        if self._active.any():
            t0 = time.perf_counter()
            if self._spec is not None:
                n_active, n_accepted = self._verify_phase(finished)
            else:
                n_active = self._decode_phase(finished)
            c.decode_seconds += time.perf_counter() - t0
            c.decode_steps += 1
        cs = self.cache.stats()
        c.prefix_evictions = cs["evictions"]
        for key in ("host_tier_pages", "host_tier_bytes", "host_tier_hits",
                    "host_tier_spills", "host_tier_restores"):
            setattr(c, key, cs[key])
        self.metrics.on_state(
            queue_depth=self.scheduler.queue_depth,
            active=len(self.scheduler.running),
            pages_used=cs["pages_in_use"],
            usable_pages=cs["usable_pages"],
            shared_pages=cs["shared_pages"],
            cached_pages=cs["reclaimable_pages"],
            cow_copies=cs["cow_copies"],
            evictions=cs["evictions"],
            host_tier_pages=cs["host_tier_pages"],
            host_tier_bytes=cs["host_tier_bytes"],
            host_tier_hits=cs["host_tier_hits"],
            host_tier_spills=cs["host_tier_spills"],
            host_tier_restores=cs["host_tier_restores"])
        if att is not None:
            t_end, phase_s = att.finish()  # the residual goes to "other"
            self._step_stats = {
                "step": step_idx, "t_start": t_start, "t_end": t_end,
                "admitted": len(admitted), "prefills": n_prefills,
                "chunks": n_chunks, "batch": n_active,
                "accepted": n_accepted, "finished": len(finished),
                "preemptions": self.scheduler.preemption_count - preempt0,
                "queue_depth": self.scheduler.queue_depth,
                "pages_in_use": cs["pages_in_use"], "phase_s": phase_s}
        return finished

    def _prefill_chunk(self, req: Request) -> int | None:
        """Advance one PREFILLING request by one chunk; returns its first
        generated token when this chunk completed the prompt, else None
        (and reads nothing from the device)."""
        c = self.counters
        start = req.prefilled_tokens
        n = min(self.config.chunk_size, req.prompt_len - start)
        final = start + n >= req.prompt_len
        t0 = time.perf_counter()
        tok = self._prefill_pass(req, start, n, final)
        req.prefilled_tokens = start + n
        c.prefill_chunks += 1
        self.metrics.on_prefill_chunk(n)
        if self._tracer is not None:
            self._tracer.event(req.rid, "prefill_chunk", start=start,
                               tokens=n, bucket=self._bucket(n), final=final)
        if tok is not None:
            tok = tok.item()  # the completed prefill's one read
        c.prefill_seconds += time.perf_counter() - t0
        return tok

    def _decode_phase(self, finished: list) -> int:
        """One decode step; returns the slots it served."""
        toks = self._decode()
        self.metrics.on_decode_step()
        tr = self._tracer
        n_new = 0
        for slot in np.nonzero(self._active)[0]:
            req = self.scheduler.running[int(slot)]
            tok = int(toks[slot])
            req.generated.append(tok)
            req.tokens_emitted += 1
            req.fresh = False  # it has decoded: fair game for preemption
            self._ctx[slot] += 1
            self._last_tok[slot] = tok
            self._gen[slot] += 1
            n_new += 1
            if tr is not None and len(req.generated) % tr.mark_every == 0:
                tr.event(req.rid, "decode_mark", tokens=len(req.generated))
            if self._maybe_finish(req, tok):
                finished.append(req.rid)
        self.counters.tokens += n_new
        self.metrics.on_tokens(n_new)
        if self._attr is not None:
            # the dispatch, the token read and the per-slot bookkeeping
            self._roofline.on_call("decode", self._attr.mark("decode"))
        return n_new

    def _verify_phase(self, finished: list) -> tuple[int, int]:
        """One verify step, then each slot emits its accepted candidates
        and the target's next token (1 .. K + 1 tokens), and the pages its
        rejected span reserved go back to the allocator. Returns (active
        slots, candidates accepted)."""
        c = self.counters
        K = self._spec.depth
        packed = self._verify()
        self.metrics.on_decode_step()
        c.verify_steps += 1
        tr = self._tracer
        n_slots = n_new = n_accepted = 0
        for slot in np.nonzero(self._active)[0]:
            req = self.scheduler.running[int(slot)]
            a = int(packed[slot, K + 1])
            n_slots += 1
            n_accepted += a
            req.fresh = False
            if tr is not None:
                tr.event(req.rid, "spec_verify", proposed=K, accepted=a)
            emitted = 0
            done = False
            for tok in packed[slot, :a + 1]:
                tok = int(tok)
                req.generated.append(tok)
                req.tokens_emitted += 1
                emitted += 1
                if tr is not None and \
                        len(req.generated) % tr.mark_every == 0:
                    tr.event(req.rid, "decode_mark",
                             tokens=len(req.generated))
                if self._maybe_finish(req, tok):
                    finished.append(req.rid)
                    done = True
                    break
            n_new += emitted
            if done:
                continue
            self._ctx[slot] += emitted
            self._last_tok[slot] = req.generated[-1]
            self._gen[slot] += emitted
            self.cache.shrink(slot, req.tokens_resident)
            self._hist[slot, req.tokens_resident - emitted:
                       req.tokens_resident] = req.generated[-emitted:]
        c.tokens += n_new
        c.spec_proposed += K * n_slots
        c.spec_accepted += n_accepted
        self.metrics.on_tokens(n_new)
        self.metrics.on_spec(proposed=K * n_slots, accepted=n_accepted)
        if self._attr is not None:
            self._roofline.on_call("verify", self._attr.mark("verify"))
        return n_slots, n_accepted

    def _state_summary(self) -> str:
        s = self.scheduler
        waiting = [r.rid for r in itertools.islice(s.waiting, 8)]
        more = "..." if s.queue_depth > 8 else ""
        active = sorted(r.rid for r in s.running.values())
        return (f"step={self._step_idx}, queue_depth={s.queue_depth} "
                f"(waiting rids {waiting}{more}), active rids {active}, "
                f"pages_in_use={self.cache.allocator.pages_in_use}/"
                f"{self.cache.cfg.usable_pages}")

    def run(self, max_steps: int = 100000,
            budget_s: float | None = None) -> dict[int, np.ndarray]:
        """Drive step() until every queued request finished; returns
        {request_id: prompt + generated} for the requests that finished
        during this call.

        ``budget_s``: seconds of engine time after which admission pauses
        and the in-flight batch — preemption victims included — drains;
        requests never admitted stay queued for a later call. A caller-set
        ``admit_paused`` is honoured the same way and survives the call.
        Raises RuntimeError past ``max_steps``, after dumping the flight
        record."""
        done: dict[int, np.ndarray] = {}
        stop_at = self.now() + budget_s if budget_s is not None else None
        paused_before = self.admit_paused
        steps = 0
        try:
            while not self.scheduler.all_done:
                if stop_at is not None and self.now() >= stop_at:
                    self.admit_paused = True
                if self.admit_paused and not self.scheduler.running \
                        and not self.scheduler.inflight_waiting:
                    break  # drained: the queue is left for a later call
                for rid in self.step():
                    done[rid] = self._finished[rid]
                steps += 1
                if steps > max_steps:
                    err = RuntimeError(
                        f"serving loop exceeded {max_steps} steps without "
                        f"draining: {self._state_summary()}")
                    try:
                        self._flight_auto("stuck-engine")
                    except Exception:  # noqa: BLE001 — the backstop wins
                        pass
                    raise err
        finally:
            self.admit_paused = paused_before
        return done

    # -------------------------------------------------------- observability
    def _watchdog_counters(self) -> dict:
        """The monotonic totals the watchdog rules window over, all host
        values. Retraces and kernel fallbacks are counters the port never
        bumps (it compiles nothing and never falls back)."""
        return {
            "retraces": monitor.stat_get(
                "serving_analysis_retraces_total", 0),
            "fallbacks": monitor.stat_get(
                "serving_pallas_fallback_total", 0),
            "proposed": monitor.stat_get(
                "serving_spec_proposed_tokens_total", 0),
            "accepted": monitor.stat_get(
                "serving_spec_accepted_tokens_total", 0),
            "evictions": monitor.stat_get("serving_prefix_evictions", 0),
            "spills": monitor.stat_get("serving_host_tier_spills_total", 0),
            "tenant_slo": self._tenants.burn_totals(),
        }

    def alerts(self) -> list:
        """The watchdog alert history (``obs.Alert``), oldest first —
        empty with tracing or watchdogs off."""
        return self._watchdog.alerts() if self._watchdog is not None else []

    def flight_record(self, reason: str = "manual") -> dict:
        """Assemble (but do not write) the flight record (schema v2): the
        newest ``flight_record_steps`` step records, the alert history, a
        gauge snapshot, the per-request latency summaries, the per-tenant
        roll-ups and a bounded ring of wire journeys."""
        cfg = self.config
        return build_flight_record(
            reason=reason, now=self.now(), step=self._step_idx,
            config={"max_batch": cfg.max_batch,
                    "num_pages": cfg.num_pages,
                    "page_size": cfg.page_size,
                    "max_prompt_len": cfg.max_prompt_len,
                    "chunk_size": cfg.chunk_size,
                    "kv_dtype": cfg.kv_dtype,
                    "tensor_parallel": cfg.tensor_parallel,
                    "spec_depth": cfg.spec.depth if cfg.spec else 0,
                    "preemption_mode": cfg.preemption_mode,
                    "debug_checks": cfg.debug_checks},
            timeline=self._timeline, alerts=self.alerts(),
            gauges=self.metrics.snapshot(), programs={},
            requests=self.latency_summaries(),
            tenants=self.tenant_report() or {},
            journeys=self._journeys.wire_records(limit=MAX_FLIGHT_JOURNEYS)
            if self._journeys is not None else (),
            max_steps=cfg.flight_record_steps)

    def dump_flight_record(self, path, reason: str = "manual") -> dict:
        """Write the flight record as JSON to ``path``; returns it."""
        return _write_flight_record(path, self.flight_record(reason))

    def _flight_auto(self, reason: str) -> None:
        """The automatic dump: kept on ``last_flight_record``, and written
        to ``flight_record_path`` when one is configured."""
        rec = self.flight_record(reason)
        self.last_flight_record = rec
        if self.config.flight_record_path:
            _write_flight_record(self.config.flight_record_path, rec)

    def _on_fatal(self, exc: BaseException) -> None:
        """An exception is escaping the step: close the open phase
        attribution into a partial StepRecord (counts zero, timing, queue
        and pages real, ``extra`` naming the fatal), flush it into the
        ring and dump the flight record. Nothing here may mask the
        original exception."""
        try:
            att = self._attr
            if att is not None and att.open:
                t_end, phase_s = att.finish()
                self._timeline.append(StepRecord(
                    step=self._step_idx - 1, t_start=att.t0, t_end=t_end,
                    admitted=0, prefills=0, batch=0, finished=0,
                    preemptions=0, queue_depth=self.scheduler.queue_depth,
                    pages_in_use=self.cache.allocator.pages_in_use,
                    phase_s=phase_s,
                    extra={"fatal": f"{type(exc).__name__}: {exc}"}))
            self._flight_auto(f"engine-fatal: {type(exc).__name__}")
        except Exception:  # noqa: BLE001 — the original fatal wins
            pass

    @property
    def timeline(self) -> StepTimeline | None:
        """The bounded per-step ring; None with tracing off."""
        return self._timeline

    def trace(self, rid: int):
        """The request's lifecycle trace (``obs.RequestTrace``), or None
        with tracing off or once evicted under the retention bound."""
        return self._tracer.get(rid) if self._tracer is not None else None

    def journey(self, rid: int):
        """The request's journey (``obs.Journey``; ``.to_wire()`` gives
        the ``paddle-tpu/journey/v1`` dict), or None with tracing off or
        once evicted."""
        return self._journeys.get(rid) if self._journeys is not None \
            else None

    def journeys(self) -> list:
        """Every retained journey, oldest first (empty with tracing
        off)."""
        return self._journeys.journeys() if self._journeys is not None \
            else []

    def tenant_report(self) -> dict | None:
        """The per-tenant goodput roll-up with the observed per-tenant
        p99s — the flight record's ``tenants`` section. None with tracing
        off."""
        if self._tenants is None:
            return None
        return self._tenants.rollup(self.metrics.tenant_hists)

    def traces(self) -> list:
        """Every retained RequestTrace, oldest first (empty with tracing
        off)."""
        return self._tracer.traces() if self._tracer is not None else []

    def latency_summaries(self) -> list[dict]:
        """Per-request latency decompositions for every retained trace."""
        return self._tracer.summaries() if self._tracer is not None else []

    def export_chrome_trace(self, path=None) -> dict:
        """Chrome ``trace_event`` JSON of the retained request traces, the
        step timeline, the alerts and one track per tenant (loads in
        ui.perfetto.dev); written to ``path`` when given, returned either
        way."""
        traces, alerts, journeys = (self.traces(), self.alerts(),
                                    self.journeys())
        if path is not None:
            return write_chrome_trace(path, traces, self._timeline, alerts,
                                      journeys)
        return chrome_trace(traces, self._timeline, alerts, journeys)
