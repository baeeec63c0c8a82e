"""Serving observability surfaced through ``utils/monitor.py`` — the port
of ``paddle_tpu/serving/metrics.py``: the same ``serving_*`` names,
seeded the same way, so a dashboard or a flight-record reader cannot
tell the two engines apart.

Every gauge and counter is a ``serving_*`` stat in the process-wide
monitor registry, pre-seeded to 0 at construction (``_SEEDED``: a
snapshot taken before the first event still shows the zeros), plus:

- labeled families (``_FAMILIES``): registry keys
  ``serving_<base>{<label>=<value>}`` whose label values are seeded at
  engine construction (``seed_family``) — ``alerts_total{rule=}``,
  ``cost_model_drift{program=}``, the per-tenant goodput/badput and
  ``tenant_retired_total{tenant=,class=}`` counters;
- histograms (``_HISTOGRAMS``): ``ttft_s``, ``tpot_s``, ``queue_wait_s``,
  ``e2e_s`` (fed from request traces at retirement), ``step_duration_s``
  and ``batch_occupancy`` (fed at every step boundary), mirrored lazily
  as ``serving_<hist>_p50/p90/p99`` and ``_count`` at ``snapshot()``;
  the ``step_phase_s{phase=}`` family (per-phase step wall time) and the
  per-tenant ``ttft_s`` / ``tpot_s`` / ``queue_delay_s{tenant=}``
  families mirror the same way;
- ``prometheus()``: the text exposition, counters typed from
  ``COUNTER_STATS``.

The fleet router and its transport (``serving/fleet.py``,
``serving/channel.py``) feed the ``fleet_*``, ``wire_*`` and
``breaker_*`` names and the per-peer ``wire_rtt_s`` / ``wire_attempts``
histogram families; ``tp_degree`` is set at engine construction.

The analysis layer feeds the rest under ``ServingConfig(debug_checks=
True)``, as in the reference: ``on_analysis`` (the guards' retraces and
the SyncTally's host reads), ``on_hlo_audit`` (each program's audit),
``on_tp_audit`` and ``on_mesh_audit`` (tensor parallelism's census and
its placement); the engine's ``RooflineTracker`` divides measured step
time by the audits' flops and bytes into ``mfu``, ``hbm_bw_util`` and
``cost_model_drift{program=}``. What stays at its seeded zero, as in the
reference without the inputs that feed it: ``pallas_fallback_total`` and
the ``flash_*`` dispatch counters (the port never falls back). The
``kernel_speedup_*{kernel=}`` families carry the reference's labels
(``ragged_paged``, ``ragged_paged_q8``, ``ragged_paged_verify`` ...):
the engine seeds them at construction with the predictions of the port's
own kernelcheck bank (``obs.attribution.load_banked_kernel_speedups``;
the reference's TPU bank is not read) and feeds the measured half at its
decode and verify dispatches, published once both legs, kernel and plain
version, have samples.
"""
from __future__ import annotations

import time
from collections import deque

from ..obs.attribution import PHASES
from ..obs.histogram import (LATENCY_EDGES_S, OCCUPANCY_EDGES, QUANTILES,
                             Histogram, HistogramFamily)
from ..obs.tenant import CLASSES as TENANT_CLASSES
from ..utils import monitor

PREFIX = "serving_"

# always-visible counters and gauges (a snapshot taken before the first
# event must still show the zeros — dashboards key on presence); the
# reference's list, name for name
_SEEDED = ("tokens_total", "prefills_total", "prefill_tokens_total",
           "prefill_chunks_total", "chunk_limit", "slo_throttles_total",
           "decode_steps", "preemptions_total",
           "rejected", "shed", "expired", "cancelled", "failed",
           "swap_outs", "swap_ins",
           "prefix_hits", "prefix_misses", "prefix_tokens_saved",
           "prefix_shared_pages", "prefix_cached_pages",
           "prefix_cow_copies", "prefix_evictions",
           "spec_depth", "spec_proposed_tokens_total",
           "spec_accepted_tokens_total", "spec_acceptance_rate",
           "kv_bytes_per_token", "host_tier_pages", "host_tier_bytes",
           "host_tier_hits_total", "host_tier_spills_total",
           "host_tier_restores_total",
           "pallas_fallback_total",
           "flash_pad_total", "flash_edge_fallback_total",
           "analysis_retraces_total", "analysis_host_syncs_total",
           "hlo_collective_ops", "hlo_host_transfers",
           "hlo_peak_hbm_bytes", "hlo_flops_per_step",
           "tp_degree", "tp_collective_ops_per_step",
           "tp_collective_bytes_per_token", "tp_collective_overlap_frac",
           "ici_bytes_per_token", "dcn_bytes_per_token",
           "collective_time_predicted_s",
           "tokens_per_sec", "queue_depth", "active_requests",
           "page_pool_used", "page_utilization", "mfu", "hbm_bw_util",
           "fleet_replicas", "fleet_prefix_affinity_hits_total",
           "fleet_spills_total",
           "fleet_goodput_tokens_total", "fleet_inflight_exchanges",
           "wire_tx_bytes_total", "wire_rx_bytes_total",
           "wire_retries_total", "wire_hedge_wins_total",
           "wire_refetch_fallback_total",
           "queue_depth_peak", "page_pool_peak")

# labeled stat families: base name -> label key, or an ORDERED tuple of
# label keys for multi-label families. Members live in the monitor
# registry as ``serving_<base>{<l1>=<v1>,<l2>=<v2>}`` keys (labels in
# declared order — seeding and every write site must agree); label
# VALUES are seeded at engine construction (seed_family) since most are
# only known then (prefill bucket labels, declared tenants).
_FAMILIES = {
    "step_phase_s": "phase",              # histogram family (below)
    "alerts_total": "rule",               # counter: watchdog firings
    "cost_model_drift": "program",        # stat_max: measured/predicted
    "kernel_speedup_predicted": "kernel",  # the kernelcheck bank
    "kernel_speedup_measured": "kernel",   # live composite/kernel ratio
    "kernel_speedup_drift": "kernel",      # measured / predicted
    "tenant_goodput_tokens_total": "tenant",   # in_slo tokens per tenant
    "tenant_badput_tokens_total": "tenant",    # everything-else tokens
    "tenant_retired_total": ("tenant", "class"),  # retirements per
    # terminal class — the one multi-label family (badput breakdown)
    "fleet_tenant_weight": "tenant",      # router admission weight (the
    # slo_burn-actuated outer-loop gain; 1.0 until a burn onset)
    "wire_corrupt_total": "kind",         # counter: decode failures by
    # WireError taxonomy kind (truncated / corrupt / bad_version)
    "breaker_open_total": "peer",         # counter: circuit-breaker
    # open transitions per peer replica index
    "breaker_state": "peer",              # gauge: current breaker state
    # per peer (closed/half_open/open as 0/1/2 — every transition
    # metered, the gauge can never skip a state)
    "wire_bytes_total": "type",           # counter: exchange tx bytes
    # by frame type (page / digests / rehome), fed from ExchangeInfo
    "wire_rtt_s": "peer",                 # histogram family (below):
    "wire_attempts": "peer",              # per-peer exchange round-trip
    # time and copies-sent count, fed from ExchangeInfo post-exchange
    "ttft_s": "tenant",                   # histogram family (per-tenant
    "tpot_s": "tenant",                   # latency classes; the plain
    "queue_delay_s": "tenant",            # serving_ttft_s etc. hist
    # keeps the engine-wide view, these children split it by tenant)
}

# histogram name -> bucket edges; percentile gauges <name>_{p50,p90,p99}
# and <name>_count are seeded for each (dynamically — same presence
# contract as _SEEDED)
_HISTOGRAMS = (("ttft_s", LATENCY_EDGES_S),
               ("tpot_s", LATENCY_EDGES_S),
               ("queue_wait_s", LATENCY_EDGES_S),
               ("e2e_s", LATENCY_EDGES_S),
               ("step_duration_s", LATENCY_EDGES_S),
               ("batch_occupancy", OCCUPANCY_EDGES))

# trace-summary key -> histogram it feeds
_SUMMARY_HISTS = (("ttft", "ttft_s"), ("tpot", "tpot_s"),
                  ("queue_wait", "queue_wait_s"), ("e2e", "e2e_s"))

# Prometheus exposition types for the monotonic stats; unlisted serving_*
# scalars export as gauges, the histograms as real bucket series
COUNTER_STATS = frozenset(
    PREFIX + k for k in _SEEDED
    if k.endswith("_total") or k in (
        "decode_steps", "rejected", "shed", "expired", "cancelled",
        "failed", "swap_outs", "swap_ins", "prefix_hits", "prefix_misses",
        "prefix_tokens_saved", "prefix_cow_copies", "prefix_evictions",
        "hlo_collective_ops", "hlo_host_transfers")) \
    | frozenset({  # labeled counter family bases
        PREFIX + "alerts_total",
        PREFIX + "tenant_goodput_tokens_total",
        PREFIX + "tenant_badput_tokens_total",
        PREFIX + "tenant_retired_total",
        PREFIX + "wire_corrupt_total",
        PREFIX + "breaker_open_total",
        PREFIX + "wire_bytes_total"})

#: serving_breaker_state{peer=} gauge values — the breaker state
#: machine's three states in escalation order
BREAKER_STATE_VALUES = {"closed": 0, "half_open": 1, "open": 2}


class ServingMetrics:
    """Writes the serving stats; a sliding window over (time, tokens_total)
    yields tokens/s without a background thread."""

    def __init__(self, window_s: float = 10.0):
        self.window_s = window_s
        self._samples: deque[tuple[float, float]] = deque()
        self.hists = {name: Histogram(PREFIX + name, edges)
                      for name, edges in _HISTOGRAMS}
        # the per-phase step-time histogram family (label-generic: the
        # mechanism the per-tenant latency classes below reuse)
        self.phase_hist = HistogramFamily(
            PREFIX + "step_phase_s", "phase", LATENCY_EDGES_S,
            values=PHASES)
        # per-tenant latency classes: children of the SAME base names as
        # the engine-wide hists (plus queue_delay_s), split by tenant —
        # children are created by seed_tenants / first observation
        self.tenant_hists = {
            "ttft_s": HistogramFamily(PREFIX + "ttft_s", "tenant",
                                      LATENCY_EDGES_S),
            "tpot_s": HistogramFamily(PREFIX + "tpot_s", "tenant",
                                      LATENCY_EDGES_S),
            "queue_delay_s": HistogramFamily(PREFIX + "queue_delay_s",
                                             "tenant", LATENCY_EDGES_S),
        }
        # per-peer transport families, fed from ExchangeInfo after every
        # exchange — children created by seed_wire_peers at router
        # construction (or on first sight of a peer)
        self.wire_hists = {
            "wire_rtt_s": HistogramFamily(PREFIX + "wire_rtt_s",
                                          "peer", LATENCY_EDGES_S),
            "wire_attempts": HistogramFamily(PREFIX + "wire_attempts",
                                             "peer", OCCUPANCY_EDGES),
        }
        # scalar family members seeded so far: base -> ordered values
        # (str, or a tuple matching a multi-label declaration;
        # seed_family records them so reset() can replay the zeros)
        self._family_values: dict[str, list] = {}
        self.reset()

    def _hist_families(self):
        return (self.phase_hist, *self.tenant_hists.values(),
                *self.wire_hists.values())

    @staticmethod
    def _family_key(base: str, value) -> str:
        """The registry key of one family member: ``base{l=v}`` for a
        single label, ``base{l1=v1,l2=v2}`` in DECLARED label order for
        a multi-label family (every write site must render the same
        order)."""
        label = _FAMILIES[base]  # KeyError = undeclared family
        if isinstance(label, tuple):
            if not isinstance(value, tuple) or len(value) != len(label):
                raise ValueError(
                    f"family {base!r} declares labels {label} — seed "
                    f"values must be {len(label)}-tuples, got {value!r}")
            body = ",".join(f"{k}={v}" for k, v in zip(label, value))
        else:
            body = f"{label}={value}"
        return PREFIX + f"{base}{{{body}}}"

    def reset(self) -> None:
        for k in list(monitor.stats_with_prefix(PREFIX)):
            monitor.stat_reset(k)
        for k in _SEEDED:
            monitor.stat_set(PREFIX + k, 0)
        for h in self.hists.values():
            h.reset()
        for fam in self._hist_families():
            fam.reset()
        for base, values in self._family_values.items():
            for v in values:
                monitor.stat_set(self._family_key(base, v), 0)
        self._publish_hists()  # seed the percentile gauges at 0
        self._samples.clear()
        self._samples.append((time.perf_counter(), 0.0))

    def seed_family(self, base: str, values) -> None:
        """Pre-seed labeled family members at 0 — the presence contract
        ``_SEEDED`` gives scalars, for label values only known at engine
        construction (prefill buckets, watchdog rules, declared
        tenants). ``base`` must be declared in ``_FAMILIES``; a
        multi-label base takes value TUPLES in declared label order."""
        seen = self._family_values.setdefault(base, [])
        for v in values:
            v = tuple(str(x) for x in v) if isinstance(v, tuple) \
                else str(v)
            key = self._family_key(base, v)
            if v not in seen:
                seen.append(v)
            # seeding declares PRESENCE — it must never erase history.
            # Engines in one process share the one monitor registry: a
            # second engine first seeing an ad-hoc tenant mid-run would
            # otherwise zero counts the first one already accrued.
            if monitor.stat_get(key, None) is None:
                monitor.stat_set(key, 0)

    def seed_tenants(self, tenants) -> None:
        """Pre-seed every per-tenant surface for the given tenant names:
        the goodput/badput counter families, the (tenant, class)
        retirement grid, and the three latency histogram-family
        children — called at engine construction for the declared
        tenants + "default", and on first sight of an ad-hoc tenant."""
        tenants = [str(t) for t in tenants]
        self.seed_family("tenant_goodput_tokens_total", tenants)
        self.seed_family("tenant_badput_tokens_total", tenants)
        self.seed_family("tenant_retired_total",
                         [(t, c) for t in tenants for c in TENANT_CLASSES])
        for fam in self.tenant_hists.values():
            for t in tenants:
                fam.child(t)

    def seed_wire_peers(self, peers) -> None:
        """Pre-seed every per-peer transport surface for the given
        replica indices: the ``breaker_state`` gauge family (at 0 =
        closed) and the ``wire_rtt_s`` / ``wire_attempts`` histogram
        children — called at router construction."""
        peers = [str(p) for p in peers]
        self.seed_family("breaker_state", peers)
        for fam in self.wire_hists.values():
            for p in peers:
                fam.child(p)

    # ------------------------------------------------------------- updates
    def on_prefill(self, tokens: int = 0) -> None:
        monitor.stat_add(PREFIX + "prefills_total", 1)
        monitor.stat_add(PREFIX + "prefill_tokens_total", int(tokens))

    def on_prefix_hit(self, tokens_saved: int) -> None:
        monitor.stat_add(PREFIX + "prefix_hits", 1)
        monitor.stat_add(PREFIX + "prefix_tokens_saved", int(tokens_saved))

    def on_prefill_chunk(self, tokens: int) -> None:
        """One chunk of a chunked prefill: the chunk counter plus the
        FLOPs-weighted token count (the final chunk's ``on_prefill(0)``
        then adds only the per-request prefill count)."""
        monitor.stat_add(PREFIX + "prefill_chunks_total", 1)
        monitor.stat_add(PREFIX + "prefill_tokens_total", int(tokens))

    def on_chunk_limit(self, limit: int, throttled: bool = False) -> None:
        """Mirror the SLO controller's chunks-per-step limit; a window
        that lowered it also counts a throttle."""
        monitor.stat_set(PREFIX + "chunk_limit", int(limit))
        if throttled:
            monitor.stat_add(PREFIX + "slo_throttles_total", 1)

    def on_prefix_miss(self) -> None:
        monitor.stat_add(PREFIX + "prefix_misses", 1)

    def on_preempt(self) -> None:
        monitor.stat_add(PREFIX + "preemptions_total", 1)

    def on_rejected(self) -> None:
        monitor.stat_add(PREFIX + "rejected", 1)

    def on_shed(self) -> None:
        monitor.stat_add(PREFIX + "shed", 1)

    def on_expired(self) -> None:
        monitor.stat_add(PREFIX + "expired", 1)

    def on_cancelled(self) -> None:
        monitor.stat_add(PREFIX + "cancelled", 1)

    def on_failed(self) -> None:
        monitor.stat_add(PREFIX + "failed", 1)

    def on_swap_out(self) -> None:
        monitor.stat_add(PREFIX + "swap_outs", 1)

    def on_swap_in(self) -> None:
        monitor.stat_add(PREFIX + "swap_ins", 1)

    def on_tokens(self, n: int) -> None:
        total = monitor.stat_add(PREFIX + "tokens_total", int(n))
        now = time.perf_counter()
        self._samples.append((now, float(total)))
        while len(self._samples) > 2 and \
                now - self._samples[0][0] > self.window_s:
            self._samples.popleft()
        t0, n0 = self._samples[0]
        rate = (total - n0) / (now - t0) if now > t0 else 0.0
        monitor.stat_set(PREFIX + "tokens_per_sec", rate)

    def on_decode_step(self) -> None:
        monitor.stat_add(PREFIX + "decode_steps", 1)

    def on_spec_depth(self, depth: int) -> None:
        """The configured speculation depth K (0 = speculation off), set
        once at engine construction."""
        monitor.stat_set(PREFIX + "spec_depth", int(depth))

    def on_spec(self, proposed: int, accepted: int) -> None:
        """One verify step's speculation outcome: candidates proposed
        (depth per active slot) and accepted; the lifetime acceptance
        rate is recomputed off the running totals stat_add returns."""
        p = monitor.stat_add(PREFIX + "spec_proposed_tokens_total",
                             int(proposed))
        a = monitor.stat_add(PREFIX + "spec_accepted_tokens_total",
                             int(accepted))
        monitor.stat_set(PREFIX + "spec_acceptance_rate",
                         a / p if p else 0.0)

    def on_kv_bytes_per_token(self, nbytes: int) -> None:
        """Device bytes one resident token costs (set once at engine
        construction — a static consequence of kv_dtype + the model
        shape, the denominator capacity dashboards divide HBM by)."""
        monitor.stat_set(PREFIX + "kv_bytes_per_token", int(nbytes))

    def on_state(self, queue_depth: int, active: int, pages_used: int,
                 usable_pages: int, shared_pages: int = 0,
                 cached_pages: int = 0, cow_copies: int = 0,
                 evictions: int = 0, host_tier_pages: int = 0,
                 host_tier_bytes: int = 0, host_tier_hits: int = 0,
                 host_tier_spills: int = 0,
                 host_tier_restores: int = 0) -> None:
        monitor.stat_set(PREFIX + "queue_depth", queue_depth)
        monitor.stat_set(PREFIX + "active_requests", active)
        monitor.stat_set(PREFIX + "page_pool_used", pages_used)
        monitor.stat_set(PREFIX + "page_utilization",
                         pages_used / max(1, usable_pages))
        monitor.stat_max(PREFIX + "queue_depth_peak", queue_depth)
        monitor.stat_max(PREFIX + "page_pool_peak", pages_used)
        monitor.stat_set(PREFIX + "prefix_shared_pages", shared_pages)
        monitor.stat_set(PREFIX + "prefix_cached_pages", cached_pages)
        # cache-owned monotonic counters, mirrored as absolute values
        monitor.stat_set(PREFIX + "prefix_cow_copies", cow_copies)
        monitor.stat_set(PREFIX + "prefix_evictions", evictions)
        monitor.stat_set(PREFIX + "host_tier_pages", host_tier_pages)
        monitor.stat_set(PREFIX + "host_tier_bytes", host_tier_bytes)
        monitor.stat_set(PREFIX + "host_tier_hits_total", host_tier_hits)
        monitor.stat_set(PREFIX + "host_tier_spills_total",
                         host_tier_spills)
        monitor.stat_set(PREFIX + "host_tier_restores_total",
                         host_tier_restores)

    def on_analysis(self, retraces: int, host_syncs: int) -> None:
        """CompileGuard/SyncTally totals, mirrored as absolute values (the
        guards own the monotonic counts)."""
        monitor.stat_set(PREFIX + "analysis_retraces_total", retraces)
        monitor.stat_set(PREFIX + "analysis_host_syncs_total", host_syncs)

    def on_tp_degree(self, degree: int) -> None:
        """The engine's tensor-parallel degree (1 = single-chip), set at
        construction so dashboards can segment every other gauge by it."""
        monitor.stat_set(PREFIX + "tp_degree", int(degree))

    def on_tp_audit(self, collective_ops: int, bytes_per_token: float,
                    overlap_frac: float = 0.0) -> None:
        """One tensor-parallel step audit (debug_checks, once per
        program): collective ops a step, collective payload bytes per
        token the program advances and the overlap fraction (0.0 in the
        port: every collective is synchronous). stat_max keeps the worst
        program observed."""
        monitor.stat_max(PREFIX + "tp_collective_ops_per_step",
                         int(collective_ops))
        monitor.stat_max(PREFIX + "tp_collective_bytes_per_token",
                         float(bytes_per_token))
        monitor.stat_max(PREFIX + "tp_collective_overlap_frac",
                         float(overlap_frac))

    def on_mesh_audit(self, ici_bytes_per_token: float,
                      dcn_bytes_per_token: float,
                      predicted_s: float) -> None:
        """One meshcheck placement (debug_checks, once per program): the
        per-token collective payload within a host (``ici``: NVLink) and
        across hosts (``dcn``: the network), attributed on the declared
        (or default single-host) topology, and the link-time model's
        predicted collective seconds a step. stat_max keeps the worst
        program; dcn_bytes_per_token staying 0.0 IS the single-host
        contract."""
        monitor.stat_max(PREFIX + "ici_bytes_per_token",
                         float(ici_bytes_per_token))
        monitor.stat_max(PREFIX + "dcn_bytes_per_token",
                         float(dcn_bytes_per_token))
        monitor.stat_max(PREFIX + "collective_time_predicted_s",
                         float(predicted_s))

    def on_hlo_audit(self, collective_ops: int, host_transfers: int,
                     peak_hbm_bytes: int, flops: float) -> None:
        """One step audit (debug_checks, once per program): collective
        and host-transfer ops accumulate across programs, peak bytes and
        flops keep the per-program maximum."""
        monitor.stat_add(PREFIX + "hlo_collective_ops", int(collective_ops))
        monitor.stat_add(PREFIX + "hlo_host_transfers", int(host_transfers))
        monitor.stat_max(PREFIX + "hlo_peak_hbm_bytes", int(peak_hbm_bytes))
        monitor.stat_max(PREFIX + "hlo_flops_per_step", float(flops))

    # ------------------------------------------- attribution + watchdogs
    def on_phase(self, phase: str, seconds: float) -> None:
        """One phase's share of one step's wall time (attribution layer;
        zero-time phases are not observed — the StepRecord keeps the
        exact split)."""
        self.phase_hist.observe(phase, seconds)

    def on_roofline(self, mfu: float, hbm_bw_util: float) -> None:
        """The live roofline gauges, recomputed from measured dispatch
        time against the per-program predictions."""
        monitor.stat_set(PREFIX + "mfu", float(mfu))
        monitor.stat_set(PREFIX + "hbm_bw_util", float(hbm_bw_util))

    def on_drift(self, program: str, ratio: float) -> None:
        """Measured/predicted step-time ratio for one compiled program —
        a high-watermark, so the worst drift ever seen survives
        sampling."""
        monitor.stat_max(PREFIX + f"cost_model_drift{{program={program}}}",
                         float(ratio))

    def on_kernel_ab(self, kernel: str, predicted: float | None = None,
                     measured: float | None = None,
                     drift: float | None = None) -> None:
        """One kernel's predicted-vs-measured speedup A/B: a predicted
        speedup beside the live plain/kernel dispatch-time ratio (absent
        until both paths have served traffic)."""
        if predicted is not None:
            monitor.stat_set(
                PREFIX + f"kernel_speedup_predicted{{kernel={kernel}}}",
                float(predicted))
        if measured is not None:
            monitor.stat_set(
                PREFIX + f"kernel_speedup_measured{{kernel={kernel}}}",
                float(measured))
        if drift is not None:
            monitor.stat_set(
                PREFIX + f"kernel_speedup_drift{{kernel={kernel}}}",
                float(drift))

    def on_alert(self, rule: str) -> None:
        """One watchdog firing (the rule's family member is pre-seeded
        at engine construction)."""
        monitor.stat_add(PREFIX + f"alerts_total{{rule={rule}}}", 1)

    # ------------------------------------------------- per-tenant ledger
    def on_tenant_retire(self, tenant: str, cls: str, tokens: int) -> None:
        """One classified retirement from the tenant ledger: bump the
        (tenant, class) retirement counter and accrue the request's
        emitted tokens to goodput (``in_slo``) or badput (anything
        else). Family members are pre-seeded for declared tenants; the
        engine seeds ad-hoc tenants on first sight."""
        monitor.stat_add(
            PREFIX + f"tenant_retired_total{{tenant={tenant},class={cls}}}",
            1)
        if cls == "in_slo":
            monitor.stat_add(
                PREFIX + f"tenant_goodput_tokens_total{{tenant={tenant}}}",
                int(tokens))
        else:
            monitor.stat_add(
                PREFIX + f"tenant_badput_tokens_total{{tenant={tenant}}}",
                int(tokens))

    # ------------------------------------------------------ fleet router
    def on_fleet_replicas(self, n: int) -> None:
        """Live replica count — set at router construction and again when
        a ``replica_down`` fault retires a replica."""
        monitor.stat_set(PREFIX + "fleet_replicas", int(n))

    def on_fleet_affinity_hit(self) -> None:
        """One request routed to a replica with a warm prefix match."""
        monitor.stat_add(PREFIX + "fleet_prefix_affinity_hits_total", 1)

    def on_fleet_spill(self) -> None:
        """One request spilled off its warm replica (or re-homed off a
        dead one) to the least-loaded survivor."""
        monitor.stat_add(PREFIX + "fleet_spills_total", 1)

    def on_fleet_tenant_weight(self, tenant: str, weight: float) -> None:
        """The router's admission weight for one tenant (family member
        pre-seeded at router construction)."""
        monitor.stat_set(
            PREFIX + f"fleet_tenant_weight{{tenant={tenant}}}",
            float(weight))

    # ------------------------------------------------------ wire transport
    def on_wire_tx(self, nbytes: int) -> None:
        """Frame bytes handed to the channel (counted per attempt —
        a retried or hedged frame pays its bytes again, the real cost)."""
        monitor.stat_add(PREFIX + "wire_tx_bytes_total", int(nbytes))

    def on_wire_rx(self, nbytes: int) -> None:
        """Frame bytes of a SUCCESSFUL exchange's winning copy, decoded
        clean (corrupt arrivals count in the corrupt family instead)."""
        monitor.stat_add(PREFIX + "wire_rx_bytes_total", int(nbytes))

    def on_wire_retry(self) -> None:
        """One transport retry (the attempt after a backoff)."""
        monitor.stat_add(PREFIX + "wire_retries_total", 1)

    def on_wire_corrupt(self, kind: str) -> None:
        """One frame that failed to decode, by WireError taxonomy kind
        (family pre-seeded at router construction for the three
        kinds)."""
        monitor.stat_add(
            PREFIX + f"wire_corrupt_total{{kind={kind}}}", 1)

    def on_wire_hedge_win(self) -> None:
        """One hedged read won by the hedge copy (the second transfer
        completed first or alone)."""
        monitor.stat_add(PREFIX + "wire_hedge_wins_total", 1)

    def on_wire_refetch_fallback(self) -> None:
        """One cross-replica page fetch that failed (corrupt / timed
        out / breaker open) and degraded to local re-prefill instead of
        failing the request."""
        monitor.stat_add(PREFIX + "wire_refetch_fallback_total", 1)

    def on_breaker_open(self, peer) -> None:
        """One circuit-breaker open transition for ``peer`` (family
        pre-seeded at router construction for every replica index)."""
        monitor.stat_add(
            PREFIX + f"breaker_open_total{{peer={peer}}}", 1)

    def on_breaker_state(self, peer, state: str) -> None:
        """The breaker's CURRENT state for ``peer`` as a gauge
        (closed/half_open/open as 0/1/2) — fed on every transition, so
        a scrape between transitions always shows the true state and
        the gauge can never skip half_open on the way back to
        closed."""
        monitor.stat_set(
            PREFIX + f"breaker_state{{peer={peer}}}",
            BREAKER_STATE_VALUES[state])

    def on_wire_exchange(self, peer, *, rtt_s: float,
                         attempts: int) -> None:
        """One finished exchange (success or failure), fed from
        ``Transport.last``: whole-exchange round-trip time (backoffs
        included) and copies sent, both split per peer."""
        peer = str(peer)
        self.wire_hists["wire_rtt_s"].observe(peer, float(rtt_s))
        self.wire_hists["wire_attempts"].observe(peer, int(attempts))

    def on_wire_frame_bytes(self, kind: str, nbytes: int) -> None:
        """Exchange tx bytes attributed to their frame type (family
        pre-seeded at router construction for the three kinds)."""
        monitor.stat_add(
            PREFIX + f"wire_bytes_total{{type={kind}}}", int(nbytes))

    def on_fleet_inflight(self, delta: int) -> None:
        """Exchanges currently on the wire — +1 at exchange entry, -1
        on return (a scrape mid-exchange shows 1)."""
        monitor.stat_add(PREFIX + "fleet_inflight_exchanges", int(delta))

    def on_fleet_goodput(self, tokens: int) -> None:
        """Fleet-wide goodput roll-up: the sum of every tenant's in-SLO
        tokens, mirrored as one counter (stat_set of a monotonic sum —
        the host_tier mirror idiom)."""
        monitor.stat_set(PREFIX + "fleet_goodput_tokens_total",
                         int(tokens))

    def observe_tenant(self, tenant: str, ttft, tpot,
                       queue_delay) -> None:
        """Feed the per-tenant latency histogram families at one
        retirement — None fields (milestones the lifecycle never
        reached) are skipped, the observe_request contract."""
        for key, v in (("ttft_s", ttft), ("tpot_s", tpot),
                       ("queue_delay_s", queue_delay)):
            if v is not None:
                self.tenant_hists[key].observe(tenant, v)

    # ---------------------------------------------------------- histograms
    def observe_request(self, summary: dict) -> None:
        """Feed the request-latency histograms from one trace summary
        (obs.trace.RequestTrace.summary). None fields — a milestone the
        lifecycle never reached, e.g. TTFT of a request cancelled while
        waiting — are skipped, not recorded as zeros."""
        for key, hist in _SUMMARY_HISTS:
            v = summary.get(key)
            if v is not None:
                self.hists[hist].observe(v)

    def observe_step(self, duration_s: float, occupancy: int) -> None:
        """One engine step: duration (engine-clock seconds) and the number
        of active decode slots it served."""
        self.hists["step_duration_s"].observe(duration_s)
        self.hists["batch_occupancy"].observe(occupancy)

    def _publish_hists(self) -> None:
        """Mirror percentiles + counts into the monitor registry. Called
        lazily from snapshot()/reset(), never on the serving hot path —
        observation stays O(log buckets). Family children mirror as
        ``<base>_<suffix>{<label>=<value>}`` — the phase family and
        every per-tenant family through the same loop."""
        for name, h in self.hists.items():
            for suffix, q in QUANTILES:
                monitor.stat_set(f"{PREFIX}{name}_{suffix}",
                                 h.percentile(q))
            monitor.stat_set(f"{PREFIX}{name}_count", h.count)
        for fam in self._hist_families():
            for value, h in fam.children().items():
                lab = f"{{{fam.label}={value}}}"
                for suffix, q in QUANTILES:
                    monitor.stat_set(f"{fam.name}_{suffix}" + lab,
                                     h.percentile(q))
                monitor.stat_set(f"{fam.name}_count" + lab, h.count)

    # ------------------------------------------------------------ querying
    def snapshot(self) -> dict:
        self._publish_hists()
        return monitor.stats_with_prefix(PREFIX)

    def prometheus(self) -> str:
        """Prometheus text exposition of every serving stat: scalars typed
        counter/gauge (labeled family members rendered with proper
        sample labels through the sorted/escaped label renderer), the
        obs histograms — including the per-phase family's children and
        the per-tenant latency families — as cumulative bucket series.
        Histograms sharing a base name (the plain ``serving_ttft_s`` and
        its ``{tenant=}`` children) are emitted adjacent, so the
        ``# TYPE`` header appears exactly once per family."""
        from ..obs.export import prometheus_text

        types = {k: "counter" for k in COUNTER_STATS}
        hists = []
        for name, h in self.hists.items():
            hists.append(h)
            fam = self.tenant_hists.get(name)
            if fam is not None:  # tenant children ride under the same base
                hists.extend(fam.children().values())
        for name, fam in self.tenant_hists.items():
            if name not in self.hists:  # queue_delay_s: family-only base
                hists.extend(fam.children().values())
        hists.extend(self.phase_hist.children().values())
        for fam in self.wire_hists.values():
            hists.extend(fam.children().values())
        return prometheus_text(self.snapshot(), hists, types)
