"""Anomaly watchdogs: known serving pathologies detected live as
structured alerts — the port of ``paddle_tpu/obs/alerts.py``.

Every rule is evaluated once per engine step, at the step boundary, off
values that are ALREADY host-resident — the just-built
:class:`~.timeline.StepRecord` plus a small dict of monotonic counter
totals the engine reads out of its own host state and the monitor
registry. No device read is added, and every rule is EDGE-TRIGGERED: it fires once when its condition onsets and stays
quiet while the condition merely persists, so a deterministic scenario
fires each rule exactly once and a clean run fires none.

The rules (names and messages are the reference's):

- ``retrace_after_warmup`` — ``serving_analysis_retraces_total`` grew
  after the warmup window: a guarded program was traced again. The
  port's ``CompileGuard``s (``analysis.tracecheck``, under
  ``ServingConfig(debug_checks=True)``) count each new signature beyond
  a program's budget as a retrace, which fires the rule.
- ``pallas_fallback`` — ``serving_pallas_fallback_total`` grew: a hot
  dispatch degraded from its kernel to the plain path. The port never
  falls back (a CUDA tensor launches the kernel or raises), so the rule
  stays quiet.
- ``spec_acceptance_collapse`` — the windowed speculative acceptance
  rate fell below the floor with enough proposals to mean it: the draft
  stopped tracking the target and every verify step is mostly wasted
  FLOPs.
- ``eviction_thrash`` — prefix-page evictions + host-tier spills in the
  window crossed the threshold: the pool is churning its warm prefixes
  instead of serving from them.
- ``queue_stall`` — requests are waiting but nothing was admitted and
  nothing is running for N consecutive steps: the engine is wedged (or
  paused with work queued), not merely busy.
- ``slo_burn`` — a tenant's windowed SLO-violation fraction (violation
  retirements / total retirements, from the per-tenant goodput ledger —
  ``tenant.py``) crossed the threshold with enough retirements to mean
  it: that tenant's latency promise is burning, per-tenant and latched
  (re-arms only after a healthy window), the request-grain twin of the
  engine-grain rules above.

Each firing appends an :class:`Alert` to a bounded history ring, bumps
the pre-seeded ``serving_alerts_total{rule=}`` counter family (via the
engine), and renders as an instant on the Chrome-trace engine track —
and the whole history rides along in every flight-record dump.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

__all__ = ["Alert", "WatchdogConfig", "Watchdog", "RULES"]

#: every rule name — the pre-seeded label set of serving_alerts_total{rule=}
RULES = ("retrace_after_warmup", "pallas_fallback",
         "spec_acceptance_collapse", "eviction_thrash", "queue_stall",
         "slo_burn")


@dataclass(frozen=True)
class Alert:
    """One watchdog firing — the structured record the flight recorder
    dumps and the Chrome export renders as an engine-track instant."""
    rule: str
    step: int       # engine step index the rule fired at
    t: float        # engine-clock seconds
    message: str
    data: dict = field(default_factory=dict)

    def asdict(self) -> dict:
        return {"rule": self.rule, "step": self.step, "t": self.t,
                "message": self.message, "data": dict(self.data)}


@dataclass(frozen=True)
class WatchdogConfig:
    """Thresholds; the defaults are deliberately conservative — a clean
    engine (the demo, the bench) must never fire."""
    warmup_steps: int = 8           # retrace rule arms after this step
    acceptance_floor: float = 0.1   # windowed spec acceptance below = bad
    acceptance_min_proposed: int = 64  # proposals before the rate means much
    acceptance_window_steps: int = 16  # spec acceptance window
    thrash_window_steps: int = 16
    thrash_events: int = 8          # evictions + spills in the window
    stall_steps: int = 4            # consecutive no-progress steps
    slo_burn_window_steps: int = 16  # per-tenant retirement window
    slo_burn_threshold: float = 0.5  # violation fraction that fires
    slo_burn_min_retired: int = 4   # retirements before the fraction
    # means anything (one late request out of one is not a burn)
    capacity: int = 256             # alert history ring bound

    def validate(self) -> None:
        if self.warmup_steps < 0:
            raise ValueError(f"warmup_steps {self.warmup_steps} < 0")
        if not 0.0 < self.acceptance_floor < 1.0:
            raise ValueError(
                f"acceptance_floor {self.acceptance_floor} outside (0, 1)")
        if not 0.0 < self.slo_burn_threshold <= 1.0:
            raise ValueError(
                f"slo_burn_threshold {self.slo_burn_threshold} outside "
                f"(0, 1]")
        for name in ("acceptance_min_proposed", "acceptance_window_steps",
                     "thrash_window_steps", "thrash_events", "stall_steps",
                     "slo_burn_window_steps", "slo_burn_min_retired",
                     "capacity"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} {getattr(self, name)} < 1")


class Watchdog:
    """The rule engine. ``on_step(record, counters)`` evaluates every
    rule against one step and returns the alerts that fired (possibly
    empty). ``counters`` carries monotonic TOTALS (retraces, fallbacks,
    proposed, accepted, evictions, spills) — the watchdog keeps its own
    baselines and windows, so callers just hand it the current values.
    """

    def __init__(self, config: WatchdogConfig | None = None, clock=None):
        self.cfg = config or WatchdogConfig()
        self.cfg.validate()
        self._clock = clock or (lambda: 0.0)
        self.history: deque[Alert] = deque(maxlen=self.cfg.capacity)
        self.fired_total: dict[str, int] = {rule: 0 for rule in RULES}
        # baselines / windows
        self._retraces = 0
        self._fallbacks = 0
        self._spec_win: deque[tuple[int, int]] = deque(
            maxlen=self.cfg.acceptance_window_steps)
        self._spec_last = (0, 0)
        self._spec_latched = False
        self._thrash_win: deque[int] = deque(
            maxlen=self.cfg.thrash_window_steps)
        self._thrash_last = 0
        self._stall_streak = 0
        # slo_burn: per-tenant (violation, retired) delta windows, last
        # totals, and the per-tenant latch
        self._burn_win: dict[str, deque] = {}
        self._burn_last: dict[str, tuple[int, int]] = {}
        self._burn_latched: set[str] = set()

    def _fire(self, out: list, rule: str, step: int, message: str,
              **data) -> None:
        alert = Alert(rule, step, self._clock(), message, data)
        self.history.append(alert)
        self.fired_total[rule] += 1
        out.append(alert)

    def on_step(self, record, counters: dict) -> list[Alert]:
        cfg = self.cfg
        out: list[Alert] = []
        step = record.step

        # retrace after warmup: the compile-once contract broke live
        retraces = int(counters.get("retraces", 0))
        if retraces > self._retraces and step >= cfg.warmup_steps:
            self._fire(out, "retrace_after_warmup", step,
                       f"{retraces - self._retraces} over-budget "
                       f"retrace(s) at step {step} (after the "
                       f"{cfg.warmup_steps}-step warmup)",
                       retraces_total=retraces)
        self._retraces = retraces

        # pallas fallback: a hot dispatch lost its fast kernel
        fallbacks = int(counters.get("fallbacks", 0))
        if fallbacks > self._fallbacks:
            self._fire(out, "pallas_fallback", step,
                       f"{fallbacks - self._fallbacks} Pallas dispatch(es) "
                       f"degraded to the composite path",
                       fallbacks_total=fallbacks)
        self._fallbacks = fallbacks

        # speculative acceptance collapse, windowed and latched: fire at
        # the collapse edge, re-arm only after a healthy window
        proposed = int(counters.get("proposed", 0))
        accepted = int(counters.get("accepted", 0))
        lp, la = self._spec_last
        self._spec_last = (proposed, accepted)
        self._spec_win.append((proposed - lp, accepted - la))
        wp = sum(d[0] for d in self._spec_win)
        wa = sum(d[1] for d in self._spec_win)
        if wp >= cfg.acceptance_min_proposed:
            rate = wa / wp
            if rate < cfg.acceptance_floor and not self._spec_latched:
                self._spec_latched = True
                self._fire(out, "spec_acceptance_collapse", step,
                           f"windowed speculative acceptance {rate:.3f} "
                           f"below floor {cfg.acceptance_floor} "
                           f"({wa}/{wp} over {len(self._spec_win)} steps)",
                           window_proposed=wp, window_accepted=wa,
                           rate=rate)
            elif rate >= cfg.acceptance_floor:
                self._spec_latched = False

        # eviction/spill thrash: warm prefixes churning out of the pool
        ev = int(counters.get("evictions", 0)) + int(
            counters.get("spills", 0))
        self._thrash_win.append(ev - self._thrash_last)
        self._thrash_last = ev
        wev = sum(self._thrash_win)
        if wev >= cfg.thrash_events:
            self._fire(out, "eviction_thrash", step,
                       f"{wev} prefix evictions + host-tier spills in "
                       f"{len(self._thrash_win)} steps (threshold "
                       f"{cfg.thrash_events})",
                       window_events=wev)
            self._thrash_win.clear()  # re-arm after another full thrash

        # slo burn, per-tenant, windowed and latched like the acceptance
        # rule: the ledger hands monotonic (violations, retired) totals;
        # fire at the onset edge, re-arm only after a healthy window
        for tenant, (v, r) in (counters.get("tenant_slo") or {}).items():
            win = self._burn_win.get(tenant)
            if win is None:
                win = self._burn_win[tenant] = deque(
                    maxlen=cfg.slo_burn_window_steps)
            lv, lr = self._burn_last.get(tenant, (0, 0))
            self._burn_last[tenant] = (v, r)
            win.append((v - lv, r - lr))
            wv = sum(d[0] for d in win)
            wr = sum(d[1] for d in win)
            if wr < cfg.slo_burn_min_retired:
                # too few retirements to judge a burn — but a FULL window
                # with zero violations is unambiguously healthy, and must
                # re-arm the latch even for a low-rate tenant (otherwise a
                # sparse tenant's first burn latches forever and every
                # later episode is silently missed)
                if wv == 0 and len(win) == win.maxlen:
                    self._burn_latched.discard(tenant)
                continue
            frac = wv / wr
            if frac >= cfg.slo_burn_threshold:
                if tenant not in self._burn_latched:
                    self._burn_latched.add(tenant)
                    self._fire(out, "slo_burn", step,
                               f"tenant {tenant!r} windowed SLO-violation "
                               f"fraction {frac:.3f} at/above threshold "
                               f"{cfg.slo_burn_threshold} ({wv}/{wr} "
                               f"retirements over {len(win)} steps)",
                               tenant=tenant, window_violations=wv,
                               window_retired=wr, fraction=frac)
            else:
                self._burn_latched.discard(tenant)

        # queue stall: waiting work, zero progress, N consecutive steps
        stalled = (record.queue_depth > 0 and record.admitted == 0
                   and record.batch == 0 and record.chunks == 0)
        self._stall_streak = self._stall_streak + 1 if stalled else 0
        if self._stall_streak == cfg.stall_steps:
            self._fire(out, "queue_stall", step,
                       f"{record.queue_depth} request(s) waiting with no "
                       f"admission and nothing running for "
                       f"{cfg.stall_steps} consecutive steps",
                       queue_depth=record.queue_depth)

        return out

    def alerts(self) -> list[Alert]:
        """The retained alert history, oldest first."""
        return list(self.history)
