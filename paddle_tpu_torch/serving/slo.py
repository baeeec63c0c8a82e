"""SLO-adaptive admission for chunked prefill — the port of
``paddle_tpu/serving/slo.py``.

Chunked prefill (engine.py) bounds how much prefill work ONE request can
inject into a step; this module bounds how much prefill work ALL requests
together inject, driven by the latency objectives the operator actually
cares about. :class:`SLOConfig` declares the targets —

- ``ttft_p99_s``: time-to-first-token p99. The controller cannot observe
  a waiting request's TTFT before it happens, so it enforces the
  controllable proxy: a newcomer enqueued behind K steps of queue pays
  ~K x step_duration before its first token, so the windowed
  ``serving_step_duration_s`` p99 must stay under ``ttft_p99_s *
  step_budget_frac`` (how much of the TTFT budget a single step may eat).
- ``tpot_p99_s``: per-output-token p99 for RUNNING requests — the
  windowed ``serving_tpot_s`` p99 must stay under it. Prefill chunks
  stretch the very steps decode tokens ride, so TPOT is the direct
  casualty of over-admitting chunks.

:class:`SLOController` evaluates every ``window_steps`` engine steps and
adapts ``chunk_limit`` — prefill chunks admitted per step — AIMD-style:
halve on a breached window (multiplicative decrease, floored at
``min_chunks_per_step``), +1 on a clean window (additive increase, capped
at ``max_chunks_per_step``). While degraded (throttled below the cap) the
engine also passes ``Scheduler.admit(prefer_cached=True)``: waiters with
warm prefix-cache hits are admitted ahead of cold ones — their uncached
tail is cheap, so they cost almost none of the scarce chunk budget.

The contract that makes this safe to run in the serving loop: the
controller reads ONLY host-side state — the obs histograms' integer
bucket counts (windowed by snapshot subtraction,
``obs.histogram.percentile_from_counts`` over the delta) — and never
touches a device value, so the engine's one device read a step stays
one with the controller on.

The step histograms are fed by the obs layer, so the controller requires
``enable_tracing=True`` (the default; the engine refuses the combination
otherwise rather than silently never throttling).
"""
from __future__ import annotations

from dataclasses import dataclass

from ..obs.histogram import percentile_from_counts

__all__ = ["SLOConfig", "SLOController"]

# the histograms the controller windows — step-fed and trace-fed (names
# are keys into ServingMetrics.hists)
_WATCHED = ("step_duration_s", "tpot_s")


@dataclass(frozen=True)
class SLOConfig:
    """Latency objectives + controller tuning for chunked prefill.

    At least one of ``ttft_p99_s`` / ``tpot_p99_s`` must be set — a
    controller with nothing to enforce is a configuration error, not a
    no-op. ``max_chunks_per_step=0`` defaults to the engine's
    ``max_batch`` (every prefilling slot may advance each step)."""

    ttft_p99_s: float | None = None  # enqueue -> first token, p99 target
    tpot_p99_s: float | None = None  # seconds per output token, p99 target
    window_steps: int = 8            # steps per controller evaluation
    min_chunks_per_step: int = 1     # floor: prefill never fully starves
    max_chunks_per_step: int = 0     # cap; 0 -> engine max_batch
    step_budget_frac: float = 0.25   # step p99 budget as a TTFT fraction


class SLOController:
    """Windowed-p99 AIMD over chunks-admitted-per-step. Host-side only.

    ``on_step()`` is called at every engine step boundary; it is a
    counter bump except on window boundaries, where it computes the
    windowed p99s (integer bucket arithmetic) and adjusts
    ``chunk_limit``. ``degraded`` is True from the first breached window
    until the limit has additively recovered to the cap — the engine
    keys the warm-prefix admission preference on it."""

    def __init__(self, cfg: SLOConfig, metrics, default_max_chunks: int):
        if cfg.ttft_p99_s is None and cfg.tpot_p99_s is None:
            raise ValueError(
                "SLOConfig must set at least one of ttft_p99_s / "
                "tpot_p99_s — a controller with no target enforces "
                "nothing")
        if cfg.window_steps < 1:
            raise ValueError(f"window_steps {cfg.window_steps} < 1")
        if cfg.min_chunks_per_step < 1:
            raise ValueError(
                f"min_chunks_per_step {cfg.min_chunks_per_step} < 1 — "
                f"a zero floor would starve prefill forever")
        if cfg.max_chunks_per_step < 0:
            raise ValueError(
                f"max_chunks_per_step {cfg.max_chunks_per_step} < 0 — "
                f"a negative cap would silently admit no chunks at all "
                f"(0 means: default to the engine's max_batch)")
        if not 0.0 < cfg.step_budget_frac <= 1.0:
            raise ValueError(
                f"step_budget_frac {cfg.step_budget_frac} outside (0, 1]")
        self.cfg = cfg
        self._metrics = metrics
        self.max_chunks = cfg.max_chunks_per_step or default_max_chunks
        self.min_chunks = min(cfg.min_chunks_per_step, self.max_chunks)
        self.chunk_limit = self.max_chunks
        self.degraded = False
        self.throttles = 0     # windows that actually lowered the limit
        self.evaluations = 0   # windows evaluated
        self.last_breach: list[str] = []  # human-readable, newest window
        self._steps = 0
        self._mark()

    def _mark(self) -> None:
        """Snapshot the watched histograms' bucket counts — the window
        origin the next evaluation subtracts."""
        self._marks = {name: list(self._metrics.hists[name].counts)
                       for name in _WATCHED}

    def _window_p99(self, name: str) -> float | None:
        """p99 of the samples observed since the last mark, or None for
        an empty window (no evidence is not a breach)."""
        h = self._metrics.hists[name]
        delta = [c - p for c, p in zip(h.counts, self._marks[name])]
        n = sum(delta)
        if n == 0:
            return None
        return percentile_from_counts(h.edges, delta, 0.99, n)

    def breaches(self) -> list[str]:
        """The targets the CURRENT window violates (empty = healthy)."""
        out = []
        cfg = self.cfg
        if cfg.tpot_p99_s is not None:
            p = self._window_p99("tpot_s")
            if p is not None and p > cfg.tpot_p99_s:
                out.append(f"tpot_p99 {p:.4g}s > target {cfg.tpot_p99_s:.4g}s")
        if cfg.ttft_p99_s is not None:
            budget = cfg.ttft_p99_s * cfg.step_budget_frac
            p = self._window_p99("step_duration_s")
            if p is not None and p > budget:
                out.append(f"step_duration_p99 {p:.4g}s > ttft step budget "
                           f"{budget:.4g}s "
                           f"({cfg.ttft_p99_s:.4g}s * "
                           f"{cfg.step_budget_frac:g})")
        return out

    def on_step(self) -> tuple[int, int] | None:
        """One engine step elapsed. On a window boundary, evaluate and
        adapt; returns ``(old_limit, new_limit)`` when the limit changed
        (the engine mirrors it into the ``serving_chunk_limit`` gauge),
        else None. Never reads device state."""
        self._steps += 1
        if self._steps % self.cfg.window_steps:
            return None
        self.evaluations += 1
        breached = self.breaches()
        old = self.chunk_limit
        if breached:
            self.degraded = True
            self.last_breach = breached
            self.chunk_limit = max(self.min_chunks, self.chunk_limit // 2)
            if self.chunk_limit < old:
                self.throttles += 1
        else:
            self.chunk_limit = min(self.max_chunks, self.chunk_limit + 1)
            if self.chunk_limit == self.max_chunks:
                self.degraded = False
        self._mark()
        return (old, self.chunk_limit) if self.chunk_limit != old else None
