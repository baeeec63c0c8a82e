"""Goodput attribution: where an engine step's wall time goes — the port
of ``paddle_tpu/obs/attribution.py``. Two host-only instruments, clock
reads and host floats only:

- :class:`PhaseAccumulator` — splits one step's wall time across the
  phases the step actually ran (admit/restore, swap resume, prefill,
  chunked prefill, decode-or-verify, eviction/preemption, residual
  "other") by stamping a mark at each phase boundary. The interval since
  the previous mark is charged to the named phase, so the per-phase
  times SUM EXACTLY to the step's wall time by construction. The engine
  rolls the split into the ``serving_step_phase_s{phase=}`` histogram
  family and onto each :class:`~.timeline.StepRecord`.
- :class:`RooflineTracker` — accumulates measured per-program dispatch
  times against per-program (flops, bytes) predictions and publishes
  ``serving_mfu``, ``serving_hbm_bw_util``,
  ``serving_cost_model_drift{program=}`` and the
  ``serving_kernel_speedup_*{kernel=}`` A/B. The per-program
  predictions come from the debug checks' audits
  (``ServingConfig(debug_checks=True)``, ``analysis.hlocheck``); the
  kernel predictions from the port's own kernelcheck bank
  (:func:`load_banked_kernel_speedups`), seeded at engine construction;
  the engine feeds the A/B's measurements at its decode and verify
  dispatches, on the kernel's leg (the card) or the plain version's (the
  CPU).

Peaks default to one NVIDIA H100 SXM's published dense rates; override
per deployment via ``ServingConfig(peak_flops_per_s=,
peak_hbm_bytes_per_s=)``.

Imports nothing from ``paddle_tpu_torch.serving`` (serving imports us).
"""
from __future__ import annotations

__all__ = ["PHASES", "PhaseAccumulator", "RooflineTracker",
           "DEFAULT_PEAK_FLOPS_PER_S", "DEFAULT_PEAK_HBM_BYTES_PER_S",
           "load_banked_kernel_speedups"]

#: the phase vocabulary — the pre-seeded label set of the
#: ``serving_step_phase_s{phase=}`` histogram family. "admit" covers the
#: deadline sweep + scheduler admission (including host-tier restores),
#: "swap" the swap-resume re-entry, "evict" injected/real preemption and
#: decode-page eviction pressure, "other" the residual step bookkeeping.
PHASES = ("admit", "swap", "prefill", "chunk_prefill", "decode", "verify",
          "evict", "other")

# NVIDIA H100 SXM data sheet, dense: 989 TFLOP/s bf16, 3.35 TB/s HBM3
DEFAULT_PEAK_FLOPS_PER_S = 989e12
DEFAULT_PEAK_HBM_BYTES_PER_S = 3.35e12


class PhaseAccumulator:
    """Mark-based wall-time splitter for one engine step at a time.

    ``begin(t)`` opens a step; each ``mark(phase)`` charges the interval
    since the previous mark (or begin) to ``phase`` and returns it;
    ``finish()`` charges the remainder to ``"other"`` and returns
    ``(t_end, {phase: seconds})``. Exactness contract: the returned
    phase dict's values are precisely the consecutive clock deltas, so
    on any clock they sum to ``t_end - t_begin`` up to float addition —
    and EXACTLY on the integer-valued virtual clocks the tests use.
    """

    __slots__ = ("_clock", "open", "t0", "_last", "_acc")

    def __init__(self, clock):
        self._clock = clock
        self.open = False
        self.t0 = 0.0
        self._last = 0.0
        self._acc: dict[str, float] = {}

    def begin(self, t: float | None = None) -> float:
        t = self._clock() if t is None else t
        self.open = True
        self.t0 = self._last = t
        self._acc = {}
        return t

    def mark(self, phase: str, t: float | None = None) -> float:
        """Charge now - last_mark to ``phase``; returns the interval."""
        t = self._clock() if t is None else t
        dt = t - self._last
        if dt:
            self._acc[phase] = self._acc.get(phase, 0.0) + dt
        self._last = t
        return dt

    def finish(self, t: float | None = None) -> tuple[float, dict]:
        """Close the step: residual time goes to ``"other"``; returns
        ``(t_end, phases)``."""
        t = self._clock() if t is None else t
        self.mark("other", t)
        self.open = False
        return t, self._acc


def load_banked_kernel_speedups() -> dict[str, float]:
    """The banked ``predicted_speedup`` of each kernel A/B label, from the
    port's kernelcheck bank (``analysis/kernelcheck_bank.json``: each
    entry maps the reference's labels it serves to the bytes its plain
    version materializes over the bytes the kernel moves) — {} when the
    bank is unavailable, so obs never hard-depends on it. The TPU bank
    (``profiles/kernelcheck.json``) is the reference's and is not read."""
    try:
        import json

        from ..analysis.kernelcheck import bank_path

        with open(bank_path()) as fh:
            banked = json.load(fh)
    except Exception:  # noqa: BLE001 — optional input, absence is normal
        return {}
    out = {}
    for rec in banked.values():
        predicted = rec.get("predicted_speedup") if isinstance(rec, dict) \
            else None
        if isinstance(predicted, dict):
            out.update({label: float(v) for label, v in predicted.items()
                        if isinstance(v, (int, float))})
    return dict(sorted(out.items()))


class RooflineTracker:
    """Measured-vs-predicted accounting per compiled program.

    Predictions arrive once per program (``on_program``, from the debug
    checks' audits); measurements accrue per
    dispatch (``on_call`` — dispatch-to-fetch wall seconds). ``publish``
    pushes the derived gauges through a ``ServingMetrics`` and is a no-op
    until both sides of at least one program exist, so an engine without
    predictions pays one boolean check per step.
    """

    def __init__(self, peak_flops_per_s: float = 0.0,
                 peak_hbm_bytes_per_s: float = 0.0,
                 banked_kernels: dict[str, float] | None = None):
        self.peak_flops = float(peak_flops_per_s) or DEFAULT_PEAK_FLOPS_PER_S
        self.peak_bw = (float(peak_hbm_bytes_per_s)
                        or DEFAULT_PEAK_HBM_BYTES_PER_S)
        if self.peak_flops <= 0 or self.peak_bw <= 0:
            raise ValueError(
                f"device peaks must be positive, got flops/s "
                f"{self.peak_flops}, bytes/s {self.peak_bw}")
        # label -> (flops, hbm_bytes) predicted per step of this program
        self._predicted: dict[str, tuple[float, float]] = {}
        # label -> [seconds, calls] measured
        self._measured: dict[str, list[float]] = {}
        # kernel A/B: name -> predicted speedup; measured split by
        # which path served the dispatch
        self._kernel_predicted = dict(banked_kernels or {})
        self._kernel_s: dict[str, list[float]] = {}  # [k_s, k_n, c_s, c_n]
        self._dirty = False

    # ------------------------------------------------------------- feeding
    def on_program(self, label: str, flops: float, hbm_bytes: float) -> None:
        """One program's predicted (flops, bytes) per step."""
        self._predicted[label] = (float(flops), float(hbm_bytes))

    def on_call(self, label: str, seconds: float) -> None:
        """One measured dispatch of ``label`` (dispatch -> fetch wall)."""
        acc = self._measured.get(label)
        if acc is None:
            acc = self._measured[label] = [0.0, 0]
        acc[0] += seconds
        acc[1] += 1
        if label in self._predicted:
            self._dirty = True

    def on_kernel_call(self, name: str, seconds: float,
                       kernel: bool) -> None:
        """One measured dispatch of a kernel-eligible step: ``kernel``
        says whether the hand-written kernel (True) or the plain version
        (False) served it."""
        acc = self._kernel_s.get(name)
        if acc is None:
            acc = self._kernel_s[name] = [0.0, 0, 0.0, 0]
        i = 0 if kernel else 2
        acc[i] += seconds
        acc[i + 1] += 1
        # a sample only moves a published gauge once BOTH legs have been
        # measured (the A/B ratio), so a one-legged steady state
        # (every dispatch on the same path) keeps publish() a no-op
        if acc[1] and acc[3]:
            self._dirty = True

    # ------------------------------------------------------------ deriving
    def predicted_step_s(self, label: str) -> float | None:
        """The roofline time for one step of ``label``: whichever of
        compute and memory traffic binds at the configured peaks."""
        pred = self._predicted.get(label)
        if pred is None:
            return None
        flops, nbytes = pred
        return max(flops / self.peak_flops, nbytes / self.peak_bw)

    def gauges(self) -> dict:
        """The derived gauge values:

        - ``mfu`` / ``hbm_bw_util``: achieved/(peak) over every program
          with both a prediction and measured time,
        - ``drift``: {label: measured mean / predicted} per such program,
        - ``kernels``: {name: {predicted, measured, drift}} — measured
          present only once BOTH dispatch paths have samples.
        """
        flops = nbytes = seconds = 0.0
        drift: dict[str, float] = {}
        for label, (s, n) in self._measured.items():
            pred_s = self.predicted_step_s(label)
            if pred_s is None or not n or s <= 0:
                continue
            f, b = self._predicted[label]
            flops += f * n
            nbytes += b * n
            seconds += s
            if pred_s > 0:
                drift[label] = (s / n) / pred_s
        out = {
            "mfu": flops / seconds / self.peak_flops if seconds else 0.0,
            "hbm_bw_util": (nbytes / seconds / self.peak_bw
                            if seconds else 0.0),
            "drift": drift,
            "kernels": {},
        }
        for name in {*self._kernel_predicted, *self._kernel_s}:
            predicted = self._kernel_predicted.get(name)
            entry: dict = {}
            if predicted is not None:
                entry["predicted"] = predicted
            acc = self._kernel_s.get(name)
            if acc and acc[1] and acc[3] and acc[0] > 0:
                measured = (acc[2] / acc[3]) / (acc[0] / acc[1])
                entry["measured"] = measured
                if predicted:
                    entry["drift"] = measured / predicted
            out["kernels"][name] = entry
        return out

    def publish(self, metrics) -> None:
        """Push the gauges through a ``ServingMetrics``. No-op (one
        boolean check) unless new measurements landed since the last
        publish."""
        if not self._dirty:
            return
        self._dirty = False
        g = self.gauges()
        metrics.on_roofline(g["mfu"], g["hbm_bw_util"])
        for label, ratio in g["drift"].items():
            metrics.on_drift(label, ratio)
        for name, entry in g["kernels"].items():
            metrics.on_kernel_ab(name, predicted=entry.get("predicted"),
                                 measured=entry.get("measured"),
                                 drift=entry.get("drift"))
