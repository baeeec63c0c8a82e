"""Engine-loop step timeline: a bounded ring of per-step records — the
port of ``paddle_tpu/obs/timeline.py``.

Per-request traces (``trace.py``) answer "where did THIS request spend its
time"; the step timeline answers the complementary operational question —
"what was the ENGINE doing when tail latency spiked": how big was the
batch, how much of the step was prefill vs decode, how full was the page
pool, did anything get preempted. A ``deque(maxlen=capacity)`` keeps memory
bounded no matter how long the engine serves; the newest ``capacity``
steps are always available for export into the Chrome-trace engine track.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

__all__ = ["StepRecord", "StepTimeline"]


@dataclass(frozen=True)
class StepRecord:
    """One continuous-batching iteration, as the engine saw it."""
    step: int            # engine step index
    t_start: float       # engine-clock seconds
    t_end: float
    admitted: int        # requests admitted this step (incl. swap resumes)
    prefills: int        # prefills COMPLETED this step (first token out)
    batch: int           # active decode slots this step
    finished: int        # requests that finished this step
    preemptions: int     # victims preempted this step
    queue_depth: int     # waiting requests after the step
    pages_in_use: int    # pool pages held after the step
    chunks: int = 0      # chunked-prefill chunks executed this step
    accepted: int = 0    # speculative candidates accepted this step
    # (ServingConfig(spec=); tokens emitted = batch + accepted per step)
    host_syncs: int | None = None  # the reference's debug-check sync
    # tally; None here (the debug checks are ROADMAP Queue 1 item 11)
    phase_s: dict = field(default_factory=dict)  # wall-time attribution:
    # {phase: seconds} over attribution.PHASES — sums to duration
    # exactly (the PhaseAccumulator mark contract); {} with tracing off
    # or on pre-attribution records
    extra: dict = field(default_factory=dict)  # exporter passthrough

    @property
    def duration(self) -> float:
        return self.t_end - self.t_start

    def phase_mix(self) -> str:
        """Coarse label of what the step did — the field Perfetto colors
        the engine track by. A step that only advanced chunks (no prefill
        completed, nothing decoding yet) still reads "prefill"."""
        parts = []
        if self.prefills or self.chunks:
            parts.append("prefill")
        if self.batch:
            parts.append("decode")
        return "+".join(parts) or "idle"


class StepTimeline:
    """Ring buffer of :class:`StepRecord`. Appends are O(1); the deque
    drops the oldest record once ``capacity`` is reached."""

    def __init__(self, capacity: int = 512):
        if capacity < 1:
            raise ValueError(f"capacity {capacity} < 1")
        self.capacity = capacity
        self._records: deque[StepRecord] = deque(maxlen=capacity)
        self.total_steps = 0  # appended ever, incl. records since dropped

    def append(self, record: StepRecord) -> None:
        self._records.append(record)
        self.total_steps += 1

    def records(self) -> list[StepRecord]:
        """Retained records, oldest first."""
        return list(self._records)

    @property
    def last(self) -> StepRecord | None:
        return self._records[-1] if self._records else None

    def __len__(self) -> int:
        return len(self._records)
