"""Fixed-bucket streaming histograms for serving latency metrics — the
port of ``paddle_tpu/obs/histogram.py``.

Design constraints, in order:

- **Bounded memory.** A serving engine observes one latency sample per
  request (TTFT, TPOT, queue wait, e2e) and two per step (duration,
  occupancy) forever; storing raw samples grows without bound. A fixed
  bucket layout costs ``len(edges) + 1`` ints for the life of the process
  — the same shape Prometheus client histograms use, so the exporter in
  ``export.py`` renders the classic ``_bucket{le=...}`` series directly.
- **O(log buckets) observe.** ``observe`` is a bisect + two adds — cheap
  enough to sit on the engine's step boundary without showing up in the
  obs-on-vs-off bench delta.
- **Pre-seeded presence**: a histogram exists —
  and its percentile gauges read 0 — from construction, not from its first
  sample, so dashboards keyed on metric presence never miss the early
  window of an incident.

Percentiles are estimated by linear interpolation inside the bucket that
holds the requested rank (the standard Prometheus ``histogram_quantile``
estimator): exact at bucket edges, within one bucket width everywhere
else. The overflow bucket is reported as its lower edge — a deliberate
underestimate that keeps a single runaway sample from painting p99 as
infinity.
"""
from __future__ import annotations

from bisect import bisect_left

__all__ = ["Histogram", "HistogramFamily", "LATENCY_EDGES_S",
           "OCCUPANCY_EDGES", "QUANTILES", "percentile_from_counts",
           "split_labels"]

# Latency edges in seconds: ~Prometheus default widened to cover both a
# microbenchmark CPU step (sub-millisecond) and a multi-minute queue wait.
LATENCY_EDGES_S = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0,
)

# Batch-occupancy edges: small integers exact, powers of two beyond — a
# decode batch is a slot count, not a duration.
OCCUPANCY_EDGES = (0.0, 1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0, 16.0, 24.0,
                   32.0, 64.0, 128.0, 256.0)

# The quantiles every serving histogram publishes: (suffix, q).
QUANTILES = (("p50", 0.50), ("p90", 0.90), ("p99", 0.99))


def percentile_from_counts(edges, counts, q: float,
                           count: int | None = None) -> float:
    """The histogram_quantile estimator over a raw bucket-count vector
    (``len(edges) + 1`` entries, last = overflow). Shared by
    :meth:`Histogram.percentile` and callers holding count DELTAS — the
    SLO admission controller computes windowed p99s by subtracting two
    snapshots of a cumulative histogram's counts and estimating over the
    difference, without a second histogram on the hot path."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile {q} outside [0, 1]")
    count = sum(counts) if count is None else count
    if count == 0:
        return 0.0
    target = q * count
    cum = 0
    for i, c in enumerate(counts):
        if cum + c >= target:
            if i == len(edges):  # overflow: clamp, don't invent
                return edges[-1]
            lo = 0.0 if i == 0 else edges[i - 1]
            hi = edges[i]
            frac = (target - cum) / c if c else 0.0
            return lo + frac * (hi - lo)
        cum += c
    return edges[-1]


class Histogram:
    """Fixed-bucket histogram: bucket ``i`` counts samples in
    ``(edges[i-1], edges[i]]`` (bucket 0 is ``(-inf, edges[0]]``), plus one
    overflow bucket above ``edges[-1]``. Tracks ``count``/``sum`` so mean
    and Prometheus exposition come for free."""

    def __init__(self, name: str, edges=LATENCY_EDGES_S):
        edges = tuple(float(e) for e in edges)
        if len(edges) < 2 or any(a >= b for a, b in zip(edges, edges[1:])):
            raise ValueError(
                f"histogram {name!r}: edges must be >= 2 strictly "
                f"increasing values, got {edges}")
        self.name = name
        self.edges = edges
        self.counts = [0] * (len(edges) + 1)  # + overflow bucket
        self.count = 0
        self.sum = 0.0

    def observe(self, value: float) -> None:
        """O(log buckets): bisect to the owning bucket, bump two counters."""
        v = float(value)
        self.counts[bisect_left(self.edges, v)] += 1
        self.count += 1
        self.sum += v

    def reset(self) -> None:
        self.counts = [0] * (len(self.edges) + 1)
        self.count = 0
        self.sum = 0.0

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        """Linear interpolation inside the bucket holding rank ``q *
        count`` (the histogram_quantile estimator). 0.0 for an empty
        histogram; the first bucket interpolates from 0 (these are
        non-negative measurements); the overflow bucket clamps to the top
        edge rather than extrapolating to infinity."""
        return percentile_from_counts(self.edges, self.counts, q,
                                      self.count)

    def snapshot(self) -> dict:
        """Percentiles + count/sum/mean, always present (zeros when
        empty), keyed by the quantile suffixes the metrics registry
        publishes."""
        out = {suffix: self.percentile(q) for suffix, q in QUANTILES}
        out.update(count=self.count, sum=self.sum, mean=self.mean)
        return out

    def cumulative_buckets(self) -> list[tuple[float, int]]:
        """``(upper_edge, cumulative_count)`` pairs, Prometheus
        ``_bucket{le=...}`` shaped; the final pair is ``(inf, count)``."""
        out, cum = [], 0
        for edge, c in zip(self.edges, self.counts):
            cum += c
            out.append((edge, cum))
        out.append((float("inf"), self.count))
        return out

    def __repr__(self) -> str:
        return (f"Histogram({self.name!r}, count={self.count}, "
                f"p50={self.percentile(0.5):.4g}, "
                f"p99={self.percentile(0.99):.4g})")


def split_labels(name: str) -> tuple[str, dict]:
    """Parse a ``base{k=v,k2=v2}`` metric name into (base, labels) —
    the registry-key convention labeled families use. A plain name
    returns ``(name, {})``."""
    if "{" not in name or not name.endswith("}"):
        return name, {}
    base, _, body = name.partition("{")
    labels: dict[str, str] = {}
    for part in body[:-1].split(","):
        k, _, v = part.partition("=")
        labels[k] = v
    return base, labels


class HistogramFamily:
    """A label-keyed family of fixed-bucket histograms sharing one base
    name — the mechanism behind ``serving_step_phase_s{phase=}`` (and the
    per-tenant TTFT/TPOT classes the fleet router will reuse: the label
    key is arbitrary). Children are created on first observation; the
    declared ``values`` exist — and publish zeros — from construction,
    the same presence contract the scalar ``_SEEDED`` registry enforces.
    Each child is a plain :class:`Histogram` named
    ``base{label=value}``, so every exporter that understands labeled
    names renders it with no extra plumbing."""

    def __init__(self, name: str, label: str, edges=LATENCY_EDGES_S,
                 values=()):
        self.name = name
        self.label = label
        self.edges = tuple(edges)
        self._children: dict[str, Histogram] = {}
        for v in values:
            self.child(v)

    def child(self, value) -> Histogram:
        """The child histogram for one label value (created pre-seeded
        when absent)."""
        key = str(value)
        h = self._children.get(key)
        if h is None:
            h = Histogram(f"{self.name}{{{self.label}={key}}}", self.edges)
            self._children[key] = h
        return h

    def observe(self, value, sample: float) -> None:
        self.child(value).observe(sample)

    def children(self) -> dict[str, Histogram]:
        """{label value: child histogram}, insertion-ordered."""
        return dict(self._children)

    def reset(self) -> None:
        for h in self._children.values():
            h.reset()

    def __len__(self) -> int:
        return len(self._children)
