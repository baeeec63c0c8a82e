"""Runtime stats monitor — the port of ``paddle_tpu/utils/monitor.py``.

A process-wide, thread-safe registry of named int counters and float
gauges (Paddle's ``platform/monitor.h`` STAT_ADD/STAT_RESET), plus timing
helpers. Process-global as in the reference: every ``ServingMetrics`` in
the process writes the same ``serving_*`` names, and building one resets
them. The reference's registry is a separate module with its own dict.
"""
from __future__ import annotations

import threading
import time

__all__ = ["stat_add", "stat_set", "stat_max", "stat_get", "stat_reset",
           "all_stats", "stats_with_prefix", "StatTimer"]

_lock = threading.Lock()
_stats: dict[str, float] = {}


def stat_add(name: str, value=1):
    with _lock:
        _stats[name] = _stats.get(name, 0) + value
        return _stats[name]


def stat_set(name: str, value):
    with _lock:
        _stats[name] = value


def stat_max(name: str, value):
    """High-watermark gauge: keeps the largest value ever set (e.g. peak
    queue depth / page pressure — the spike a sampled gauge misses)."""
    with _lock:
        cur = _stats.get(name)
        if cur is None or value > cur:
            _stats[name] = value
        return _stats[name]


def stat_get(name: str, default=0):
    with _lock:
        return _stats.get(name, default)


def stat_reset(name: str | None = None):
    with _lock:
        if name is None:
            _stats.clear()
        else:
            _stats.pop(name, None)


def all_stats() -> dict:
    with _lock:
        return dict(_stats)


def stats_with_prefix(prefix: str) -> dict:
    """Namespaced view of the registry (e.g. the serving_* stats exported by
    paddle_tpu_torch.serving.metrics)."""
    with _lock:
        return {k: v for k, v in _stats.items() if k.startswith(prefix)}


class StatTimer:
    """Context manager accumulating elapsed seconds into `<name>` and hit
    count into `<name>_count`."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        stat_add(self.name, time.perf_counter() - self._t0)
        stat_add(self.name + "_count", 1)
        return False
