"""Profiler statistics and result files — the port of
``paddle_tpu/profiler/statistic.py`` (``SortedKeys``, ``ProfilerResult``,
``export_protobuf``, ``load_profiler_result``, ``summary``).

The host tracer's ring buffer (``csrc/host_tracer.cc``) is the event
source of the per-name table, as in the reference; device time lives in
the ``torch.profiler`` trace that ``Profiler.export`` writes. A result file
is the reference's pickle (``{"version": 1, "events": [(name, start_ns,
dur_ns, tid), ...]}``), so a file either package writes loads in the
other.
"""
from __future__ import annotations

import json
import os
import pickle
import socket
import tempfile
from enum import Enum

__all__ = ["SortedKeys", "ProfilerResult", "export_protobuf",
           "load_profiler_result", "summary"]


class SortedKeys(Enum):
    """reference: profiler_statistic.py:35 — summary-table sort orders."""

    CPUTotal = 0
    CPUAvg = 1
    CPUMax = 2
    CPUMin = 3
    GPUTotal = 4
    GPUAvg = 5
    GPUMax = 6
    GPUMin = 7


class ProfilerResult:
    """In-memory profiling data: a list of (name, start_ns, dur_ns, tid)
    host events (reference ProfilerResult wraps the C++ node trees)."""

    def __init__(self, events):
        self.events = list(events)

    def time_range_summary(self):
        lo = min((e[1] for e in self.events), default=0)
        hi = max((e[1] + e[2] for e in self.events), default=0)
        return lo, hi

    def per_name_stats(self):
        stats = {}
        for name, _start, dur, _tid in self.events:
            s = stats.setdefault(name, {"calls": 0, "total_ns": 0,
                                        "max_ns": 0, "min_ns": None})
            s["calls"] += 1
            s["total_ns"] += dur
            s["max_ns"] = max(s["max_ns"], dur)
            s["min_ns"] = dur if s["min_ns"] is None else min(s["min_ns"], dur)
        for s in stats.values():
            s["avg_ns"] = s["total_ns"] / s["calls"]
        return stats

    def save(self, path):
        with open(path, "wb") as f:
            pickle.dump({"version": 1, "events": self.events}, f, protocol=4)


def _collect_current_events():
    """Drain the host tracer's buffer through its chrome export (works for
    both the native ring buffer and the python fallback)."""
    from . import host_tracer

    tr = host_tracer()
    with tempfile.NamedTemporaryFile("r", suffix=".json", delete=False) as f:
        tmp = f.name
    try:
        tr.export_chrome_trace(tmp)
        with open(tmp) as f:
            data = json.load(f)
    finally:
        os.unlink(tmp)
    return [(e["name"], int(e["ts"] * 1000), int(e["dur"] * 1000),
             int(e.get("tid", 0)))
            for e in data.get("traceEvents", [])
            if e.get("ph") == "X"]  # skip metadata (ph "M") rows


def export_protobuf(dir_name, worker_name=None):
    """reference: profiler.py:209 — returns a callable for
    Profiler(on_trace_ready=...) that dumps the result under dir_name."""
    os.makedirs(dir_name, exist_ok=True)

    def handler(prof=None):
        name = worker_name or f"{socket.gethostname()}_{os.getpid()}"
        path = os.path.join(dir_name, name + ".paddle_trace.pb")
        ProfilerResult(_collect_current_events()).save(path)
        return path

    return handler


def load_profiler_result(filename):
    """reference: utils.py:128 — load a dumped result back to memory."""
    with open(filename, "rb") as f:
        blob = pickle.load(f)
    return ProfilerResult(blob["events"])


def summary(result=None, sorted_by=SortedKeys.CPUTotal, op_detail=True,
            thread_sep=False, time_unit="ms"):
    """Formatted per-name table (reference Profiler.summary →
    profiler_statistic._build_table). Returns the string and prints it."""
    if result is None:
        result = ProfilerResult(_collect_current_events())
    stats = result.per_name_stats()
    keymap = {
        SortedKeys.CPUTotal: lambda s: -s["total_ns"],
        SortedKeys.CPUAvg: lambda s: -s["avg_ns"],
        SortedKeys.CPUMax: lambda s: -s["max_ns"],
        SortedKeys.CPUMin: lambda s: -(s["min_ns"] or 0),
        SortedKeys.GPUTotal: lambda s: -s["total_ns"],
        SortedKeys.GPUAvg: lambda s: -s["avg_ns"],
        SortedKeys.GPUMax: lambda s: -s["max_ns"],
        SortedKeys.GPUMin: lambda s: -(s["min_ns"] or 0),
    }
    div = {"s": 1e9, "ms": 1e6, "us": 1e3, "ns": 1.0}[time_unit]
    rows = sorted(stats.items(), key=lambda kv: keymap[sorted_by](kv[1]))
    lines = [f"{'Name':40s} {'Calls':>7s} {'Total(' + time_unit + ')':>12s} "
             f"{'Avg':>10s} {'Max':>10s} {'Min':>10s}"]
    for name, s in rows:
        lines.append(
            f"{name[:40]:40s} {s['calls']:>7d} {s['total_ns'] / div:>12.3f} "
            f"{s['avg_ns'] / div:>10.3f} {s['max_ns'] / div:>10.3f} "
            f"{(s['min_ns'] or 0) / div:>10.3f}")
    table = "\n".join(lines)
    print(table)
    return table
