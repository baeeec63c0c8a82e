"""``paddle.profiler`` — the port of ``paddle_tpu/profiler/__init__.py``
(``Profiler``, ``RecordEvent``, ``ProfilerTarget``, ``ProfilerState``,
``make_scheduler``, ``export_chrome_tracing``, ``benchmark``,
``host_tracer``) over ``torch.profiler``.

- ``Profiler`` runs ``torch.profiler.profile`` with the CPU and, for the
  ``GPU`` target, the CUDA activities (the reference's
  ``jax.profiler.start_trace``); ``export`` writes its chrome trace.
  ``timer_only`` keeps only the step times, and ``summary()`` returns the
  reference's string of them.
- ``RecordEvent(name)`` records into the host tracer and opens a
  ``torch.profiler.record_function(name)``, so the span shows in the
  device trace as the reference's ``TraceAnnotation`` shows in its.
- The host tracer is the repository's ``csrc/host_tracer.cc`` (plain C++,
  a mutex-guarded ring buffer with a chrome-trace exporter), built alone
  with ``g++`` into ``build/paddle_tpu_torch/`` at first use (named by a
  hash of the source) and loaded with ``ctypes``. Where it cannot be
  built or loaded the reference's Python ring buffer takes its place;
  ``host_tracer().native`` says which, ``.error`` why.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

import numpy as np
import torch

from .statistic import (ProfilerResult, SortedKeys,  # noqa: F401
                        export_protobuf, load_profiler_result, summary)

__all__ = ["Profiler", "RecordEvent", "ProfilerTarget", "ProfilerState",
           "make_scheduler", "export_protobuf", "load_profiler_result",
           "SortedKeys", "ProfilerResult", "summary",
           "export_chrome_tracing", "benchmark", "host_tracer"]

_SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "host_tracer.cc"
_GXX_FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17", "-pthread")


class ProfilerTarget:
    CPU = "cpu"
    GPU = "gpu"
    TPU = "tpu"


class ProfilerState:
    CLOSED = 0
    READY = 1
    RECORD = 2
    RECORD_AND_RETURN = 3


def make_scheduler(closed=0, ready=0, record=1, repeat=0, skip_first=0):
    """``scheduler(step) -> ProfilerState``: ``skip_first`` steps closed,
    then cycles of ``closed``, ``ready`` and ``record`` steps, the last
    step of a cycle ``RECORD_AND_RETURN``."""
    def scheduler(step):
        s = step - skip_first
        if s < 0:
            return ProfilerState.CLOSED
        cycle = closed + ready + record
        pos = s % cycle if cycle else 0
        if pos < closed:
            return ProfilerState.CLOSED
        if pos < closed + ready:
            return ProfilerState.READY
        if pos == cycle - 1:
            return ProfilerState.RECORD_AND_RETURN
        return ProfilerState.RECORD

    return scheduler


def export_chrome_tracing(dir_name, worker_name=None):
    """An ``on_trace_ready`` handler that writes the chrome trace under
    ``dir_name``."""
    def handler(prof):
        name = worker_name or f"worker_{os.getpid()}"
        prof.export(os.path.join(dir_name, f"{name}.pt.trace.json"))

    return handler


class Profiler:
    def __init__(self, targets=None, scheduler=None, on_trace_ready=None,
                 timer_only=False, record_shapes=False, profile_memory=False):
        self._targets = list(targets) if targets is not None else [
            ProfilerTarget.CPU, ProfilerTarget.GPU]
        self._timer_only = timer_only
        self._on_trace_ready = on_trace_ready
        self._record_shapes = record_shapes
        self._profile_memory = profile_memory
        self._prof = None
        self._running = False
        self._step = 0
        self._step_times = []
        self._last = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *a):
        self.stop()

    def start(self):
        host_tracer()  # eager: keep the one-time native build out of traces
        self._last = time.perf_counter()
        if not self._timer_only:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if ProfilerTarget.GPU in self._targets:
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(
                activities=activities, record_shapes=self._record_shapes,
                profile_memory=self._profile_memory)
            self._prof.__enter__()
            self._running = True

    def stop(self):
        if self._running:
            self._prof.__exit__(None, None, None)
            self._running = False
        if self._on_trace_ready:
            self._on_trace_ready(self)

    def step(self, num_samples=None):
        now = time.perf_counter()
        if self._last is not None:
            self._step_times.append(now - self._last)
        self._last = now
        self._step += 1
        if self._prof is not None and self._running:
            self._prof.step()

    def export(self, path=None, format=None):
        """Write the chrome trace of the recorded window to ``path`` (a
        file; a directory gets ``trace.pt.trace.json``) and return the
        file's path; None with ``timer_only``."""
        if self._prof is None:
            return None
        if path is None or os.path.isdir(path):
            path = os.path.join(path or ".", "trace.pt.trace.json")
        self._prof.export_chrome_trace(path)
        return path

    def summary(self, sorted_by=None, op_detail=True, thread_sep=False,
                time_unit="ms"):
        if not self._step_times:
            return "no steps recorded"
        ts = np.asarray(self._step_times) * 1000
        return (f"steps: {len(ts)}  avg: {ts.mean():.3f}ms  p50: "
                f"{np.percentile(ts, 50):.3f}ms  max: {ts.max():.3f}ms")


def _native_library():
    """``(library, error)``: ``csrc/host_tracer.cc`` built with ``g++``
    (once; reused while the source is unchanged) and loaded, or None and
    the reason."""
    from ..kernels._build import BUILD_DIR

    try:
        src = _SOURCE.read_bytes()
        digest = hashlib.sha256(src + " ".join(_GXX_FLAGS).encode()) \
            .hexdigest()[:16]
        out = BUILD_DIR / f"host_tracer-{digest}.so"
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            proc = subprocess.run(["g++", *_GXX_FLAGS, "-o", str(tmp),
                                   str(_SOURCE)], capture_output=True,
                                  text=True, timeout=120)
            if proc.returncode:
                return None, f"g++ failed: {proc.stderr.strip()[-500:]}"
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
    except (OSError, subprocess.SubprocessError) as e:
        return None, f"{type(e).__name__}: {e}"
    vp, u64, i64 = ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int64
    lib.host_tracer_new.restype = vp
    lib.host_tracer_new.argtypes = [i64]
    lib.host_tracer_free.argtypes = [vp]
    lib.host_tracer_record.argtypes = [vp, ctypes.c_char_p, u64, u64, u64]
    lib.host_tracer_count.restype = i64
    lib.host_tracer_count.argtypes = [vp]
    lib.host_tracer_dropped.restype = i64
    lib.host_tracer_dropped.argtypes = [vp]
    lib.host_tracer_clear.argtypes = [vp]
    lib.host_tracer_export.restype = i64
    lib.host_tracer_export.argtypes = [vp, ctypes.c_char_p, ctypes.c_char_p]
    return lib, None


class _HostTracer:
    """The ring-buffer host-event recorder: the native library when it
    loads, else the reference's Python list of the same capacity."""

    def __init__(self, capacity=1 << 16, native=True):
        self._capacity = capacity
        self._lib, self.error = _native_library() if native \
            else (None, "native tracer not asked for")
        self._h = self._lib.host_tracer_new(capacity) if self._lib else None
        self._events = []  # the Python ring buffer

    @property
    def native(self) -> bool:
        return self._h is not None

    def record(self, name, start_ns, dur_ns, tid):
        if self._h:
            self._lib.host_tracer_record(self._h, name.encode(), start_ns,
                                         dur_ns, tid)
        else:
            self._events.append((name, start_ns, dur_ns, tid))
            if len(self._events) > self._capacity:
                self._events.pop(0)

    def count(self):
        if self._h:
            return int(self._lib.host_tracer_count(self._h))
        return len(self._events)

    def clear(self):
        if self._h:
            self._lib.host_tracer_clear(self._h)
        else:
            self._events.clear()

    def export_chrome_trace(self, path, process_name="paddle_tpu host"):
        """Write chrome://tracing JSON; returns the number of events."""
        if self._h:
            n = int(self._lib.host_tracer_export(self._h, path.encode(),
                                                 process_name.encode()))
            if n < 0:
                raise OSError(f"cannot write trace to {path}")
            return n
        import json as _json

        evs = [{"name": nm, "ph": "X", "pid": 1, "tid": t,
                "ts": s / 1000.0, "dur": d / 1000.0}
               for nm, s, d, t in self._events]
        with open(path, "w") as f:
            _json.dump({"traceEvents": evs}, f)
        return len(evs)


_host_tracer = None


def host_tracer() -> _HostTracer:
    global _host_tracer
    if _host_tracer is None:
        _host_tracer = _HostTracer()
    return _host_tracer


@contextlib.contextmanager
def RecordEvent(name, event_type=None):
    """A host span: recorded in the host tracer (chrome-trace exportable)
    and opened as ``torch.profiler.record_function(name)``, so it also
    shows in the device trace."""
    tr = host_tracer()  # before t0: the first call may build the library
    t0 = time.perf_counter_ns()
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        tr.record(name, t0, time.perf_counter_ns() - t0,
                  threading.get_ident() % (1 << 31))


class benchmark:
    """A throughput timer (the reference's ``profiler/timer.py``)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._times = []
        self._last = None

    def begin(self):
        self._last = time.perf_counter()

    def step(self, num_samples=None):
        now = time.perf_counter()
        if self._last is not None:
            self._times.append((now - self._last, num_samples or 1))
        self._last = now

    def end(self):
        pass

    def report(self):
        if not self._times:
            return {}
        total_t = sum(t for t, _ in self._times)
        total_n = sum(n for _, n in self._times)
        return {"ips": total_n / total_t, "steps": len(self._times)}
