"""``paddle_tpu_torch.profiler`` against the JAX package's.

- The host tracer: the repository's ``csrc/host_tracer.cc`` built with
  ``g++`` and loaded (``native``), and the Python ring buffer beside it:
  the same events in, the same count, the ring's wrap at capacity, the
  same chrome-trace JSON out (names, timestamps in µs, durations, tids).
- ``make_scheduler``'s states over 20 steps equal the reference's for
  several settings; ``benchmark``'s ``ips`` is samples over seconds.
- ``ProfilerResult`` files round-trip in both directions between the
  packages (the reference's pickle, ``"version": 1``); ``summary``'s
  table equals the reference's for the same events.
- ``Profiler`` over the CPU: ``RecordEvent("step")`` spans land in the
  exported ``torch.profiler`` trace and in the host tracer; ``timer_only``
  keeps only step times; ``summary()`` is the reference's string.
"""
import json
import os

import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu_torch import _device
from paddle_tpu_torch import profiler as tprof
from paddle_tpu.profiler import statistic as jstat


@pytest.fixture(autouse=True)
def _cpu():
    prev = _device._CURRENT
    T.set_device("cpu")
    yield
    _device._CURRENT = prev


EVENTS = [("fwd", 1_000, 2_500, 7), ("bwd", 4_000, 3_000, 7),
          ('quote"d', 9_000, 1_000, 8), ("fwd", 12_000, 1_500, 7)]


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_host_tracer_ring_and_export(native, tmp_path):
    tr = tprof._HostTracer(capacity=3, native=native)
    assert tr.native is native, tr.error
    for e in EVENTS:
        tr.record(*e)
    assert tr.count() == 3  # the oldest dropped
    path = str(tmp_path / "host.json")
    assert tr.export_chrome_trace(path) == 3
    with open(path) as f:
        evs = [e for e in json.load(f)["traceEvents"] if e["ph"] == "X"]
    assert [(e["name"], e["ts"], e["dur"], e["tid"]) for e in evs] == [
        (n, s / 1000.0, d / 1000.0, t) for n, s, d, t in EVENTS[1:]]
    tr.clear()
    assert tr.count() == 0


def test_default_tracer_is_native_and_matches_the_reference(tmp_path):
    assert tprof.host_tracer().native, tprof.host_tracer().error
    trs = {"t": tprof._HostTracer(capacity=8),
           "j": J.profiler._HostTracer(capacity=8)}
    outs = {}
    for k, tr in trs.items():
        for e in EVENTS:
            tr.record(*e)
        path = str(tmp_path / f"{k}.json")
        tr.export_chrome_trace(path)
        with open(path) as f:
            outs[k] = [e for e in json.load(f)["traceEvents"]
                       if e["ph"] == "X"]
    assert outs["t"] == outs["j"]


@pytest.mark.parametrize("kw", [dict(), dict(closed=1, ready=1, record=2),
                                dict(closed=2, record=3, skip_first=3),
                                dict(ready=2, record=1, repeat=2)])
def test_make_scheduler_states(kw):
    t, j = T.profiler.make_scheduler(**kw), J.profiler.make_scheduler(**kw)
    assert [t(s) for s in range(20)] == [j(s) for s in range(20)]
    assert T.profiler.ProfilerState.RECORD_AND_RETURN == \
        J.profiler.ProfilerState.RECORD_AND_RETURN


def test_benchmark_ips(monkeypatch):
    clock = iter([10.0, 10.5, 11.5, 12.0])
    monkeypatch.setattr(tprof.time, "perf_counter", lambda: next(clock))
    b = T.profiler.benchmark()
    b.begin()
    for n in (32, 32, 16):
        b.step(n)
    assert b.report() == {"ips": 80 / 2.0, "steps": 3}
    assert T.profiler.benchmark().report() == {}


def test_profiler_result_round_trips(tmp_path):
    events = [(n, s, d, t) for n, s, d, t in EVENTS]
    a, b = str(tmp_path / "t.pb"), str(tmp_path / "j.pb")
    T.profiler.ProfilerResult(events).save(a)
    J.profiler.ProfilerResult(events).save(b)
    assert J.profiler.load_profiler_result(a).events == events
    assert T.profiler.load_profiler_result(b).events == events
    rt = T.profiler.load_profiler_result(b)
    rj = J.profiler.load_profiler_result(a)
    assert rt.per_name_stats() == rj.per_name_stats()
    assert rt.time_range_summary() == rj.time_range_summary()
    for key in ("CPUTotal", "CPUAvg", "GPUMax", "CPUMin"):
        assert T.profiler.summary(rt, getattr(T.profiler.SortedKeys, key),
                                  time_unit="us") == \
            jstat.summary(rj, getattr(J.profiler.SortedKeys, key),
                          time_unit="us")


def test_profiler_spans_and_export(tmp_path):
    tr = tprof.host_tracer()
    n0 = tr.count()
    x = T.to_tensor(np.random.RandomState(0).rand(64, 64).astype(np.float32))
    with T.profiler.Profiler(targets=[T.profiler.ProfilerTarget.CPU]) as prof:
        for _ in range(3):
            with T.profiler.RecordEvent("step"):
                (x @ x).sum()
            prof.step()
    assert tr.count() == n0 + 3
    path = prof.export(str(tmp_path))
    with open(path) as f:
        names = [e.get("name") for e in json.load(f)["traceEvents"]]
    assert names.count("step") == 3
    assert prof.summary().startswith("steps: 3  avg: ")
    handler = T.profiler.export_protobuf(str(tmp_path / "pb"),
                                         worker_name="w")
    out = handler(prof)
    assert os.path.basename(out) == "w.paddle_trace.pb"
    assert "step" in {e[0] for e in J.profiler.load_profiler_result(
        out).events}
    timer = T.profiler.Profiler(timer_only=True)
    timer.start()
    timer.step()
    timer.stop()
    assert timer.export() is None and timer.summary().startswith("steps: 1")
    assert T.profiler.Profiler(timer_only=True).summary() == \
        J.profiler.Profiler(timer_only=True).summary()
