"""Exporters: Chrome ``trace_event`` JSON (Perfetto) and Prometheus text
— the port of ``paddle_tpu/obs/export.py``, layout and text unchanged.

Chrome trace: the classic ``{"traceEvents": [...]}`` JSON that
chrome://tracing and https://ui.perfetto.dev load directly. Layout is one
process (pid 1, "paddle_tpu.serving") holding one track per request (tid =
rid + 1, named "request <rid>") plus the engine loop on tid 0: request
tracks carry complete ("X") spans for the queued / prefill / decode phases
rebuilt from the raw lifecycle events, with instants ("i") for
preemptions, swaps, decode marks, and retirement; the engine track carries
one span per step, labeled by its phase mix and carrying the step's batch
size / page pressure / preemption count / phase attribution in ``args``,
with a global instant per watchdog alert. Counter tracks (``ph: "C"`` —
Perfetto renders them as stacked area charts above the spans) plot
``pages_in_use`` / ``batch`` / ``queue_depth`` per step from the timeline
ring, so resource pressure is visible alongside the request spans it
explains, and each tenant with retired journeys gets its own track of
retirement instants. Timestamps are engine-clock seconds rebased to the
earliest event and scaled to the microseconds the format requires — a
virtual test clock exports exactly like a wall clock.

Prometheus: standard text exposition (``# TYPE`` + samples) over the
monitor registry's ``serving_*`` scalars and the obs histograms rendered
as cumulative ``_bucket{le="..."}`` series with ``_sum``/``_count`` — the
format every Prometheus scraper and promtool understands. Labeled
family members — registry keys shaped ``base{label=value}`` (one or
more labels), e.g. ``serving_alerts_total{rule=queue_stall}``, the
``serving_step_phase_s{phase=}`` / ``serving_ttft_s{tenant=}``
histogram children, and the multi-label
``serving_tenant_retired_total{tenant=,class=}`` counters — render as
one metric family per base through the one label-set renderer
(:func:`_label_str`: sorted ``k="v"`` pairs, escaped values), so a
family bucket like ``serving_ttft_s_bucket{le="0.5",tenant="batch"}``
is identical text on the live-registry and flight-record-dump paths.
"""
from __future__ import annotations

import json

from .histogram import split_labels
from .timeline import StepTimeline
from .trace import RequestTrace

__all__ = ["chrome_trace", "write_chrome_trace", "prometheus_text",
           "latency_table"]

_ENGINE_TID = 0
_PID = 1

# lifecycle events that ALSO render as instants on the request's track
_INSTANTS = ("pallas_fallback",
             "preempted", "swap_out", "swap_in", "decode_mark",
             "prefill_chunk", "retired", "spill", "restore",
             "spec_verify",
             "wire_retry", "refetch_fallback", "breaker_open")


def _request_events(trace: RequestTrace) -> list[dict]:
    """Rebuild one request's phase spans + instants from its raw events.
    A span left open at the end of the trace (a still-live request) is
    closed at the last event's timestamp so exports of a running engine
    stay loadable."""
    tid = trace.rid + 1
    out: list[dict] = []
    open_name: str | None = None
    open_t = 0.0

    def close(t: float) -> None:
        nonlocal open_name
        if open_name is not None:
            out.append({"name": open_name, "ph": "X", "ts": open_t,
                        "dur": max(t - open_t, 0.0), "pid": _PID,
                        "tid": tid, "cat": "request"})
            open_name = None

    for ev in trace.events:
        if ev.name == "enqueued":
            open_name, open_t = "queued", ev.t
        elif ev.name == "admitted":
            close(ev.t)
        elif ev.name == "prefill_start":
            close(ev.t)
            open_name, open_t = "prefill", ev.t
        elif ev.name == "prefill_chunk":
            # chunked prefill: each chunk gets its own span on the track
            # (the first closes the opening "prefill" sliver, later ones
            # close their predecessor) — chunk boundaries stay visible
            close(ev.t)
            open_name, open_t = "prefill_chunk", ev.t
        elif ev.name == "prefill_end":
            close(ev.t)
        elif ev.name in ("first_token", "resumed"):
            close(ev.t)
            open_name, open_t = "decode", ev.t
        elif ev.name == "preempted":
            close(ev.t)
            open_name, open_t = "queued", ev.t
        elif ev.name == "retired":
            close(ev.t)
        if ev.name in _INSTANTS:
            name = ev.name
            if ev.name == "retired":
                name = f"retired: {ev.arg('state', '?')}"
            out.append({"name": name, "ph": "i", "ts": ev.t, "pid": _PID,
                        "tid": tid, "s": "t", "cat": "request",
                        "args": dict(ev.args or {})})
    if trace.events:
        close(trace.events[-1].t)
    return out


# the per-step counter tracks: (track name, StepRecord attribute) —
# Perfetto plots each as an area chart above the spans, so page pressure
# and queue depth are visible against the request activity they explain
_COUNTER_TRACKS = (("pages_in_use", "pages_in_use"), ("batch", "batch"),
                   ("queue_depth", "queue_depth"))


#: tenant tracks sit far above any plausible request tid (tid = rid + 1)
_TENANT_TID_BASE = 1_000_000


def chrome_trace(traces=(), timeline: StepTimeline | None = None,
                 alerts=(), journeys=()) -> dict:
    """Build the ``trace_event`` JSON dict from request traces, the
    engine step timeline, the watchdog alert history, and/or the
    journey book — each tenant with retired journeys gets its own track
    of retirement instants (state + token count + latency summary), so
    per-tenant traffic reads alongside the per-request spans. Accepts
    :class:`~.journey.Journey` objects or their wire
    dicts. Pure function of its inputs — safe to call on a live engine
    between steps."""
    raw: list[dict] = []
    names: dict[int, str] = {_ENGINE_TID: "engine loop"}
    for trace in traces:
        names[trace.rid + 1] = f"request {trace.rid}"
        raw.extend(_request_events(trace))
    tenant_tids: dict[str, int] = {}
    for j in journeys:
        w = j if isinstance(j, dict) else j.to_wire()
        if w.get("state") is None or w.get("e2e_s") is None:
            continue  # still in flight: its request track tells the story
        tid = tenant_tids.get(w["tenant"])
        if tid is None:
            tid = _TENANT_TID_BASE + len(tenant_tids)
            tenant_tids[w["tenant"]] = tid
            names[tid] = f"tenant {w['tenant']}"
        retire_t = next((h["t"] for h in reversed(w["hops"])
                         if h["kind"] == "retire"), None)
        if retire_t is None:
            continue
        raw.append({"name": f"retire:{w['state']}", "ph": "i",
                    "ts": retire_t, "pid": _PID, "tid": tid, "s": "t",
                    "cat": "tenant",
                    "args": {"rid": w["rid"], "tokens": w["tokens"],
                             "ttft_s": w["ttft_s"], "tpot_s": w["tpot_s"],
                             "e2e_s": w["e2e_s"]}})
    if timeline is not None:
        for rec in timeline.records():
            args = {"step": rec.step, "batch": rec.batch,
                    "prefills": rec.prefills, "chunks": rec.chunks,
                    "admitted": rec.admitted,
                    "finished": rec.finished,
                    "preemptions": rec.preemptions,
                    "queue_depth": rec.queue_depth,
                    "pages_in_use": rec.pages_in_use}
            if rec.accepted:
                # speculative decoding: candidates the verify accepted
                # (tokens this step = batch + accepted)
                args["accepted"] = rec.accepted
            if rec.host_syncs is not None:
                args["host_syncs"] = rec.host_syncs
            if rec.phase_s:
                args["phases"] = dict(rec.phase_s)
            args.update(rec.extra)
            raw.append({"name": rec.phase_mix(), "ph": "X",
                        "ts": rec.t_start, "dur": rec.duration,
                        "pid": _PID, "tid": _ENGINE_TID, "cat": "engine",
                        "args": args})
            for track, attr in _COUNTER_TRACKS:
                raw.append({"name": track, "ph": "C", "ts": rec.t_end,
                            "pid": _PID, "tid": _ENGINE_TID,
                            "cat": "engine",
                            "args": {track: getattr(rec, attr)}})
    for alert in alerts:
        a = alert if isinstance(alert, dict) else alert.asdict()
        raw.append({"name": f"alert:{a['rule']}", "ph": "i", "ts": a["t"],
                    "pid": _PID, "tid": _ENGINE_TID, "s": "g",
                    "cat": "alert",
                    "args": {"step": a["step"], "message": a["message"],
                             **(a.get("data") or {})}})
    # rebase to the earliest timestamp and scale seconds -> microseconds
    origin = min((e["ts"] for e in raw), default=0.0)
    for e in raw:
        e["ts"] = (e["ts"] - origin) * 1e6
        if "dur" in e:
            e["dur"] *= 1e6
    # the reference's process name: the layout stays the reference's
    meta = [{"name": "process_name", "ph": "M", "pid": _PID, "tid": 0,
             "args": {"name": "paddle_tpu.serving"}}]
    meta += [{"name": "thread_name", "ph": "M", "pid": _PID, "tid": tid,
              "args": {"name": label}}
             for tid, label in sorted(names.items())]
    return {"traceEvents": meta + raw, "displayTimeUnit": "ms"}


def write_chrome_trace(path, traces=(),
                       timeline: StepTimeline | None = None,
                       alerts=(), journeys=()) -> dict:
    """Render and write the Perfetto-loadable JSON; returns the dict."""
    doc = chrome_trace(traces, timeline, alerts, journeys)
    with open(path, "w") as f:
        json.dump(doc, f)
    return doc


def _fmt(v) -> str:
    """Prometheus sample value: integral floats print as ints."""
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)


def _escape_label(v) -> str:
    """Prometheus label-value escaping: backslash, double-quote, and
    newline must be escaped inside the quoted value (the exposition
    format's only three specials)."""
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def _label_str(labels: dict) -> str:
    """The one label-set renderer behind every exposition sample:
    ``{k="v",k2="v2"}`` with the pairs SORTED by key and the values
    escaped — so a multi-label sample (a histogram-family bucket's
    merged ``{tenant=, le=}``, a ``{tenant=, class=}`` counter) renders
    the same valid text regardless of which path assembled the dict.
    Empty string for no labels."""
    if not labels:
        return ""
    return "{" + ",".join(f'{k}="{_escape_label(v)}"'
                          for k, v in sorted(labels.items())) + "}"


def prometheus_text(stats: dict, histograms=(), types: dict | None = None,
                    ) -> str:
    """Text exposition of scalar stats (``types`` maps BASE name ->
    "counter"; everything else is a gauge) plus histograms as cumulative
    bucket series. Histogram-derived scalar mirrors (``<hist>_p50`` etc.)
    are skipped — scrapers should aggregate the buckets themselves.
    Registry keys shaped ``base{label=value}`` (the labeled-family
    convention) render as one metric family per base with proper sample
    labels; sorted key order keeps each family's samples contiguous, so
    the ``# TYPE`` header is emitted once per base."""
    types = types or {}
    lines: list[str] = []
    hist_bases = tuple({split_labels(h.name)[0] for h in histograms})
    last_typed = None
    for name in sorted(stats):
        base, labels = split_labels(name)
        if base.startswith(hist_bases) and hist_bases:
            continue  # published as a real histogram below
        if base != last_typed:
            lines.append(f"# TYPE {base} {types.get(base, 'gauge')}")
            last_typed = base
        lines.append(f"{base}{_label_str(labels)} {_fmt(stats[name])}")
    for h in histograms:
        base, labels = split_labels(h.name)
        if base != last_typed:
            lines.append(f"# TYPE {base} histogram")
            last_typed = base
        for edge, cum in h.cumulative_buckets():
            le = "+Inf" if edge == float("inf") else f"{edge:.10g}"
            lines.append(f"{base}_bucket"
                         f"{_label_str(dict(labels, le=le))} {cum}")
        lines.append(f"{base}_sum{_label_str(labels)} {_fmt(h.sum)}")
        lines.append(f"{base}_count{_label_str(labels)} {h.count}")
    return "\n".join(lines) + "\n"


def latency_table(summaries, header: bool = True) -> str:
    """Fixed-width per-request latency table (queue wait / TTFT / TPOT /
    e2e, seconds) from :meth:`RequestTrace.summary` dicts — the demo's
    human-readable view of the same decomposition the histograms
    aggregate."""
    def cell(v, width=10):
        return (f"{v:>{width}.4f}" if isinstance(v, float)
                else f"{str(v) if v is not None else '-':>{width}}")

    rows = []
    if header:
        rows.append(f"{'rid':>5} {'state':>9} {'tokens':>6} "
                    f"{'queue_wait':>10} {'ttft':>10} {'tpot':>10} "
                    f"{'e2e':>10}")
    for s in summaries:
        rows.append(" ".join([f"{s['rid']:>5}", f"{s['state'] or '?':>9}",
                              f"{s['tokens']:>6}",
                              cell(s["queue_wait"]), cell(s["ttft"]),
                              cell(s["tpot"]), cell(s["e2e"])]))
    return "\n".join(rows)
