"""Black-box flight recorder — the port of ``paddle_tpu/obs/recorder.py``:
a bounded JSON dump of what the engine was doing when something went
wrong.

:func:`build_flight_record` snapshots the engine's surfaces — the step
timeline ring, the watchdog alert history, the metrics registry, the
per-program audit roll-ups (empty in the port until its audits exist,
ROADMAP Queue 1 item 11), the per-request latency summaries, the
per-tenant roll-ups and a ring of wire journeys — into one
schema-versioned dict (bounded), and :func:`dump_flight_record` writes
it as JSON. The engine dumps automatically on its fatal paths (an
exception escaping the step body, the stuck-engine backstop) and
whenever a request retires FAILED, and on demand via
``engine.dump_flight_record(path)``.

``python -m paddle_tpu_torch.obs --flight-record dump.json``
pretty-prints a dump; :func:`validate_flight_record` is the schema gate
the CLI and the tests use — it accepts schema ``v2`` (current) AND the
original ``v1`` (dumps written before the tenant layer existed).
"""
from __future__ import annotations

import json
from dataclasses import asdict

from .journey import validate_journey

__all__ = ["FLIGHT_RECORD_SCHEMA", "FLIGHT_RECORD_SCHEMA_V1",
           "MAX_FLIGHT_JOURNEYS", "build_flight_record",
           "dump_flight_record", "validate_flight_record",
           "format_flight_record"]

FLIGHT_RECORD_SCHEMA_V1 = "paddle-tpu/flight-record/v1"
FLIGHT_RECORD_SCHEMA = "paddle-tpu/flight-record/v2"

#: journeys retained per dump — also the bound callers should apply
#: BEFORE serializing (JourneyBook.wire_records(limit=...)), so a
#: failure-path dump is O(kept), not O(every retained journey)
MAX_FLIGHT_JOURNEYS = 64

#: required top-level keys and their types — the schema contract the
#: tests pin and the CLI enforces before pretty-printing; v2 adds the
#: per-tenant roll-ups and the journey ring on top of the v1 set
_SCHEMA_KEYS = (("schema", str), ("reason", str), ("dumped_at", float),
                ("step", int), ("config", dict), ("steps", list),
                ("alerts", list), ("gauges", dict), ("programs", dict),
                ("requests", list))
_SCHEMA_KEYS_V2 = _SCHEMA_KEYS + (("tenants", dict), ("journeys", list))


def build_flight_record(*, reason: str, now: float, step: int,
                        config: dict | None = None, timeline=None,
                        alerts=(), gauges: dict | None = None,
                        programs: dict | None = None, requests=(),
                        tenants: dict | None = None, journeys=(),
                        max_steps: int = 64,
                        max_requests: int = 64,
                        max_journeys: int = MAX_FLIGHT_JOURNEYS) -> dict:
    """Assemble one flight record (schema v2). ``timeline`` is a
    :class:`~.timeline.StepTimeline` (or None — tracing off), ``alerts``
    an iterable of :class:`~.alerts.Alert`
    (or already-dict entries), ``requests`` latency-summary dicts,
    ``tenants`` the :meth:`TenantLedger.rollup` dict, ``journeys`` wire
    journey dicts (the newest ``max_journeys`` are kept)."""
    steps = timeline.records()[-max_steps:] if timeline is not None else []
    return {
        "schema": FLIGHT_RECORD_SCHEMA,
        "reason": str(reason),
        "dumped_at": float(now),
        "step": int(step),
        "config": dict(config or {}),
        "steps": [asdict(r) for r in steps],
        "alerts": [a if isinstance(a, dict) else a.asdict()
                   for a in alerts],
        "gauges": dict(gauges or {}),
        "programs": dict(programs or {}),
        "requests": list(requests)[-max_requests:],
        "tenants": dict(tenants or {}),
        "journeys": list(journeys)[-max_journeys:],
    }


def dump_flight_record(path, record: dict) -> dict:
    """Write the record as JSON; returns it unchanged."""
    with open(path, "w") as f:
        json.dump(record, f, indent=1, default=str)
    return record


def validate_flight_record(record) -> dict:
    """Schema gate: raises ValueError naming the first violation; returns
    the record for chaining."""
    if not isinstance(record, dict):
        raise ValueError(f"flight record must be a dict, got "
                         f"{type(record).__name__}")
    schema = record.get("schema")
    if schema == FLIGHT_RECORD_SCHEMA:
        keys = _SCHEMA_KEYS_V2
    elif schema == FLIGHT_RECORD_SCHEMA_V1:
        keys = _SCHEMA_KEYS  # back-compat: pre-tenant dumps stay readable
    else:
        raise ValueError(
            f"unknown flight-record schema {schema!r} "
            f"(expected {FLIGHT_RECORD_SCHEMA!r} or "
            f"{FLIGHT_RECORD_SCHEMA_V1!r})")
    for key, typ in keys:
        if key not in record:
            raise ValueError(f"flight record missing key {key!r}")
        if typ is float and isinstance(record[key], int):
            continue  # JSON round-trips integral floats as ints
        if not isinstance(record[key], typ):
            raise ValueError(
                f"flight record key {key!r} must be {typ.__name__}, got "
                f"{type(record[key]).__name__}")
    for rec in record["steps"]:
        for field in ("step", "t_start", "t_end"):
            if field not in rec:
                raise ValueError(
                    f"flight-record step entry missing {field!r}: {rec}")
    for alert in record["alerts"]:
        for field in ("rule", "step", "message"):
            if field not in alert:
                raise ValueError(
                    f"flight-record alert entry missing {field!r}: {alert}")
    for journey in record.get("journeys", ()):
        validate_journey(journey)  # each ring entry is itself schema-gated
    return record


def format_flight_record(record: dict) -> str:
    """Human-readable rendering of a (validated) dump — the CLI's default
    view: header, alert table, the newest step records, and the nonzero
    headline gauges."""
    lines = [f"flight record  schema={record['schema']}",
             f"reason: {record['reason']}",
             f"dumped at t={record['dumped_at']:.6f}s, engine step "
             f"{record['step']}"]
    cfg = record["config"]
    if cfg:
        lines.append("config: " + ", ".join(
            f"{k}={v}" for k, v in sorted(cfg.items())))
    lines.append(f"\nalerts ({len(record['alerts'])}):")
    for a in record["alerts"]:
        lines.append(f"  step {a['step']:>5}  {a['rule']:<26} "
                     f"{a['message']}")
    if not record["alerts"]:
        lines.append("  (none)")
    steps = record["steps"]
    lines.append(f"\nsteps (last {len(steps)} retained):")
    for rec in steps[-10:]:
        phases = rec.get("phase_s") or {}
        mix = "+".join(sorted(k for k, v in phases.items() if v)) or "-"
        fatal = (rec.get("extra") or {}).get("fatal")
        dur = rec["t_end"] - rec["t_start"]
        lines.append(
            f"  step {rec['step']:>5}  dur={dur:.6f}s "
            f"batch={rec.get('batch', 0)} "
            f"queue={rec.get('queue_depth', 0)} "
            f"pages={rec.get('pages_in_use', 0)} phases={mix}"
            + (f"  FATAL: {fatal}" if fatal else ""))
    if not steps:
        lines.append("  (tracing was off — no step records)")
    if record["programs"]:
        lines.append("\naudited programs:")
        for label, p in sorted(record["programs"].items()):
            lines.append(f"  {label:<16} flops/step={p.get('flops', 0):.4g}"
                         f"  peak_hbm={p.get('peak_hbm_bytes', 0)}")
    tenants = record.get("tenants") or {}
    if tenants:
        from .tenant import tenant_table

        lines.append(f"\ntenants ({len(tenants)}):")
        lines.append(tenant_table(tenants))
        n_journeys = len(record.get("journeys") or ())
        lines.append(f"journeys retained: {n_journeys} "
                     f"(--journey RID prints one)")
    nonzero = {k: v for k, v in sorted(record["gauges"].items())
               if isinstance(v, (int, float)) and v}
    lines.append(f"\nnonzero gauges ({len(nonzero)}):")
    for k, v in nonzero.items():
        lines.append(f"  {k} = {v}")
    return "\n".join(lines)
