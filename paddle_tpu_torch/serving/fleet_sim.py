"""Trace-driven fleet simulator: replay a journey dump offline — the port
of ``paddle_tpu/serving/fleet_sim.py`` (pure host Python; it reads dumps
written by either package).

``paddle-tpu/journey/v1`` wire records carry everything a capacity
question needs — arrival time, queueing delay, service time, terminal
state, per-request latencies, tenant — so a dump from a live run (a
``FleetRouter.journey_dump()``, or the ``journeys`` section of a flight
record) can be replayed against HYPOTHETICAL fleet shapes without
touching a model or a device:

- :func:`replay_classes` re-runs the goodput/badput classification of
  every terminal record through a fresh :class:`TenantLedger` —
  deterministic (``classify`` is a pure function of state + latencies
  vs targets), so with the live run's own SLO table it reproduces the
  live per-tenant retirement-class counts EXACTLY (the pin the fleet
  test holds), and with a hypothetical SLO table it answers "how much
  of yesterday's traffic would have violated the new targets".
- :func:`simulate` replays arrivals against a hypothetical replica
  count / slots-per-replica / admission-weight table on a virtual
  clock: each record's service demand is its measured ``e2e_s`` minus
  its measured ``queue_delay_s`` (what the engine actually spent on
  it), dispatch order is weighted the way the live router orders its
  pending queue, and the output is per-tenant projected queueing —
  the "would 2 replicas have held the p99?" planning tool.

Non-terminal records (state None — e.g. the dead-replica half of a
re-homed request's journey pair) are skipped by both: they describe no
retirement and consumed no attributable service. Hops of kinds this
build does not know (a NEWER writer's v1-compatible extension) are
stripped and counted, never fatal — the what-if report carries the
count so a truncated replay is visible, not silent.

CLI::

    python -m paddle_tpu_torch.serving.fleet_sim dump.json \
        --replicas 2 --slots 4 --slo interactive=0.5:0.05 \
        --weight batch=2.0

accepts a flight-record JSON (reads its ``journeys`` section) or a bare
list of wire journeys, prints the replayed class table and the what-if
projection. Pure host code: no torch, no device, no clock reads.
"""
from __future__ import annotations

import argparse
import json

from ..obs.journey import JOURNEY_KINDS, validate_journey
from ..obs.tenant import CLASSES, TenantLedger, TenantSLO

__all__ = ["replay_classes", "simulate", "main"]


def _percentile(values: list[float], q: float) -> float:
    """Nearest-rank percentile of a non-empty list (pure python — the
    simulator must not need numpy for a table)."""
    xs = sorted(values)
    idx = min(len(xs) - 1, max(0, int(round(q * (len(xs) - 1)))))
    return xs[idx]


def _records(dump) -> tuple[list[dict], int]:
    """Normalize a dump: a flight record (dict with ``journeys``) or a
    bare list of wire journeys; every record is schema-validated.
    Returns ``(records, unknown_hops)``: hops whose ``kind`` a NEWER
    writer minted (the journey schema is a v1-compatible extension
    point — ``JOURNEY_KINDS`` grows, nothing moves) are stripped and
    counted instead of failing validation, so an old replayer degrades
    to skipping the hops it cannot interpret rather than refusing the
    whole dump. Malformed hops (non-dict, missing fields) still fail —
    forward-compat forgives NEW vocabulary, not broken grammar."""
    if isinstance(dump, dict):
        dump = dump.get("journeys", [])
    out, unknown = [], 0
    for rec in dump:
        if isinstance(rec, dict) and isinstance(rec.get("hops"), list):
            keep = []
            for hop in rec["hops"]:
                if (isinstance(hop, dict)
                        and all(f in hop for f in ("kind", "step", "t"))
                        and isinstance(hop["kind"], str)
                        and hop["kind"] not in JOURNEY_KINDS):
                    unknown += 1
                else:
                    keep.append(hop)
            if len(keep) != len(rec["hops"]):
                rec = dict(rec, hops=keep)
        out.append(validate_journey(rec))
    return out, unknown


def replay_classes(dump, slos: dict | None = None) -> dict:
    """Re-classify every terminal journey through a fresh ledger:
    {tenant: {class: count}}. With the live run's SLO table this equals
    the live run's ``retirement_class_counts()`` exactly — classify
    reads only (state, ttft, tpot) vs targets, all of which the wire
    record preserves verbatim."""
    ledger = TenantLedger(slos)
    counts: dict[str, dict[str, int]] = {}
    for rec in _records(dump)[0]:
        state = rec["state"]
        if state is None:
            continue
        cls = ledger.on_retire(rec["tenant"], state,
                               ttft=rec["ttft_s"], tpot=rec["tpot_s"],
                               tokens=int(rec["tokens"]))
        counts.setdefault(rec["tenant"],
                          {c: 0 for c in CLASSES})[cls] += 1
    return counts


def _arrival(rec: dict) -> float | None:
    """A record's arrival time: its first ``enqueue`` hop (every
    journey the engine or router opens stamps one)."""
    for hop in rec["hops"]:
        if hop["kind"] == "enqueue":
            return float(hop["t"])
    return None


def simulate(dump, replicas: int, slots: int,
             weights: dict | None = None) -> dict:
    """Replay the dump's arrivals against ``replicas`` hypothetical
    replicas of ``slots`` concurrent requests each: deterministic
    earliest-free-slot dispatch, ties broken by admission weight
    (descending) then arrival order — the live router's pending-queue
    discipline. Service demand per request is its measured engine time
    (``e2e_s - queue_delay_s``); requests the live run never served
    (shed / no latency record) project zero demand and are reported in
    ``unserved``. Returns per-tenant projected queue-delay stats and
    the fleet-wide makespan."""
    if replicas < 1:
        raise ValueError(f"replicas {replicas} < 1")
    if slots < 1:
        raise ValueError(f"slots {slots} < 1")
    weights = dict(weights or {})
    jobs, unserved = [], 0
    records, unknown_hops = _records(dump)
    for rec in records:
        if rec["state"] is None:
            continue
        t0 = _arrival(rec)
        e2e, qd = rec["e2e_s"], rec["queue_delay_s"]
        if t0 is None or e2e is None or qd is None:
            unserved += 1
            continue
        jobs.append((t0, -weights.get(rec["tenant"], 1.0),
                     len(jobs), rec["tenant"], max(e2e - qd, 0.0)))
    jobs.sort()  # arrival, then weight (desc), then submit order
    free = [0.0] * (replicas * slots)  # next-free time per slot
    delays: dict[str, list[float]] = {}
    makespan = 0.0
    for t0, _, _, tenant, service in jobs:
        k = min(range(len(free)), key=lambda i: (free[i], i))
        start = max(free[k], t0)
        free[k] = start + service
        makespan = max(makespan, free[k])
        delays.setdefault(tenant, []).append(start - t0)
    out = {
        "replicas": replicas, "slots": slots, "served": len(jobs),
        "unserved": unserved, "unknown_hops": unknown_hops,
        "makespan_s": makespan, "tenants": {}}
    for tenant, ds in sorted(delays.items()):
        out["tenants"][tenant] = {
            "requests": len(ds),
            "queue_delay_mean_s": sum(ds) / len(ds),
            "queue_delay_p99_s": _percentile(ds, 0.99),
            "queue_delay_max_s": max(ds),
        }
    return out


def _parse_slo(spec: str) -> tuple[str, TenantSLO]:
    try:
        tenant, targets = spec.split("=", 1)
        ttft, tpot = targets.split(":", 1)
        return tenant, TenantSLO(ttft_p99_s=float(ttft),
                                 tpot_p99_s=float(tpot))
    except (ValueError, TypeError):
        raise argparse.ArgumentTypeError(
            f"--slo wants tenant=ttft:tpot (seconds), got {spec!r}")


def _parse_weight(spec: str) -> tuple[str, float]:
    try:
        tenant, w = spec.split("=", 1)
        return tenant, float(w)
    except (ValueError, TypeError):
        raise argparse.ArgumentTypeError(
            f"--weight wants tenant=<float>, got {spec!r}")


def format_report(classes: dict, what_if: dict) -> str:
    """Human tables for the CLI: the replayed class counts, then the
    what-if projection."""
    lines = ["replayed retirement classes:"]
    header = f"{'tenant':<16}" + "".join(f"{c:>11}" for c in CLASSES)
    lines.append(header)
    for tenant in sorted(classes):
        row = classes[tenant]
        lines.append(f"{tenant:<16}"
                     + "".join(f"{row[c]:>11}" for c in CLASSES))
    lines.append("")
    lines.append(
        f"what-if: {what_if['replicas']} replica(s) x "
        f"{what_if['slots']} slot(s) — {what_if['served']} served, "
        f"{what_if['unserved']} unserved, "
        f"makespan {what_if['makespan_s']:.3f}s")
    if what_if.get("unknown_hops"):
        lines.append(f"note: skipped {what_if['unknown_hops']} hop(s) "
                     f"of kinds newer than this build")
    lines.append(f"{'tenant':<16}{'requests':>10}{'qd_mean_s':>12}"
                 f"{'qd_p99_s':>12}{'qd_max_s':>12}")
    for tenant, row in sorted(what_if["tenants"].items()):
        lines.append(
            f"{tenant:<16}{row['requests']:>10}"
            f"{row['queue_delay_mean_s']:>12.4f}"
            f"{row['queue_delay_p99_s']:>12.4f}"
            f"{row['queue_delay_max_s']:>12.4f}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.serving.fleet_sim",
        description="Replay a paddle-tpu journey dump against a "
                    "hypothetical fleet shape (offline capacity "
                    "planning; no device, no model).")
    ap.add_argument("dump", help="flight-record JSON (its 'journeys' "
                                 "section is read) or a bare JSON list "
                                 "of wire journeys")
    ap.add_argument("--replicas", type=int, default=3,
                    help="hypothetical replica count (default 3)")
    ap.add_argument("--slots", type=int, default=4,
                    help="concurrent requests per replica (default 4)")
    ap.add_argument("--slo", type=_parse_slo, action="append",
                    default=[], metavar="TENANT=TTFT:TPOT",
                    help="hypothetical SLO target (repeatable); "
                         "omit to re-run the no-SLO classification")
    ap.add_argument("--weight", type=_parse_weight, action="append",
                    default=[], metavar="TENANT=W",
                    help="hypothetical admission weight (repeatable)")
    args = ap.parse_args(argv)
    with open(args.dump) as f:
        dump = json.load(f)
    classes = replay_classes(dump, slos=dict(args.slo))
    what_if = simulate(dump, replicas=args.replicas, slots=args.slots,
                       weights=dict(args.weight))
    print(format_report(classes, what_if))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
