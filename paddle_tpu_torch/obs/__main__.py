"""``python -m paddle_tpu_torch.obs`` — the observability CLI, the port
of ``paddle_tpu/obs/__main__.py``.

Operates on a flight-record dump (``engine.dump_flight_record(path)`` or
the automatic fatal/failure dumps), written by either package:

    python -m paddle_tpu_torch.obs --flight-record dump.json
        pretty-print the dump: reason, alert table, newest step records,
        audited programs, nonzero gauges
    python -m paddle_tpu_torch.obs --flight-record dump.json --prometheus
        render the dump's gauge snapshot as Prometheus text exposition
    python -m paddle_tpu_torch.obs --flight-record dump.json --latency-table
        render the dump's per-request latency summaries
    python -m paddle_tpu_torch.obs --flight-record dump.json --tenant-table
        render the dump's per-tenant roll-ups (goodput %, TTFT/TPOT p99,
        badput breakdown by class) — flight-record v2 dumps only
    python -m paddle_tpu_torch.obs --flight-record dump.json --journey RID
        pretty-print one request's journey out of the dump's journey ring
    python -m paddle_tpu_torch.obs --prometheus
        (no dump) text exposition of THIS process's live ``serving_*``
        registry

Cluster-grain dumps (``FleetRouter.dump_fleet_record(path)`` or the
automatic replica-down / chaos-invariant dumps), written by either
package:

    python -m paddle_tpu_torch.obs --fleet-record dump.json
        pretty-print the fleet record: per-replica roll-up table, breaker
        states, router state, exchange-span tally
    python -m paddle_tpu_torch.obs --fleet-record dump.json --span RID
        pretty-print every exchange span tree the dump kept for one
        request
    python -m paddle_tpu_torch.obs --fleet-record dump.json --prometheus
        merge every bundled replica registry into one exposition with
        ``replica=`` labels

Exit codes: 0 clean, 1 findings (the dump records alerts or an
engine-fatal/failure reason), 2 bad usage or an unreadable/invalid dump.
"""
from __future__ import annotations

import json
import sys

from .export import latency_table, prometheus_text
from .journey import format_journey
from .recorder import format_flight_record, validate_flight_record
from .tenant import tenant_table


def _counter_types(gauges: dict) -> dict:
    """Type the monotonic names for exposition from the serving
    registry's COUNTER_STATS — the same single source of truth behind
    the live ``ServingMetrics.prometheus()``, so a dump's exposition can
    never type-flap against a live scrape of the same process. (Runtime
    import: the obs LIBRARY modules never import serving — serving
    imports them — but this CLI entry point is never imported by
    serving, so there is no cycle.)"""
    from ..serving.metrics import COUNTER_STATS
    from .histogram import split_labels

    out = {}
    for name in gauges:
        base = split_labels(name)[0]
        if base in COUNTER_STATS:
            out[base] = "counter"
    return out


def _fleet_main(args) -> int:
    """The cluster-grain input: every view over a fleet record."""
    from .fleetscope import (FleetMetrics, format_fleet_record,
                             format_span_tree, validate_fleet_record)

    try:
        with open(args.fleet_record) as fh:
            record = validate_fleet_record(json.load(fh))
    except (OSError, ValueError) as e:
        print(f"cannot read fleet record {args.fleet_record!r}: {e}")
        return 2

    if args.latency_table or args.tenant_table or args.journey is not None:
        print("that view reads a single replica's flight record: pass "
              "--flight-record PATH (a fleet record bundles them under "
              "'replicas')")
        return 2
    if args.span is not None:
        trees = [rec for rec in record["exchanges"]
                 if rec.get("rid") == args.span]
        if not trees:
            retained = sorted({rec.get("rid")
                               for rec in record["exchanges"]
                               if rec.get("rid") is not None})
            print(f"rid {args.span} not in the dump's exchange ring "
                  f"(retained rids: {retained[:16]}"
                  + ("..." if len(retained) > 16 else "") + ")")
            return 2
        print("\n".join(format_span_tree(rec) for rec in trees))
    elif args.prometheus:
        # type the monotonic names off the first replica's gauges (the
        # families are fleet-uniform)
        gauges = (record["replicas"][0].get("gauges", {})
                  if record["replicas"] else {})
        print(FleetMetrics.from_fleet_record(
            record, types=_counter_types(gauges)).prometheus(), end="")
    else:
        print(format_fleet_record(record))
    dirty = bool(record["alerts"]) or record["reason"] != "manual"
    return 1 if dirty else 0


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.obs",
        description="Flight-record reader + Prometheus exposition "
                    "(0 clean, 1 alerts/fatal recorded, 2 bad usage).")
    parser.add_argument("--flight-record", metavar="PATH", default=None,
                        help="flight-record JSON dump to read")
    parser.add_argument("--fleet-record", metavar="PATH", default=None,
                        help="cluster fleet-record JSON dump to read "
                             "(paddle-tpu/fleet-record/v1)")
    view = parser.add_mutually_exclusive_group()
    view.add_argument("--prometheus", action="store_true",
                      help="render the dump's gauges (or, with no dump, "
                           "this process's live serving_* registry) as "
                           "Prometheus text")
    view.add_argument("--latency-table", action="store_true",
                      help="render the dump's per-request latency "
                           "summaries")
    view.add_argument("--tenant-table", action="store_true",
                      help="render the dump's per-tenant goodput/SLO "
                           "roll-ups (flight-record v2)")
    view.add_argument("--journey", metavar="RID", type=int, default=None,
                      help="pretty-print one request's journey out of "
                           "the dump's journey ring")
    view.add_argument("--span", metavar="RID", type=int, default=None,
                      help="pretty-print one request's exchange span "
                           "trees out of a fleet record's ring")
    try:
        args = parser.parse_args(argv)
    except SystemExit as e:
        return 0 if e.code == 0 else 2

    if args.fleet_record is not None:
        if args.flight_record is not None:
            print("--flight-record and --fleet-record are different "
                  "inputs: pass one")
            return 2
        return _fleet_main(args)
    if args.span is not None:
        print("--span reads a fleet record's exchange ring: pass "
              "--fleet-record PATH")
        return 2

    if args.flight_record is None:
        if args.prometheus:
            from ..utils import monitor

            stats = monitor.stats_with_prefix("serving_")
            print(prometheus_text(stats, types=_counter_types(stats)),
                  end="")
            return 0
        parser.print_usage()
        print("a view needs input: pass --flight-record PATH "
              "(--prometheus alone reads the live registry)")
        return 2

    try:
        with open(args.flight_record) as fh:
            record = validate_flight_record(json.load(fh))
    except (OSError, ValueError) as e:
        print(f"cannot read flight record {args.flight_record!r}: {e}")
        return 2

    if args.prometheus:
        print(prometheus_text(record["gauges"],
                              types=_counter_types(record["gauges"])),
              end="")
    elif args.latency_table:
        print(latency_table(record["requests"]))
    elif args.tenant_table:
        tenants = record.get("tenants")
        if tenants is None:
            print(f"dump {args.flight_record!r} has no tenant section "
                  f"(flight-record v1, pre-tenant)")
            return 2
        print(tenant_table(tenants))
    elif args.journey is not None:
        ring = record.get("journeys")
        if ring is None:  # v1 predates journeys — don't claim eviction
            print(f"dump {args.flight_record!r} has no journey ring "
                  f"(flight-record v1, pre-tenant)")
            return 2
        journeys = {j["rid"]: j for j in ring}
        if args.journey not in journeys:
            retained = sorted(journeys)
            print(f"rid {args.journey} not in the dump's journey ring "
                  f"(retained rids: {retained[:16]}"
                  + ("..." if len(retained) > 16 else "") + ")")
            return 2
        print(format_journey(journeys[args.journey]))
    else:
        print(format_flight_record(record))
    # findings contract: a dump that recorded alerts, or was written by a
    # fatal/failure path, is a finding — scriptable triage
    dirty = bool(record["alerts"]) or record["reason"] != "manual"
    return 1 if dirty else 0


if __name__ == "__main__":
    sys.exit(main())
