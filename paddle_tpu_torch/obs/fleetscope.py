"""fleetscope — fleet-grain observability: cross-replica spans, merged
metrics, and the cluster flight recorder; the port of
``paddle_tpu/obs/fleetscope.py``. A fleet record written by either
package validates under the other's ``validate_fleet_record``. Three
pieces:

- **Spans** (:class:`FleetScope`): every ``Transport.exchange``
  becomes a causally-linked span. The id is deterministic —
  :func:`span_id` is FNV-1a over (rid, hop serial), the same idiom as
  ``channel.unit_hash`` — and rides the wire in the v1-compatible
  payload tail (``wire._span_tail``), so the receiving side of a real
  network could link its half without a clock in common. Retry
  attempts, backoff waits, and breaker transitions arrive as child
  spans from the transport; :func:`flow_events` renders the tree as
  Chrome ``ph:"s"/"f"`` flow arrows from the sender track to the
  receiver track.
- **Merged metrics** (:class:`FleetMetrics`): every replica's registry
  snapshot folded into ONE valid prometheus exposition with a
  ``replica=`` label on each sample — the same renderer
  (``export.prometheus_text`` / ``_label_str``) and the same
  one-``# TYPE``-per-base grouping as a single replica's scrape, and
  the same text whether fed live snapshots or a fleet record's dumped
  gauges.
- **Cluster flight recorder**: ``paddle-tpu/fleet-record/v1`` bundles
  per-replica flight records (each validated against the existing v2
  schema), router state, the bounded ring of recent exchanges with
  their span trees, and the merged alert history.
  :func:`validate_fleet_record` is the strict gate, mirroring
  ``recorder.validate_flight_record``.

Layering: this module imports NOTHING from ``paddle_tpu_torch.serving``
(serving imports us) — which is why the FNV-1a constants are declared
locally instead of taken from ``channel.unit_hash``.
"""
from __future__ import annotations

import json
from collections import deque

from .export import _fmt, prometheus_text
from .histogram import split_labels
from .recorder import validate_flight_record

__all__ = ["FLEET_RECORD_SCHEMA", "FleetMetrics", "FleetScope",
           "build_fleet_record", "dump_fleet_record", "flow_events",
           "format_fleet_record", "format_span_tree", "span_id",
           "span_key",
           "validate_fleet_record"]

FLEET_RECORD_SCHEMA = "paddle-tpu/fleet-record/v1"

#: the chrome-trace thread id of each replica's wire lane (spans and
#: flow endpoints live here, off the step/phase lanes)
WIRE_TID = 77

# FNV-1a 64-bit (same constants as serving.channel.unit_hash, declared
# locally — see the layering note in the module docstring)
_FNV_SEED = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK = (1 << 64) - 1


def span_id(rid, serial: int) -> int:
    """Deterministic 64-bit span id for one exchange: FNV-1a over
    (rid, hop serial). A rid-less exchange (gossip carries no request)
    hashes rid as -1; the serial alone keeps the id unique."""
    h = _FNV_SEED
    for v in (-1 if rid is None else int(rid), int(serial)):
        h ^= v & _MASK
        h = (h * _FNV_PRIME) & _MASK
    return h


def span_key(sid: int) -> str:
    """The rendered span id — fixed-width hex, because a 64-bit int
    does not survive a JSON round trip through a float53 viewer."""
    return f"{sid:016x}"


class FleetScope:
    """Bounded recorder of cross-replica exchange spans.

    The router opens a span per exchange (it knows kind / src / dst /
    rid), the transport appends retry / backoff / breaker children and
    ends it — both behind one ``is not None`` attribute check, the
    tracer-None idiom, so a detached scope costs nothing. Everything
    is plain dicts on the deterministic transport timeline: the ring
    drops into the fleet record as-is.
    """

    def __init__(self, capacity: int = 256):
        self.capacity = int(capacity)
        self._ring: deque = deque(maxlen=self.capacity)
        self._open: dict[int, dict] = {}
        self._serial = 0

    # ------------------------------------------------------------ record
    def open(self, *, kind: str, src, dst=None, rid=None, step: int = 0,
             t: float = 0.0) -> int:
        """Begin one exchange span; returns the id the frames (and the
        transport's child spans) travel under."""
        self._serial += 1
        sid = span_id(rid, self._serial)
        rec = {"span": span_key(sid), "serial": self._serial,
               "kind": str(kind), "rid": rid, "src": src, "dst": dst,
               "step": int(step), "t0": float(t), "t1": float(t),
               "ok": None, "retries": 0, "children": []}
        self._open[sid] = rec
        self._ring.append(rec)
        return sid

    def child(self, span: int, kind: str, t0: float, t1: float,
              **args) -> None:
        """One child span (attempt / backoff / breaker) under an open
        exchange. Unknown ids (ring evicted) are dropped, not raised —
        this sits on the transport's per-attempt path."""
        rec = self._open.get(span)
        if rec is None:
            return
        rec["children"].append(
            {"kind": str(kind), "t0": float(t0), "t1": float(t1),
             **args})

    def end(self, span: int, *, t: float, ok, retries: int = 0) -> None:
        """Close an exchange span with its outcome."""
        rec = self._open.pop(span, None)
        if rec is None:
            return
        rec["t1"] = float(t)
        rec["ok"] = None if ok is None else bool(ok)
        rec["retries"] = int(retries)

    # ------------------------------------------------------------- query
    def records(self) -> list:
        """The exchange ring, oldest first (JSON-ready dicts)."""
        return list(self._ring)

    def spans_for(self, rid) -> list:
        """Every recorded exchange span for one request id."""
        return [r for r in self._ring if r["rid"] == rid]


# ------------------------------------------------------- chrome flows
def flow_events(records, *, transport_pid: int,
                time_scale: float = 1e6) -> list:
    """Chrome trace events for exchange spans: an ``X`` slice plus a
    flow-start (``ph:"s"``) on the sender's wire lane, the children
    nested under it, and a landing slice plus flow-finish (``ph:"f"``,
    ``bp:"e"``) on the receiver's wire lane — one gossip / fetch /
    re-home reads as a single arrowed tree across replica tracks.
    Replica index ``i`` maps to pid ``i + 1`` (the fleet's chrome
    export convention); a side with no replica (gossip lands on the
    router) falls back to the transport's own track."""
    out = []
    pids = set()
    for rec in records:
        src = rec.get("src")
        dst = rec.get("dst")
        src_pid = transport_pid if src is None else int(src) + 1
        dst_pid = transport_pid if dst is None else int(dst) + 1
        pids.update((src_pid, dst_pid))
        name = f"wire:{rec['kind']}"
        ts = rec["t0"] * time_scale
        dur = max(rec["t1"] - rec["t0"], 0.0) * time_scale
        args = {"span": rec["span"], "rid": rec["rid"],
                "ok": rec["ok"], "retries": rec["retries"]}
        out.append({"name": name, "cat": "wire", "ph": "X", "ts": ts,
                    "dur": dur, "pid": src_pid, "tid": WIRE_TID,
                    "args": args})
        for ch in rec["children"]:
            out.append({"name": f"wire:{ch['kind']}", "cat": "wire",
                        "ph": "X", "ts": ch["t0"] * time_scale,
                        "dur": max(ch["t1"] - ch["t0"], 0.0)
                        * time_scale,
                        "pid": src_pid, "tid": WIRE_TID,
                        "args": {k: v for k, v in ch.items()
                                 if k not in ("t0", "t1")}})
        out.append({"name": name, "cat": "wire", "ph": "s",
                    "id": rec["span"], "ts": ts, "pid": src_pid,
                    "tid": WIRE_TID})
        out.append({"name": f"{name} recv", "cat": "wire", "ph": "X",
                    "ts": ts + dur, "dur": 1.0, "pid": dst_pid,
                    "tid": WIRE_TID, "args": {"span": rec["span"]}})
        out.append({"name": name, "cat": "wire", "ph": "f", "bp": "e",
                    "id": rec["span"], "ts": ts + dur, "pid": dst_pid,
                    "tid": WIRE_TID})
    out.extend({"ph": "M", "name": "thread_name", "pid": pid,
                "tid": WIRE_TID, "args": {"name": "wire"}}
               for pid in sorted(pids))
    return out


# ---------------------------------------------------- merged metrics
class FleetMetrics:
    """Every replica's registry folded into one scrape.

    ``per_replica`` maps replica name -> stats dict (registry keys,
    ``base{label=value}`` style). The merge injects ``replica=`` into
    each sample's label set and renders through the same exposition
    pipeline as a single replica — so the fleet view is one valid
    document with one ``# TYPE`` per base, identical in shape whether
    the inputs are live snapshots or a dumped fleet record's gauges
    (:meth:`from_fleet_record`).
    """

    def __init__(self, per_replica: dict, types: dict | None = None):
        self.per_replica = {str(k): dict(v)
                            for k, v in per_replica.items()}
        self.types = dict(types or {})

    @classmethod
    def from_fleet_record(cls, record: dict,
                          types: dict | None = None) -> "FleetMetrics":
        """The dump path: one registry per bundled flight record."""
        return cls({i: rec.get("gauges", {})
                    for i, rec in enumerate(record.get("replicas", ()))},
                   types)

    def merged(self) -> dict:
        """One registry-style dict with ``replica=`` merged into every
        key's label set."""
        out = {}
        for rep, stats in self.per_replica.items():
            for name, val in stats.items():
                base, labels = split_labels(name)
                body = ",".join(
                    f"{k}={v}"
                    for k, v in (*labels.items(), ("replica", rep)))
                out[f"{base}{{{body}}}"] = val
        return out

    def prometheus(self) -> str:
        """The merged text exposition (scalars; histogram bucket series
        stay per-replica — their percentile mirrors merge here)."""
        return prometheus_text(self.merged(), (), self.types)


# ----------------------------------------------------- fleet record
_FLEET_KEYS = (("schema", str), ("reason", str), ("dumped_at", float),
               ("step", int), ("replicas", list), ("router", dict),
               ("exchanges", list), ("alerts", list))


def build_fleet_record(*, reason: str, now: float, step: int, replicas,
                       router: dict, exchanges, alerts) -> dict:
    """Assemble a fleet record (the cluster-grain counterpart of
    ``recorder.build_flight_record``): per-replica flight records,
    router state, the exchange-span ring, and the merged alert
    history."""
    return {"schema": FLEET_RECORD_SCHEMA, "reason": str(reason),
            "dumped_at": float(now), "step": int(step),
            "replicas": list(replicas), "router": dict(router),
            "exchanges": list(exchanges), "alerts": list(alerts)}


def dump_fleet_record(path, record: dict) -> dict:
    """Validate and write one fleet record as JSON; returns the
    record."""
    validate_fleet_record(record)
    with open(path, "w") as f:
        json.dump(record, f, indent=1, default=str)
    return record


def validate_fleet_record(record) -> dict:
    """The strict schema gate for ``paddle-tpu/fleet-record/v1`` —
    raises ValueError naming the first offending key; every bundled
    replica record must itself pass ``validate_flight_record``.
    Returns the record for chaining."""
    if not isinstance(record, dict):
        raise ValueError(f"fleet record must be a dict, "
                         f"got {type(record).__name__}")
    schema = record.get("schema")
    if schema != FLEET_RECORD_SCHEMA:
        raise ValueError(f"unknown fleet record schema {schema!r} "
                         f"(this build speaks {FLEET_RECORD_SCHEMA})")
    for key, typ in _FLEET_KEYS:
        if key not in record:
            raise ValueError(f"fleet record missing key {key!r}")
        v = record[key]
        if typ is float and isinstance(v, int) \
                and not isinstance(v, bool):
            v = float(v)  # JSON round-trips integral floats as ints
        if not isinstance(v, typ):
            raise ValueError(
                f"fleet record key {key!r} must be {typ.__name__}, "
                f"got {type(record[key]).__name__}")
    for i, rec in enumerate(record["replicas"]):
        try:
            validate_flight_record(rec)
        except ValueError as e:
            raise ValueError(f"fleet record replica {i}: {e}") from e
    for i, ex in enumerate(record["exchanges"]):
        if not isinstance(ex, dict) \
                or not {"span", "kind", "t0", "t1",
                        "children"} <= set(ex):
            raise ValueError(
                f"fleet record exchange {i} is not a span record")
    for i, al in enumerate(record["alerts"]):
        if not isinstance(al, dict) or "rule" not in al \
                or "replica" not in al:
            raise ValueError(
                f"fleet record alert {i} missing rule/replica")
    return record


# -------------------------------------------------------- formatting
def format_span_tree(rec: dict) -> str:
    """One exchange span and its children as an indented tree — the
    ``--span`` CLI view."""
    head = (f"span {rec['span']} wire:{rec['kind']} rid={rec['rid']} "
            f"src={rec['src']} dst={rec['dst']} step={rec['step']} "
            f"[{_fmt(rec['t0'])}s -> {_fmt(rec['t1'])}s] "
            f"ok={rec['ok']} retries={rec['retries']}")
    lines = [head]
    kids = rec.get("children", [])
    for i, ch in enumerate(kids):
        tee = "`-" if i == len(kids) - 1 else "|-"
        extra = " ".join(f"{k}={v}" for k, v in sorted(ch.items())
                         if k not in ("kind", "t0", "t1"))
        lines.append(f"  {tee} {ch['kind']} "
                     f"[{_fmt(ch['t0'])}s -> {_fmt(ch['t1'])}s]"
                     + (f" {extra}" if extra else ""))
    return "\n".join(lines)


def format_fleet_record(record: dict) -> str:
    """Human-readable summary: the per-replica roll-up table, breaker
    states, and the exchange-ring tally — the default ``--fleet-record``
    CLI view."""
    out = [f"fleet record {record['schema']} "
           f"reason={record['reason']!r} step={record['step']} "
           f"dumped_at={_fmt(record['dumped_at'])}s"]
    out.append(f"{'replica':>8} {'reason':>16} {'step':>6} "
               f"{'requests':>8} {'tokens':>8} {'alerts':>6}")
    for i, rec in enumerate(record["replicas"]):
        gauges = rec.get("gauges", {})
        out.append(f"{i:>8} {rec['reason'][:16]:>16} "
                   f"{rec['step']:>6} {len(rec['requests']):>8} "
                   f"{_fmt(gauges.get('serving_tokens_total', 0)):>8} "
                   f"{len(rec['alerts']):>6}")
    router = record["router"]
    breakers = router.get("breakers", {})
    if breakers:
        states = " ".join(f"peer {p}: {s}"
                          for p, s in sorted(breakers.items()))
        out.append(f"breakers: {states}")
    out.append(f"router: live={router.get('live')} "
               f"down={router.get('down')} "
               f"pending={len(router.get('pending', ()))} "
               f"weights={router.get('weights')}")
    out.append(f"exchanges: {len(record['exchanges'])} spans recorded, "
               f"{len(record['alerts'])} fleet alerts")
    return "\n".join(out)
