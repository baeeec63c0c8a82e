"""Request-journey records: the wire-exportable trace of one request's
trip through the engine — the port of ``paddle_tpu/obs/journey.py``.

A :class:`Journey` is the request-grain complement of the engine-grain
flight recorder: every request accrues an ordered list of **hops** —
enqueue → router hops when a fleet router is in front (``routed`` /
``spilled`` with the chosen replica and warm-prefix width, or ``shed``
when the router retires it unserved) → admit (queue delay, prefix-hit
width, restore/spill page refs) → each prefill chunk → decode/verify
step refs (with accepted counts under speculation) →
preemptions/swaps → retire (terminal state) — each
hop stamped with the ENGINE STEP INDEX it happened in and the engine
clock time. Nothing here reads the device: journeys are assembled
purely from the lifecycle events the tracer and scheduler already stamp
(the :class:`~.trace.Tracer` ``journal`` hook replays every event into
the book) plus the engine's host-resident step counter.

The wire format (:meth:`Journey.to_wire`, schema
``paddle-tpu/journey/v1``, gated by :func:`validate_journey`) is a
plain JSON dict — THE trace-export-over-the-wire format the multi-host
arc consumes: a prefill host can ship a request's journey-so-far to the
decode host and the fleet router can aggregate retired journeys across
replicas without any shared memory. The flight recorder embeds a
bounded ring of these dicts (schema v2), and
``python -m paddle_tpu_torch.obs --journey RID`` pretty-prints one out
of a dump.

Bounds: the book retains ``capacity`` journeys (oldest TERMINAL evicted
first — live journeys are never truncated mid-lifecycle, the Tracer
retention contract) and each journey caps its hop list at ``max_hops``
(``dropped_hops`` counts the overflow; the terminal retire hop is
always recorded). Imports nothing from ``paddle_tpu_torch.serving`` —
serving imports us.
"""
from __future__ import annotations

from collections import OrderedDict

__all__ = ["JOURNEY_SCHEMA", "JOURNEY_KINDS", "Journey", "JourneyBook",
           "validate_journey", "format_journey"]

JOURNEY_SCHEMA = "paddle-tpu/journey/v1"

#: trace event name -> journey hop kind (events not listed here — e.g.
#: the cadenced decode marks' enclosing spans — don't become hops)
_EVENT_KINDS = {
    "enqueued": "enqueue",
    "admitted": "admit",
    "spill": "spill",
    "restore": "restore",
    "prefill_start": "prefill_start",
    "prefill_chunk": "prefill_chunk",
    "prefill_end": "prefill_end",
    "first_token": "first_token",
    "decode_mark": "decode",
    "spec_verify": "verify",
    "preempted": "preempt",
    "swap_out": "swap_out",
    "swap_in": "swap_in",
    "resumed": "resume",
    "pallas_fallback": "fallback",
    "retired": "retire",
    # fleet-router hops (serving/fleet.py stamps these on the owning
    # replica's tracer before the engine's own lifecycle events): v1
    # kinds, so either package's dumps validate under the other
    "routed": "routed",
    "spilled": "spilled",
    "shed_by_router": "shed",
    # wire-transport hops, stamped by the router around its exchanges
    "wire_retry": "wire_retry",
    "refetch_fallback": "refetch_fallback",
    "breaker_open": "breaker_open",
}

#: every hop kind a validate_journey-clean record may carry
JOURNEY_KINDS = frozenset(_EVENT_KINDS.values())

# wire-dict required keys and types (latency fields are float-or-None,
# checked separately; "state" is str-or-None — None = still in flight)
_WIRE_KEYS = (("schema", str), ("rid", int), ("tenant", str),
              ("tokens", int), ("preemptions", int),
              ("prefix_hit_tokens", int), ("dropped_hops", int),
              ("hops", list))
_WIRE_LATENCIES = ("queue_delay_s", "ttft_s", "tpot_s", "e2e_s")


class Journey:
    """One request's hop list + derived latency fields. Mutated only by
    the owning :class:`JourneyBook`; read anywhere."""

    __slots__ = ("rid", "tenant", "state", "hops", "dropped_hops",
                 "max_hops", "tokens", "preemptions", "prefix_hit_tokens",
                 "enqueued_t", "admitted_t", "first_token_t", "retired_t")

    def __init__(self, rid: int, tenant: str, max_hops: int):
        self.rid = rid
        self.tenant = tenant
        self.state: str | None = None  # terminal state once retired
        self.hops: list[dict] = []
        self.dropped_hops = 0
        self.max_hops = max_hops
        self.tokens = 0
        self.preemptions = 0
        self.prefix_hit_tokens = 0
        self.enqueued_t: float | None = None
        self.admitted_t: float | None = None
        self.first_token_t: float | None = None
        self.retired_t: float | None = None

    @property
    def terminal(self) -> bool:
        return self.state is not None

    def _hop(self, kind: str, step: int, t: float, data: dict) -> None:
        if kind != "retire" and len(self.hops) >= self.max_hops:
            # bounded: long decodes overflow into the drop counter; the
            # terminal hop is always kept (a journey must end)
            self.dropped_hops += 1
            return
        hop = {"kind": kind, "step": int(step), "t": float(t)}
        hop.update(data)
        self.hops.append(hop)

    # ------------------------------------------------------- derived views
    def _dt(self, t: float | None) -> float | None:
        if t is None or self.enqueued_t is None:
            return None
        return t - self.enqueued_t

    def to_wire(self) -> dict:
        """The schema-versioned JSON-ready dict — the over-the-wire
        journey format. Latency fields are None for milestones this
        lifecycle never reached (a shed request has no TTFT)."""
        tpot = None
        if self.state == "finished" and self.tokens > 1 \
                and self.first_token_t is not None \
                and self.retired_t is not None:
            # finished requests retire at the step boundary that emitted
            # their last token, so retirement time IS last-token time
            # (the RequestTrace.summary tpot contract)
            tpot = (self.retired_t - self.first_token_t) / (self.tokens - 1)
        return {
            "schema": JOURNEY_SCHEMA,
            "rid": self.rid,
            "tenant": self.tenant,
            "state": self.state,
            "tokens": self.tokens,
            "preemptions": self.preemptions,
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "queue_delay_s": self._dt(self.admitted_t),
            "ttft_s": self._dt(self.first_token_t),
            "tpot_s": tpot,
            "e2e_s": self._dt(self.retired_t),
            "dropped_hops": self.dropped_hops,
            "hops": [dict(h) for h in self.hops],
        }

    def __repr__(self) -> str:
        return (f"Journey(rid={self.rid}, tenant={self.tenant!r}, "
                f"state={self.state}, hops={len(self.hops)})")


class JourneyBook:
    """Engine-owned journey store, fed by the tracer's ``journal`` hook.
    ``step_source`` is a zero-arg callable returning the engine's current
    step index (a host int read — zero device syncs)."""

    def __init__(self, step_source, capacity: int = 2048,
                 max_hops: int = 256):
        if capacity < 1:
            raise ValueError(f"capacity {capacity} < 1")
        if max_hops < 8:
            raise ValueError(f"max_hops {max_hops} < 8")
        self._step_source = step_source
        self.capacity = capacity
        self.max_hops = max_hops
        self._journeys: OrderedDict[int, Journey] = OrderedDict()
        self.evicted = 0

    def begin(self, rid: int, tenant: str) -> Journey:
        """Create the journey for a new request (before the tracer stamps
        ``enqueued`` — the hook routes that event onto it). Evicts
        oldest-first TERMINAL journeys to stay under ``capacity``."""
        if len(self._journeys) >= self.capacity:
            for key in [k for k, j in self._journeys.items() if j.terminal]:
                if len(self._journeys) < self.capacity:
                    break
                del self._journeys[key]
                self.evicted += 1
        j = Journey(rid, tenant, self.max_hops)
        self._journeys[rid] = j
        return j

    def on_event(self, rid: int, name: str, t: float, args) -> None:
        """The Tracer ``journal`` hook: fold one lifecycle event into the
        request's journey. Unknown rids (journey evicted, or tracing
        began before the book) and non-hop events are ignored."""
        j = self._journeys.get(rid)
        if j is None:
            return
        kind = _EVENT_KINDS.get(name)
        if kind is None:
            return
        args = args or {}
        if kind == "enqueue":
            j.enqueued_t = t
        elif kind == "admit" and j.admitted_t is None:
            j.admitted_t = t
            j.prefix_hit_tokens = int(args.get("cached_tokens", 0))
        elif kind == "first_token" and j.first_token_t is None:
            j.first_token_t = t
        elif kind == "preempt":
            j.preemptions += 1
        elif kind == "retire":
            j.state = args.get("state")
            j.tokens = int(args.get("tokens", 0))
            j.retired_t = t
        j._hop(kind, self._step_source(), t, dict(args))

    def get(self, rid: int) -> Journey | None:
        return self._journeys.get(rid)

    def journeys(self) -> list[Journey]:
        """Every retained journey, oldest first."""
        return list(self._journeys.values())

    def wire_records(self, limit: int | None = None) -> list[dict]:
        """The newest ``limit`` journeys as wire dicts (all when None) —
        what the flight recorder embeds."""
        out = [j.to_wire() for j in self._journeys.values()]
        return out[-limit:] if limit is not None else out

    def __len__(self) -> int:
        return len(self._journeys)


def validate_journey(record) -> dict:
    """Schema gate for one wire journey: raises ValueError naming the
    first violation; returns the record for chaining."""
    if not isinstance(record, dict):
        raise ValueError(
            f"journey must be a dict, got {type(record).__name__}")
    if record.get("schema") != JOURNEY_SCHEMA:
        raise ValueError(f"unknown journey schema {record.get('schema')!r} "
                         f"(expected {JOURNEY_SCHEMA!r})")
    for key, typ in _WIRE_KEYS:
        if key not in record:
            raise ValueError(f"journey missing key {key!r}")
        if typ is int and isinstance(record[key], bool):
            raise ValueError(f"journey key {key!r} must be int, got bool")
        if not isinstance(record[key], typ):
            raise ValueError(f"journey key {key!r} must be {typ.__name__},"
                             f" got {type(record[key]).__name__}")
    state = record.get("state")
    if state is not None and not isinstance(state, str):
        raise ValueError(f"journey state must be str or None, got "
                         f"{type(state).__name__}")
    for key in _WIRE_LATENCIES:
        if key not in record:
            raise ValueError(f"journey missing key {key!r}")
        v = record[key]
        if v is not None and not isinstance(v, (int, float)):
            raise ValueError(f"journey key {key!r} must be a number or "
                             f"None, got {type(v).__name__}")
    for hop in record["hops"]:
        if not isinstance(hop, dict):
            raise ValueError(f"journey hop must be a dict: {hop!r}")
        for field in ("kind", "step", "t"):
            if field not in hop:
                raise ValueError(f"journey hop missing {field!r}: {hop}")
        if hop["kind"] not in JOURNEY_KINDS:
            raise ValueError(f"unknown journey hop kind {hop['kind']!r}")
    return record


def format_journey(record: dict) -> str:
    """Human-readable rendering of one (validated) wire journey — the
    CLI's ``--journey RID`` view: header, latency line, hop table."""
    def fmt(v):
        return f"{v:.6f}" if isinstance(v, (int, float)) else "-"

    lines = [f"journey rid={record['rid']} tenant={record['tenant']} "
             f"state={record['state'] or 'in-flight'} "
             f"tokens={record['tokens']} "
             f"preemptions={record['preemptions']}",
             f"queue_delay={fmt(record['queue_delay_s'])}s "
             f"ttft={fmt(record['ttft_s'])}s "
             f"tpot={fmt(record['tpot_s'])}s "
             f"e2e={fmt(record['e2e_s'])}s "
             f"prefix_hit_tokens={record['prefix_hit_tokens']}",
             f"hops ({len(record['hops'])}"
             + (f", {record['dropped_hops']} dropped" if
                record["dropped_hops"] else "") + "):"]
    for hop in record["hops"]:
        extra = ", ".join(f"{k}={v}" for k, v in sorted(hop.items())
                          if k not in ("kind", "step", "t"))
        lines.append(f"  step {hop['step']:>6} t={hop['t']:<12.6f} "
                     f"{hop['kind']:<14}" + (f" {extra}" if extra else ""))
    return "\n".join(lines)
