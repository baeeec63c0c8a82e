"""Per-request lifecycle tracing for the serving engine — the port of
``paddle_tpu/obs/trace.py``.

A :class:`RequestTrace` is an append-only list of ``(event, timestamp,
args)`` triples covering one request's whole life — enqueued, admitted,
prefill_start/prefill_end (with a ``prefill_chunk`` per chunk in between
under chunked prefill — TTFT stays anchored to ``first_token``, which
only the FINAL chunk emits), first_token, periodic decode_mark, preempted /
swap_out / swap_in / resumed, host-tier ``spill`` / ``restore`` (prefix
pages this admission pushed to or pulled from the host cache tier), and a
terminal ``retired`` carrying the final state
(finished/cancelled/expired/failed/shed). Timestamps come from the
ENGINE clock (``ServingConfig(clock=)`` + fault skew), never from the wall
clock directly: every trace behavior is testable sleep-free with a virtual
clock, and the ``slow_step`` fault's skew shows up in traces exactly like
it does in deadlines.

The :class:`Tracer` is the engine-owned store (rid -> trace). Contracts:

- **O(1) per event**: an event is one dict lookup + one list append; no
  summarization happens on the hot path. Summaries (queue_wait, prefill
  time, TTFT, TPOT, e2e) are computed on demand from the raw events.
- **Bounded memory**: retention returns to ``capacity`` whenever traces
  are available to evict — oldest TERMINAL first; live requests always
  keep their traces (truncating an in-flight trace would fabricate a
  lifecycle), so an all-live burst may transiently exceed the bound and
  is reclaimed as those requests retire.
- **Preemption-resumable**: a preempted request's trace keeps
  accumulating through re-admission — a recompute victim shows a second
  ``prefill_start``, a swap victim shows ``swap_in``/``resumed`` — so the
  summary's TTFT stays anchored to the FIRST token the client ever saw.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass

__all__ = ["TraceEvent", "RequestTrace", "Tracer"]

# terminal event name; its ``state`` arg is the request's final state
RETIRED = "retired"


@dataclass(frozen=True)
class TraceEvent:
    name: str
    t: float  # engine-clock seconds
    args: dict | None = None

    def arg(self, key, default=None):
        return self.args.get(key, default) if self.args else default


class RequestTrace:
    """One request's lifecycle: ordered events + derived latency summary."""

    __slots__ = ("rid", "events", "state")

    def __init__(self, rid: int):
        self.rid = rid
        self.events: list[TraceEvent] = []
        self.state: str | None = None  # terminal state once retired

    def add(self, name: str, t: float, args: dict | None = None) -> None:
        self.events.append(TraceEvent(name, t, args))
        if name == RETIRED:
            self.state = args.get("state") if args else None

    @property
    def terminal(self) -> bool:
        return self.state is not None

    def first(self, name: str) -> TraceEvent | None:
        return next((e for e in self.events if e.name == name), None)

    def last(self, name: str) -> TraceEvent | None:
        return next((e for e in reversed(self.events) if e.name == name),
                    None)

    def count(self, name: str) -> int:
        return sum(1 for e in self.events if e.name == name)

    def summary(self) -> dict:
        """The latency decomposition (seconds; None when the lifecycle
        never reached the relevant milestone — e.g. TTFT of a request
        cancelled while waiting):

        - ``queue_wait``: enqueued -> FIRST admission,
        - ``prefill_time``: first prefill_start -> first prefill_end,
        - ``ttft``: enqueued -> first_token (time to first token),
        - ``tpot``: (last token - first token) / (tokens - 1) — mean
          client-observed time per output token (preemption stalls
          included, as the client experiences them); FINISHED requests
          with >= 2 tokens only — a cancelled/expired retirement can
          happen arbitrarily long after the last token was produced, so
          its retirement time says nothing about decode speed,
        - ``e2e``: enqueued -> retired,

        plus ``state``, ``tokens`` (generated count at retirement),
        ``preemptions``, ``cached_tokens`` (prefix-cache hit width), and
        ``prefill_chunks`` (chunked-prefill chunk count; 0 unchunked).
        """
        enq = self.first("enqueued")
        adm = self.first("admitted")
        ps, pe = self.first("prefill_start"), self.first("prefill_end")
        ft = self.first("first_token")
        ret = self.last(RETIRED)
        tokens = ret.arg("tokens", 0) if ret else 0

        def dt(a, b):
            return b.t - a.t if a is not None and b is not None else None

        tpot = None
        if ft is not None and ret is not None and tokens and tokens > 1 \
                and ret.arg("state") == "finished":
            # the final token lands in the same step boundary that retires
            # a FINISHED request, so retirement time IS last-token time;
            # any other terminal state retires at some later sweep and
            # would smear queue/swap wait into the per-token figure
            tpot = (ret.t - ft.t) / (tokens - 1)
        return {
            "rid": self.rid,
            "state": self.state,
            "tokens": tokens,
            "queue_wait": dt(enq, adm),
            "prefill_time": dt(ps, pe),
            "ttft": dt(enq, ft),
            "tpot": tpot,
            "e2e": dt(enq, ret),
            "preemptions": self.count("preempted"),
            "cached_tokens": ps.arg("cached", 0) if ps else 0,
            "prefill_chunks": self.count("prefill_chunk"),
        }

    def __repr__(self) -> str:
        names = [e.name for e in self.events]
        return f"RequestTrace(rid={self.rid}, state={self.state}, {names})"


class Tracer:
    """Engine-owned trace store. Every mutation is O(1); eviction only
    runs at trace creation and only removes terminal traces."""

    def __init__(self, clock, capacity: int = 2048, mark_every: int = 32):
        if capacity < 1:
            raise ValueError(f"capacity {capacity} < 1")
        if mark_every < 1:
            raise ValueError(f"mark_every {mark_every} < 1")
        self._clock = clock
        self.capacity = capacity
        self.mark_every = mark_every  # decode_mark cadence, in tokens
        self._traces: OrderedDict[int, RequestTrace] = OrderedDict()
        self.evicted = 0
        # optional event-stream tap: a callable(rid, name, t, args) every
        # event ALSO flows through — the journey book subscribes here, so
        # journeys fold over the exact stream the traces record with zero
        # new instrumentation sites (and one attribute check when unset)
        self.journal = None

    def begin(self, rid: int) -> RequestTrace:
        """Create the trace for a new request and stamp ``enqueued``.
        Evicts oldest-first TERMINAL traces until the store is back under
        ``capacity`` — an all-live burst may grow past the bound rather
        than corrupt an in-flight lifecycle, but the store returns to
        ``capacity`` as soon as enough of those traces retire."""
        if len(self._traces) >= self.capacity:
            for key in [k for k, t in self._traces.items() if t.terminal]:
                if len(self._traces) < self.capacity:
                    break
                del self._traces[key]
                self.evicted += 1
        trace = RequestTrace(rid)
        self._traces[rid] = trace
        t = self._clock()
        trace.add("enqueued", t)
        j = self.journal
        if j is not None:
            j(rid, "enqueued", t, None)
        return trace

    def event(self, rid: int, name: str, **args) -> None:
        """Append one timestamped event — a dict lookup and a list append.
        Unknown rids are ignored (the trace was evicted under memory
        pressure; dropping a late event beats unbounded retention)."""
        trace = self._traces.get(rid)
        if trace is not None:
            t = self._clock()
            trace.add(name, t, args or None)
            j = self.journal
            if j is not None:
                j(rid, name, t, args)

    def get(self, rid: int) -> RequestTrace | None:
        return self._traces.get(rid)

    def traces(self) -> list[RequestTrace]:
        """Every retained trace, oldest first."""
        return list(self._traces.values())

    def summaries(self) -> list[dict]:
        return [t.summary() for t in self._traces.values()]

    def __len__(self) -> int:
        return len(self._traces)
