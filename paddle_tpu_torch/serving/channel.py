"""Deterministic lossy channel + the fault-tolerant Transport policy — the
port of ``paddle_tpu/serving/channel.py``, pure host Python: the same
seeded fates frame by frame, the same backoff, breaker and timeline.

Two layers, both sleep-free and fully seeded, so every network failure
mode the fleet must survive is reproducible in a CPU test:

:class:`SimChannel` is the physics: a seeded lossy / corrupting /
duplicating / reordering / latent pipe. ``transfer(peer, frames)``
decides each frame's fate from an FNV-1a hash stream over (seed, frame
counter) — the same seed always drops/corrupts the same frames, so a
chaos run is a replayable artifact, not an anecdote. A default-config
channel is **lossless and order-preserving**: bytes out == bytes in.

:class:`Transport` is the policy: per-peer timeouts, bounded retries
with exponential backoff and deterministic jitter, optional hedged
reads (two independent channel copies per attempt — first complete set
wins, the hedge win counted), and a per-peer circuit breaker
(closed → open after ``breaker_threshold`` consecutive failed
exchanges → half-open after ``breaker_reset_s`` → closed on the next
success, re-open on the next failure). Frame decode happens INSIDE the
retry loop through :func:`.wire.decode_frame`, so a
corrupt frame is counted by kind and retried like a lost one — no
:class:`.wire.WireError` ever raises past
``exchange()``; the caller sees decoded values or ``None``.

Time: the transport runs its OWN deterministic timeline (``t``,
seconds, advanced by channel latency and backoff — never a sleep).
It deliberately does NOT read the engine clock: engine time drives
deadlines and SLO classes, and a transport that consumed engine-clock
reads would make a lossless-channel fleet time-skewed against the
in-process fleet — the bit-identical parity pin forbids exactly that.
Breaker open/half-open/closed transitions are stamped on this timeline
(``breaker_events``) and exported as Chrome instants by the fleet.

Fault points (:mod:`.faults`, consulted on the injector the router
attaches): ``wire_drop`` / ``wire_corrupt`` / ``wire_delay`` (matched
by the request id the exchange is serving, None for gossip) and
``peer_timeout`` (matched by PEER index, like ``replica_down``). They
compose with the channel's own seeded loss — a fault-point drop and a
channel drop are indistinguishable to the policy layer, by design.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field

from .wire import WireError, decode_frame

__all__ = ["ChannelConfig", "SimChannel", "TransportConfig",
           "CircuitBreaker", "Transport", "ExchangeInfo"]

# FNV-1a constants (shared idiom with kv_cache.prefix_digest — explicit
# constants because python's hash() is process-salted and could never
# reproduce a chaos schedule across runs)
_FNV_SEED = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK = (1 << 64) - 1


def unit_hash(*salts: int) -> float:
    """Deterministic uniform-ish value in [0, 1) from integer salts —
    the one randomness source for channels, jitter, and chaos
    schedules."""
    h = _FNV_SEED
    for s in salts:
        s = int(s) & _MASK
        for shift in (0, 8, 16, 24, 32, 40, 48, 56):
            h ^= (s >> shift) & 0xFF
            h = (h * _FNV_PRIME) & _MASK
    return h / float(1 << 64)


@dataclass(frozen=True)
class ChannelConfig:
    """The physics knobs. All-zero rates (the default) is the lossless
    channel the parity pin runs over."""

    seed: int = 0
    drop_rate: float = 0.0      # P(frame vanishes)
    corrupt_rate: float = 0.0   # P(one byte flips or the tail is cut)
    dup_rate: float = 0.0       # P(frame arrives twice)
    reorder_rate: float = 0.0   # P(adjacent arrivals swap)
    latency_s: float = 0.0      # base one-way latency per transfer
    jitter_s: float = 0.0       # extra seeded latency, uniform [0, j)

    def validate(self) -> None:
        for name in ("drop_rate", "corrupt_rate", "dup_rate",
                     "reorder_rate"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} {v} not in [0, 1]")
        if self.latency_s < 0 or self.jitter_s < 0:
            raise ValueError("latency_s/jitter_s must be >= 0")


class SimChannel:
    """Seeded lossy pipe. ``transfer`` maps frames to (latency, bytes)
    arrivals, already in arrival order; loss drops the tuple, corruption
    rewrites the bytes (flip a byte, or truncate the tail — both decode
    to typed WireErrors downstream), duplication emits the frame twice.
    Purely host-side, no clock reads — latency is REPORTED, the
    transport accrues it."""

    def __init__(self, config: ChannelConfig | None = None):
        self.config = config or ChannelConfig()
        self.config.validate()
        self._n = itertools.count()
        self.sent = 0
        self.delivered = 0
        self.dropped = 0
        self.corrupted = 0
        self.duplicated = 0
        self.reordered = 0

    def _unit(self, seqno: int, salt: int) -> float:
        return unit_hash(self.config.seed, seqno, salt)

    def _mangle(self, data: bytes, seqno: int) -> bytes:
        """One corruption: flip a seeded byte, or cut the tail — the
        two shapes the WireError taxonomy distinguishes."""
        self.corrupted += 1
        if not data:
            return data
        if self._unit(seqno, 3) < 0.5:
            at = int(self._unit(seqno, 4) * len(data))
            return data[:at] + bytes([data[at] ^ 0xA5]) + data[at + 1:]
        keep = int(self._unit(seqno, 5) * len(data))
        return data[:keep]

    def transfer(self, peer: int, frames) -> list[tuple[float, bytes]]:
        """Push ``frames`` toward ``peer``; returns ``(latency_s,
        bytes)`` arrivals in arrival order."""
        c = self.config
        arrivals: list[tuple[float, bytes]] = []
        for data in frames:
            seqno = next(self._n)
            self.sent += 1
            if self._unit(seqno, 0) < c.drop_rate:
                self.dropped += 1
                continue
            if self._unit(seqno, 1) < c.corrupt_rate:
                data = self._mangle(data, seqno)
            lat = c.latency_s + c.jitter_s * self._unit(seqno, 6)
            arrivals.append((lat, data))
            if self._unit(seqno, 2) < c.dup_rate:
                self.duplicated += 1
                arrivals.append((lat + c.jitter_s
                                 * self._unit(seqno, 7), data))
        arrivals.sort(key=lambda a: a[0])
        for i in range(len(arrivals) - 1):
            seqno = next(self._n)
            if self._unit(seqno, 8) < c.reorder_rate:
                arrivals[i], arrivals[i + 1] = arrivals[i + 1], arrivals[i]
                self.reordered += 1
        self.delivered += len(arrivals)
        return arrivals


@dataclass(frozen=True)
class TransportConfig:
    """The policy knobs (see the README knob table)."""

    timeout_s: float = 0.05      # per-attempt arrival deadline
    retries: int = 3             # retry budget per exchange (attempts-1)
    backoff_s: float = 0.01      # base backoff before retry k: base*2^k
    backoff_max_s: float = 1.0   # backoff ceiling
    jitter_frac: float = 0.5     # backoff *= 1 + frac*unit(seed,peer,k)
    hedge: bool = False          # hedged reads for page fetches
    breaker_threshold: int = 3   # consecutive failed exchanges to open
    breaker_reset_s: float = 1.0  # open -> half-open probe delay
    seed: int = 0                # jitter stream seed

    def validate(self) -> None:
        if self.timeout_s <= 0:
            raise ValueError(f"timeout_s {self.timeout_s} <= 0")
        if self.retries < 0:
            raise ValueError(f"retries {self.retries} < 0")
        if self.backoff_s < 0 or self.backoff_max_s < self.backoff_s:
            raise ValueError(
                f"backoff_s {self.backoff_s} must be >= 0 and <= "
                f"backoff_max_s {self.backoff_max_s}")
        if self.jitter_frac < 0:
            raise ValueError(f"jitter_frac {self.jitter_frac} < 0")
        if self.breaker_threshold < 1:
            raise ValueError(
                f"breaker_threshold {self.breaker_threshold} < 1")
        if self.breaker_reset_s <= 0:
            raise ValueError(
                f"breaker_reset_s {self.breaker_reset_s} <= 0")


class CircuitBreaker:
    """Per-peer closed/open/half-open state machine on the transport
    timeline. Outcomes are per EXCHANGE (post-retry), not per attempt —
    a peer that needs one retry per exchange is degraded, not dead, and
    must not trip the breaker."""

    def __init__(self, threshold: int, reset_s: float):
        self.threshold = threshold
        self.reset_s = reset_s
        self.state = "closed"
        self.failures = 0
        self.opened_t = 0.0

    def allow(self, now: float) -> bool:
        """May an exchange start now? An open breaker past its reset
        delay transitions to half-open and admits ONE probe."""
        if self.state == "open" and now >= self.opened_t + self.reset_s:
            self.state = "half_open"
        return self.state != "open"

    def blocked(self, now: float) -> bool:
        """Read-only: is the peer currently unreachable? (No state
        transition — the router's affinity degrade polls this every
        placement.)"""
        return self.state == "open" \
            and now < self.opened_t + self.reset_s

    def on_success(self) -> bool:
        """Exchange succeeded; True when this CLOSED a half-open
        breaker (a transition worth an event)."""
        reopened = self.state == "half_open"
        self.state = "closed"
        self.failures = 0
        return reopened

    def on_failure(self, now: float) -> bool:
        """Exchange failed (out of retries); True when this OPENED the
        breaker."""
        self.failures += 1
        if self.state == "half_open" or self.failures >= self.threshold:
            self.state = "open"
            self.opened_t = now
            return True
        return False


@dataclass
class ExchangeInfo:
    """What one ``exchange()`` went through — the router reads this to
    stamp journey hops (wire_retry / breaker_open) after dispatch and
    to feed the per-peer transport families (``serving_wire_rtt_s`` /
    ``serving_wire_attempts`` / ``serving_wire_bytes_total``)."""

    ok: bool = False
    retries: int = 0
    timeouts: int = 0
    corrupt: int = 0
    hedge_win: bool = False
    breaker_open: bool = False
    latency_s: float = 0.0
    peer: int = -1
    span: int | None = None       # fleetscope span id riding the frames
    attempts: int = 0             # copies actually sent (retries + 1)
    backoff_s: float = 0.0        # total backoff waited on the timeline
    tx_bytes: int = 0
    rx_bytes: int = 0
    t_start: float = 0.0          # transport-timeline bounds of the
    t_end: float = 0.0            # whole exchange (rtt = end - start)


@dataclass
class _Attempt:
    ok: bool = False
    latency_s: float = 0.0
    corrupt: int = 0
    timeout: bool = False
    values: list = field(default_factory=list)
    rx_bytes: int = 0


class Transport:
    """The fleet's one way to move bytes between replicas. Build it
    over a channel, let the router :meth:`attach` its metrics and fault
    injector, then ``exchange(peer, frames)`` -> decoded values or
    ``None`` (retries exhausted / breaker open) — the caller always
    degrades, never raises."""

    def __init__(self, channel: SimChannel | None = None,
                 config: TransportConfig | None = None):
        self.channel = channel or SimChannel()
        self.config = config or TransportConfig()
        self.config.validate()
        self.t = 0.0  # the transport timeline (see module docstring)
        self.metrics = None
        self.injector = None
        self.scope = None  # FleetScope (obs.fleetscope) or None
        self.breakers: dict[int, CircuitBreaker] = {}
        #: (t, peer, state) per breaker transition — Chrome instants
        self.breaker_events: list[tuple[float, int, str]] = []
        self.last = ExchangeInfo()
        self.tx_bytes = 0
        self.rx_bytes = 0
        self.retries_total = 0
        self.timeouts_total = 0
        self.corrupt_total = 0
        self.hedge_wins_total = 0
        self.exchanges_total = 0

    def attach(self, metrics=None, injector=None,
               scope=None) -> "Transport":
        """Bind the router's ServingMetrics + FaultInjector (the wire_*
        / peer_timeout points are consulted on the latter) and,
        optionally, a fleetscope span recorder."""
        self.metrics = metrics
        self.injector = injector
        self.scope = scope
        return self

    # ------------------------------------------------------------ breaker
    def _breaker(self, peer: int) -> CircuitBreaker:
        br = self.breakers.get(peer)
        if br is None:
            br = self.breakers[peer] = CircuitBreaker(
                self.config.breaker_threshold,
                self.config.breaker_reset_s)
        return br

    def peer_open(self, peer: int) -> bool:
        """Is ``peer`` behind an open breaker right now? (The router
        degrades affinity routing for such peers — their gossip is
        stale by definition.)"""
        br = self.breakers.get(peer)
        return br is not None and br.blocked(self.t)

    def _transition(self, peer: int, state: str) -> None:
        self.breaker_events.append((self.t, peer, state))
        m = self.metrics
        if m is not None:
            # EVERY transition reaches the serving_breaker_state gauge
            # (closed/half_open/open as 0/1/2) — metering only the open
            # edge made the gauge skip the half_open -> closed recovery
            m.on_breaker_state(peer, state)
            if state == "open":
                m.on_breaker_open(peer)
        sc = self.scope
        if sc is not None and self.last.span is not None:
            sc.child(self.last.span, "breaker", self.t, self.t,
                     state=state, peer=peer)

    # ------------------------------------------------------------ attempt
    def backoff_for(self, peer: int, attempt: int) -> float:
        """Backoff before retry ``attempt`` (1-based): exponential with
        deterministic jitter, capped — golden-tested, so the formula is
        public."""
        c = self.config
        raw = c.backoff_s * (2.0 ** (attempt - 1)) \
            * (1.0 + c.jitter_frac * unit_hash(c.seed, peer, attempt))
        return min(raw, c.backoff_max_s)

    def _consult_faults(self, peer: int, rid, step: int):
        """(drop_all, corrupt_first, extra_delay_s, forced_timeout)
        from the armed fault points for this attempt."""
        inj = self.injector
        if inj is None:
            return (False, False, 0.0, False)
        timeout = inj.hit("peer_timeout", step=step, rid=peer) is not None
        drop = inj.hit("wire_drop", step=step, rid=rid) is not None
        corrupt = inj.hit("wire_corrupt", step=step, rid=rid) is not None
        delay = inj.hit("wire_delay", step=step, rid=rid)
        return (drop, corrupt,
                delay.delay_s if delay is not None else 0.0, timeout)

    def _one_copy(self, peer: int, frames: list, extra_delay: float,
                  want: int) -> _Attempt:
        """Send one copy of the frame set through the channel and
        evaluate it: complete iff ``want`` distinct frames decode
        cleanly within the timeout."""
        a = _Attempt()
        self.tx_bytes += sum(len(f) for f in frames)
        if self.metrics is not None:
            self.metrics.on_wire_tx(sum(len(f) for f in frames))
        arrivals = self.channel.transfer(peer, frames)
        lat = max((la for la, _ in arrivals), default=0.0) + extra_delay
        if not arrivals or lat > self.config.timeout_s:
            a.timeout = bool(arrivals)  # no arrivals at all is a loss,
            a.latency_s = self.config.timeout_s  # late arrivals a timeout
            return a
        a.latency_s = lat
        seen: set[bytes] = set()
        for _, data in arrivals:
            if data in seen:
                continue  # a duplicate of a frame already counted
            seen.add(data)
            try:
                a.values.append(decode_frame(data))
                a.rx_bytes += len(data)
            except WireError as e:
                a.corrupt += 1
                if self.metrics is not None:
                    self.metrics.on_wire_corrupt(e.kind)
        a.ok = len(a.values) == want
        return a

    # ----------------------------------------------------------- exchange
    def exchange(self, peer: int, frames, *, step: int = 0, rid=None,
                 hedge: bool | None = None, span=None):
        """Deliver ``frames`` to ``peer`` and decode what comes back:
        a list of ``(kind, value)`` in arrival order on success, None
        when the breaker is open or the retry budget runs out.
        ``self.last`` carries the attempt accounting either way.
        ``span`` is the fleetscope span id the frames were encoded
        under (None when fleetscope is off) — retry attempts, backoff
        waits, and breaker transitions become its child spans."""
        info = self.last = ExchangeInfo(peer=peer, span=span)
        info.t_start = self.t
        self.exchanges_total += 1
        m = self.metrics
        if m is not None:
            m.on_fleet_inflight(1)
        tx0, rx0 = self.tx_bytes, self.rx_bytes
        try:
            return self._exchange_body(peer, list(frames), step, rid,
                                       hedge, info)
        finally:
            info.t_end = self.t
            info.tx_bytes = self.tx_bytes - tx0
            info.rx_bytes = self.rx_bytes - rx0
            sc = self.scope
            if sc is not None and span is not None:
                sc.end(span, t=self.t, ok=info.ok,
                       retries=info.retries)
            if m is not None:
                m.on_fleet_inflight(-1)

    def _exchange_body(self, peer: int, frames: list, step: int, rid,
                       hedge, info: ExchangeInfo):
        c = self.config
        sc = self.scope

        def _attempt_span(t0: float, ok: bool, **kw) -> None:
            if sc is not None and info.span is not None:
                sc.child(info.span, "attempt", t0, self.t, ok=ok, **kw)

        if not frames:
            info.ok = True
            return []
        br = self._breaker(peer)
        if not br.allow(self.t):
            info.breaker_open = True
            return None
        if br.state == "half_open":
            self._transition(peer, "half_open")
        use_hedge = c.hedge if hedge is None else hedge
        for attempt in range(c.retries + 1):
            if attempt:
                wait = self.backoff_for(peer, attempt)
                t0 = self.t
                self.t += wait
                info.retries += 1
                info.backoff_s += wait
                self.retries_total += 1
                if self.metrics is not None:
                    self.metrics.on_wire_retry()
                if sc is not None and info.span is not None:
                    sc.child(info.span, "backoff", t0, self.t,
                             attempt=attempt)
            info.attempts += 1
            a0 = self.t
            drop, corrupt, extra_delay, forced_timeout = \
                self._consult_faults(peer, rid, step)
            if forced_timeout:
                self.t += c.timeout_s
                info.timeouts += 1
                self.timeouts_total += 1
                _attempt_span(a0, False, timeout=True)
                continue
            sent = frames
            if drop:
                sent = []
            elif corrupt and sent:
                flipped = bytearray(sent[0])
                flipped[len(flipped) // 2] ^= 0xA5
                sent = [bytes(flipped)] + sent[1:]
            tries = [self._one_copy(peer, sent, extra_delay,
                                    len(frames))]
            if use_hedge:
                tries.append(self._one_copy(peer, sent, extra_delay,
                                            len(frames)))
            info.corrupt += sum(t.corrupt for t in tries)
            self.corrupt_total += sum(t.corrupt for t in tries)
            done = [t for t in tries if t.ok]
            if done:
                best = min(done, key=lambda t: t.latency_s)
                if use_hedge and best is tries[-1] \
                        and (len(done) == 1 or best.latency_s
                             < tries[0].latency_s):
                    info.hedge_win = True
                    self.hedge_wins_total += 1
                    if self.metrics is not None:
                        self.metrics.on_wire_hedge_win()
                self.t += best.latency_s
                info.latency_s = best.latency_s
                self.rx_bytes += best.rx_bytes
                if self.metrics is not None:
                    self.metrics.on_wire_rx(best.rx_bytes)
                _attempt_span(a0, True)
                if br.on_success():
                    self._transition(peer, "closed")
                info.ok = True
                return best.values
            worst = max(t.latency_s for t in tries)
            self.t += worst
            timed_out = any(t.timeout for t in tries)
            if timed_out:
                info.timeouts += 1
                self.timeouts_total += 1
            _attempt_span(a0, False, timeout=timed_out,
                          corrupt=sum(t.corrupt for t in tries))
        if br.on_failure(self.t):
            self._transition(peer, "open")
        return None
