"""Deterministic fault injection for the serving engine, the fleet router
and its transport — the port of ``paddle_tpu/serving/faults.py``.

The engine consults an installed :class:`FaultInjector` at its step
boundaries — named points, matched by (point, step index, request id):

- ``prefill_fail``   a request's prefill fails: it retires FAILED (its
  admission undone, slot and pages freed) before the prefill runs;
- ``chunk_fail``     a chunked prefill fails mid-stream, consulted before
  every chunk: the request retires FAILED with part of its prompt's KV
  resident, its pages drain, the rest of the batch goes on this step;
- ``decode_fail``    decoding a request fails: only it retires FAILED; the
  rest of the batch decodes this very step;
- ``verify_fail``    a request's speculative verify fails (consulted
  before the verify): it retires FAILED, its pages, the speculative
  reserve included, drain, and the survivors verify this step;
- ``pool_exhausted`` the page pool runs dry before a decode step: the
  scheduler's victim policy preempts one running request (recompute or
  swap per the engine's configuration);
- ``restore_fail``   a host-tier prefix restore fails mid-admission
  (``host_tier_bytes > 0``): the cache consults it right before the copy,
  the admission is undone, and the request retires FAILED;
- ``slow_step``      advances the engine's virtual clock by ``delay_s``
  without sleeping, so deadlines and ``run(budget_s=)`` are testable.

Every fault fires before the state change it poisons, so the host state
after a fault is the pre-step state minus the retired request. Without an
injector the engine pays one attribute lookup per step.

Two fleet-grain points consulted by the router (:mod:`.fleet`), not the
engine — install the injector on the ``FleetRouter`` for these:

- ``route_fail``     a request's routing decision fails: the router sheds
  it at once (SHED, a clean journey in the router's own book);
- ``replica_down``   a replica dies at a step boundary; ``rid`` carries
  the REPLICA INDEX. Its never-admitted waiters re-route to survivors as
  spills, its in-flight requests retire FAILED.

Four wire-grain points consulted by the transport (:mod:`.channel`) per
attempt, once the router has attached its injector to it:

- ``wire_drop``      every frame of one attempt vanishes (matched by the
  rid the exchange serves; ``rid=None`` arms hit gossip too);
- ``wire_corrupt``   one frame of the attempt is bit-flipped: a typed
  WireError, counted by kind, and a retry;
- ``wire_delay``     the attempt's arrival latency grows by ``delay_s``
  virtual seconds;
- ``peer_timeout``   the attempt times out; ``rid`` carries the PEER
  index.

"""
from __future__ import annotations

from dataclasses import dataclass, field

POINTS = ("prefill_fail", "chunk_fail", "decode_fail", "verify_fail",
          "pool_exhausted", "restore_fail", "slow_step",
          "route_fail", "replica_down",
          "wire_drop", "wire_corrupt", "wire_delay", "peer_timeout")

__all__ = ["POINTS", "InjectedFault", "FaultInjector"]


class InjectedFault(RuntimeError):
    """The exception an armed fail point raises; the engine records it on
    the affected request (``Request.error``) and keeps serving the rest."""


@dataclass
class _Arm:
    point: str
    step: int | None  # None -> any step
    rid: int | None   # None -> any request (first consulted wins)
    times: int        # remaining firings; -1 -> unlimited
    delay_s: float    # slow_step only: virtual seconds to add


@dataclass
class FaultInjector:
    """A deterministic schedule of faults. ``arm`` registers a fault;
    ``hit`` is the engine-side consult (matches, decrements, records)."""

    _arms: list[_Arm] = field(default_factory=list)
    fired: list[tuple[str, int, int | None]] = field(default_factory=list)

    def arm(self, point: str, *, step: int | None = None,
            rid: int | None = None, times: int = 1,
            delay_s: float = 0.0) -> "FaultInjector":
        if point not in POINTS:
            raise ValueError(f"unknown fault point {point!r}; one of {POINTS}")
        if times == 0 or times < -1:
            raise ValueError(f"times must be positive or -1 (unlimited), "
                             f"got {times}")
        self._arms.append(_Arm(point, step, rid, times, float(delay_s)))
        return self  # chainable: inj.arm(...).arm(...)

    def hit(self, point: str, *, step: int,
            rid: int | None = None) -> _Arm | None:
        """First matching armed fault, or None. Matching consumes one
        firing and appends (point, step, rid) to ``fired``."""
        for arm in self._arms:
            if arm.point != point or arm.times == 0:
                continue
            if arm.step is not None and arm.step != step:
                continue
            if arm.rid is not None and arm.rid != rid:
                continue
            if arm.times > 0:
                arm.times -= 1
            self.fired.append((point, step, rid))
            return arm
        return None
