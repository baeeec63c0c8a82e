"""Admission + continuous batching scheduler (host side) — the port of
``paddle_tpu/serving/scheduler.py``.

FIFO admission with head-of-line order: a request is admitted only when a
decode slot and its prompt's pages are available, never out of arrival
order. One decode step serves every running slot. When the pool runs dry
mid-decode a running request is preempted — youngest first, sparing
requests prefilled (or swap-resumed) this very step while a seasoned
victim exists — in one of two modes (``preemption_mode``):

- ``recompute``: its pages are freed, its generated tokens dropped, and it
  requeues at the front to replay from prefill. The engine keys every
  sampled token by (seed, rid, token index), so the replay reproduces the
  tokens, sampled or greedy;
- ``swap``: its pages are copied to the host (``kv_cache.SwapHandle``) and
  it resumes later with its generated tokens intact.

Backpressure: ``max_waiting`` bounds the waiting queue (0 = unbounded). A
full queue rejects the newcomer (``shed_policy="reject"`` raises
:class:`EngineOverloaded`) or sheds the longest-waiting newcomer
(``"shed-oldest"``), returned to the caller marked SHED. Preemption
victims requeued at the front bypass the bound and are never shed: a
queue holding only victims rejects the newcomer under either policy.

Chunked prefill adds PREFILLING between admission and decode: the request
holds its slot and pages while its prompt streams through the prefill
step ``chunk_size`` tokens a step; ``Request.prefilled_tokens`` tracks the
progress (kept across a swap, reset by a recompute). Speculative decoding
sets ``decode_reserve`` to its depth K: a verify step writes K candidate
tokens past the resident ones, so admission and growth reserve them.

Under SLO degradation the engine passes ``admit(prefer_cached=True)``,
which relaxes strict FIFO to prefer waiters with warm prefix-cache hits
(their uncached tail is cheap): preemption victims still go first, cold
waiters never reorder among themselves, and a head skipped
``HEAD_SKIP_LIMIT`` times in a row is admitted next. With a ``tracer``
(the engine's ``obs.Tracer``) the scheduler stamps the lifecycle events
it owns: ``spill``, ``restore`` and ``admitted`` at admission,
``preempted`` and ``swap_out`` at preemption.

Prefix caching changes the accounting, not the policy: admission is
costed in unique pages (a cached prefix is mapped by refcount bump), and
admission-time validation guarantees every accepted request can finish
with the pool to itself, so the preempt-retry loop terminates. A request
whose host-tier restore fails at admission (``HostTierRestoreError``: the
cache undid the admission) stays queued and is recorded; the engine
retires it FAILED.
"""
from __future__ import annotations

import itertools
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from .kv_cache import HostTierRestoreError, PagedKVCache

WAITING, RUNNING, FINISHED = "waiting", "running", "finished"
CANCELLED, FAILED, EXPIRED, SHED = "cancelled", "failed", "expired", "shed"
# admitted (slot + pages held), prompt still streaming through the prefill
# step; treated like RUNNING for eviction, deadlines and preemption
PREFILLING = "prefilling"

__all__ = ["WAITING", "RUNNING", "FINISHED", "CANCELLED", "FAILED",
           "EXPIRED", "SHED", "PREFILLING", "EngineOverloaded", "Request",
           "Scheduler"]

_rid_counter = itertools.count()


class EngineOverloaded(RuntimeError):
    """Admission refused: the bounded waiting queue is full and the shed
    policy is "reject". The caller should back off and retry."""


@dataclass(eq=False)  # identity semantics: requests are entities
class Request:
    prompt: np.ndarray  # [prompt_len] int
    max_new_tokens: int
    rid: int = field(default_factory=lambda: next(_rid_counter))
    state: str = WAITING
    slot: int | None = None
    generated: list = field(default_factory=list)
    preemptions: int = 0
    admit_seq: int = -1  # admission order stamp (preemption victim = max)
    deadline: float | None = None  # absolute engine-clock time; None = never
    error: BaseException | None = None  # why a FAILED request failed
    swap: object | None = None  # kv_cache.SwapHandle while swapped out
    fresh: bool = False  # prefilled/swap-resumed this step, no decode yet
    cached_tokens: int = 0  # prompt tokens served from the prefix cache
    # prompt tokens with KV resident (chunked prefill progress, the cached
    # prefix included): kept across a swap, reset by a recompute
    prefilled_tokens: int = 0
    # the prefix-cache hit at this prefill attempt's start (a swap restore
    # zeroes cached_tokens; this survives it for the hit accounting)
    prefix_hit_tokens: int = 0
    resumed_from_swap: bool = False  # set by admit(), cleared by the engine
    # the request's SLO/traffic class (obs/tenant.py): a label only —
    # admission and scheduling never read it
    tenant: str = "default"
    # tokens this request ever emitted, tokens a recompute preemption
    # dropped and replayed included: the tenant ledger accrues it, so its
    # totals reconcile with serving_tokens_total
    tokens_emitted: int = 0

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def tokens_resident(self) -> int:
        """Tokens whose KV lives in the cache: prompt + generated (each
        generated token's KV is written by the decode step consuming it)."""
        return self.prompt_len + len(self.generated)

    def output(self) -> np.ndarray:
        return np.concatenate(
            [self.prompt, np.asarray(self.generated, dtype=self.prompt.dtype)])


class Scheduler:
    def __init__(self, cache: PagedKVCache, max_batch: int,
                 max_waiting: int = 0, shed_policy: str = "reject",
                 preemption_mode: str = "recompute", tracer=None):
        if shed_policy not in ("reject", "shed-oldest"):
            raise ValueError(f"shed_policy {shed_policy!r} not in "
                             f"('reject', 'shed-oldest')")
        if preemption_mode not in ("recompute", "swap"):
            raise ValueError(f"preemption_mode {preemption_mode!r} not in "
                             f"('recompute', 'swap')")
        if max_waiting < 0:
            raise ValueError(f"max_waiting {max_waiting} < 0")
        self.cache = cache
        self.max_batch = max_batch
        self.max_waiting = max_waiting
        self.shed_policy = shed_policy
        self.preemption_mode = preemption_mode
        self._tracer = tracer  # obs.Tracer or None
        self.waiting: deque[Request] = deque()
        self.running: dict[int, Request] = {}  # slot -> Request
        self._free_slots = list(range(max_batch - 1, -1, -1))  # pop() -> 0,1,..
        self._admit_seq = itertools.count()
        self.preemption_count = 0
        # extra token capacity a decoding slot holds past tokens_resident:
        # the speculative depth K (0 = plain decode)
        self.decode_reserve = 0
        self._head_skips = 0  # prefer_cached: consecutive skips of the head
        # (request, error) of admissions whose host-tier restore failed
        self.restore_failures: list[tuple[Request, HostTierRestoreError]] = []

    # ------------------------------------------------------------ admission
    @property
    def queue_depth(self) -> int:
        return len(self.waiting)

    @property
    def all_done(self) -> bool:
        return not self.waiting and not self.running

    @property
    def inflight_waiting(self) -> int:
        """Preempted requests in the waiting queue: work a paused drain
        must still finish."""
        return sum(r.preemptions > 0 for r in self.waiting)

    def add(self, req: Request) -> Request | None:
        """Queue a request; returns the request this admission shed (state
        SHED), or None. Raises ValueError when it could never fit (the
        speculative reserve included) and EngineOverloaded when the queue
        is full under "reject" or holds only preemption victims."""
        total = req.prompt_len + req.max_new_tokens + self.decode_reserve
        if not self.cache.fits_ever(total):
            raise ValueError(
                f"request {req.rid}: {total} tokens can never fit "
                f"(max {self.cache.cfg.max_tokens_per_seq} per sequence, "
                f"{self.cache.cfg.usable_pages} usable pages"
                + (f", incl. the speculative decode reserve of "
                   f"{self.decode_reserve}" if self.decode_reserve else "")
                + ")")
        shed = None
        if self.max_waiting and len(self.waiting) >= self.max_waiting:
            if self.shed_policy == "reject":
                raise EngineOverloaded(
                    f"waiting queue full ({self.max_waiting}); request "
                    f"{req.rid} rejected")
            # the longest-waiting newcomer yields; preemption victims are
            # in-flight work and never shed
            shed = next((r for r in self.waiting if r.preemptions == 0),
                        None)
            if shed is None:
                raise EngineOverloaded(
                    f"waiting queue full ({self.max_waiting}) with only "
                    f"preempted in-flight requests; request {req.rid} "
                    f"rejected")
            self.waiting.remove(shed)
            shed.state, shed.swap = SHED, None
        req.state = WAITING
        self.waiting.append(req)
        return shed

    #: consecutive times a warm waiter may jump the same queue head under
    #: prefer_cached before the head is admitted next
    HEAD_SKIP_LIMIT = 16

    def _next_waiter(self, prefer_cached: bool, probe: dict) -> Request:
        """The next admission candidate: the FIFO head, or under
        ``prefer_cached`` the warm waiter (non-empty prefix-cache hit)
        with the fewest uncached tokens, earliest first. A preemption
        victim at the head always goes first, as does a head skipped
        ``HEAD_SKIP_LIMIT`` times in a row. ``probe`` memoizes the
        per-waiter probes for one admit() call."""
        head = self.waiting[0]
        if not prefer_cached or head.preemptions > 0:
            return head
        if self._head_skips >= self.HEAD_SKIP_LIMIT:
            self._head_skips = 0
            return head
        best, best_key = head, None
        for i, r in enumerate(self.waiting):
            if r.rid not in probe:
                probe[r.rid] = self.cache.cached_prefix_tokens(r.prompt)
            cached = probe[r.rid]
            if cached <= 0:  # cold: only eligible as the FIFO head
                continue
            key = (r.prompt_len - cached, i)
            if best_key is None or key < best_key:
                best, best_key = r, key
        if best is not head:
            self._head_skips += 1
        else:
            self._head_skips = 0
        return best

    def admit(self, resume_only: bool = False,
              prefer_cached: bool = False) -> list[Request]:
        """Admit waiting requests into free slots while pages are
        available; the first that does not fit blocks the queue, as does
        one whose host-tier restore failed (recorded in
        ``restore_failures``). A swapped-out request gets its handle's
        pages restored instead of prompt pages. ``resume_only`` admits
        preemption victims only (a paused drain); ``prefer_cached`` (the
        SLO controller's degraded mode) prefers warm waiters, see
        ``_next_waiter``."""
        admitted = []
        tr = self._tracer
        probe: dict[int, int] = {}  # rid -> cached tokens, this call
        while self.waiting and self._free_slots:
            req = self._next_waiter(prefer_cached, probe)
            if resume_only and req.preemptions == 0:
                break
            slot = self._free_slots[-1]
            spills0 = self.cache.spills
            if req.swap is not None:
                if not self.cache.swap_in(slot, req.swap):
                    break
                req.swap = None
                req.cached_tokens = 0
                req.resumed_from_swap = True
            else:
                try:
                    ok = self.cache.admit(slot, req.prompt_len,
                                          tokens=req.prompt, rid=req.rid)
                except HostTierRestoreError as e:
                    self.restore_failures.append((req, e))
                    break
                if not ok:
                    break
                req.cached_tokens = self.cache.cached_tokens(slot)
            self._free_slots.pop()
            if self.waiting[0] is req:
                self.waiting.popleft()
            else:  # prefer_cached picked past the head
                self.waiting.remove(req)
            req.state, req.slot = RUNNING, slot
            req.admit_seq = next(self._admit_seq)
            self.running[slot] = req
            admitted.append(req)
            if tr is not None:
                # chronological: the spills this admission's allocation
                # forced, the pages restored into it, the admission
                spilled = self.cache.spills - spills0
                if spilled:
                    tr.event(req.rid, "spill", pages=spilled)
                restored = self.cache.restored_pages(slot)
                if restored:
                    tr.event(req.rid, "restore", pages=restored)
                tr.event(req.rid, "admitted", slot=slot,
                         cached_tokens=req.cached_tokens)
        return admitted

    def pop_restore_failures(self) -> list[tuple[Request,
                                                 HostTierRestoreError]]:
        """Drain the (request, error) pairs of failed restores."""
        out, self.restore_failures = self.restore_failures, []
        return out

    # ------------------------------------------------------------- decoding
    def pick_victim(self) -> Request:
        """Youngest admitted, among requests that have decoded at least
        once when any exist."""
        seasoned = [r for r in self.running.values() if not r.fresh]
        pool = seasoned or list(self.running.values())
        return max(pool, key=lambda r: r.admit_seq)

    def ensure_decode_pages(self) -> list[tuple[Request, int]]:
        """Before a decode step every decoding slot writes the KV of its
        last generated token at position ``tokens_resident - 1`` (plus
        ``decode_reserve`` candidates after it), so it needs capacity for
        ``tokens_resident + decode_reserve`` tokens; a PREFILLING request
        already holds its prompt's pages. Preempts per ``pick_victim``
        until the survivors fit; returns the (request, vacated slot)
        pairs."""
        preempted = []
        for slot in sorted(self.running,
                           key=lambda s: self.running[s].admit_seq):
            req = self.running.get(slot)
            if req is None:  # already preempted this round
                continue
            reserve = self.decode_reserve if req.state != PREFILLING else 0
            while req.slot is not None and not self.cache.grow(
                    slot, req.tokens_resident + reserve):
                victim = self.pick_victim()
                preempted.append((victim, self.preempt(victim)))
                # fits_ever() at admission guarantees a lone request can
                # always grow, so this loop terminates
        return preempted

    def preempt(self, req: Request) -> int:
        """Preempt a running request per ``preemption_mode`` and requeue it
        at the front. Returns the vacated slot."""
        slot = req.slot
        self.running.pop(slot)
        tr = self._tracer
        if tr is not None:
            tr.event(req.rid, "preempted", mode=self.preemption_mode,
                     tokens=len(req.generated))
        if self.preemption_mode == "swap":
            req.swap = self.cache.swap_out(slot)
            if tr is not None:
                tr.event(req.rid, "swap_out", pages=req.swap.n_pages)
        else:
            self.cache.release(slot)
            req.generated.clear()
            req.prefilled_tokens = 0  # its chunk progress lived in the pages
        self._free_slots.append(slot)
        req.state, req.slot = WAITING, None
        req.preemptions += 1
        self.preemption_count += 1
        self.waiting.appendleft(req)
        return slot

    def evict(self, req: Request) -> int | None:
        """Remove a request from waiting or running without finishing it
        (cancel, deadline, failure), freeing its slot, pages and swap
        handle. Returns the vacated slot (None when it was waiting); the
        caller sets the terminal state."""
        if req.state in (RUNNING, PREFILLING):
            slot = req.slot
            self.running.pop(slot)
            self.cache.release(slot)
            self._free_slots.append(slot)
            req.slot = None
            return slot
        if req.state == WAITING:
            self.waiting.remove(req)
            req.swap = None
        return None

    def finish(self, req: Request) -> None:
        slot = req.slot
        self.running.pop(slot)
        self.cache.release(slot)
        self._free_slots.append(slot)
        req.state, req.slot = FINISHED, None
