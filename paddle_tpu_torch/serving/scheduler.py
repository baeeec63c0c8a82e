"""Admission + continuous batching scheduler (host side) — the port of
``paddle_tpu/serving/scheduler.py`` (recompute preemption).

FIFO admission with head-of-line order: a request is admitted only when a
decode slot and its prompt's pages are available, never out of arrival
order. One decode step serves every running slot. When the pool runs dry
mid-decode a running request is preempted — youngest first, sparing
requests prefilled this very step while a seasoned victim exists — by
RECOMPUTE: its pages are freed, its generated tokens dropped, and it
requeues at the front to replay from prefill (greedy decoding makes the
replay reproduce its tokens).

Prefix caching changes the accounting, not the policy: admission is
costed in unique pages (a cached prefix is mapped by refcount bump), and
admission-time validation guarantees every accepted request can finish
with the pool to itself, so the preempt-retry loop terminates. A request
whose host-tier restore fails at admission (``HostTierRestoreError``: the
cache undid the admission) stays queued and is recorded; the engine
retires it FAILED through ``fail`` and serves everyone else.

Not carried over yet (ROADMAP Queue 1 item 4): swap preemption, the
bounded waiting queue with shedding, deadlines and cancellation, chunked
prefill's PREFILLING state, and the speculative decode reserve.
"""
from __future__ import annotations

import itertools
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from .kv_cache import HostTierRestoreError, PagedKVCache

WAITING, RUNNING, FINISHED, FAILED = "waiting", "running", "finished", \
    "failed"

__all__ = ["WAITING", "RUNNING", "FINISHED", "FAILED", "Request",
           "Scheduler"]

_rid_counter = itertools.count()


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
    fresh: bool = False  # prefilled this step, no decode yet
    cached_tokens: int = 0  # prompt tokens served from the prefix cache
    error: BaseException | None = None  # why a FAILED request failed

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
    def __init__(self, cache: PagedKVCache, max_batch: int):
        self.cache = cache
        self.waiting: deque[Request] = deque()
        self.running: dict[int, Request] = {}  # slot -> Request
        self._free_slots = list(range(max_batch - 1, -1, -1))  # pop() -> 0,1,..
        self._admit_seq = itertools.count()
        self.preemption_count = 0
        # (request, error) of admissions whose host-tier restore failed
        self.restore_failures: list[tuple[Request, HostTierRestoreError]] = []

    @property
    def all_done(self) -> bool:
        return not self.waiting and not self.running

    def add(self, req: Request) -> None:
        """Queue a request; raises ValueError when it could never fit."""
        total = req.prompt_len + req.max_new_tokens
        if not self.cache.fits_ever(total):
            raise ValueError(
                f"request {req.rid}: {total} tokens can never fit "
                f"(max {self.cache.cfg.max_tokens_per_seq} per sequence, "
                f"{self.cache.cfg.usable_pages} usable pages)")
        req.state = WAITING
        self.waiting.append(req)

    def admit(self) -> list[Request]:
        """Admit waiting requests FIFO into free slots while pages are
        available; the first request that does not fit blocks the queue,
        as does one whose host-tier restore failed (recorded in
        ``restore_failures`` for the engine to retire)."""
        admitted = []
        while self.waiting and self._free_slots:
            req = self.waiting[0]
            slot = self._free_slots[-1]
            try:
                ok = self.cache.admit(slot, req.prompt_len, tokens=req.prompt)
            except HostTierRestoreError as e:
                self.restore_failures.append((req, e))
                break
            if not ok:
                break
            req.cached_tokens = self.cache.cached_tokens(slot)
            self._free_slots.pop()
            self.waiting.popleft()
            req.state, req.slot = RUNNING, slot
            req.admit_seq = next(self._admit_seq)
            self.running[slot] = req
            admitted.append(req)
        return admitted

    def pop_restore_failures(self) -> list[tuple[Request,
                                                 HostTierRestoreError]]:
        """Drain the (request, error) pairs of failed restores."""
        out, self.restore_failures = self.restore_failures, []
        return out

    def fail(self, req: Request, error: BaseException) -> None:
        """Retire a waiting request FAILED (it holds no slot or pages)."""
        self.waiting.remove(req)
        req.state, req.error = FAILED, error

    def pick_victim(self) -> Request:
        """Youngest admitted, among requests that have decoded at least
        once when any exist."""
        seasoned = [r for r in self.running.values() if not r.fresh]
        pool = seasoned or list(self.running.values())
        return max(pool, key=lambda r: r.admit_seq)

    def ensure_decode_pages(self) -> list[tuple[Request, int]]:
        """Before a decode step every running slot writes the KV of its
        last generated token at position ``tokens_resident - 1``, so it
        needs capacity for ``tokens_resident`` tokens. Preempts per
        ``pick_victim`` until the survivors fit; returns the (request,
        vacated slot) pairs."""
        preempted = []
        for slot in sorted(self.running,
                           key=lambda s: self.running[s].admit_seq):
            req = self.running.get(slot)
            if req is None:  # already preempted this round
                continue
            while req.slot is not None \
                    and not self.cache.grow(slot, req.tokens_resident):
                victim = self.pick_victim()
                preempted.append((victim, self.preempt(victim)))
                # fits_ever() at admission guarantees a lone request can
                # always grow, so this loop terminates
        return preempted

    def preempt(self, req: Request) -> int:
        """Recompute preemption: free the pages, drop the generated tokens,
        requeue at the front. Returns the vacated slot."""
        slot = req.slot
        self.running.pop(slot)
        self.cache.release(slot)
        req.generated.clear()
        self._free_slots.append(slot)
        req.state, req.slot = WAITING, None
        req.preemptions += 1
        self.preemption_count += 1
        self.waiting.appendleft(req)
        return slot

    def finish(self, req: Request) -> None:
        slot = req.slot
        self.running.pop(slot)
        self.cache.release(slot)
        self._free_slots.append(slot)
        req.state, req.slot = FINISHED, None
