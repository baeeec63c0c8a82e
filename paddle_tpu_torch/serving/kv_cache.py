"""Paged KV cache: preallocated page pool + refcounted allocator + page
tables + automatic prefix caching + the host spill tier — the port of
``paddle_tpu/serving/kv_cache.py`` (float and int8 pools).

The device side is one tensor ``[num_layers, 2, num_pages, page_size,
heads, head_dim]`` (K and V of every layer), allocated zeroed on the
device and written in place by the model's paged forward — the
counterpart of the JAX engine donating its pools to the jitted step. With
``kv_dtype="int8"`` the pools hold int8 codes and beside them one float32
``[num_layers, 2, num_pages, heads]`` tensor of per-page-per-head scales
(``scales``), also zeroed: a zero scale marks an all-zero page. The
host side is bookkeeping only, in plain Python and numpy exactly as the
reference does it: a refcounted block allocator with the same free-list
order (so page ids match the reference's), per-slot page tables mirrored
into a dense ``[max_batch, pages_per_seq]`` int32 array, and the prefix
index.

Page 0 is reserved (never allocated): the null page that padding tokens
and inactive slots write to.

Prefix caching: every FULL page whose token block is known is registered
under a LINKED exact key ``(parent_serial, block_tokens)``; a new prompt
is matched in whole pages and the hits are mapped into its page table by
refcount bump. Refcount-0 registered pages stay resident in an LRU
reclaimable set and are evicted oldest-first (and purged from the index)
only when an allocation would otherwise fail. A fully cached prompt
recomputes its last token; the page holding it is copied first
(copy-on-write) when another holder shares it.

Host tier (``host_tier_bytes > 0``): when LRU eviction reclaims indexed
refcount-0 prefix pages, their bytes (codes and scales of every layer)
are first copied to a bounded host-memory LRU (``HostTier``) under their
index keys and chain serials. An admission whose prompt continues a
device-index chain into the tier restores those pages into freshly
allocated ones and counts them as prefix hits; a failed restore undoes
the admission and raises ``HostTierRestoreError``. Both copies move the
raw bytes, so a round trip is bit exact.

Swap preemption (``swap_out`` / ``swap_in``): a slot's pages, codes and
scales of every layer, are copied to host tensors (a ``SwapHandle``) and
its holds dropped; the resume allocates as many pages and copies the
bytes back, so a round trip is bit exact and the pool's shape never
changes. ``shrink`` returns the tail pages a speculative verify step
reserved past its accepted tokens. ``restore_fault`` (installed by the
engine when a fault injector is armed) is consulted right before a
host-tier restore: the ``restore_fail`` fault point.

Tensor parallelism (``tp > 1``, ``serving/tp.py``): each rank's pools
hold its own ``num_heads / tp`` heads; the page tables, refcounts, prefix
index, serials and free list are host integers, equal on every rank. Swap
handles and host-tier entries hold the rank's own heads too: within one
engine no payload leaves its rank, so moving them needs no collective.
``kv_bytes_per_token``, the host tier's byte bound and its byte gauge
count the whole pool, all ranks together, as the reference's gathered
copies do.

The fleet's currency (``serving/fleet.py``): :func:`prefix_digest` hashes
a prompt's page-aligned prefixes into chained FNV-1a digests and
:meth:`PagedKVCache.gossip_digests` gives the digests of every chain the
cache can serve, so a router counts a replica's warm tokens without
seeing its tokens. :meth:`PagedKVCache.export_prefix_chain` copies a
prefix chain out as standalone :class:`SpilledPage` s (the payload of a
cross-replica page fetch) and :meth:`PagedKVCache.import_spilled_chain`
adopts a peer's chain into the local host tier, where the next admission
restores it.
"""
from __future__ import annotations

import itertools
import math
from collections import Counter, OrderedDict
from dataclasses import dataclass

import numpy as np
import torch

from .._device import resolve_device

NULL_PAGE = 0
_RESERVED_PAGES = 1  # page 0 = null page

__all__ = ["NULL_PAGE", "PageAllocator", "PagedCacheConfig", "PagedKVCache",
           "HostTier", "HostTierRestoreError", "SpilledPage", "SwapHandle",
           "DIGEST_SEED", "prefix_digest"]


class PageAllocator:
    """Refcounted block allocator over page ids ``[1, num_pages)``.
    ``alloc`` hands out pages at refcount 1 (lowest ids first);
    ``incref``/``decref`` implement sharing. A page at refcount zero either
    returns to the free list or, with ``hold=True`` (an indexed prefix
    page), parks in an LRU side pool until reclaimed or re-taken."""

    def __init__(self, num_pages: int):
        if num_pages <= _RESERVED_PAGES:
            raise ValueError(f"need more than {_RESERVED_PAGES} pages "
                             f"(page 0 is the reserved null page)")
        self.num_pages = num_pages
        # pop() hands out low ids first — the reference's order exactly
        self._free = list(range(num_pages - 1, _RESERVED_PAGES - 1, -1))
        self._ref: dict[int, int] = {}  # page -> refcount (>= 1)
        # refcount-0 pages held for the prefix cache, oldest (LRU) first
        self._cached: OrderedDict[int, None] = OrderedDict()

    @property
    def num_usable(self) -> int:
        return self.num_pages - _RESERVED_PAGES

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_reclaimable(self) -> int:
        return len(self._cached)

    @property
    def pages_in_use(self) -> int:
        return len(self._ref)

    def refcount(self, page: int) -> int:
        return self._ref.get(page, 0)

    def alloc(self, n: int) -> list[int] | None:
        """n pages at refcount 1, or None (and no state change) when the
        free list cannot cover them. Reclaimable pages are not tapped."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._ref[p] = 1
        return pages

    def incref(self, page: int) -> int:
        if page not in self._ref:
            raise ValueError(f"incref of page {page} with no live holders")
        self._ref[page] += 1
        return self._ref[page]

    def decref(self, page: int, hold: bool = False) -> int:
        """Drop one holder; at zero the page returns to the free list, or
        parks in the reclaimable LRU pool when ``hold``. Decref of a page
        with no holders raises."""
        c = self._ref.get(page)
        if c is None:
            raise ValueError(
                f"decref of page {page} not handed out by this allocator "
                f"(double free or foreign page)")
        c -= 1
        if c:
            self._ref[page] = c
            return c
        del self._ref[page]
        if hold:
            self._cached[page] = None
            self._cached.move_to_end(page)
        else:
            self._free.append(page)
        return 0

    def take_cached(self, page: int) -> None:
        """Prefix-cache hit on a reclaimable page: revive it at refcount 1
        without touching its pool bytes."""
        del self._cached[page]
        self._ref[page] = 1

    def reclaim_lru(self) -> int | None:
        """Evict the least-recently-parked reclaimable page to the free
        list; returns its id (the caller purges its index entry)."""
        if not self._cached:
            return None
        page, _ = self._cached.popitem(last=False)
        self._free.append(page)
        return page


class HostTierRestoreError(RuntimeError):
    """A host-tier prefix restore failed. The admission is undone and the
    stale tier entries dropped; the engine retires the request FAILED."""


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


@dataclass(eq=False)  # tensor fields: identity semantics
class SwapHandle:
    """Host copy of one sequence's KV pages (swap preemption): ``data``
    ``[num_layers, 2, n_pages, page_size, heads, head_dim]`` in page-table
    order, K and V of every layer in the pool's dtype, and for int8 pools
    ``scales`` ``[num_layers, 2, n_pages, heads]``. Restoring into any
    ``n_pages`` pages, in order, puts every token back at its position."""
    n_pages: int
    data: torch.Tensor
    scales: torch.Tensor | None = None

    @property
    def nbytes(self) -> int:
        n = _nbytes(self.data)
        return n + (_nbytes(self.scales) if self.scales is not None else 0)


@dataclass(eq=False)  # tensor fields: identity semantics
class SpilledPage:
    """One prefix page in the host tier: its index key, its chain serial
    (kept so a restore re-links descendants exactly), and its raw bytes on
    the host — ``k``/``v`` ``[num_layers, page_size, heads, head_dim]`` in
    the pool's dtype, plus for int8 pools the scales ``[num_layers,
    heads]``."""
    key: tuple
    serial: int
    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None

    @property
    def nbytes(self) -> int:
        n = _nbytes(self.k) + _nbytes(self.v)
        if self.k_scale is not None:
            n += _nbytes(self.k_scale) + _nbytes(self.v_scale)
        return n


class HostTier:
    """Bounded LRU of :class:`SpilledPage` keyed by index key — the
    capacity tier behind the paged pool. Host bookkeeping only: the cache
    owns every copy between the card and the host. ``share``: the entries
    hold one rank's heads of ``share`` ranks; the bound and ``bytes``
    count whole pages (an entry's bytes times ``share``)."""

    def __init__(self, max_bytes: int, share: int = 1):
        self.max_bytes = max_bytes
        self.share = share
        self.bytes = 0
        self._entries: OrderedDict[tuple, SpilledPage] = OrderedDict()

    def _size(self, entry: SpilledPage) -> int:
        return entry.nbytes * self.share

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, key: tuple, touch: bool = True) -> SpilledPage | None:
        """Peek an entry (the caller pops it only after a successful
        restore). ``touch`` promotes it to most recent; read-only probes
        pass False so they never reorder the LRU."""
        e = self._entries.get(key)
        if e is not None and touch:
            self._entries.move_to_end(key)
        return e

    def put(self, entry: SpilledPage) -> None:
        """Insert, dropping the oldest entries (their KV is gone) until the
        byte bound holds. An entry larger than the whole bound is refused."""
        self.pop(entry.key)
        size = self._size(entry)
        if size > self.max_bytes:
            return
        while self._entries and self.bytes + size > self.max_bytes:
            _, old = self._entries.popitem(last=False)
            self.bytes -= self._size(old)
        self._entries[entry.key] = entry
        self.bytes += size

    def pop(self, key: tuple) -> SpilledPage | None:
        e = self._entries.pop(key, None)
        if e is not None:
            self.bytes -= self._size(e)
        return e


def _block_tokens(tokens, page_size: int, i: int) -> tuple:
    """Block ``i`` of ``tokens`` as a plain int tuple — the one place
    token blocks are sliced for keying, shared by the index keys and the
    gossip digests so they cannot disagree."""
    return tuple(int(t) for t in tokens[i * page_size:(i + 1) * page_size])


# Gossip digests: chained FNV-1a over page-aligned token blocks, the
# reference's constants (Python's hash() is salted per process). A
# collision costs at worst one poorer route: digests are routing hints.
DIGEST_SEED = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_U64 = (1 << 64) - 1


def _digest_step(parent_digest: int, block: tuple) -> int:
    """Fold one page-aligned token block into its parent chain digest."""
    h = parent_digest
    for t in block:
        for shift in (0, 8, 16, 24):  # 4 bytes a token covers any vocab
            h ^= (t >> shift) & 0xFF
            h = (h * _FNV_PRIME) & _U64
        h ^= 0xFE  # token delimiter: (1,2),(3) never equals (1),(2,3)
        h = (h * _FNV_PRIME) & _U64
    return h


def prefix_digest(tokens, page_size: int) -> tuple:
    """Chained digests of every full page-aligned prefix of ``tokens``:
    element ``i`` covers blocks ``0..i``. Counting how many leading
    elements lie in a cache's :meth:`PagedKVCache.gossip_digests`, times
    ``page_size``, gives its ``cached_prefix_tokens``."""
    out, h = [], DIGEST_SEED
    for i in range(len(tokens) // page_size):
        h = _digest_step(h, _block_tokens(tokens, page_size, i))
        out.append(h)
    return tuple(out)


KV_DTYPES = ("float32", "int8")


@dataclass(frozen=True)
class PagedCacheConfig:
    num_layers: int
    num_heads: int
    head_dim: int
    num_pages: int = 64
    page_size: int = 16
    max_batch: int = 4
    pages_per_seq: int = 8  # page-table width == max seq pages per request
    dtype: torch.dtype | None = None  # float pools' dtype; None -> float32
    enable_prefix_caching: bool = True
    # "float32": pools in ``dtype`` (the model's); "int8": codes plus
    # per-page-per-head float32 absmax scales
    kv_dtype: str = "float32"
    host_tier_bytes: int = 0  # host spill tier bound; 0 = off
    tp: int = 1  # tensor-parallel ranks: each holds num_heads / tp heads

    @property
    def quantized(self) -> bool:
        return self.kv_dtype == "int8"

    @property
    def local_heads(self) -> int:
        return self.num_heads // self.tp

    @property
    def kv_bytes_per_token(self) -> int:
        """Device bytes one resident token costs across all layers: K and
        V elements, plus for int8 pools the page scales spread over the
        page's tokens (rounded up)."""
        per = 2 * self.num_layers * self.num_heads * self.head_dim
        if self.quantized:
            return per + (2 * self.num_layers * self.num_heads * 4
                          + self.page_size - 1) // self.page_size
        return per * (self.dtype or torch.float32).itemsize

    @property
    def max_tokens_per_seq(self) -> int:
        return self.pages_per_seq * self.page_size

    @property
    def usable_pages(self) -> int:
        return self.num_pages - _RESERVED_PAGES


class PagedKVCache:
    """Host-side manager of the pool: slot admission (with prefix
    matching), on-demand growth during decode, release. ``pools`` is the
    device tensor the model's paged forward writes in place."""

    def __init__(self, cfg: PagedCacheConfig, device=None):
        if cfg.kv_dtype not in KV_DTYPES:
            raise ValueError(f"kv_dtype {cfg.kv_dtype!r} not in {KV_DTYPES}")
        if cfg.host_tier_bytes < 0:
            raise ValueError(f"host_tier_bytes {cfg.host_tier_bytes} < 0")
        if cfg.host_tier_bytes and not cfg.enable_prefix_caching:
            raise ValueError(
                "host_tier_bytes spills indexed prefix pages — it needs "
                "enable_prefix_caching=True (nothing would ever spill)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.allocator = PageAllocator(cfg.num_pages)
        if cfg.num_heads % cfg.tp:
            raise ValueError(f"tp={cfg.tp} must divide num_heads="
                             f"{cfg.num_heads}")
        self.pools = torch.zeros(
            (cfg.num_layers, 2, cfg.num_pages, cfg.page_size, cfg.local_heads,
             cfg.head_dim),
            dtype=torch.int8 if cfg.quantized else cfg.dtype or torch.float32,
            device=self.device)
        self.scales = torch.zeros(
            (cfg.num_layers, 2, cfg.num_pages, cfg.local_heads),
            dtype=torch.float32, device=self.device) if cfg.quantized \
            else None
        self.page_table = np.full((cfg.max_batch, cfg.pages_per_seq),
                                  NULL_PAGE, np.int32)
        self._slot_pages: dict[int, list[int]] = {}
        # prefix index: (parent_serial, block_tokens) -> full immutable
        # page. Serials are never reused, so a key pins its whole prefix
        # transitively with no hash collisions.
        self._key_to_page: dict[tuple, int] = {}
        self._page_key: dict[int, tuple] = {}
        self._page_serial: dict[int, int] = {}  # registered page -> serial
        self._serials = itertools.count(1)      # 0 = chain-head parent
        self._slot_cached: dict[int, int] = {}  # slot -> cached prompt tokens
        self._slot_restored: dict[int, int] = {}  # slot -> restored pages
        self.cow_copies = 0   # shared pages privatized before a write
        self.evictions = 0    # reclaimable pages purged under pressure
        self.host_tier = (HostTier(cfg.host_tier_bytes, share=cfg.tp)
                          if cfg.host_tier_bytes else None)
        self.spills = 0          # pages spilled to the host tier
        self.restores = 0        # pages restored from the host tier
        self.host_tier_hits = 0  # admissions that restored >= 1 page
        # the restore_fail fault point: a callable (rid) -> bool the engine
        # installs with an armed injector; None costs one attribute check
        self.restore_fault = None

    # ------------------------------------------------------------- sizing
    def pages_for(self, num_tokens: int) -> int:
        return max(1, math.ceil(num_tokens / self.cfg.page_size))

    def fits_ever(self, total_tokens: int) -> bool:
        """Could a request of total_tokens run with the whole pool to
        itself? (The admission bound that makes preemption terminate.)"""
        return (total_tokens <= self.cfg.max_tokens_per_seq
                and self.pages_for(total_tokens) <= self.cfg.usable_pages)

    # ----------------------------------------------------- prefix caching
    def _block_key(self, parent_serial: int, tokens, i: int) -> tuple:
        return (parent_serial,
                _block_tokens(tokens, self.cfg.page_size, i))

    def match_prefix(self, tokens) -> list[int]:
        """Longest chain of cached FULL pages covering a prefix of
        ``tokens``, in page order."""
        if not self.cfg.enable_prefix_caching:
            return []
        pages, parent = [], 0
        for i in range(len(tokens) // self.cfg.page_size):
            page = self._key_to_page.get(self._block_key(parent, tokens, i))
            if page is None:
                break
            pages.append(page)
            parent = self._page_serial[page]
        return pages

    def register_prefix(self, slot: int, tokens) -> int:
        """Index every full page of ``slot`` whose token block ``tokens``
        covers. First registration wins. Returns pages newly indexed."""
        if not self.cfg.enable_prefix_caching:
            return 0
        pages = self._slot_pages.get(slot)
        if not pages:
            return 0
        new, parent = 0, 0
        for i in range(min(len(pages), len(tokens) // self.cfg.page_size)):
            key = self._block_key(parent, tokens, i)
            existing = self._key_to_page.get(key)
            if existing is not None:
                parent = self._page_serial[existing]
                continue
            if pages[i] in self._page_key:
                # the page anchors a different chain already (a COW
                # source); descendants would need an unreachable parent
                break
            serial = next(self._serials)
            self._key_to_page[key] = pages[i]
            self._page_key[pages[i]] = key
            self._page_serial[pages[i]] = serial
            if self.host_tier is not None:
                # the device index always wins: a spilled twin of a key
                # registered afresh is stale
                self.host_tier.pop(key)
            parent = serial
            new += 1
        return new

    def cached_tokens(self, slot: int) -> int:
        """Prompt tokens slot ``slot`` reused from the prefix cache."""
        return self._slot_cached.get(slot, 0)

    def restored_pages(self, slot: int) -> int:
        """Host-tier pages restored into ``slot`` at its admission."""
        return self._slot_restored.get(slot, 0)

    def _match_host_tail(self, tokens, parent: int, start_block: int,
                         touch: bool = True) -> list[SpilledPage]:
        """Continue a device-index prefix chain into the host tier: the
        longest run of spilled pages extending block ``start_block`` of
        ``tokens`` from chain serial ``parent`` (each match becomes the
        tier's most recent entry unless ``touch=False``, a read-only
        probe)."""
        if self.host_tier is None:
            return []
        out = []
        for i in range(start_block, len(tokens) // self.cfg.page_size):
            e = self.host_tier.get(self._block_key(parent, tokens, i),
                                   touch=touch)
            if e is None:
                break
            out.append(e)
            parent = e.serial
        return out

    def cached_prefix_tokens(self, tokens) -> int:
        """Tokens of ``tokens`` a fresh admission would serve from the
        prefix cache now (whole-page device-index matches plus the host
        tier's continuation of the chain). Read-only: no refcount moves,
        no tier LRU reorder — the scheduler's warm-waiter probe."""
        pages = self.match_prefix(tokens)
        parent = self._page_serial[pages[-1]] if pages else 0
        spilled = self._match_host_tail(tokens, parent, len(pages),
                                        touch=False)
        return (len(pages) + len(spilled)) * self.cfg.page_size

    def gossip_digests(self) -> frozenset:
        """The chain digests of every prefix chain reachable from the root
        — the device index plus the host tier's continuations — the set a
        fleet router gossips instead of tokens. A digest is in the set iff
        its whole chain resolves, so counting leading
        :func:`prefix_digest` elements in it reproduces
        :meth:`cached_prefix_tokens`. A child's serial always exceeds its
        parent's, so one pass in serial order resolves every node."""
        if not self.cfg.enable_prefix_caching:
            return frozenset()
        nodes = [(self._page_serial[page], key)
                 for key, page in self._key_to_page.items()]
        if self.host_tier is not None:
            nodes.extend((e.serial, key)
                         for key, e in self.host_tier._entries.items())
        by_serial = {0: DIGEST_SEED}  # serial -> chain digest
        for serial, (parent_serial, block) in sorted(nodes):
            parent = by_serial.get(parent_serial)
            if parent is None:
                continue  # ancestor purged: unreachable from the root
            by_serial[serial] = _digest_step(parent, block)
        del by_serial[0]
        return frozenset(by_serial.values())

    def export_prefix_chain(self, tokens,
                            max_pages: int | None = None) -> list:
        """The longest resolvable prefix chain covering ``tokens`` as
        standalone :class:`SpilledPage` copies, in chain order from the
        root: the device-index pages in one gather and one device-to-host
        copy, then the host tier's continuation copied as is. Read-only:
        no refcount, tier order or index changes, so the donor serves on
        as before."""
        pages = self.match_prefix(tokens)
        parent = self._page_serial[pages[-1]] if pages else 0
        spilled = self._match_host_tail(tokens, parent, len(pages),
                                        touch=False)
        if max_pages is not None:
            pages = pages[:max_pages]
            spilled = spilled[:max(0, max_pages - len(pages))]
        out = self._copy_out(pages) if pages else []
        out.extend(SpilledPage(
            key=e.key, serial=e.serial, k=e.k.clone(), v=e.v.clone(),
            k_scale=None if e.k_scale is None else e.k_scale.clone(),
            v_scale=None if e.v_scale is None else e.v_scale.clone())
            for e in spilled)
        return out

    def import_spilled_chain(self, entries) -> int:
        """Adopt a peer's exported prefix chain into the local host tier,
        the receiving half of a cross-replica page fetch. Serials are per
        cache, so the peer's are remapped: entries are walked from the
        root (arrival order does not matter), and each block either exists
        here already (device index or tier; the first registration wins,
        the peer's copy is dropped) or enters the tier under a fresh local
        serial, its key re-parented onto the local chain. Returns pages
        newly inserted. Raises ValueError without a host tier or for pages
        of another dtype or scale layout than this pool's."""
        if self.host_tier is None:
            raise ValueError(
                "import_spilled_chain needs the host tier "
                "(host_tier_bytes > 0) as its landing zone")
        by_parent: dict[int, SpilledPage] = {}
        for e in entries:
            by_parent.setdefault(int(e.key[0]), e)
        new = 0
        src_parent = 0  # cursor in the peer's serial space
        parent = 0      # the chain so far in the local serial space
        while src_parent in by_parent:
            e = by_parent.pop(src_parent)
            src_parent = int(e.serial)
            if e.k.dtype != self.pools.dtype \
                    or (e.k_scale is None) == self.cfg.quantized:
                raise ValueError(
                    f"imported page dtype {e.k.dtype}/scales="
                    f"{e.k_scale is not None} does not match this pool "
                    f"({self.pools.dtype}, kv_dtype={self.cfg.kv_dtype!r})")
            key = (parent, tuple(e.key[1]))
            page = self._key_to_page.get(key)
            if page is not None:
                parent = self._page_serial[page]
                continue
            held = self.host_tier.get(key, touch=False)
            if held is not None:
                parent = held.serial
                continue
            serial = next(self._serials)
            self.host_tier.put(SpilledPage(
                key=key, serial=serial, k=e.k.clone(), v=e.v.clone(),
                k_scale=None if e.k_scale is None else e.k_scale.clone(),
                v_scale=None if e.v_scale is None else e.v_scale.clone()))
            if self.host_tier.get(key, touch=False) is None:
                break  # refused at the byte bound: its descendants would
                # chain onto a parent the tier does not hold
            parent = serial
            new += 1
        return new

    def shared_page_count(self) -> int:
        """Pages currently mapped by more than one page table."""
        return sum(1 for c in self.allocator._ref.values() if c > 1)

    def _unregister(self, page: int) -> None:
        key = self._page_key.pop(page, None)
        if key is not None:
            self._key_to_page.pop(key, None)
            self._page_serial.pop(page, None)

    def _copy_out(self, pages: list[int]) -> list[SpilledPage]:
        """Standalone host copies of the named indexed pages under their
        index keys and chain serials: one gather and one device-to-host
        copy for all of them, codes and scales of every layer."""
        idx = torch.tensor(pages, dtype=torch.long, device=self.device)
        data = self.pools[:, :, idx].cpu()        # [L, 2, n, ps, h, d]
        sc = None if self.scales is None else self.scales[:, :, idx].cpu()
        return [SpilledPage(
            key=self._page_key[page], serial=self._page_serial[page],
            k=data[:, 0, j].clone(), v=data[:, 1, j].clone(),
            k_scale=None if sc is None else sc[:, 0, j].clone(),
            v_scale=None if sc is None else sc[:, 1, j].clone())
            for j, page in enumerate(pages)]

    def _spill_pages(self, pages: list[int]) -> None:
        """Copy the named (resident, refcount-0, indexed) pages into the
        host tier before they are reclaimed."""
        for entry in self._copy_out(pages):
            self.host_tier.put(entry)
            self.spills += 1

    def _alloc_or_evict(self, n: int) -> list[int] | None:
        """Allocate n pages, LRU-evicting reclaimable cached pages (purged
        from the index first) when the free list alone cannot cover it.
        With the host tier the sweep's victims spill there first."""
        if n == 0:
            return []
        if self.allocator.num_free + self.allocator.num_reclaimable < n:
            return None  # doomed: keep the warm cache, change no state
        need = n - self.allocator.num_free
        if need > 0 and self.host_tier is not None:
            # reclaim_lru pops oldest first: exactly this LRU prefix
            self._spill_pages(list(itertools.islice(self.allocator._cached,
                                                    need)))
        for _ in range(need):
            page = self.allocator.reclaim_lru()
            self._unregister(page)
            self.evictions += 1
        return self.allocator.alloc(n)

    def _claim_shared(self, page: int) -> None:
        if self.allocator.refcount(page) == 0:
            self.allocator.take_cached(page)
        else:
            self.allocator.incref(page)

    def _release_pages(self, pages) -> None:
        for p in pages:
            self.allocator.decref(p, hold=p in self._page_key)

    def _copy_page_bytes(self, src: int, dst: int) -> None:
        """The copy-on-write data move: page ``src`` into page ``dst``, K
        and V of every layer (codes and scales for int8 pools), one index
        copy on the device each."""
        self.pools[:, :, dst] = self.pools[:, :, src]
        if self.scales is not None:
            self.scales[:, :, dst] = self.scales[:, :, src]

    def _write_pages(self, pages: list[int], entries) -> None:
        """Copy spilled entries' bytes into ``pages`` on the device: one
        host-to-device copy of the stacked pages (and of their scales)."""
        idx = torch.tensor(pages, dtype=torch.long, device=self.device)
        data = torch.stack([torch.stack([e.k, e.v], 1) for e in entries], 2)
        self.pools[:, :, idx] = data.to(self.device)
        if self.scales is not None:
            sc = torch.stack([torch.stack([e.k_scale, e.v_scale], 1)
                              for e in entries], 2)
            self.scales[:, :, idx] = sc.to(self.device)

    def _restore_pages(self, entries: list[SpilledPage],
                       pages: list[int], rid=None) -> None:
        """Copy host-tier entries into freshly allocated ``pages`` (aligned
        lists) and re-register each under its original key and serial, so
        descendants of the chain, on the device or still in the tier, stay
        reachable. A failed copy, or the ``restore_fail`` fault point for
        request ``rid``, drops the entries and raises
        HostTierRestoreError; the caller undoes the admission."""
        hook = self.restore_fault
        if hook is not None and hook(rid):
            for e in entries:
                self.host_tier.pop(e.key)
            raise HostTierRestoreError(f"restore_fail injected (rid {rid})")
        try:
            self._write_pages(pages, entries)
        except (RuntimeError, ValueError) as err:
            for e in entries:
                self.host_tier.pop(e.key)
            raise HostTierRestoreError(
                f"host-tier restore failed: {type(err).__name__}: "
                f"{err}") from err
        for e, page in zip(entries, pages):
            self.host_tier.pop(e.key)
            self._key_to_page[e.key] = page
            self._page_key[page] = e.key
            self._page_serial[page] = e.serial
            self.restores += 1
        self.host_tier_hits += 1

    # ---------------------------------------------------------- admission
    def admit(self, slot: int, num_tokens: int, tokens=None,
              rid=None) -> bool:
        """Allocate what a prompt of num_tokens needs and fill the slot's
        page-table row, sharing the longest indexed whole-page prefix of
        ``tokens`` by refcount bump. A fully cached prompt caps its cached
        span at ``num_tokens - 1`` (its last token is recomputed for the
        first output's logits) and gets a private copy of the page holding
        that token when another holder shares it. False (no state change)
        when even LRU eviction cannot cover the private remainder.

        Host tier: the match continues into spilled pages, which are
        restored into private pages and count as cached like device hits.
        A failed restore (a failed copy, or the ``restore_fail`` fault
        point for request ``rid``) undoes the whole admission and raises
        HostTierRestoreError."""
        if slot in self._slot_pages:
            raise ValueError(f"slot {slot} already admitted")
        total = self.pages_for(num_tokens)
        shared: list[int] = []
        spilled: list[SpilledPage] = []
        if tokens is not None and self.cfg.enable_prefix_caching:
            shared = self.match_prefix(tokens[:num_tokens])
            parent = self._page_serial[shared[-1]] if shared else 0
            spilled = self._match_host_tail(tokens[:num_tokens], parent,
                                            len(shared))
            for p in shared:
                self._claim_shared(p)
        cached = (len(shared) + len(spilled)) * self.cfg.page_size
        full_hit = bool(shared or spilled) and cached >= num_tokens
        if full_hit:
            cached = num_tokens - 1
        # refcount includes this request's own claim: > 1 = other holders.
        # A restored page is this request's private copy: no COW for it.
        need_cow = full_hit and not spilled \
            and self.allocator.refcount(shared[-1]) > 1
        private = self._alloc_or_evict(total - len(shared)
                                       + (1 if need_cow else 0))
        if private is None:
            self._release_pages(shared)
            return False
        if spilled:
            try:
                self._restore_pages(spilled, private[:len(spilled)], rid)
            except HostTierRestoreError:
                for p in private:  # fresh refcount-1 pages: free them
                    self.allocator.decref(p)
                self._release_pages(shared)
                raise
            self._slot_restored[slot] = len(spilled)
        if need_cow:
            dst = private.pop()
            src = shared[-1]
            self._copy_page_bytes(src, dst)
            self.allocator.decref(src, hold=src in self._page_key)
            shared[-1] = dst
            self.cow_copies += 1
        pages = shared + private
        self._slot_pages[slot] = pages
        self._slot_cached[slot] = cached
        self.page_table[slot, :] = NULL_PAGE
        self.page_table[slot, :len(pages)] = pages
        return True

    def shrink(self, slot: int, num_tokens: int) -> int:
        """Return the slot's over-allocated tail pages past what
        ``num_tokens`` need (a verify step reserved pages for its K
        candidates before the accept count was known). Only private,
        unindexed pages are popped: the walk stops at a shared or indexed
        one. Returns the pages freed."""
        pages = self._slot_pages.get(slot)
        if not pages:
            return 0
        keep = self.pages_for(num_tokens)
        freed = 0
        while len(pages) > keep:
            page = pages[-1]
            if self.allocator.refcount(page) != 1 or page in self._page_key:
                break
            pages.pop()
            self.page_table[slot, len(pages)] = NULL_PAGE
            self.allocator.decref(page)
            freed += 1
        return freed

    def grow(self, slot: int, num_tokens: int) -> bool:
        """Ensure the slot can hold num_tokens, allocating pages on demand
        (evicting reclaimable cached pages first). False when the pool is
        exhausted — the scheduler must preempt."""
        pages = self._slot_pages[slot]
        need = self.pages_for(num_tokens)
        if need > self.cfg.pages_per_seq:
            raise ValueError(
                f"slot {slot}: {num_tokens} tokens need {need} pages > "
                f"pages_per_seq={self.cfg.pages_per_seq}")
        while len(pages) < need:
            got = self._alloc_or_evict(1)
            if got is None:
                return False
            self.page_table[slot, len(pages)] = got[0]
            pages.extend(got)
        return True

    # --------------------------------------------------------------- swap
    def swap_out(self, slot: int) -> SwapHandle:
        """Copy the slot's pages (codes and scales of every layer) to the
        host in one gather and one device-to-host copy, then drop its
        holds. Shared pages are copied too (the resume owns private
        pages); their device copies stay for the other holders."""
        pages = self._slot_pages.get(slot)
        if not pages:
            raise ValueError(f"slot {slot} has no pages to swap out")
        idx = torch.tensor(pages, dtype=torch.long, device=self.device)
        handle = SwapHandle(
            n_pages=len(pages), data=self.pools[:, :, idx].cpu(),
            scales=None if self.scales is None
            else self.scales[:, :, idx].cpu())
        self.release(slot)
        return handle

    def swap_in(self, slot: int, handle: SwapHandle) -> bool:
        """Allocate ``handle.n_pages`` pages for the slot (evicting
        reclaimable prefix pages first) and copy the swapped bytes back
        into them. False, with no state change, when even eviction cannot
        cover the handle."""
        if slot in self._slot_pages:
            raise ValueError(f"slot {slot} already admitted")
        pages = self._alloc_or_evict(handle.n_pages)
        if pages is None:
            return False
        idx = torch.tensor(pages, dtype=torch.long, device=self.device)
        self.pools[:, :, idx] = handle.data.to(self.device)
        if self.scales is not None:
            self.scales[:, :, idx] = handle.scales.to(self.device)
        self._slot_pages[slot] = pages
        self.page_table[slot, :] = NULL_PAGE
        self.page_table[slot, :len(pages)] = pages
        return True

    # ------------------------------------------------------------ release
    def release(self, slot: int) -> None:
        pages = self._slot_pages.pop(slot, None)
        self._slot_cached.pop(slot, None)
        self._slot_restored.pop(slot, None)
        if pages:
            self._release_pages(pages)
        self.page_table[slot, :] = NULL_PAGE

    def stats(self) -> dict:
        """One host-side reading of the pool's counts — the source of the
        serving gauges and the step records alike."""
        a = self.allocator
        t = self.host_tier
        return {"pages_in_use": a.pages_in_use,
                "free_pages": a.num_free,
                "reclaimable_pages": a.num_reclaimable,
                "usable_pages": self.cfg.usable_pages,
                "shared_pages": self.shared_page_count(),
                "cow_copies": self.cow_copies,
                "evictions": self.evictions,
                "host_tier_pages": len(t) if t is not None else 0,
                "host_tier_bytes": t.bytes if t is not None else 0,
                "host_tier_hits": self.host_tier_hits,
                "host_tier_spills": self.spills,
                "host_tier_restores": self.restores}

    # --------------------------------------------------------- invariants
    def check_invariants(self) -> None:
        """Structural invariants of the allocator, the page tables and the
        prefix index; raises AssertionError naming the violated one."""
        a = self.allocator
        free, live, parked = set(a._free), set(a._ref), set(a._cached)
        assert not (free & live) and not (free & parked) \
            and not (live & parked), "page states must be disjoint"
        assert len(free) + len(live) + len(parked) == a.num_usable, \
            "every usable page is exactly one of free/live/reclaimable"
        assert all(c >= 1 for c in a._ref.values()), "live refcounts >= 1"
        indexed = set(self._page_key)
        assert parked <= indexed, "reclaimable pages must stay indexed"
        assert not (free & indexed), \
            "a free page reachable through the prefix index would serve " \
            "stale KV to its next matcher"
        assert set(self._key_to_page.values()) == indexed
        assert set(self._page_serial) == indexed, \
            "every indexed page carries exactly one chain serial"
        holds = Counter(itertools.chain.from_iterable(
            self._slot_pages.values()))
        assert all(holds[p] <= a.refcount(p) for p in holds), \
            "a page table may never hold more references than its refcount"
        if self.host_tier is not None:
            t = self.host_tier
            assert t.bytes == sum(t._size(e) for e in t._entries.values()), \
                "host-tier byte accounting must match its entries"
            assert t.bytes <= t.max_bytes, \
                "host tier exceeded its declared byte bound"
            assert not (set(t._entries) & set(self._key_to_page)), \
                "a key reachable both on the device and in the host tier " \
                "would make the tier copy silently stale"
