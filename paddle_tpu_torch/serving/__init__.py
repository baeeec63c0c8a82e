"""paddle_tpu_torch.serving — the continuous-batching engine of the port:
a paged KV cache (fixed pool of float or int8 pages, refcounted allocator,
per-request page tables, automatic prefix caching with copy-on-write, LRU
eviction, a host spill tier, swap to the host), a FIFO scheduler with
recompute or swap preemption and a bounded waiting queue, fault
injection, speculative decoding, and an engine whose prefill, chunk,
decode and verify steps attend through the Hopper ragged paged-attention
kernel, greedy or sampled."""
from .engine import EngineCounters, ServingConfig, ServingEngine, prefill_buckets
from .faults import FaultInjector, InjectedFault
from .kv_cache import (NULL_PAGE, HostTier, HostTierRestoreError,
                       PageAllocator, PagedCacheConfig, PagedKVCache,
                       SpilledPage, SwapHandle)
from .scheduler import EngineOverloaded, Request, Scheduler
from .spec import SpecConfig

__all__ = ["EngineCounters", "ServingConfig", "ServingEngine",
           "prefill_buckets", "FaultInjector", "InjectedFault", "NULL_PAGE",
           "HostTier", "HostTierRestoreError", "PageAllocator",
           "PagedCacheConfig", "PagedKVCache", "SpilledPage", "SwapHandle",
           "EngineOverloaded", "Request", "Scheduler", "SpecConfig"]
