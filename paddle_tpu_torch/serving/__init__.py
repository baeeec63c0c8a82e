"""paddle_tpu_torch.serving — the continuous-batching engine of the port:
a paged KV cache (fixed pool of float or int8 pages, refcounted allocator,
per-request page tables, automatic prefix caching with copy-on-write, LRU
eviction and a host spill tier), a FIFO scheduler with recompute
preemption, and an engine whose prefill and ``[max_batch]`` decode steps
attend through the Hopper ragged paged-attention kernel."""
from .engine import EngineCounters, ServingConfig, ServingEngine, prefill_buckets
from .kv_cache import (NULL_PAGE, HostTier, HostTierRestoreError,
                       PageAllocator, PagedCacheConfig, PagedKVCache,
                       SpilledPage)
from .scheduler import Request, Scheduler

__all__ = ["EngineCounters", "ServingConfig", "ServingEngine",
           "prefill_buckets", "NULL_PAGE", "HostTier", "HostTierRestoreError",
           "PageAllocator", "PagedCacheConfig", "PagedKVCache", "Request",
           "Scheduler", "SpilledPage"]
