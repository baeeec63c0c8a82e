"""paddle_tpu_torch.serving — the continuous-batching engine of the port:
a paged KV cache (fixed pool of float or int8 pages, refcounted allocator,
per-request page tables, automatic prefix caching with copy-on-write, LRU
eviction, a host spill tier, swap to the host), a FIFO scheduler with
recompute or swap preemption and a bounded waiting queue, fault
injection, speculative decoding, and an engine whose prefill, chunk,
decode and verify steps attend through the Hopper ragged paged-attention
kernel, greedy or sampled, on one card or tensor-parallel over a process
group (:mod:`.tp`); above the engine, the fleet: replicas behind a
prefix-affinity router (:mod:`.fleet`), the wire codec (:mod:`.wire`),
the lossy channel and its transport (:mod:`.channel`), the chaos soak
(:mod:`.chaos`) and the journey-replay simulator (:mod:`.fleet_sim`)."""
from .engine import EngineCounters, ServingConfig, ServingEngine, prefill_buckets
from .channel import (ChannelConfig, CircuitBreaker, SimChannel, Transport,
                      TransportConfig)
from .chaos import ChaosConfig, ChaosInvariantError
from .faults import FaultInjector, InjectedFault
from .fleet import FleetConfig, FleetRouter
from .kv_cache import (NULL_PAGE, HostTier, HostTierRestoreError,
                       PageAllocator, PagedCacheConfig, PagedKVCache,
                       SpilledPage, SwapHandle, init_pools, prefix_digest)
from .metrics import ServingMetrics
from .scheduler import EngineOverloaded, Request, Scheduler
from .slo import SLOConfig, SLOController
from .spec import SpecConfig
from .tp import TPContext, quantized_psum
from .wire import (WIRE_SCHEMA, RehomeRecord, WireError, decode_frame,
                   encode_digests, encode_page, encode_rehome)
from ..obs.tenant import TenantLedger, TenantSLO

__all__ = ["EngineCounters", "ServingConfig", "ServingEngine",
           "prefill_buckets", "FaultInjector", "InjectedFault", "NULL_PAGE",
           "HostTier", "HostTierRestoreError", "PageAllocator",
           "PagedCacheConfig", "PagedKVCache", "SpilledPage", "SwapHandle",
           "EngineOverloaded", "Request", "Scheduler", "SpecConfig",
           "prefix_digest", "ChannelConfig", "SimChannel", "Transport",
           "TransportConfig", "FleetConfig", "FleetRouter", "TPContext",
           "quantized_psum", "init_pools", "ServingMetrics", "SLOConfig",
           "SLOController", "TenantSLO", "TenantLedger", "WIRE_SCHEMA",
           "WireError", "RehomeRecord", "encode_page", "encode_digests",
           "encode_rehome", "decode_frame", "CircuitBreaker", "ChaosConfig",
           "ChaosInvariantError"]
