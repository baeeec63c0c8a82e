"""The serving loop: scheduler + paged cache + model — the port of
``paddle_tpu/serving/engine.py`` (greedy decoding, prefix caching,
recompute preemption, float or int8 KV pools, the host spill tier, no
chunking, tracing off).

Each ``step()``: admit waiting requests FIFO, prefill each admitted one
(its uncached prompt tail, right-padded to the smallest pad bucket, with
queries entering at ``ctx = cached tokens``), make sure every running
slot has a page for its next token (preempting by recompute when the pool
is dry), then one decode step for the whole ``[max_batch]`` batch —
inactive slots run the same computation against the null page and emit
pad. Outputs are the reference's greedy tokens.

The JAX engine compiles one program per pad bucket plus one decode
program and donates the pools to them. PyTorch runs eagerly: the pad
buckets are kept so the two engines compute over the same shapes, and
the pools are written in place by the model (the counterpart of the
donation). The host reads the device once per prefill (its first token)
and once per decode step (the batch's tokens); host-tier spills and
restores are the cache's own copies, made at admission.

A request whose host-tier restore fails is retired FAILED (``failed``
holds its error) and the step goes on serving everyone else.

A ``ServingConfig`` field the port does not have yet raises
NotImplementedError naming the ROADMAP item that brings it.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, fields

import numpy as np
import torch

from .._device import resolve_device
from ..text.gpt import PagedBatch
from .kv_cache import KV_DTYPES, PagedCacheConfig, PagedKVCache
from .scheduler import Request, Scheduler

__all__ = ["ServingConfig", "EngineCounters", "ServingEngine",
           "prefill_buckets"]

# Reference ServingConfig fields the port does not serve yet: the
# reference default (the only value accepted) and where it is planned.
_LATER = {
    "do_sample": (False, "sampling: ROADMAP Queue 1 item 5"),
    "max_waiting": (0, "the bounded waiting queue and shedding: ROADMAP "
                       "Queue 1 item 4"),
    "shed_policy": ("reject", "the bounded waiting queue and shedding: "
                              "ROADMAP Queue 1 item 4"),
    "preemption_mode": ("recompute", "swap preemption: ROADMAP Queue 1 "
                                     "item 4"),
    "chunk_size": (0, "chunked prefill: ROADMAP Queue 1 item 4"),
    "slo": (None, "SLO admission: ROADMAP Queue 1 item 6"),
    "spec": (None, "speculative decoding: ROADMAP Queue 1 item 6"),
    "tensor_parallel": (1, "tensor parallelism: ROADMAP Queue 1 item 9"),
    "debug_checks": (False, "the analysis contracts: ROADMAP Queue 1 "
                            "item 11"),
    "enable_tracing": (False, "the observability layer: ROADMAP Queue 1 "
                              "item 8"),
}


@dataclass(frozen=True)
class ServingConfig:
    max_batch: int = 4
    num_pages: int = 64
    page_size: int = 16
    pages_per_seq: int = 0  # 0 -> ceil(max_seq_len / page_size)
    max_prompt_len: int = 32  # the largest prefill pad bucket
    eos_token_id: int | None = None
    pad_token_id: int = 0
    enable_prefix_caching: bool = True  # cross-request KV page sharing
    # "float32": pools in the model's dtype; "int8": codes + page scales
    kv_dtype: str = "float32"
    host_tier_bytes: int = 0  # host spill tier for evicted prefix pages
    # not served yet: accepted at the reference default only (see _LATER)
    do_sample: bool = False
    max_waiting: int = 0
    shed_policy: str = "reject"
    preemption_mode: str = "recompute"
    chunk_size: int = 0
    slo: object = None
    spec: object = None
    tensor_parallel: int = 1
    debug_checks: bool = False
    enable_tracing: bool = False

    def __post_init__(self):
        for f in fields(self):
            if f.name in _LATER:
                default, where = _LATER[f.name]
                if getattr(self, f.name) != default:
                    raise NotImplementedError(
                        f"ServingConfig({f.name}={getattr(self, f.name)!r}) "
                        f"is not ported yet — {where}")
        if self.kv_dtype not in KV_DTYPES:
            raise ValueError(f"kv_dtype {self.kv_dtype!r} not in "
                             f"{KV_DTYPES}")
        if self.host_tier_bytes < 0:
            raise ValueError(f"host_tier_bytes {self.host_tier_bytes} < 0")
        if self.host_tier_bytes and not self.enable_prefix_caching:
            raise ValueError(
                "host_tier_bytes gives evicted indexed prefix pages a second "
                "life — enable_prefix_caching=False would leave nothing to "
                "spill; enable it or drop the tier")


def prefill_buckets(max_prompt_len: int) -> list[int]:
    """The prefill pad buckets: powers of two from 8 up, capped at (and
    always including) ``max_prompt_len``."""
    buckets, b = [], 8
    while b < max_prompt_len:
        buckets.append(b)
        b *= 2
    buckets.append(max_prompt_len)
    return buckets


@dataclass
class EngineCounters:
    """Plain counters of what the engine did. The two times are host-clock
    seconds from dispatch through the token fetch that ends each prefill or
    decode step (the fetch waits for the device). The cache's counts
    (``prefix_evictions`` and the ``host_tier_*`` ones, under the
    reference's gauge names) are read after every step."""
    prefills: int = 0
    decode_steps: int = 0
    tokens: int = 0
    preemptions: int = 0
    prefix_hit_tokens: int = 0
    prefill_tokens: int = 0  # prompt tokens actually prefilled
    failed: int = 0  # requests retired FAILED (a host-tier restore failed)
    prefill_seconds: float = 0.0
    decode_seconds: float = 0.0
    kv_bytes_per_token: int = 0
    prefix_evictions: int = 0
    host_tier_pages: int = 0
    host_tier_bytes: int = 0
    host_tier_hits: int = 0
    host_tier_spills: int = 0
    host_tier_restores: int = 0


class ServingEngine:
    """Continuous-batching engine over a port ``GPTForCausalLM``.

    ``device`` (``None`` = the card; raises when there is none) must be
    the device the model lives on; the KV pool is allocated there."""

    def __init__(self, model, config: ServingConfig | None = None,
                 device=None):
        dev = resolve_device(device)
        if model.device.type != dev.type:
            raise ValueError(f"the model lives on {model.device}, the engine "
                             f"was asked for {dev}")
        self.device = model.device
        self.config = cfg = config or ServingConfig()
        self.model = model.eval()
        mc = model.cfg
        if cfg.max_prompt_len > mc.max_seq_len:
            raise ValueError(
                f"max_prompt_len {cfg.max_prompt_len} exceeds the model's "
                f"max_seq_len {mc.max_seq_len}")
        pages_per_seq = cfg.pages_per_seq or -(-mc.max_seq_len // cfg.page_size)
        self.cache = PagedKVCache(PagedCacheConfig(
            num_layers=mc.num_layers, num_heads=mc.num_heads,
            head_dim=mc.hidden_size // mc.num_heads,
            num_pages=cfg.num_pages, page_size=cfg.page_size,
            max_batch=cfg.max_batch, pages_per_seq=pages_per_seq,
            dtype=model.dtype,
            enable_prefix_caching=cfg.enable_prefix_caching,
            kv_dtype=cfg.kv_dtype, host_tier_bytes=cfg.host_tier_bytes),
            device=self.device)
        self.prefill_buckets = prefill_buckets(cfg.max_prompt_len)
        self.scheduler = Scheduler(self.cache, cfg.max_batch)
        self.counters = EngineCounters(
            kv_bytes_per_token=self.cache.cfg.kv_bytes_per_token)
        self.failed: dict[int, BaseException] = {}  # rid -> restore error
        b = cfg.max_batch
        self._ctx = np.zeros(b, np.int32)
        self._last_tok = np.full(b, cfg.pad_token_id, np.int32)
        self._active = np.zeros(b, bool)
        self._finished: dict[int, np.ndarray] = {}

    # ------------------------------------------------------------ requests
    def add_request(self, prompt, max_new_tokens: int) -> int:
        """Queue a prompt; returns the request id. Raises ValueError when
        the request could never run (empty, too long for the largest
        bucket, the model, or the whole pool)."""
        if isinstance(prompt, torch.Tensor):
            prompt = prompt.detach().cpu().numpy()
        prompt = np.asarray(prompt)
        if prompt.ndim != 1:
            raise ValueError(f"prompt must be 1-D, got shape {prompt.shape}")
        if prompt.shape[0] == 0:
            raise ValueError("prompt must contain at least one token")
        if int(max_new_tokens) <= 0:
            raise ValueError("max_new_tokens must be positive")
        if prompt.shape[0] > self.config.max_prompt_len:
            raise ValueError(
                f"prompt_len {prompt.shape[0]} exceeds max_prompt_len "
                f"{self.config.max_prompt_len}")
        total = prompt.shape[0] + int(max_new_tokens)
        if total > self.model.cfg.max_seq_len:
            raise ValueError(
                f"prompt_len + max_new_tokens = {total} exceeds max_seq_len "
                f"{self.model.cfg.max_seq_len}")
        req = Request(prompt=prompt.astype(np.int32),
                      max_new_tokens=int(max_new_tokens))
        self.scheduler.add(req)
        return req.rid

    def result(self, rid: int) -> np.ndarray:
        return self._finished[rid]

    def pop_finished(self) -> dict[int, np.ndarray]:
        """Drain and return every completed output (prompt + generated)."""
        done, self._finished = self._finished, {}
        return done

    # --------------------------------------------------------------- steps
    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    @torch.no_grad()
    def _prefill(self, req: Request) -> int:
        """One request's uncached prompt tail in one pass; returns its
        first generated token (greedy)."""
        cached = req.cached_tokens
        tail = req.prompt[cached:]
        n = len(tail)
        bucket = next(b for b in self.prefill_buckets if b >= n)
        padded = np.full(bucket, self.config.pad_token_id, np.int32)
        padded[:n] = tail
        paged = PagedBatch(
            pools=self.cache.pools,
            page_table=self._to_device(self.cache.page_table[req.slot:req.slot + 1]),
            ctx_lens=self._to_device(np.array([cached], np.int32)),
            valid=self._to_device(np.arange(bucket) < n)[None, :],
            scales=self.cache.scales)
        logits = self.model(self._to_device(padded).long()[None, :],
                            paged=paged)
        return int(logits[0, n - 1].argmax())

    @torch.no_grad()
    def _decode(self) -> np.ndarray:
        """One token for every slot; inactive slots emit pad."""
        active = self._to_device(self._active)
        paged = PagedBatch(pools=self.cache.pools,
                           page_table=self._to_device(self.cache.page_table),
                           ctx_lens=self._to_device(self._ctx),
                           valid=active[:, None], scales=self.cache.scales)
        logits = self.model(self._to_device(self._last_tok).long()[:, None],
                            paged=paged)
        toks = logits[:, -1].argmax(dim=-1)
        toks = torch.where(active, toks, self.config.pad_token_id)
        return toks.cpu().numpy()  # the step's one device -> host fetch

    def _clear_slot(self, slot: int) -> None:
        self._active[slot] = False
        self._ctx[slot] = 0
        self._last_tok[slot] = self.config.pad_token_id

    def _maybe_finish(self, req: Request, tok: int) -> bool:
        eos = self.config.eos_token_id
        if len(req.generated) >= req.max_new_tokens or \
                (eos is not None and tok == eos):
            slot = req.slot
            # index the generated span too (all but the final token, whose
            # KV was never written), then release: indexed pages park
            # reclaimable instead of freed
            self.cache.register_prefix(slot, req.output()[:-1])
            self.scheduler.finish(req)
            self._clear_slot(slot)
            self._finished[req.rid] = req.output()
            return True
        return False

    def step(self) -> list[int]:
        """One continuous-batching iteration: admit + prefill joiners,
        preempt if the pool is dry, one decode step for the batch, retire
        finishers. Returns the ids of requests that finished."""
        c = self.counters
        finished = []
        admitted = self.scheduler.admit()
        # a failed host-tier restore undid that request's admission: retire
        # it FAILED and serve everyone else
        for req, err in self.scheduler.pop_restore_failures():
            self.scheduler.fail(req, err)
            self.failed[req.rid] = err
            c.failed += 1
        for req in admitted:
            t0 = time.perf_counter()
            tok = self._prefill(req)
            c.prefill_seconds += time.perf_counter() - t0
            req.generated.append(tok)
            slot = req.slot
            self._ctx[slot] = req.prompt_len
            self._last_tok[slot] = tok
            self._active[slot] = True
            req.fresh = True
            # every full prompt page is now resident: index it for reuse
            self.cache.register_prefix(slot, req.prompt)
            c.prefills += 1
            c.tokens += 1
            c.prefix_hit_tokens += req.cached_tokens  # 0 with caching off
            c.prefill_tokens += req.prompt_len - req.cached_tokens
            if self._maybe_finish(req, tok):
                finished.append(req.rid)

        for _, slot in self.scheduler.ensure_decode_pages():
            self._clear_slot(slot)
            c.preemptions += 1

        if self._active.any():
            t0 = time.perf_counter()
            toks = self._decode()
            c.decode_seconds += time.perf_counter() - t0
            c.decode_steps += 1
            for slot in np.nonzero(self._active)[0]:
                req = self.scheduler.running[int(slot)]
                tok = int(toks[slot])
                req.generated.append(tok)
                req.fresh = False  # it has decoded: fair game for preemption
                self._ctx[slot] += 1
                self._last_tok[slot] = tok
                c.tokens += 1
                if self._maybe_finish(req, tok):
                    finished.append(req.rid)
        cs = self.cache.stats()
        c.prefix_evictions = cs["evictions"]
        for key in ("host_tier_pages", "host_tier_bytes", "host_tier_hits",
                    "host_tier_spills", "host_tier_restores"):
            setattr(c, key, cs[key])
        return finished

    def run(self, max_steps: int = 100000) -> dict[int, np.ndarray]:
        """Drive step() until every queued request finished; returns
        {request_id: prompt + generated} for the requests that finished
        during this call. Raises RuntimeError past ``max_steps``."""
        done: dict[int, np.ndarray] = {}
        for _ in range(max_steps):
            if self.scheduler.all_done:
                return done
            for rid in self.step():
                done[rid] = self._finished[rid]
        if not self.scheduler.all_done:
            raise RuntimeError(f"serving loop exceeded {max_steps} steps "
                               f"without draining")
        return done
