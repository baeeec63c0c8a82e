"""Executed-step auditor — the port of ``paddle_tpu/analysis/hlocheck.py``.

The reference AOT-lowers a jitted step and reads the optimized HLO. The
port compiles nothing, so there is no HLO: this module keeps the name
(so a reader finds the counterpart) and audits one *executed* step
instead — the step callable runs once inside a census, and the report
holds what that run did:

- **Collective census** — every ``distributed.collective.all_reduce``
  the step issues (its ``census()``), with its payload bytes and the
  ranks of its group, enforced against a declared
  :class:`CollectiveBudget`: a single-card step budgets zero, a
  tensor-parallel step exactly the ``2L + 1`` all-reduces (``2L + 2``
  with quantized logits) its Megatron split implies, byte-capped
  (``serving/tp.py`` ``TPContext.step_budget``).
- **Host transfers** — the host's reads of the device inside the step's
  device program (an ``analysis.tracecheck.SyncTally`` around the run;
  on the card the synchronising CUDA operations too). The engine splits
  each step into a guarded device program and its one read, so the
  program's budget is zero.
- **Aliasing** — every donated tensor (the KV pools and their scales)
  is written in place: its ``data_ptr()`` unchanged and its ``_version``
  moved. A step that copies a pool instead raises
  :class:`AliasingViolation`, the reference's 2x-memory contract.
- **Flops and peak bytes** — from :func:`step_cost`, an analytic model at
  the program's shapes, standing in for ``cost_analysis`` /
  ``memory_analysis``.

``overlap_frac`` is 0 in the port: no collective is asynchronous, so a
budget's ``min_overlap_frac`` passes vacuously, as on the reference's
CPU mesh, where every collective compiles synchronous (so
:class:`CollectiveOverlapError` is never raised).

:data:`REGISTRY` names the auditable steps (the engine's prefill, chunk,
decode and verify on a toy GPT, the int8-pool twins, the cache's swap
and copy-on-write movers, and the TP=2 engine steps, run in two spawned
gloo ranks); ``python -m paddle_tpu_torch.analysis hlo [--step NAME]``
sweeps them. ``ServingConfig(debug_checks=True)`` audits every engine
program once, at its first call: the audited run is the engine's own
call, so the audit costs the census and nothing else.

Nothing here imports the serving stack at module level.
"""
from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass, field, replace

import torch

from .tracecheck import SyncTally, _param_names, flatten_args

__all__ = ["CollectiveBudget", "CollectiveOp", "HostTransfer",
           "HloAuditReport", "HloCheckError", "CollectiveBudgetError",
           "CollectiveOverlapError", "HostTransferError",
           "AliasingViolation", "SINGLE_CHIP", "StepCost", "step_cost",
           "audit", "audit_guard", "StepSpec", "REGISTRY", "run_step",
           "main"]


class HloCheckError(RuntimeError):
    """A step audit failed."""


class CollectiveBudgetError(HloCheckError):
    """The step issued more collective traffic than its declared
    CollectiveBudget. The message names the op kind, count, and bytes."""


class CollectiveOverlapError(HloCheckError):
    """Fewer than ``min_overlap_frac`` of the step's asynchronous
    collectives overlap compute (never raised in the port: none is
    asynchronous)."""


class HostTransferError(HloCheckError):
    """The step's device program read the device from the host beyond its
    budget — a stall of the dispatch pipeline mid-step."""


class AliasingViolation(HloCheckError):
    """A donated tensor was not written in place: the step copied it (two
    copies live — for a KV pool, a silent 2x memory cost) or never wrote
    it."""


# ------------------------------------------------------------------ records
@dataclass(frozen=True)
class CollectiveOp:
    kind: str     # all-reduce (the one collective the port issues)
    nbytes: int   # payload bytes of the call's tensor
    instr: str    # the call's place in the step: "all-reduce#i"
    line: str     # kind, dtype, shape and group, for messages
    # the participant ranks: one group, the ranks of the call's process
    # group (the reference parses them from replica_groups)
    replica_groups: tuple = ()
    group_count: int = 0


@dataclass(frozen=True)
class HostTransfer:
    kind: str    # the read: item / tolist / cpu / cuda_sync / ...
    detail: str
    line: str


# ------------------------------------------------------------------ budgets
@dataclass(frozen=True)
class CollectiveBudget:
    """Per-step ceiling on collective and host-transfer traffic. The
    default is the single-card serving contract: ZERO everything — a
    sharded step declares exactly the collectives its partitioning implies
    (and optionally caps their total payload bytes). The per-medium arms
    (``max_ici_bytes`` / ``max_dcn_bytes`` / ``max_dcn_ops``) need a
    declared topology and are checked by ``meshcheck.MeshReport.check``."""
    all_reduce: int = 0
    all_gather: int = 0
    reduce_scatter: int = 0
    collective_permute: int = 0
    all_to_all: int = 0
    collective_broadcast: int = 0
    host_transfers: int = 0
    max_collective_bytes: int | None = None
    max_ici_bytes: int | None = None
    max_dcn_bytes: int | None = None
    max_dcn_ops: int | None = None
    min_overlap_frac: float = 0.0

    def allowed(self, kind: str) -> int:
        return getattr(self, kind.replace("-", "_"), 0)


#: the single-card serving contract: no collectives, no host transfers
SINGLE_CHIP = CollectiveBudget()


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB"):
        if abs(n) < 1024:
            return f"{n:.0f} {unit}" if unit == "B" else f"{n:.1f} {unit}"
        n /= 1024
    return f"{n:.2f} GiB"


# ------------------------------------------------------------------- report
@dataclass(frozen=True)
class HloAuditReport:
    """Everything one executed step admits."""
    name: str
    collectives: tuple[CollectiveOp, ...] = ()
    host_transfers: tuple[HostTransfer, ...] = ()
    donated_leaves: int = 0
    aliased_leaves: int = 0
    donated_bytes: int = 0
    alias_bytes: int = 0
    unaliased: tuple[str, ...] = ()  # donated leaves not written in place
    flops: float = 0.0
    peak_bytes: int = 0
    # the audited run's return value: the engine's own call
    outputs: object = field(default=None, repr=False, compare=False)

    def counts(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for c in self.collectives:
            out[c.kind] = out.get(c.kind, 0) + 1
        return out

    @property
    def collective_bytes(self) -> int:
        return sum(c.nbytes for c in self.collectives)

    @property
    def overlap_frac(self) -> float:
        """overlapped / asynchronous collectives: 0.0, none is
        asynchronous."""
        return 0.0

    def enforce(self, budget: CollectiveBudget) -> "HloAuditReport":
        """Raise naming the offending op when the step exceeds the budget;
        aliasing of donated tensors is always enforced."""
        for kind, n in sorted(self.counts().items()):
            allowed = budget.allowed(kind)
            if n > allowed:
                first = next(c for c in self.collectives if c.kind == kind)
                raise CollectiveBudgetError(
                    f"hlocheck({self.name!r}): {kind} x{n} "
                    f"({_fmt_bytes(self.collective_bytes)} total collective "
                    f"payload) exceeds the declared budget of {allowed} — "
                    f"first over-budget op: {first.line}")
        if budget.max_collective_bytes is not None and \
                self.collective_bytes > budget.max_collective_bytes:
            raise CollectiveBudgetError(
                f"hlocheck({self.name!r}): total collective payload "
                f"{self.collective_bytes} bytes exceeds the declared cap of "
                f"{budget.max_collective_bytes} bytes "
                f"({', '.join(sorted(self.counts()))})")
        if len(self.host_transfers) > budget.host_transfers:
            first = self.host_transfers[0]
            raise HostTransferError(
                f"hlocheck({self.name!r}): {len(self.host_transfers)} "
                f"host read(s) inside the step's device program (budget "
                f"{budget.host_transfers}) — every one stalls the dispatch "
                f"pipeline mid-step. First: {first.kind} ({first.detail})")
        if self.donated_leaves and (
                self.aliased_leaves < self.donated_leaves
                or self.alias_bytes < self.donated_bytes):
            who = (f" — not written in place: {', '.join(self.unaliased)}"
                   if self.unaliased else "")
            raise AliasingViolation(
                f"hlocheck({self.name!r}): {self.donated_leaves} donated "
                f"tensor(s) ({_fmt_bytes(self.donated_bytes)}) but only "
                f"{self.aliased_leaves} ({_fmt_bytes(self.alias_bytes)}) "
                f"written in place — a donated-but-copied pool holds TWO "
                f"copies live (for a KV pool, a silent 2x memory cost){who}")
        return self

    def summary(self) -> str:
        c = self.counts()
        coll = ", ".join(f"{k}x{v}" for k, v in sorted(c.items())) or "none"
        alias = (f"{self.aliased_leaves}/{self.donated_leaves} donated "
                 f"written in place" if self.donated_leaves
                 else "no donation")
        return (f"hlocheck {self.name}: collectives {coll} "
                f"({_fmt_bytes(self.collective_bytes)}); overlap n/a "
                f"(sync); host transfers {len(self.host_transfers)}; "
                f"{alias}; flops/step {self.flops:.4g}; peak bytes "
                f"{_fmt_bytes(self.peak_bytes)}")


# --------------------------------------------------------------- cost model
@dataclass(frozen=True)
class StepCost:
    """One program's analytic cost on one rank."""
    flops: float
    param_bytes: int
    kv_bytes: int
    activation_bytes: int

    @property
    def peak_bytes(self) -> int:
        return self.param_bytes + self.kv_bytes + self.activation_bytes


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def step_cost(model_cfg, label: str, batch: int, seq: int, width: int,
              dtype=torch.float32, kv_dtype: str = "float32",
              tp: int = 1) -> StepCost:
    """The analytic cost of one GPT serving program on one of ``tp``
    ranks: ``batch`` rows of ``seq`` new tokens each (``prefill[N]``: 1 x
    N, ``decode``: max_batch x 1, ``verify``: max_batch x (K + 1)) over a
    page table ``width`` positions wide (pages_per_seq x page_size).

    Flops (``T = batch * seq`` tokens, ``L`` layers, hidden ``h``, ffn
    ``f``, vocab ``V``): the matmuls, ``2 T P`` with ``P = L (4 h^2 +
    2 h f) + V h`` (qkv, out, fc1, fc2 and the LM head), plus attention
    at the program's padded width, ``4 T L h width`` (the scores and the
    PV product over every table position) — both divided by ``tp`` (the
    heads, the ffn and the head's contraction are split). The elementwise
    work is left out: at real widths it is a small share.

    Peak bytes: the rank's parameters, the KV its page tables address
    (``batch * width`` positions of every layer's K and V, int8 codes
    plus their page scales for int8 pools) and the step's activations
    (``T`` rows of ``2 h + (3 h + f) / tp + V`` elements: the residual
    stream, one block's widest intermediates and the logits)."""
    L, h, V = model_cfg.num_layers, model_cfg.hidden_size, \
        model_cfg.vocab_size
    f = model_cfg.ffn_hidden
    item = _itemsize(dtype)
    tokens = batch * seq
    matmul = L * (4 * h * h + 2 * h * f) + V * h
    flops = (2.0 * tokens * matmul + 4.0 * tokens * L * h * width) / tp
    per_layer = (4 * h * h + 2 * h * f) // tp + (3 * h + f) // tp \
        + 2 * h + 4 * h  # sharded weights and biases, out/fc2 bias, 2 LNs
    embed = V * h + model_cfg.max_seq_len * h
    head = 0 if model_cfg.tie_word_embeddings else V * h
    params = (L * per_layer + embed + head + 2 * h) * item
    heads = model_cfg.num_heads // tp
    hd = h // model_cfg.num_heads
    positions = batch * width
    if kv_dtype == "int8":
        kv = 2 * L * positions * heads * hd + 2 * L * positions * heads * 4
    else:
        kv = 2 * L * positions * heads * hd * item
    act = tokens * (2 * h + (3 * h + f) // tp + V) * item
    return StepCost(flops=flops, param_bytes=params, kv_bytes=kv,
                    activation_bytes=act)


# -------------------------------------------------------------------- audit
def _census_ops(calls) -> tuple:
    ops = []
    for i, (kind, nbytes, ranks, dtype, shape) in enumerate(calls):
        ops.append(CollectiveOp(
            kind=kind, nbytes=int(nbytes), instr=f"{kind}#{i}",
            line=f"{kind} {dtype}{list(shape)} over ranks {list(ranks)}",
            replica_groups=(tuple(ranks),), group_count=1))
    return tuple(ops)


def audit(fn, args, *, name: str | None = None, donate_argnums=(),
          budget: CollectiveBudget | None = None,
          cost: StepCost | None = None) -> HloAuditReport:
    """Run ``fn(*args)`` once inside a collective census and a SyncTally
    and audit what it did: the collectives, the host reads, whether every
    tensor of the ``donate_argnums`` arguments was written in place. The
    run's return value is kept on ``report.outputs``. ``cost`` supplies
    the flops and byte figures (:func:`step_cost`); with ``budget`` the
    report is enforced before being returned."""
    from ..distributed import collective

    name = name or getattr(fn, "__name__", "step")
    params = _param_names(getattr(fn, "fn", fn))
    donated = [(n, t, t.data_ptr(), t._version)
               for i in donate_argnums if i < len(args)
               for n, t in flatten_args((args[i],), None, params[i:i + 1])
               if isinstance(t, torch.Tensor)]
    with collective.census() as calls, SyncTally() as tally:
        out = fn(*args)
    ok = [t.data_ptr() == ptr and t._version != ver
          for _, t, ptr, ver in donated]
    written = [d[1] for d, w in zip(donated, ok) if w]
    unaliased = tuple(d[0] for d, w in zip(donated, ok) if not w)
    report = HloAuditReport(
        name=name, collectives=_census_ops(calls),
        host_transfers=tuple(HostTransfer(kind, f"{kind} inside {name}",
                                          kind) for kind in tally.events),
        donated_leaves=len(donated), aliased_leaves=len(written),
        donated_bytes=sum(t.numel() * t.element_size()
                          for _, t, _, _ in donated),
        alias_bytes=sum(t.numel() * t.element_size() for t in written),
        unaliased=unaliased,
        flops=cost.flops if cost is not None else 0.0,
        peak_bytes=cost.peak_bytes if cost is not None else 0,
        outputs=out)
    if budget is not None:
        report.enforce(budget)
    return report


def audit_guard(guard, args, budget: CollectiveBudget | None = None,
                name: str | None = None,
                cost: StepCost | None = None) -> HloAuditReport:
    """Audit one call of a CompileGuard-wrapped step: the guard itself
    runs (so the call counts and is checked as any other) and its
    ``donate_argnums`` are read off it, so the audit can never
    desynchronise from what the guard donates."""
    return audit(guard, args, name=name or guard.name,
                 donate_argnums=guard.donate_argnums, budget=budget,
                 cost=cost)


# ----------------------------------------------------------------- registry
@dataclass(frozen=True)
class StepSpec:
    """A named auditable step: ``build()`` returns ``(target, args,
    budget, cost)`` — a CompileGuard, its arguments, the declared budget
    and the cost model (or None). ``ranks`` > 1: the step runs in that
    many spawned gloo ranks (tensor parallelism) and ``build`` is called
    in each."""
    name: str
    doc: str
    build: object = field(repr=False)
    ranks: int = 1


_TOY = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=2,
            max_seq_len=32)


def _toy_engine(tensor_parallel=1, kv_dtype="float32", spec=False,
                quantized_logits=False):
    from ..serving.engine import ServingConfig, ServingEngine
    from ..serving.spec import SpecConfig
    from ..text.gpt import GPTConfig, GPTForCausalLM

    model = GPTForCausalLM(GPTConfig(**_TOY), device="cpu",
                           generator=torch.Generator().manual_seed(7))
    return ServingEngine(model, ServingConfig(
        max_batch=2, num_pages=16, page_size=4, max_prompt_len=8,
        tensor_parallel=tensor_parallel, kv_dtype=kv_dtype,
        spec=SpecConfig(method="ngram", depth=2) if spec else None,
        tp_quantized_logits=quantized_logits, debug_checks=True),
        device="cpu")


def _build_engine_step(which: str, tensor_parallel: int = 1,
                       kv_dtype: str = "float32",
                       quantized_logits: bool = False):
    """The engine's programs on a toy GPT, with the budget and cost model
    the engine itself declares."""
    import numpy as np

    eng = _toy_engine(tensor_parallel, kv_dtype, which == "verify_spec",
                      quantized_logits)
    if which == "verify_spec":
        return (eng._verify_jit, eng._verify_args(),
                eng._step_budget("verify"), eng._step_cost("verify"))
    if which in ("prefill", "prefill_chunk"):
        bucket = eng.prefill_buckets[0]
        padded = np.zeros(bucket, np.int64)
        if which == "prefill":
            padded[:3] = (5, 7, 11)
            tail, ctx0 = 3, 0
        else:
            # a mid-prompt chunk: queries at ctx0 > 0 through the same
            # program shape
            padded[:4] = (3, 5, 7, 11)
            tail, ctx0 = 4, 4
        label = f"prefill[{bucket}]"
        return (eng._prefill_jit,
                eng._prefill_args(padded, tail, ctx0, 0, 1),
                eng._step_budget(label), eng._step_cost(label))
    return (eng._decode_jit, eng._decode_args(), eng._step_budget("decode"),
            eng._step_cost("decode"))


def _build_cache_step(which: str, kv_dtype: str = "float32"):
    """The cache's movers: zero collectives, scatter and copy donate the
    pools."""
    import numpy as np

    from ..serving.kv_cache import PagedCacheConfig, PagedKVCache

    cache = PagedKVCache(PagedCacheConfig(
        num_layers=2, num_heads=2, head_dim=4, num_pages=8, page_size=4,
        max_batch=2, pages_per_seq=4, kv_dtype=kv_dtype), device="cpu")
    idx = cache._index(np.zeros(cache.cfg.pages_per_seq, np.int64))
    if which == "swap_gather":
        return (cache._gather_jit, (cache.pools, cache.scales, idx),
                SINGLE_CHIP, None)
    if which == "swap_scatter":
        data, sc = cache._gather_jit(cache.pools, cache.scales, idx)
        return (cache._scatter_jit,
                (cache.pools, cache.scales, idx, data.clone(),
                 None if sc is None else sc.clone()), SINGLE_CHIP, None)
    return (cache._copy_jit, (cache.pools, cache.scales, cache._index([1]),
                              cache._index([2])), SINGLE_CHIP, None)


REGISTRY: dict[str, StepSpec] = {s.name: s for s in (
    StepSpec("swap_gather", "paged-cache swap-out gather (reads only, no "
             "donation)", lambda: _build_cache_step("swap_gather")),
    StepSpec("swap_scatter", "paged-cache swap-in scatter (pools donated)",
             lambda: _build_cache_step("swap_scatter")),
    StepSpec("cow_copy", "prefix-cache copy-on-write page copy (pools "
             "donated)", lambda: _build_cache_step("cow_copy")),
    StepSpec("engine_prefill", "serving prefill, smallest pad bucket (toy "
             "GPT)", lambda: _build_engine_step("prefill")),
    StepSpec("engine_prefill_chunk", "serving chunked prefill: one "
             "mid-prompt chunk at ctx0 > 0 through the prefill program",
             lambda: _build_engine_step("prefill_chunk")),
    StepSpec("engine_decode", "serving decode, whole batch (toy GPT)",
             lambda: _build_engine_step("decode")),
    StepSpec("engine_verify_spec", "speculative verify: n-gram propose + "
             "K+1-token ragged verify + accept count, one program",
             lambda: _build_engine_step("verify_spec")),
    StepSpec("engine_decode_q8", "serving decode over int8 pools (codes "
             "and scales donated)",
             lambda: _build_engine_step("decode", kv_dtype="int8")),
    StepSpec("swap_gather_q8", "swap gather over int8 pools",
             lambda: _build_cache_step("swap_gather", "int8")),
    StepSpec("swap_scatter_q8", "swap scatter into int8 pools",
             lambda: _build_cache_step("swap_scatter", "int8")),
    StepSpec("tp2_engine_prefill", "TENSOR-PARALLEL prefill (TP=2, budget "
             "2L+1 all-reduces)",
             lambda: _build_engine_step("prefill", 2), ranks=2),
    StepSpec("tp2_engine_decode", "TENSOR-PARALLEL decode (TP=2, budget "
             "2L+1 all-reduces)",
             lambda: _build_engine_step("decode", 2), ranks=2),
    StepSpec("tp2_engine_verify_spec", "TENSOR-PARALLEL verify: the "
             "decode budget, the proposer adds no collective",
             lambda: _build_engine_step("verify_spec", 2), ranks=2),
    StepSpec("tp2_engine_decode_qlogits", "TENSOR-PARALLEL decode with the "
             "int8 logits all-reduce (budget 2L+2)",
             lambda: _build_engine_step("decode", 2,
                                        quantized_logits=True), ranks=2),
)}


def _audit_spec(spec: StepSpec) -> tuple:
    target, args, budget, cost = spec.build()
    report = audit_guard(target, args, budget=budget, name=spec.name,
                         cost=cost)
    # the outputs stay behind: they may not cross a process boundary
    return replace(report, outputs=None), budget


def _rank_main(rank: int, world: int, rdv: str, names: list):
    """One spawned rank of the tensor-parallel registry steps ``names``,
    audited one after another in one process group: each step's ``(report,
    budget)``, or ``(None, "Type: message")`` for a step that raised."""
    from ..distributed import env

    env.init_parallel_env("gloo", rdv, world, rank, timeout_s=120)
    out = {}
    try:
        for name in names:
            try:
                out[name] = _audit_spec(REGISTRY[name])
            except Exception as e:  # noqa: BLE001 — reported per step
                out[name] = (None, f"{type(e).__name__}: {e}")
        return out
    finally:
        env.destroy_process_group()


class StepFailed(RuntimeError):
    """A tensor-parallel step raised in its spawned ranks; the message is
    the rank's ``Type: message``."""


def run_steps(names) -> dict:
    """Build and audit the registered steps ``names``: ``{name: (report,
    budget)}``, or ``{name: exception}`` for a step that failed (its
    budget violated, HloCheckError; or raised). The single-process steps
    run here; the tensor-parallel ones of each rank count share one
    spawn, their ranks running them one after another (a spawned gloo
    rank costs seconds before it computes anything); rank 0's pairs are
    returned."""
    names = list(names)
    unknown = [n for n in names if n not in REGISTRY]
    if unknown:
        raise KeyError(f"unknown hlocheck step(s) {', '.join(unknown)} "
                       f"(have: {', '.join(REGISTRY)})")
    out: dict = {}
    by_ranks: dict = {}
    for name in names:
        spec = REGISTRY[name]
        if spec.ranks > 1:
            by_ranks.setdefault(spec.ranks, []).append(name)
            continue
        try:
            out[name] = _audit_spec(spec)
        except Exception as e:  # noqa: BLE001 — reported per step
            out[name] = e
    from ..distributed import spawn

    for ranks, group in by_ranks.items():
        with tempfile.TemporaryDirectory(prefix="hlocheck-") as d:
            rdv = "file://" + os.path.join(d, "rdv")
            got = spawn(_rank_main, ranks, (rdv, group), timeout_s=300.0)[0]
        for name in group:
            report, budget = got[name]
            out[name] = StepFailed(budget) if report is None \
                else (report, budget)
    return {name: out[name] for name in names}


def run_step(name: str) -> tuple:
    """Build and audit one registered step, enforcing its declared budget
    (HloCheckError on violation); returns ``(report, budget)``. A
    tensor-parallel step runs in its spawned ranks; rank 0's pair is
    returned."""
    spec = REGISTRY.get(name)
    if spec is None:
        raise KeyError(f"unknown hlocheck step {name!r} "
                       f"(have: {', '.join(REGISTRY)})")
    if spec.ranks == 1:
        return _audit_spec(spec)
    got = run_steps([name])[name]
    if isinstance(got, Exception):
        raise got
    return got


def main(argv=None, audits: dict | None = None) -> int:
    """``audits``: a dict this run fills with each step's ``run_steps``
    result, for a later engine of the same gate (``check_all``)."""
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.analysis hlo",
        description="Executed-step auditor: collective census, host reads "
                    "and in-place writes of donated tensors, flops and "
                    "bytes for every registered step.")
    parser.add_argument("--step", action="append", default=None,
                        metavar="NAME",
                        help="audit only these registered steps "
                             "(repeatable; default: all)")
    parser.add_argument("--list-steps", action="store_true",
                        help="print the step registry and exit")
    args = parser.parse_args(argv)
    if args.list_steps:
        for s in REGISTRY.values():
            extra = f" [{s.ranks} ranks]" if s.ranks > 1 else ""
            print(f"{s.name}  {s.doc}{extra}")
        return 0
    names = args.step or list(REGISTRY)
    unknown = [n for n in names if n not in REGISTRY]
    if unknown:
        print(f"unknown step(s): {', '.join(unknown)} "
              f"(have: {', '.join(REGISTRY)})")
        return 2
    failed = 0
    results = run_steps(names)
    if audits is not None:
        audits.update(results)
    for name in names:
        got = results[name]
        if isinstance(got, Exception):
            # one broken step does not end the sweep; it fails the exit
            # code
            print(f"FAIL {name}: {type(got).__name__}: {got}")
            failed += 1
        else:
            print(got[0].summary())
    if failed:
        print(f"{failed} step(s) failed")
    else:
        print(f"hlocheck clean: {len(names)} step(s) within budget")
    return 1 if failed else 0
