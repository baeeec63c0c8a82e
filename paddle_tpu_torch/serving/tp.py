"""Tensor-parallel serving — the port of ``paddle_tpu/serving/tp.py``:
the Megatron weight shards, the heads-sharded paged pool, the declared
collective budget and ``quantized_psum``.

Each rank is a process in a ``torch.distributed`` group
(``distributed.init_parallel_env``) that builds the engine with the same
full model. ``TPContext.shard_params`` cuts the rank's part from it, in
the reference's Megatron layout restated for torch's ``[out, in]``
``nn.Linear``:

- ``qkv_proj`` is column-parallel on the heads axis: its output rows,
  laid out ``(3, heads, head_dim)``, are permuted into ``(tp, 3,
  heads / tp, head_dim)`` blocks and the rank keeps block ``rank``.
  Attention is parallel over heads: no communication;
- the paged pool shards the same heads axis: ``[layers, 2, pages,
  page_size, heads / tp, head_dim]`` per rank (int8 scales ``[layers, 2,
  pages, heads / tp]``). Page ids, tables, refcounts, the prefix index
  and the free list are host integers, equal on every rank;
- ``out_proj`` and ``fc2`` are row-parallel: the rank keeps its columns
  of the input axis, and one all-reduce per site (``text/gpt.py``
  ``_tp_psum``) restores the replicated residual stream. Their biases are
  real on rank 0 and zero elsewhere, added before the sum, so the sum is
  ``(p0 + b) + p1`` as in the reference;
- ``fc1`` is column-parallel; embeddings, LayerNorms and the LM head
  weight are replicated, and the head's hidden contraction is split at
  call time (``text/gpt.py`` ``_tp_logits``): one all-reduce of the
  logits.

So one engine step issues ``2 * num_layers + 1`` all-reduces, or ``+ 2``
with ``quantized_logits`` (:meth:`TPContext.step_budget` declares them;
certifying them against a compiled artifact is the reference's
``debug_checks``, ROADMAP Queue 1 item 11). Every rank runs the same
scheduler, keys and sampling on the same post-reduce logits, so the
ranks' tokens are equal.

``overlap_scheduler`` is accepted and changes nothing, as in the
reference on any backend but a TPU (:meth:`TPContext.compiler_options`
returns None).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..distributed import collective, env
from ..text.gpt import TPAxis

__all__ = ["TPContext", "CollectiveBudget", "quantized_psum"]


def quantized_psum(x: torch.Tensor, axis: TPAxis) -> torch.Tensor:
    """The EQuARX-style int8 all-reduce of the reference: every rank
    quantises against one shared step, ``psum(absmax) / (127 - n)`` (a
    4-byte all-reduce), the int8 codes are all-reduced as int8 and
    dequantised. With ``n`` ranks each contributing codes up to
    ``amax_i / step + 1/2``, the int8 sum stays below 127 for any input;
    an all-zero input takes step 1. The step is a reduction result, so
    every rank dequantises to the same bits. Arithmetic as the
    reference's: the division in float32, round half to even."""
    amax = x.abs().max().float().reshape(1)
    total = collective.all_reduce(amax, axis.group)
    step = total / (127 - axis.degree)
    step = torch.where(step > 0, step, torch.ones_like(step))
    codes = torch.clamp(torch.round(x.float() / step), -127, 127) \
        .to(torch.int8)
    ysum = collective.all_reduce(codes, axis.group)
    return ysum.to(x.dtype) * step.to(x.dtype)


@dataclass(frozen=True)
class CollectiveBudget:
    """The collectives one sharded step declares: ``all_reduce`` calls,
    their payload in bytes, and the share of them that must overlap
    compute (1.0 with the overlap scheduler, as in the reference)."""
    all_reduce: int
    max_collective_bytes: int
    min_overlap_frac: float = 0.0


class TPContext:
    """What ``ServingConfig(tensor_parallel=N)`` needs on one rank: the
    validated degree, the rank's place in the process group, the shard
    transforms and the declared budget."""

    def __init__(self, degree: int, model_cfg, *, group=None,
                 overlap_scheduler: bool = False,
                 quantized_logits: bool = False):
        if degree < 2:
            raise ValueError(f"tensor_parallel={degree}: tensor parallelism "
                             f"needs at least 2 ranks (1 = single-card "
                             f"serving)")
        for what, dim in (("num_heads", model_cfg.num_heads),
                          ("hidden_size", model_cfg.hidden_size),
                          ("ffn_hidden", model_cfg.ffn_hidden)):
            if dim % degree:
                raise ValueError(
                    f"tensor_parallel={degree} must divide the model's "
                    f"{what}={dim} (heads shard the KV pool, ffn shards "
                    f"the MLP, hidden shards the LM-head contraction)")
        world = env.get_world_size()
        if world < degree:
            raise ValueError(
                f"tensor_parallel={degree} but only {world} rank(s) in the "
                f"process group — start {degree} ranks and call "
                f"distributed.init_parallel_env(world_size={degree}) in "
                f"each before building the engine")
        if world != degree:
            raise ValueError(
                f"tensor_parallel={degree} in a process group of {world} "
                f"ranks: one engine spans the whole group")
        self.degree = degree
        self.model_cfg = model_cfg
        self.rank = env.get_rank()
        self.axis = TPAxis(group, self.rank, degree)
        self.overlap_scheduler = bool(overlap_scheduler)
        self.quantized_logits = bool(quantized_logits)

    @property
    def local_heads(self) -> int:
        return self.model_cfg.num_heads // self.degree

    # ----------------------------------------------------------- the shards
    def shard_tensor(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The rank's part of one parameter of the full model (port names
        and layout: Linear weights ``[out, in]``)."""
        c, n, r = self.model_cfg, self.degree, self.rank
        heads, hd = c.num_heads, c.hidden_size // c.num_heads
        if name.endswith("qkv_proj.weight") or name.endswith("qkv_proj.bias"):
            blocks = t.reshape(3, n, heads // n, hd, *t.shape[1:])
            return blocks[:, r].reshape(-1, *t.shape[1:]).contiguous()
        if name.endswith("out_proj.weight") or name.endswith("fc2.weight"):
            k = t.shape[1] // n
            return t[:, r * k:(r + 1) * k].contiguous()
        if name.endswith("out_proj.bias") or name.endswith("fc2.bias"):
            return t.clone() if r == 0 else torch.zeros_like(t)
        if name.endswith("fc1.weight") or name.endswith("fc1.bias"):
            k = t.shape[0] // n
            return t[r * k:(r + 1) * k].contiguous()
        return t  # embeddings, norms, the LM head: replicated

    def shard_params(self, model) -> nn.Module:
        """The rank's local model: a copy of ``model``'s structure whose
        column- and row-parallel Linears hold the rank's shards (new
        tensors) and whose replicated parameters are ``model``'s own
        tensors (serving never writes them). ``model`` is not changed."""
        cls = type(model)
        local = cls(model.cfg, device="meta", dtype=model.dtype)
        for name, mod in list(local.named_modules()):
            if isinstance(mod, nn.Linear) and name.endswith(
                    ("qkv_proj", "out_proj", "fc1", "fc2")):
                src = model.get_submodule(name)
                w = self.shard_tensor(name + ".weight", src.weight)
                parent, _, leaf = name.rpartition(".")
                setattr(local.get_submodule(parent), leaf, nn.Linear(
                    w.shape[1], w.shape[0], bias=src.bias is not None,
                    device="meta", dtype=w.dtype))
        sd = {k: self.shard_tensor(k, v.detach())
              for k, v in model.state_dict().items()}
        local.load_state_dict(sd, assign=True)
        return local.eval()

    def shard_pools(self, pools: torch.Tensor,
                    scales: torch.Tensor | None = None):
        """The rank's part of a full pool ``[layers, 2, pages, page_size,
        heads, head_dim]`` (heads on axis 4) and of its int8 scales
        ``[layers, 2, pages, heads]`` (axis 3)."""
        h = self.local_heads
        sl = slice(self.rank * h, (self.rank + 1) * h)
        return (pools[:, :, :, :, sl].contiguous(),
                None if scales is None else scales[..., sl].contiguous())

    # ------------------------------------------------------------- budgets
    def compiler_options(self) -> dict | None:
        """None: the reference asks XLA for its latency-hiding scheduler
        on a TPU only, and the port has no compiler to ask."""
        return None

    def step_budget(self, batch: int, seq: int,
                    itemsize: int = 4) -> CollectiveBudget:
        """The all-reduces one sharded step issues: two per block
        (``out_proj`` and ``fc2``, ``[batch, seq, hidden]`` each) and one
        for the logits (``[batch, seq, vocab]``); with quantized logits
        the logits take two (the 4-byte scale and the int8 codes)."""
        c = self.model_cfg
        per_block = batch * seq * c.hidden_size * itemsize
        if self.quantized_logits:
            extra, logits = 1, batch * seq * c.vocab_size + 4
        else:
            extra, logits = 0, batch * seq * c.vocab_size * itemsize
        return CollectiveBudget(
            all_reduce=2 * c.num_layers + 1 + extra,
            max_collective_bytes=2 * c.num_layers * per_block + logits,
            min_overlap_frac=1.0 if self.overlap_scheduler else 0.0)
