"""GPT model family — the port of ``paddle_tpu/text/gpt.py``
(``GPTConfig``, the presets, ``GPTForCausalLM`` with its training loss and
its paged serving forward).

PyTorch idiom throughout: ``nn.Module``s (with Paddle's
``set_state_dict``, ``nn.LayerMixin``), ``torch.nn.Linear`` with its
``[out, in]`` weight (the JAX package keeps Paddle's ``[in, out]``;
:mod:`.convert` transposes), parameter names equal to the JAX package's
(``gpt.blocks.{i}.attn.qkv_proj.weight`` ...). The qkv projection keeps
the reference's column order ``(3, heads, head_dim)``.

Two forwards:

- no cache: causal self-attention through
  ``nn.functional.scaled_dot_product_attention``, which on CUDA tensors
  runs the flash kernel (forward and backward) and on CPU tensors its
  plain version. With ``labels`` it returns the mean cross-entropy from
  the fused, chunked head + loss (``nn.functional.linear_cross_entropy``)
  — the training step. ``recompute=True`` rematerialises each block in
  the backward under ``recompute_policy`` (``distributed.fleet.recompute``:
  None or "full" the whole block, "dots" all but the four Linear
  products). In training, ``dropout > 0`` drops at the reference's four
  sites in its draw order: after the embeddings (``GPTModel.drop``), then
  in each block the attention output inside the attention (on its ``[b,
  heads, s, head_dim]`` layout), the attention's residual branch and the
  MLP's output (``core.rng.next_rng_key`` gives each its key);
- paged: ``forward(ids, paged=PagedBatch(...))``, the serving engine's
  prefill and decode. Each layer writes the new tokens' K/V into its pool
  in place (``paged_write``, or ``paged_write_quant_kv`` for int8 pools) and
  attends through ``paged_attention``, which launches the Hopper kernel on
  CUDA tensors;
- fixed cache: ``forward(ids, caches=model.gpt.init_cache(b, max_len),
  pos=p)`` returns ``(logits, caches)``. Each layer's dense ``[b, heads,
  max_len, head_dim]`` K/V buffers are written in place at ``p`` and the
  attention is the composite (``sdpa_reference``) over the written
  prefix under a causal mask, as the reference runs its composite there.
  ``text.generation.generate`` and the speculative draft proposer ride
  it.

Every LayerNorm is the port's ``nn.LayerNorm``: the LayerNorm kernels on
CUDA tensors (forward, and dx in the backward), their plain versions on
CPU tensors.

Tensor parallelism (``serving/tp.py``): the model code stays
layout-blind. Local head counts come from the qkv weight's shape, so a
rank holding ``heads / tp`` heads writes and attends only those; the one
hook is :func:`tp_axis`, a context naming the process group, set by the
serving engine around each paged forward. Inside it the two row-parallel
sites (the attention's ``out_proj``, the MLP's ``fc2``) all-reduce their
partial sums, the bias (real on rank 0, zero elsewhere) added before the
sum as in the reference, and the LM head splits its hidden contraction
across the ranks with one all-reduce of the logits (through
``quantized_psum`` with ``quantized_logits``). With no context every hook
is a no-op.
"""
from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass
from typing import NamedTuple

import torch
from torch import nn
from torch.nn import functional as F

from .._device import resolve_device
from ..core.tensor import Tensor as PortTensor
from ..amp import amp_state, maybe_cast_inputs
from ..distributed.collective import all_reduce
from ..distributed.fleet.recompute import recompute
from ..distributed.sequence_parallel import sp_local_offset
from ..kernels import paged_attention as pa
from ..nn import Dropout, LayerMixin, LayerNorm
from ..nn.functional import (linear_cross_entropy,
                             scaled_dot_product_attention)

__all__ = ["GPTConfig", "gpt_config", "PagedBatch", "write_slots",
           "GPTAttention", "GPTMLP", "GPTBlock", "GPTModel", "GPTForCausalLM",
           "TPAxis", "tp_axis", "GPTEmbeddingPipe", "GPTHeadPipe",
           "GPTPipeLoss", "build_gpt_pipeline"]


# --------------------------------------------------------- tensor parallelism
class TPAxis(NamedTuple):
    """The tensor-parallel group a forward reduces over: ``group`` (a
    ``torch.distributed`` group; None = the whole process group), this
    rank's index in it and its size."""
    group: object
    rank: int
    degree: int


_TP_AXIS: TPAxis | None = None
# the int8 logits all-reduce (serving/tp.py quantized_psum), set with the
# axis; only the LM head's reduction takes it
_TP_QUANTIZED: bool = False


@contextmanager
def tp_axis(axis: TPAxis | None, quantized_logits: bool = False):
    """The forwards inside the block reduce their row-parallel partial sums
    over ``axis`` (None: no reduction, as a replicated draft model runs);
    nested and exception-safe."""
    global _TP_AXIS, _TP_QUANTIZED
    prev = (_TP_AXIS, _TP_QUANTIZED)
    _TP_AXIS, _TP_QUANTIZED = axis, bool(quantized_logits)
    try:
        yield
    finally:
        _TP_AXIS, _TP_QUANTIZED = prev


def _tp_psum(t: torch.Tensor) -> torch.Tensor:
    """Sum a row-parallel partial over the tensor-parallel group, in
    place (identity outside a ``tp_axis`` block)."""
    if _TP_AXIS is None:
        return t
    return all_reduce(t, group=_TP_AXIS.group)


def _tp_logits(h: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """The LM head under tensor parallelism: each rank multiplies its own
    slice of the hidden axis of ``h`` by the same columns of the
    replicated ``[vocab, hidden]`` head, and one all-reduce of the
    ``[.., vocab]`` partials gives the full logits."""
    ax = _TP_AXIS
    k = h.shape[-1] // ax.degree
    sl = slice(ax.rank * k, (ax.rank + 1) * k)
    part = F.linear(h[..., sl], head[:, sl])
    if _TP_QUANTIZED:
        from ..serving.tp import quantized_psum
        return quantized_psum(part, ax)
    return all_reduce(part, group=ax.group)


def _mp_head(h, head, labels, group):
    """The LM head under hybrid-parallel training
    (``fleet.meta_parallel.shard_model``): ``head`` holds this rank's
    vocabulary rows, so each rank forms its slice of the logits and the
    loss is the vocab-parallel cross-entropy, the full logits never
    gathered (without labels they are, ``mp_gather``: every model rank
    then repeats what follows, so each takes its slice of the gradient)."""
    from ..distributed import ops

    h = ops.c_identity(h, group)
    if amp_state() is not None:
        h, head = maybe_cast_inputs("linear", [h, head])
    logits = F.linear(h, head)
    if labels is None:
        return ops.mp_gather(logits, group, -1)
    lab = labels.reshape(-1)
    per = ops.c_softmax_with_cross_entropy(
        logits.reshape(-1, logits.shape[-1]), lab, group)
    valid = lab != -100
    per = torch.where(valid, per, torch.zeros_like(per))
    return per.sum() / torch.clamp(valid.sum().float(), min=1.0)


class Linear(nn.Linear):
    """``torch.nn.Linear`` that takes the reference's mixed precision: under
    an ``amp.auto_cast`` its inputs are cast as the reference's ``linear``
    op's (white-listed: the low dtype); outside one it is torch's."""

    def forward(self, x):
        if amp_state() is None:
            return F.linear(x, self.weight, self.bias)
        x, w, b = maybe_cast_inputs("linear", [x, self.weight, self.bias])
        return F.linear(x, w, b)


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    ffn_hidden: int = 0  # 0 -> 4*hidden
    max_seq_len: int = 1024
    layer_norm_eps: float = 1e-5
    initializer_range: float = 0.02
    tie_word_embeddings: bool = True
    dropout: float = 0.0
    recompute: bool = False  # per-block rematerialisation in the backward
    recompute_policy: str | None = None  # None = full; "dots" = save the
    # Linear products only
    loss_chunk_size: int = 256  # rows per chunk of the fused head + CE

    def __post_init__(self):
        if not self.ffn_hidden:
            self.ffn_hidden = 4 * self.hidden_size


_PRESETS = {
    "gpt3-125m": dict(hidden_size=768, num_layers=12, num_heads=12),
    "gpt3-350m": dict(hidden_size=1024, num_layers=24, num_heads=16),
    "gpt3-1.3b": dict(hidden_size=2048, num_layers=24, num_heads=16),
    "gpt3-2.7b": dict(hidden_size=2560, num_layers=32, num_heads=32),
    "gpt3-6.7b": dict(hidden_size=4096, num_layers=32, num_heads=32),
    "gpt3-13b": dict(hidden_size=5120, num_layers=40, num_heads=40),
}


def gpt_config(preset: str, **overrides) -> GPTConfig:
    cfg = dict(_PRESETS[preset])
    cfg.update(overrides)
    return GPTConfig(**cfg)


@dataclass(eq=False)
class PagedBatch:
    """The paged-cache operands of one serving call.

    pools: ``[num_layers, 2, num_pages, page_size, heads, head_dim]`` — K
    (index 0) and V (index 1) of every layer, updated in place;
    page_table: ``[b, pages_per_seq]`` int32; ctx_lens: ``[b]`` int32
    tokens resident per row before this call; valid: ``[b, s]`` bool —
    which new tokens are real (padding and inactive slots write to the
    null page 0); scales: for int8 pools, their float32 ``[num_layers, 2,
    num_pages, heads]`` per-page-per-head scales (updated in place), else
    None."""
    pools: torch.Tensor
    page_table: torch.Tensor
    ctx_lens: torch.Tensor
    valid: torch.Tensor
    scales: torch.Tensor | None = None


class GPTAttention(LayerMixin, nn.Module):
    def __init__(self, cfg: GPTConfig, device=None, dtype=None):
        super().__init__()
        h = cfg.hidden_size
        self.head_dim = h // cfg.num_heads
        self.qkv_proj = Linear(h, 3 * h, device=device, dtype=dtype)
        self.out_proj = Linear(h, h, device=device, dtype=dtype)
        self.dropout = cfg.dropout

    def forward(self, x, pools=None, paged: PagedBatch | None = None,
                slots=None, cache=None, pos=None):
        """``pools``: this layer's ``([2, num_pages, page_size, heads,
        head_dim], scales)`` views of ``paged.pools`` and ``paged.scales``
        (scales ``[2, num_pages, heads]`` or None); ``slots``: the new
        tokens' ``(page_ids, offsets)`` from :func:`write_slots`.
        ``cache``: this layer's fixed ``{"k", "v"}`` buffers, written at
        ``pos``."""
        b, s, h = x.shape
        qkv = self.qkv_proj(x)
        # the head count comes from the projection's width, not the config:
        # a tensor-parallel rank holds num_heads / tp of them
        qkv = qkv.view(b, s, 3, qkv.shape[-1] // (3 * self.head_dim),
                       self.head_dim)
        if paged is not None:
            return self._paged_forward(x, qkv, pools, paged, slots)
        # one copy makes q, k and v each a contiguous [B, H, S, D] slice
        q, k, v = qkv.permute(2, 0, 3, 1, 4).contiguous().unbind(0)
        if cache is not None:
            return self._cached_forward(q, k, v, cache, pos)
        out = scaled_dot_product_attention(
            q, k, v, dropout_p=self.dropout, is_causal=True,
            training=self.training)
        return self.out_proj(out.transpose(1, 2).reshape(b, s, -1))

    def _cached_forward(self, q, k, v, cache, pos: int):
        """The fixed-cache decode: write the s new tokens' K/V at ``pos``
        in place, then attend causally over the written prefix through
        the composite."""
        b, _, s, _ = q.shape
        k_all, v_all = cache["k"], cache["v"]
        k_all[:, :, pos:pos + s] = k.to(k_all.dtype)
        v_all[:, :, pos:pos + s] = v.to(v_all.dtype)
        j = torch.arange(k_all.shape[2], device=q.device)[None, :]
        i = torch.arange(s, device=q.device)[:, None] + pos
        out = scaled_dot_product_attention(q, k_all, v_all, attn_mask=j <= i,
                                           is_causal=False, training=False)
        return self.out_proj(out.transpose(1, 2).reshape(b, s, -1)), cache

    def _paged_forward(self, x, qkv, pools, paged: PagedBatch, slots):
        """Serving prefill/decode against the paged pool: write the s new
        tokens' K/V at their slots (dead writes to the null page), then
        attend the row's whole resident prefix."""
        b, s, _ = x.shape
        pool, scales = pools
        k_pool, v_pool = pool[0], pool[1]
        q = qkv[:, :, 0].transpose(1, 2).contiguous()  # [B, H, s, D]
        k_sc = v_sc = None
        if scales is None:
            pa.paged_write(k_pool, v_pool, qkv[:, :, 1], qkv[:, :, 2], *slots)
        else:
            # int8 pool: quantise at write time (K and V in one pass),
            # dequantise in the gather
            k_sc, v_sc = scales[0], scales[1]
            pa.paged_write_quant_kv(pool, scales,
                                    qkv[:, :, 1:].permute(2, 0, 1, 3, 4),
                                    *slots)
        out = pa.paged_attention(q, k_pool, v_pool, paged.page_table,
                                 paged.ctx_lens, k_scale=k_sc, v_scale=v_sc)
        out = out.transpose(1, 2).reshape(b, s, -1).to(x.dtype)
        # row-parallel under tensor parallelism: each rank contracts its
        # own heads, the all-reduce restores the full projection
        return _tp_psum(self.out_proj(out))


def write_slots(paged: PagedBatch, positions, page_size: int):
    """``(page_ids, offsets)`` ``[b, s]`` where the new tokens at
    ``positions`` (``ctx_lens[:, None] + arange(s)``) are written. The
    page lookup is clamped to the table width — a row whose ctx is garbage
    (an inactive slot) may form positions past it; its writes go to the
    null page 0 through ``valid``, but the index must stay in range. The
    same for every layer, so the model computes it once per call."""
    table = paged.page_table
    page_idx = torch.clamp(positions // page_size, max=table.shape[1] - 1)
    page_ids = torch.gather(table.long(), 1, page_idx)
    zero = torch.zeros((), dtype=torch.long, device=positions.device)
    return (torch.where(paged.valid, page_ids, zero),
            torch.where(paged.valid, positions % page_size, zero))


class GPTMLP(LayerMixin, nn.Module):
    def __init__(self, cfg: GPTConfig, device=None, dtype=None):
        super().__init__()
        self.fc1 = Linear(cfg.hidden_size, cfg.ffn_hidden, device=device,
                             dtype=dtype)
        self.fc2 = Linear(cfg.ffn_hidden, cfg.hidden_size, device=device,
                             dtype=dtype)
        self.dropout = Dropout(cfg.dropout)

    def forward(self, x):
        # fc1 column-split, fc2 row-split under tensor parallelism: the
        # all-reduce of fc2's partials is the MLP's one collective
        return self.dropout(_tp_psum(
            self.fc2(F.gelu(self.fc1(x), approximate="tanh"))))


class GPTBlock(LayerMixin, nn.Module):
    def __init__(self, cfg: GPTConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.ln1 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, **kw)
        self.attn = GPTAttention(cfg, **kw)
        self.ln2 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, **kw)
        self.mlp = GPTMLP(cfg, **kw)
        self.dropout = Dropout(cfg.dropout)

    def forward(self, x, pools=None, paged: PagedBatch | None = None,
                slots=None, cache=None, pos=None):
        if cache is not None:
            a, cache = self.attn(self.ln1(x), cache=cache, pos=pos)
            x = x + a
            return x + self.mlp(self.ln2(x)), cache
        a = self.attn(self.ln1(x), pools, paged, slots)
        # the reference's cache paths (paged too) add the attention
        # undropped
        x = x + (a if paged is not None else self.dropout(a))
        return x + self.mlp(self.ln2(x))


class GPTModel(LayerMixin, nn.Module):
    def __init__(self, cfg: GPTConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.wte = nn.Embedding(cfg.vocab_size, cfg.hidden_size, **kw)
        self.wpe = nn.Embedding(cfg.max_seq_len, cfg.hidden_size, **kw)
        self.drop = Dropout(cfg.dropout)
        self.blocks = nn.ModuleList(
            [GPTBlock(cfg, **kw) for _ in range(cfg.num_layers)])
        self.ln_f = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, **kw)

    def init_cache(self, batch_size: int, max_len: int | None = None,
                   dtype=None) -> list[dict]:
        """Per-layer fixed ``{"k", "v"}`` buffers ``[batch_size, heads,
        max_len, head_dim]`` (zeros, on the model's device) for
        ``forward(caches=..., pos=...)``."""
        c = self.cfg
        shape = (batch_size, c.num_heads, max_len or c.max_seq_len,
                 c.hidden_size // c.num_heads)
        kw = dict(dtype=dtype or self.wte.weight.dtype,
                  device=self.wte.weight.device)
        return [{"k": torch.zeros(shape, **kw), "v": torch.zeros(shape, **kw)}
                for _ in range(c.num_layers)]

    def forward(self, input_ids, paged: PagedBatch | None = None,
                caches=None, pos: int = 0):
        """Hidden states ``[b, s, hidden]``; with ``caches`` (from
        :meth:`init_cache`) the pair ``(hidden, caches)``, the new tokens
        entering at position ``pos`` (a Python int)."""
        cfg = self.cfg
        remat = cfg.recompute and paged is None and caches is None
        s = input_ids.shape[1]
        positions = torch.arange(s, device=input_ids.device)[None, :]
        slots = None
        if paged is not None:
            # every row enters at its own length
            positions = paged.ctx_lens.long()[:, None] + positions
            slots = write_slots(paged, positions, paged.pools.shape[3])
            # the clamp keeps dead slots' garbage positions in the table
            positions = torch.clamp(positions, 0, self.cfg.max_seq_len - 1)
        elif caches is not None:
            positions = positions + pos
        else:  # global positions under sequence parallelism
            positions = positions + sp_local_offset(s)
        x = self.drop(self.wte(input_ids) + self.wpe(positions))
        if caches is not None:
            for blk, cache in zip(self.blocks, caches):
                x, _ = blk(x, cache=cache, pos=pos)
            return self.ln_f(x), caches
        for i, blk in enumerate(self.blocks):
            if remat:
                # the GPT draws from the port's key schedule, not from
                # torch's generators: nothing of theirs to preserve
                x = recompute(blk, x, policy=cfg.recompute_policy,
                              preserve_rng_state=False)
            else:
                pools = None if paged is None else (
                    paged.pools[i],
                    None if paged.scales is None else paged.scales[i])
                x = blk(x, pools, paged, slots)
        return self.ln_f(x)


class GPTForCausalLM(LayerMixin, nn.Module):
    """GPT with the LM head (tied to ``wte`` unless
    ``tie_word_embeddings=False``). Built on ``device`` (``None`` = the
    card; raises when there is none) in ``dtype`` (default float32), in
    eval mode (serving; ``model.train()`` for training), with the
    reference's initialisation: weights ``N(0, initializer_range)``,
    biases 0, LayerNorm scale 1.

    Under hybrid-parallel training ``fleet.meta_parallel.shard_model``
    sets ``_mp_group`` (``takes_mp_group``): the LM head then forms the
    vocab-parallel loss (``_mp_head``)."""

    takes_mp_group = True

    def __init__(self, cfg: GPTConfig, device=None, dtype=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.cfg = cfg
        self.gpt = GPTModel(cfg, **kw)
        self.lm_head = None if cfg.tie_word_embeddings else nn.Linear(
            cfg.hidden_size, cfg.vocab_size, bias=False, **kw)
        self.reset_parameters(generator)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.gpt.wte.weight.device

    @property
    def dtype(self) -> torch.dtype:
        return self.gpt.wte.weight.dtype

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        """Weights ``N(0, initializer_range)`` drawn from ``generator``
        (a generator on the model's device), biases 0, LayerNorm 1/0."""
        std = self.cfg.initializer_range
        for mod in self.modules():
            if isinstance(mod, (nn.Linear, nn.Embedding)):
                mod.weight.normal_(0.0, std, generator=generator)
                if getattr(mod, "bias", None) is not None:
                    mod.bias.zero_()
            elif isinstance(mod, LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()

    def forward(self, input_ids, labels=None, paged: PagedBatch | None = None,
                caches=None, pos: int = 0):
        """Logits ``[b, s, vocab]``; with ``labels`` ``[b, s]`` instead the
        mean cross-entropy (float32 scalar) from the fused, chunked head +
        loss, which never forms the ``[b, s, vocab]`` logits. With ``paged``
        the call is a serving prefill/decode against the paged pools
        (updated in place), which takes no labels. With ``caches`` (from
        ``self.gpt.init_cache``) it returns ``(logits, caches)``, the
        tokens entering at ``pos`` and their K/V written into the caches
        in place."""
        if labels is not None and (paged is not None or caches is not None):
            raise NotImplementedError(
                "labels (training loss) cannot be combined with the paged "
                "serving path or the KV cache")
        head = self.gpt.wte.weight if self.lm_head is None \
            else self.lm_head.weight  # both [vocab, hidden]
        if caches is not None:
            h, caches = self.gpt(input_ids, caches=caches, pos=pos)
            return F.linear(h, head), caches
        h = self.gpt(input_ids, paged)
        if _TP_AXIS is not None:
            return _tp_logits(h, head)
        mp = getattr(self, "_mp_group", None)
        if mp is not None:
            return _mp_head(h, head, labels, mp)
        if labels is not None:
            out = linear_cross_entropy(h, head, labels, transpose_y=True,
                                       chunk_size=self.cfg.loss_chunk_size)
        else:
            out = F.linear(h, head)
        # the port's Tensor in, the port's Tensor out: a kernel's autograd
        # function returns a plain tensor (attached to the same graph)
        if isinstance(input_ids, PortTensor) \
                and not isinstance(out, PortTensor):
            out = out.as_subclass(PortTensor)
        return out

    def generate(self, input_ids, **kwargs):
        """KV-cache autoregressive decoding: see
        :func:`..text.generation.generate`."""
        from .generation import generate

        return generate(self, input_ids, **kwargs)


# --------------------------------------------------------------- pipeline form
def _init_normal(module, std, generator=None):
    """The reference's initialisation of a piece: Linear and Embedding
    weights ``N(0, std)``, biases 0, LayerNorm 1 / 0."""
    with torch.no_grad():
        for mod in module.modules():
            if isinstance(mod, (nn.Linear, nn.Embedding)):
                mod.weight.normal_(0.0, std, generator=generator)
                if getattr(mod, "bias", None) is not None:
                    mod.bias.zero_()
            elif isinstance(mod, LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()


class GPTEmbeddingPipe(LayerMixin, nn.Module):
    """The first stage's prologue of the pipeline GPT: token plus position
    embeddings, then dropout."""

    def __init__(self, cfg: GPTConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.wte = nn.Embedding(cfg.vocab_size, cfg.hidden_size, **kw)
        self.wpe = nn.Embedding(cfg.max_seq_len, cfg.hidden_size, **kw)
        self.drop = Dropout(cfg.dropout)
        _init_normal(self, cfg.initializer_range)

    def forward(self, input_ids):
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        return self.drop(self.wte(input_ids) + self.wpe(pos[None, :]))


class GPTHeadPipe(LayerMixin, nn.Module):
    """The last stage's epilogue: the final LayerNorm and an LM head of
    its own (untied in the pipeline form)."""

    def __init__(self, cfg: GPTConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.ln_f = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, **kw)
        self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False,
                                 **kw)
        _init_normal(self, cfg.initializer_range)

    def forward(self, x):
        return self.lm_head(self.ln_f(x))


class GPTPipeLoss(LayerMixin, nn.Module):
    """The mean cross-entropy of the head's logits ``[b, s, vocab]``."""

    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.vocab = cfg.vocab_size

    def forward(self, logits, labels):
        from ..nn.functional import cross_entropy

        return cross_entropy(logits.reshape(-1, self.vocab),
                             labels.reshape(-1))


def _pipe_block(cfg: GPTConfig, device=None, dtype=None):
    blk = GPTBlock(cfg, device=resolve_device(device), dtype=dtype)
    _init_normal(blk, cfg.initializer_range)
    return blk


def build_gpt_pipeline(cfg: GPTConfig, num_stages: int, topology=None,
                       device=None, dtype=None):
    """The GPT as a ``fleet.PipelineLayer``: the embeddings, ``num_layers``
    blocks and the head, segmented uniformly into ``num_stages``, with
    ``GPTPipeLoss`` (the reference's ``build_gpt_pipeline``); built on
    ``device`` (None: the card) in ``dtype``."""
    from ..distributed.fleet.meta_parallel import LayerDesc, PipelineLayer

    kw = dict(device=device, dtype=dtype)
    descs = [LayerDesc(GPTEmbeddingPipe, cfg, **kw)]
    descs += [LayerDesc(_pipe_block, cfg, **kw)
              for _ in range(cfg.num_layers)]
    descs += [LayerDesc(GPTHeadPipe, cfg, **kw)]
    return PipelineLayer(descs, num_stages=num_stages, topology=topology,
                         loss_fn=GPTPipeLoss(cfg))
