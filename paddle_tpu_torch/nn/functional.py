"""Functional layers of the GPT — the port of the parts of
``paddle_tpu/nn/functional.py`` that its training step and serving
forward run: ``layer_norm``, ``linear_cross_entropy`` (the fused, chunked
LM head + cross-entropy) and ``scaled_dot_product_attention``.

Plain functions on ``torch.Tensor``s, differentiable by autograd.
"""
from __future__ import annotations

import torch

from ..kernels import attention
from ..kernels.fused_layernorm import fused_layer_norm

__all__ = ["layer_norm", "linear_cross_entropy",
           "scaled_dot_product_attention"]


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-05):
    """LayerNorm of ``x`` over its trailing ``normalized_shape``.

    With one normalised dimension and both a ``weight`` and a ``bias`` of
    that width (one dtype), this is :func:`fused_layer_norm`: on CUDA
    tensors the Hopper kernels, on CPU tensors their plain versions. Any
    other form is the reference's composite on either device —
    ``(x - mean) * rsqrt(var + epsilon)`` over float32 statistics, times
    the weight and plus the bias where given, cast to x's dtype — as the
    reference takes XLA there."""
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    nd = len(tuple(normalized_shape))
    d = x.shape[-1]
    if nd == 1 and weight is not None and bias is not None \
            and tuple(weight.shape) == tuple(bias.shape) == (d,) \
            and weight.dtype == bias.dtype:
        return fused_layer_norm(x, weight, bias, epsilon)
    dims = tuple(range(x.dim() - nd, x.dim()))
    xf = x.float()
    mean = xf.mean(dims, keepdim=True)
    var = xf.var(dims, unbiased=False, keepdim=True)
    out = (x - mean) * torch.rsqrt(var + epsilon)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out.to(x.dtype)


def _logits(h, w, transpose_y: bool):
    """float32 logits ``h @ w`` (``h @ wᵀ`` with ``transpose_y``).

    The reference asks the matrix unit for float32 accumulation of bf16
    inputs (``preferred_element_type=jnp.float32``). The port does the same
    on the card: a bfloat16 or float16 product on CUDA is one cuBLAS call
    with float32 accumulation and a float32 result (``torch.mm`` with
    ``out_dtype``); elsewhere, and for float32 inputs, the inputs are cast
    to float32 first — products of bf16 values are exact in float32, so
    the two differ only in summation order."""
    wt = w.t() if transpose_y else w
    if h.device.type == "cuda" and h.dtype in (torch.bfloat16, torch.float16):
        return torch.mm(h, wt, out_dtype=torch.float32)
    return torch.mm(h.float(), wt.float())


def _split_bf16(x):
    """float32 ``x`` as two bfloat16 parts ``hi + lo``: ``hi`` is ``x``
    rounded, ``lo`` the rest rounded (16 significant bits in all)."""
    hi = x.to(torch.bfloat16)
    # one pass, no float32 temporary: hi widens and the difference rounds
    # inside the subtraction
    return hi, torch.sub(x, hi, out=torch.empty_like(hi))


def _ce_input_grads(grad, h, w, transpose_y: bool, need_dh: bool,
                    need_dw: bool):
    """``(dh, dw)`` from the float32 logit gradient ``grad [rows, vocab]``,
    each formed in float32 and rounded once to its input's dtype, as the
    reference's transposed float32-accumulating product does.

    On the card with bf16 inputs the float32 gradient is split into bf16
    ``hi + lo`` parts and each result is the float32 sum of two bf16
    tensor-core products (float32 accumulation): the products see 16 of
    the gradient's 24 significant bits. One TF32 product would see 11
    and cost less (PERF.md §6), but its bf16 results would stray
    further from the float32 product rounded once, the reference's.
    Elsewhere the products are float32."""
    dh = dw = None
    wt = w if transpose_y else w.t()          # [vocab, in]
    if h.device.type == "cuda" and h.dtype == w.dtype == torch.bfloat16:
        parts = _split_bf16(grad)
        if need_dh:
            dh = sum(torch.mm(g, wt, out_dtype=torch.float32)
                     for g in parts).to(h.dtype)
        if need_dw:
            dw = sum(torch.mm(g.t(), h, out_dtype=torch.float32)
                     for g in parts)
    else:
        if need_dh:
            dh = (grad @ wt.float()).to(h.dtype)
        if need_dw:
            dw = grad.t() @ h.float()
    if dw is not None:
        dw = (dw if transpose_y else dw.t()).to(w.dtype)
    return dh, dw


class _ChunkCrossEntropy(torch.autograd.Function):
    """One chunk of rows: ``(sum of (logsumexp - target logit) over valid
    rows, number of valid rows)``. The ``[chunk, vocab]`` logits are not
    saved: the backward recomputes them, so at most one such block is live
    at a time — what ``jax.checkpoint`` does around the reference's chunk
    (``torch.utils.checkpoint`` cannot serve here: the float32-output
    product has no autograd formula).

    The reference's logsumexp and its derivative, in its order of
    operations: the forward forms the row max ``m`` (0 where not finite)
    and ``S = sum(exp(logits - m))``, ``lse = log(S) + m``, and keeps
    ``m`` and ``S``; the backward forms ``exp(logits - m) * (g / S)`` from
    the recomputed logits with ``-g`` added at the target (``g`` the
    chunk's loss cotangent on valid rows, 0 elsewhere), all in float32;
    ``dh`` and ``dw`` are formed from that float32 gradient and rounded
    once (:func:`_ce_input_grads`)."""

    @staticmethod
    def forward(ctx, h, w, label, transpose_y, ignore_index):
        logits = _logits(h, w, transpose_y)
        m = logits.amax(dim=-1, keepdim=True)
        m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        total = torch.exp(logits - m).sum(dim=-1, keepdim=True)
        lse = (torch.log(total) + m)[:, 0]
        valid = label != ignore_index
        safe = torch.where(valid, label, torch.zeros_like(label)).long()
        tgt = logits.gather(1, safe[:, None])[:, 0]
        loss = torch.where(valid, lse - tgt, torch.zeros_like(lse)).sum()
        count = valid.sum(dtype=torch.float32)
        ctx.save_for_backward(h, w, label, m, total)
        ctx.transpose_y, ctx.ignore_index = transpose_y, ignore_index
        ctx.mark_non_differentiable(count)
        return loss, count

    @staticmethod
    def backward(ctx, g_loss, _g_count):
        h, w, label, m, total = ctx.saved_tensors
        # d(lse - tgt)/dlogits = softmax - onehot(label), on valid rows
        grad = _logits(h, w, ctx.transpose_y)
        grad.sub_(m).exp_()
        valid = label != ctx.ignore_index
        safe = torch.where(valid, label, torch.zeros_like(label)).long()
        g = torch.where(valid, g_loss, torch.zeros_like(g_loss))[:, None]
        grad.mul_(g / total)
        grad.scatter_add_(1, safe[:, None], -g)
        dh, dw = _ce_input_grads(grad, h, w, ctx.transpose_y,
                                 ctx.needs_input_grad[0],
                                 ctx.needs_input_grad[1])
        return dh, dw, None, None, None


def linear_cross_entropy(hidden, weight, label, transpose_y=False,
                         chunk_size=256, ignore_index=-100):
    """Fused LM-head projection + softmax cross-entropy, chunked over rows.

    ``hidden`` ``[..., in_features]``; ``weight`` ``[in_features, vocab]``
    or, with ``transpose_y``, ``[vocab, in_features]`` (the tied
    embedding, and the port's ``nn.Linear`` head); ``label`` integer
    targets with one per row of ``hidden``. Each chunk of ``chunk_size``
    rows forms its float32 logits, reduces them to logsumexp minus the
    target logit (ignored labels count 0) and drops them; the backward
    recomputes them. Returns the mean over valid rows (float32 scalar)."""
    h2 = hidden.reshape(-1, hidden.shape[-1])
    lab = label.reshape(-1)
    if lab.numel() != h2.shape[0]:
        raise ValueError(f"label has {lab.numel()} elements for "
                         f"{h2.shape[0]} rows of hidden")
    n = h2.shape[0]
    c = min(int(chunk_size), n)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    count = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for start in range(0, n, c):
        loss_c, count_c = _ChunkCrossEntropy.apply(
            h2[start:start + c], weight, lab[start:start + c],
            bool(transpose_y), int(ignore_index))
        total = total + loss_c
        count = count + count_c
    return total / torch.clamp(count, min=1.0)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True):
    """Attention over ``[b, h, s, d]`` through ``kernels.attention.sdpa``:
    with no mask a CUDA tensor runs the flash kernel, a CPU tensor its
    plain version; with a mask, the composite.

    Attention dropout in training raises (ROADMAP Queue 1 item 7): its
    parity with the reference needs the reference's random bits, which
    the port's threefry (item 5, ``paddle_tpu_torch.random``) draws. The
    reference's sequence-parallel branch (ring attention) is ROADMAP Queue
    1 item 12; the port has no sequence-parallel scope yet."""
    if dropout_p > 0.0 and training:
        raise NotImplementedError(
            "attention dropout is not ported (ROADMAP Queue 1 item 7): its "
            "parity needs the reference's random bits, which the port's "
            "threefry (item 5, paddle_tpu_torch.random) draws; pass "
            "dropout_p=0.0")
    return attention.sdpa(query, key, value, attn_mask, is_causal=is_causal)
