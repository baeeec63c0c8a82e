"""Scaled-dot-product attention — the port of
``paddle_tpu/kernels/attention.py`` (``sdpa_reference`` and the ``sdpa``
dispatch).

Layout ``[batch, heads, seq, head_dim]``. ``sdpa_reference`` is the
composite: logits accumulated in float32, masked positions filled with
``-1e30`` (exact zero probability after the softmax), probabilities cast
to ``q.dtype`` before the PV product — the reference's exact recipe, so a
bfloat16 call rounds where the JAX one does. Float64 inputs keep float64
logits (the reference asks for float32 ones there too; the port keeps a
float64 model float64, so that the card and the CPU agree to float64
rounding). It is the plain version of the flash kernel and of the paged
kernel.

``sdpa`` dispatches as the reference does, without its TPU gates: with no
mask it goes to :func:`.flash_attention.flash_attention` (the Hopper
kernel for a CUDA tensor, the composite for a CPU one); with a mask, or
in float64 (which the kernels, like the reference's TPU kernels, do not
take), it is the composite.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["default_scale", "sdpa_reference", "sdpa"]

#: the masked-logit fill; exp(-1e30 - max) is exactly 0 in float32
MASK_FILL = -1e30


def default_scale(head_dim: int) -> float:
    """``1 / sqrt(head_dim)`` computed in float32, as the reference does —
    the kernels and the plain versions share this one value."""
    return float(np.float32(1.0) / np.sqrt(np.float32(head_dim)))


def sdpa_reference(q, k, v, mask=None, is_causal=False, scale=None):
    """softmax(q kᵀ · scale [+ mask]) v with float32 logits (float64
    for float64 inputs).

    ``mask``: bool (True = visible) or additive float, broadcastable to
    ``[b, h, s_q, s_k]``. ``is_causal`` masks bottom-right aligned
    (query ``i`` sees keys ``<= i + s_k - s_q``)."""
    if scale is None:
        scale = default_scale(q.shape[-1])
    acc = torch.float64 if q.dtype == torch.float64 else torch.float32
    logits = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) * scale
    if is_causal:
        s_q, s_k = logits.shape[-2], logits.shape[-1]
        causal = torch.ones(s_q, s_k, dtype=torch.bool,
                            device=q.device).tril(s_k - s_q)
        logits = logits.masked_fill(~causal, MASK_FILL)
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = logits.masked_fill(~mask, MASK_FILL)
        else:
            logits = logits + mask.to(logits.dtype)
    probs = torch.softmax(logits, dim=-1)
    return torch.matmul(probs.to(q.dtype), v)


def sdpa(q, k, v, mask=None, is_causal=False, scale=None):
    """Attention over ``[b, h, s, d]``: the flash kernel when there is no
    mask (on CUDA tensors; CPU tensors take its plain version), else, and
    in float64, the composite. Float16 raises: the kernels take float32
    and bfloat16, and float16 flash kernels are open work (ROADMAP Queue
    2), so ``amp.auto_cast(dtype="float16")`` cannot reach attention."""
    if mask is None and q.dtype == torch.float16:
        raise TypeError(
            "attention in float16 (amp.auto_cast(dtype='float16') casts "
            "scaled_dot_product_attention's inputs to it): the flash "
            "kernels take float32 and bfloat16 only; use bfloat16, or "
            "float32 for this op (custom_black_list)")
    if mask is None and q.dtype != torch.float64:
        from .flash_attention import flash_attention  # it imports this module

        return flash_attention(q, k, v, causal=is_causal, scale=scale)
    return sdpa_reference(q, k, v, mask, is_causal, scale)
