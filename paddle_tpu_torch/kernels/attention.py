"""Composite scaled-dot-product attention — the port of
``paddle_tpu/kernels/attention.py`` ``sdpa_reference``.

Layout ``[batch, heads, seq, head_dim]``. Logits are accumulated in
float32, masked positions are filled with ``-1e30`` (exact zero
probability after the softmax), and the probabilities are cast to
``q.dtype`` before the PV product — the reference's exact recipe, so a
bfloat16 call rounds where the JAX one does.

This is the plain path: the no-cache GPT forward and the paged kernel's
plain version use it. It is never the serving kernel on the card.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["default_scale", "sdpa_reference"]

#: the masked-logit fill; exp(-1e30 - max) is exactly 0 in float32
MASK_FILL = -1e30


def default_scale(head_dim: int) -> float:
    """``1 / sqrt(head_dim)`` computed in float32, as the reference does —
    the kernel and the plain version share this one value."""
    return float(np.float32(1.0) / np.sqrt(np.float32(head_dim)))


def sdpa_reference(q, k, v, mask=None, is_causal=False, scale=None):
    """softmax(q kᵀ · scale [+ mask]) v with float32 logits.

    ``mask``: bool (True = visible) or additive float, broadcastable to
    ``[b, h, s_q, s_k]``. ``is_causal`` masks bottom-right aligned
    (query ``i`` sees keys ``<= i + s_k - s_q``)."""
    if scale is None:
        scale = default_scale(q.shape[-1])
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
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
