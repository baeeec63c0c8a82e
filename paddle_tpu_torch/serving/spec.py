"""Speculative decoding: proposal + batched paged verify — the port of
``paddle_tpu/serving/spec.py``.

``ServingConfig(spec=SpecConfig(...))`` makes each engine step:

1. PROPOSE K candidate tokens per running request, on the device:

   - ``method="draft"``: a small port GPT decodes K tokens greedily from
     the request's last ``window`` known tokens (:func:`draft_window`),
     against its own fixed KV cache of ``window + depth`` positions made
     afresh every step — the draft keeps no state, so preemption, prefix
     caching, swap and int8 pools never meet it;
   - ``method="ngram"``: the last ``ngram`` known tokens are matched
     against every earlier position of the request's token history, and
     the K tokens after the most recent earlier occurrence are proposed
     (:func:`propose_ngram`).

2. VERIFY the pending token and the K candidates in one batched pass
   through the paged path, queries at ``ctx_lens .. ctx_lens + K``: one
   ragged kernel call a layer with ``s = K + 1`` (the kernel's split
   program up to ``K = 7``). The target's own token at every position is
   the argmax, or the sample under the engine's (seed, rid, token index)
   key, and a candidate is accepted only while it equals the target's
   stream (:func:`accept_counts`). Every emitted token is the target's,
   so outputs equal plain decoding's at any acceptance rate.

The host reads one packed ``[batch, K + 2]`` array a step (K + 1 target
tokens and the accept count), and the pages reserved for rejected
candidates go back through ``PagedKVCache.shrink``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

METHODS = ("draft", "ngram")

__all__ = ["METHODS", "SpecConfig", "propose_ngram", "draft_window",
           "accept_counts"]


@dataclass(frozen=True)
class SpecConfig:
    """Speculative-decoding knobs (``ServingConfig(spec=...)``).

    ``depth`` (K) candidates are proposed and verified a step: each step
    emits 1 to K + 1 tokens a request. ``draft`` is the proposer's port
    ``GPTConfig`` for ``method="draft"`` (the engine builds the model, or
    takes a prebuilt ``draft_model=``); ``window`` is the draft's context
    in tokens. ``ngram`` is the n-gram proposer's match width."""

    method: str = "ngram"       # "draft" | "ngram"
    depth: int = 4              # K: candidates proposed per step
    draft: object | None = None  # text.gpt.GPTConfig for method="draft"
    window: int = 8             # draft context window (last W known tokens)
    ngram: int = 2              # n-gram proposer match width

    def validate(self, model_cfg, draft_cfg=None) -> None:
        """Raise ValueError for a configuration that could never serve
        against ``model_cfg``; ``draft_cfg`` (a prebuilt draft model's)
        wins over ``self.draft``."""
        if self.method not in METHODS:
            raise ValueError(
                f"spec.method {self.method!r} not in {METHODS}")
        if self.depth < 1:
            raise ValueError(f"spec.depth {self.depth} < 1 (K candidates "
                             f"are proposed per step)")
        if self.method == "ngram":
            if self.ngram < 1:
                raise ValueError(f"spec.ngram {self.ngram} < 1")
            return
        draft_cfg = draft_cfg or self.draft
        if draft_cfg is None:
            raise ValueError(
                "spec.method='draft' needs spec.draft (the proposer "
                "model's GPTConfig) or an explicit draft_model=")
        if self.window < 1:
            raise ValueError(f"spec.window {self.window} < 1")
        if draft_cfg.vocab_size != model_cfg.vocab_size:
            raise ValueError(
                f"draft vocab_size {draft_cfg.vocab_size} != target "
                f"vocab_size {model_cfg.vocab_size} — candidate ids must "
                f"be target token ids")
        if draft_cfg.max_seq_len < self.window + self.depth:
            raise ValueError(
                f"draft max_seq_len {draft_cfg.max_seq_len} < window + "
                f"depth = {self.window + self.depth} (the draft decodes "
                f"depth tokens after its window)")


def propose_ngram(hist, known, depth: int, n: int, pad_id: int):
    """N-gram proposal: for each row, match the last ``n`` known tokens
    against every earlier position of ``hist`` and propose the ``depth``
    tokens after the most recent earlier occurrence.

    hist: ``[batch, L]`` token history (prompt + generated, zero-padded);
    known: ``[batch]`` tokens known per row (``ctx_lens + 1``: the pending
    token is known, its KV is not). Rows with no match propose
    ``pad_id`` (the verify rejects it). Returns ``[batch, depth]`` int64
    on hist's device; no host read."""
    hist = hist.long()
    k = known.long()[:, None]
    L = hist.shape[1]
    dev = hist.device
    pos = torch.arange(L, device=dev)
    ar_n = torch.arange(n, device=dev)
    tail = torch.gather(hist, 1, torch.clamp(k - n + ar_n, 0, L - 1))
    win = hist[:, torch.clamp(pos[:, None] + ar_n, max=L - 1)]  # [b, L, n]
    # an occurrence starting at i is usable iff it is fully known and
    # strictly earlier than the tail (i <= k - n - 1), which also leaves
    # at least one known continuation token
    ok = (win == tail[:, None, :]).all(-1) & (pos + n <= k - 1)
    best = torch.where(ok, pos, -1).amax(dim=1, keepdim=True)
    src = best + n + torch.arange(depth, device=dev)
    cand = torch.gather(hist, 1, torch.clamp(src, 0, L - 1))
    return torch.where((best >= 0) & (src <= k - 1), cand, pad_id)


def draft_window(hist, known, width: int):
    """The draft proposer's context: the last ``width`` known tokens per
    row, right-aligned (rows shorter than the window repeat their first
    token on the left). ``[batch, width]``."""
    L = hist.shape[1]
    idx = known.long()[:, None] - width + torch.arange(
        width, device=hist.device)
    return torch.gather(hist, 1, torch.clamp(idx, 0, L - 1))


def accept_counts(cand, target):
    """How many leading candidates each row accepts: ``cand [batch, K]``
    against the target's own tokens ``target [batch, K + 1]``; candidate
    ``j`` is accepted iff it equals ``target[:, j]`` and every earlier one
    was accepted. ``[batch]`` int64 in ``0..K``."""
    match = (cand == target[:, :cand.shape[1]]).long()
    return torch.cumprod(match, dim=1).sum(dim=1)
