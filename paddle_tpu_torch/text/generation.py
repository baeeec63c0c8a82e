"""Autoregressive generation — the port of ``paddle_tpu/text/generation.py``
(``sample_logits`` and ``generate``).

``sample_logits`` is the reference's sampler in its order of operations:
temperature, then top-k, then top-p over one descending sort, then a
draw from :func:`..random.categorical` (the Gumbel-max trick under the
reference's threefry keys). Everything stays on the logits' device.

``generate`` is the reference's decode loop over the model's fixed KV
cache (``GPTModel.init_cache``): one pass over the prompt, then one token
a step. Its keys come from ``split(key(seed))`` exactly as the
reference's ``_decode_loop`` splits them, so a sampled run draws the
reference's tokens. The reference compiles the loop into one ``scan``;
here it runs eagerly, and the host reads the device once, at the end.
"""
from __future__ import annotations

import torch

from .. import random

__all__ = ["filter_logits", "sample_logits", "generate"]


def _scalar(like, value):
    """A 0-d tensor of ``value`` in ``like``'s dtype on its device, filled
    there (``new_tensor`` would copy it from the host and wait)."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


def filter_logits(logits, temperature=1.0, top_k=0, top_p=1.0):
    """float32 ``logits`` after the temperature, the top-k and the top-p
    filters of :func:`sample_logits` (filtered entries ``-inf``)."""
    logits = logits.float()
    if temperature != 1.0:
        # a tensor divisor: a Python number divides by multiplying with
        # its reciprocal on CUDA; the reference divides
        logits = logits / _scalar(logits, max(temperature, 1e-6))
    vocab = logits.shape[-1]
    use_k = bool(top_k) and top_k < vocab
    if use_k or top_p < 1.0:
        # one descending sort serves both filters
        sorted_desc = torch.sort(logits, dim=-1, descending=True).values
        ninf = _scalar(logits, float("-inf"))
        if use_k:
            kth = sorted_desc[..., top_k - 1:top_k]
            logits = torch.where(logits < kth, ninf, logits)
        if top_p < 1.0:
            if use_k:  # the nucleus applies to the k-filtered set
                keep = torch.arange(vocab, device=logits.device) < top_k
                sorted_desc = torch.where(keep, sorted_desc, ninf)
            top = sorted_desc.amax(dim=-1, keepdim=True)
            unnorm = torch.exp(sorted_desc - top)
            probs = unnorm / unnorm.sum(dim=-1, keepdim=True)
            cum = torch.cumsum(probs, dim=-1)
            # keep the minimal prefix with cumulative mass > p (>= 1 token)
            cutoff_idx = ((cum - probs) < top_p).sum(dim=-1,
                                                    keepdim=True) - 1
            cutoff = torch.gather(sorted_desc, -1, cutoff_idx)
            logits = torch.where(logits < cutoff, ninf, logits)
    return logits


def sample_logits(logits, key, temperature=1.0, top_k=0, top_p=1.0):
    """Sample token ids from ``[..., vocab]`` logits.

    ``key`` is one key ``[2]`` for the whole batch or one per row
    (``logits.shape[:-1] + (2,)``), as :func:`..random.categorical` takes
    them. top_k and top_p compose the standard way: restrict to the k
    highest logits, then to the smallest nucleus whose cumulative
    probability exceeds p (:func:`filter_logits`). Returns int64
    ``logits.shape[:-1]``."""
    return random.categorical(
        key, filter_logits(logits, temperature, top_k, top_p))


def generate(model, input_ids, max_new_tokens=20, do_sample=False,
             temperature=1.0, top_k=0, top_p=1.0, eos_token_id=None,
             pad_token_id=0, seed=0):
    """Generate completions for ``input_ids`` (``[batch, prompt_len]``).

    Greedy when ``do_sample`` is False; temperature/top-k/top-p sampling
    otherwise. Returns ``[batch, prompt_len + max_new_tokens]`` int64 ids
    on the model's device (finished rows padded with ``pad_token_id``
    after their eos)."""
    dev = model.device
    ids = torch.as_tensor(input_ids, device=dev).long()
    if int(max_new_tokens) <= 0:
        return ids
    b, prompt_len = ids.shape
    total = prompt_len + int(max_new_tokens)
    if total > model.cfg.max_seq_len:
        raise ValueError(
            f"prompt_len + max_new_tokens = {total} exceeds max_seq_len "
            f"{model.cfg.max_seq_len}")

    def pick(logits, k):
        if do_sample:
            return sample_logits(logits, k, temperature, top_k, top_p)
        return torch.argmax(logits, dim=-1)

    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            caches = model.gpt.init_cache(b, max_len=total)
            logits, caches = model(ids, caches=caches, pos=0)
            key, sub = random.split(random.key(seed, dev))
            tok = pick(logits[:, -1], sub)
            out = [tok]
            finished = tok == eos_token_id if eos_token_id is not None \
                else None
            keys = random.split(key, max_new_tokens - 1)
            pad = torch.full_like(tok, pad_token_id)
            for t in range(int(max_new_tokens) - 1):
                logits, caches = model(tok[:, None], caches=caches,
                                       pos=prompt_len + t)
                tok = pick(logits[:, -1], keys[t])
                if finished is not None:
                    tok = torch.where(finished, pad, tok)
                    finished = finished | (tok == eos_token_id)
                out.append(tok)
    finally:
        if was_training:
            model.train()
    return torch.cat([ids, torch.stack(out, dim=1)], dim=1)
