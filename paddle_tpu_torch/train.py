"""The GPT training step — the port of ``bench.py``'s ``build_train_step``
and the top rung of its configuration ladder (``_BASE_RUNGS[0]``).

    from paddle_tpu_torch.train import BASE_RUNGS, build_train_step

    step = build_train_step(BASE_RUNGS[0])       # 350M-b8-off, on the card
    ids = torch.randint(0, 50304, (8, 1024), device="cuda")
    loss = step["train_step"](ids, labels)

One step is the computation ``bench.py`` times: the GPT forward with
labels through the fused chunked head + cross-entropy, the backward, one
AdamW update (bf16 parameters with float32 masters, AMP-O2, lr 1e-4,
weight decay 0.01) and ``zero_grad``. On the card attention runs the flash
kernels and the update the fused Adam kernel.
"""
from __future__ import annotations

import torch

from ._device import resolve_device
from .optimizer import AdamW
from .text.gpt import GPTConfig, GPTForCausalLM

__all__ = ["BASE_RUNGS", "build_train_step", "flops_per_token"]

#: ``bench.py``'s ladder as far as a caller drives it: its top rung,
#: gpt3-350m with no remat (policy "off" = no remat, None = full remat)
BASE_RUNGS = [
    dict(tag="350M-b8-off", batch=8, policy="off", hidden=1024, layers=24,
         heads=16),
]

LEARNING_RATE = 1e-4
SEED = 0  # the weights' seed, as bench.py's paddle.seed(0)


def flops_per_token(cfg: GPTConfig, n_params: int, seq: int) -> float:
    """Training operations per token, ``6 N + 12 L s h`` (``bench.py``'s
    MFU accounting)."""
    return 6.0 * n_params + 12.0 * cfg.num_layers * seq * cfg.hidden_size


def build_train_step(rung: dict, device=None, dtype=torch.bfloat16) -> dict:
    """Model, optimizer and step for one rung dict, as in ``BASE_RUNGS`` (keys
    ``hidden``, ``layers``, ``heads``, ``batch``, ``policy``; optional
    ``vocab`` (50304), ``seq`` (1024), ``loss_chunk`` (2048)).

    The weights are drawn from ``SEED`` in float32 on ``device`` (``None``
    = the card; raises when there is none) and cast to ``dtype``: bfloat16
    gives bench.py's AMP-O2 (float32 masters in the optimizer), float32 a
    full-precision step. Returns ``dict(train_step, model, opt, cfg,
    n_params)``; ``train_step(ids, labels)`` runs forward with labels,
    backward, ``opt.step()`` and ``opt.zero_grad()`` and returns the loss
    (a float32 scalar tensor, not synchronised)."""
    policy = rung["policy"]
    if policy not in ("off", None):
        raise NotImplementedError(
            f"remat policy {policy!r} is not ported (ROADMAP Queue 1 item "
            f"7); use 'off' or None (full remat)")
    cfg = GPTConfig(vocab_size=rung.get("vocab", 50304),
                    hidden_size=rung["hidden"], num_layers=rung["layers"],
                    num_heads=rung["heads"], max_seq_len=rung.get("seq", 1024),
                    dropout=0.0, recompute=policy != "off",
                    recompute_policy=None,
                    loss_chunk_size=int(rung.get("loss_chunk", 2048)))
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model = GPTForCausalLM(cfg, device=dev, dtype=torch.float32,
                           generator=gen).to(dtype)
    model.train()
    opt = AdamW(learning_rate=LEARNING_RATE,
                parameters=list(model.named_parameters()),
                multi_precision=True)

    def train_step(ids, labels):
        loss = model(ids, labels=labels)
        loss.backward()
        opt.step()
        opt.zero_grad()
        return loss.detach()

    n_params = sum(p.numel() for p in model.parameters())
    return dict(train_step=train_step, model=model, opt=opt, cfg=cfg,
                n_params=n_params)
