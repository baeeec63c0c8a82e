"""The GPT training step — the port of ``bench.py``'s ``build_train_step``
and its configuration ladder (``_BASE_RUNGS``).

    from paddle_tpu_torch.train import BASE_RUNGS, build_train_step

    step = build_train_step(BASE_RUNGS[0])       # 350M-b8-off, on the card
    ids = torch.randint(0, 50304, (8, 1024), device="cuda")
    loss = step["train_step"](ids, labels)

One step is the computation ``bench.py`` times: the GPT forward with
labels through the fused chunked head + cross-entropy, the backward, one
AdamW update (bf16 parameters with float32 masters, AMP-O2, lr 1e-4,
weight decay 0.01) and ``zero_grad``. On the card attention runs the flash
kernels, LayerNorm the LayerNorm kernels and the update the fused Adam
kernel.

``build_train_step`` also takes the reference's own options, for the
published pretraining recipe (Megatron-LM's GPT-345M: dropout 0.1,
``--clip-grad 1.0``, a warm-up then cosine decay):

    from paddle_tpu_torch.optimizer.lr import (CosineAnnealingDecay,
                                               LinearWarmup)
    from paddle_tpu_torch.utils.clip_grad import ClipGradByGlobalNorm

    sched = LinearWarmup(CosineAnnealingDecay(1.5e-4, T_max=1000), 10, 0.0,
                         1.5e-4)
    step = build_train_step(BASE_RUNGS[1], dropout=0.1,   # dots remat
                            grad_clip=ClipGradByGlobalNorm(1.0),
                            learning_rate=sched)

Then dropout runs the dropout kernel, the clip the global-norm kernel,
whose scale the Adam kernel applies, and ``train_step`` steps the
scheduler after each update. ``device="cpu"`` runs all of it on the CPU
through the kernels' plain versions.
"""
from __future__ import annotations

import torch

from ._device import resolve_device
from .core.rng import trace_rng_scope
from .optimizer import AdamW
from .optimizer.lr import LRScheduler
from .text.gpt import GPTConfig, GPTForCausalLM

__all__ = ["BASE_RUNGS", "KEY", "build_train_step", "flops_per_token"]

_RUNG_350M = dict(hidden=1024, layers=24, heads=16)
_RUNG_125M = dict(hidden=768, layers=12, heads=12)
#: ``bench.py``'s ladder (policy "off" = no remat, "dots" = keep the
#: matrix products, None = full remat)
BASE_RUNGS = [
    dict(tag="350M-b8-off", batch=8, policy="off", **_RUNG_350M),
    dict(tag="350M-b8-dots", batch=8, policy="dots", **_RUNG_350M),
    dict(tag="350M-b8-full", batch=8, policy=None, **_RUNG_350M),
    dict(tag="350M-b4-full", batch=4, policy=None, **_RUNG_350M),
    dict(tag="125M-b8-full", batch=8, policy=None, **_RUNG_125M),
]

LEARNING_RATE = 1e-4
SEED = 0  # the weights' seed, as bench.py's paddle.seed(0)
#: the base key bench.py passes every step, ``jax.random.key(0)``
KEY = (0, 0)


def flops_per_token(cfg: GPTConfig, n_params: int, seq: int) -> float:
    """Training operations per token, ``6 N + 12 L s h`` (``bench.py``'s
    MFU accounting)."""
    return 6.0 * n_params + 12.0 * cfg.num_layers * seq * cfg.hidden_size


def build_train_step(rung: dict, device=None, dtype=torch.bfloat16, *,
                     dropout: float = 0.0, grad_clip=None,
                     learning_rate=LEARNING_RATE) -> dict:
    """Model, optimizer and step for one rung dict, as in ``BASE_RUNGS`` (keys
    ``hidden``, ``layers``, ``heads``, ``batch``, ``policy``; optional
    ``vocab`` (50304), ``seq`` (1024), ``loss_chunk`` (2048)).

    The weights are drawn from ``SEED`` in float32 on ``device`` (``None``
    = the card; raises when there is none) and cast to ``dtype``: bfloat16
    gives bench.py's AMP-O2 (float32 masters in the optimizer), float32 a
    full-precision step. ``dropout``: the ``GPTConfig`` dropout;
    ``grad_clip``: a ``utils.clip_grad`` clip for AdamW; ``learning_rate``:
    a float or an ``optimizer.lr`` scheduler. The defaults are bench.py's.

    Returns ``dict(train_step, model, opt, cfg, n_params)``;
    ``train_step(ids, labels, key=KEY)`` runs the forward with labels
    inside ``trace_rng_scope(key)`` (``key``: two 32-bit words, bench.py's
    ``jax.random.key(0)`` by default), the backward, ``opt.step()``, the
    scheduler's ``step()`` if there is one, and ``opt.zero_grad()``, and
    returns the loss (a float32 scalar tensor, not synchronised)."""
    policy = rung["policy"]
    cfg = GPTConfig(vocab_size=rung.get("vocab", 50304),
                    hidden_size=rung["hidden"], num_layers=rung["layers"],
                    num_heads=rung["heads"], max_seq_len=rung.get("seq", 1024),
                    dropout=float(dropout), recompute=policy != "off",
                    recompute_policy=None if policy == "off" else policy,
                    loss_chunk_size=int(rung.get("loss_chunk", 2048)))
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model = GPTForCausalLM(cfg, device=dev, dtype=torch.float32,
                           generator=gen).to(dtype)
    model.train()
    opt = AdamW(learning_rate=learning_rate,
                parameters=list(model.named_parameters()),
                grad_clip=grad_clip, multi_precision=True)
    sched = learning_rate if isinstance(learning_rate, LRScheduler) else None

    def train_step(ids, labels, key=KEY):
        with trace_rng_scope(key):
            loss = model(ids, labels=labels)
        loss.backward()
        opt.step()
        if sched is not None:
            sched.step()
        opt.zero_grad()
        return loss.detach()

    n_params = sum(p.numel() for p in model.parameters())
    return dict(train_step=train_step, model=model, opt=opt, cfg=cfg,
                n_params=n_params)
