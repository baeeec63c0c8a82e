"""Activation recompute — the port of
``paddle_tpu/distributed/fleet/recompute.py`` (``recompute``, ``RecomputeLayer``,
``apply_recompute`` and the policy names).

The reference wraps a block in ``jax.checkpoint`` under a
``jax.checkpoint_policies`` policy. The port builds on
``torch.utils.checkpoint.checkpoint(use_reentrant=False)``, and for the
``dots`` policies on selective checkpointing
(``create_selective_checkpoint_contexts``): the outputs of the matrix
products the policy names are kept from the first forward, everything
else is computed again in the backward. Policies:

- ``None`` / ``"full"`` / ``"nothing"``: keep nothing of the block but its
  inputs;
- ``"dots"`` (``dots_with_no_batch_dims_saveable``): keep the outputs of
  products without batch dimensions (``aten.mm``, ``aten.addmm``: in a GPT
  block the four Linear layers), recompute the rest, the flash and
  LayerNorm forwards among it;
- ``"dots_saveable"``: keep batched products too (``aten.bmm``,
  ``aten.baddbmm``; attention through the composite);
- ``"everything"``: keep every intermediate, which is the plain call;
- a callable: a selective-checkpoint policy ``(ctx, op, *args, **kwargs)
  -> torch.utils.checkpoint.CheckpointPolicy``.

The hand-written kernels are ``ctypes`` calls the dispatcher never sees;
only their output buffers (``aten.empty``) are, which no policy keeps. So
their forwards run again in the recompute, and their saved tensors come
from it.

Random keys: the reference traces the block once, so its rematerialised
forward folds the same counters. The port runs the block twice, so
``recompute`` copies the key source before the first forward
(``core.rng.rng_snapshot``) and draws from that copy in the second
(``core.rng.replaying``): the recomputed dropout masks equal the first
ones, under a ``trace_rng_scope`` or the process-wide generator alike.
With no gradient to record (``torch.no_grad``) the function is called as
it is.
"""
from __future__ import annotations

import functools
import re

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ...core import rng

__all__ = ["recompute", "apply_recompute", "RecomputeLayer", "POLICIES"]

_aten = torch.ops.aten
#: the reference's policy names and the jax.checkpoint_policies they name
POLICIES = {
    None: None,
    "full": None,
    "dots": "dots_with_no_batch_dims_saveable",
    "dots_saveable": "dots_saveable",
    "nothing": "nothing_saveable",
    "everything": "everything_saveable",
}
#: the aten products each selective policy keeps
_SAVED_OPS = {
    "dots_with_no_batch_dims_saveable": frozenset(
        {_aten.mm.default, _aten.addmm.default}),
    "dots_saveable": frozenset({_aten.mm.default, _aten.addmm.default,
                                _aten.bmm.default, _aten.baddbmm.default}),
}

#: tensors kept by a selective policy in first forwards (for counting
#: what a policy saves; the recompute's own decisions are not counted)
saved_outputs = 0


def _keep(ops):
    def policy(ctx, op, *args, **kwargs):
        global saved_outputs
        if op in ops:
            if not ctx.is_recompute:
                saved_outputs += 1
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE
    return policy


def _resolve_policy(policy):
    """``"plain"`` (no checkpoint), None (full) or a selective-checkpoint
    policy function."""
    if callable(policy):
        return policy
    if policy not in POLICIES:
        raise ValueError(f"unknown recompute policy {policy!r}; one of "
                         f"{sorted(map(str, POLICIES))} or a callable")
    name = POLICIES[policy]
    if name in (None, "nothing_saveable"):
        return None
    if name == "everything_saveable":
        return "plain"
    return _keep(_SAVED_OPS[name])


def recompute(function, *args, preserve_rng_state=True, use_reentrant=True,
              policy=None, **kwargs):
    """``function(*args, **kwargs)``, its intermediates (but those the
    policy keeps) dropped after the forward and computed again in the
    backward, with the same random keys. ``preserve_rng_state`` is passed
    to ``torch.utils.checkpoint`` (torch's own generators; the port's keys
    are replayed either way); ``use_reentrant`` is accepted for the
    reference's signature and ignored: the port always checkpoints
    without reentry."""
    fn = _resolve_policy(policy)
    if not torch.is_grad_enabled() or fn == "plain":
        return function(*args, **kwargs)
    snapshot = rng.rng_snapshot()
    calls = [0]

    def run(*a, **kw):
        calls[0] += 1
        if calls[0] == 1:
            return function(*a, **kw)
        with rng.replaying(snapshot):  # the recompute: the same keys
            return function(*a, **kw)

    extra = {}
    if fn is not None:
        extra["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, fn)
    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=preserve_rng_state, **extra,
                      **kwargs)


def apply_recompute(model: nn.Module, checkpoints=None, policy=None) -> int:
    """Make sublayers recompute (their ``forward`` wrapped in
    :func:`recompute` with ``policy``): those whose name matches one of the
    regular expressions ``checkpoints``, or by default every child of
    every ``nn.ModuleList`` (the transformer blocks). Idempotent; returns
    the number of layers covered, counting those an earlier call wrapped
    (0 means a configuration error)."""
    targets = []
    if checkpoints:
        pats = [re.compile(p) for p in checkpoints]
        targets = [sub for name, sub in model.named_modules()
                   if name and any(p.search(name) for p in pats)]
    else:
        for sub in model.modules():
            if isinstance(sub, nn.ModuleList):
                targets.extend(ch for ch in sub.children()
                               if not isinstance(ch, nn.ModuleList))
    for layer in targets:
        if not getattr(layer, "_recompute_wrapped", False):
            layer.forward = functools.partial(recompute, layer.forward,
                                              policy=policy)
            layer._recompute_wrapped = True
    return len(targets)


class RecomputeLayer:
    """A layer whose calls :func:`recompute` (the reference's wrapper):
    attributes read through to the layer."""

    def __init__(self, layer):
        self._layer = layer

    def __call__(self, *args, **kwargs):
        return recompute(self._layer, *args, **kwargs)

    def __getattr__(self, name):
        return getattr(self.__dict__["_layer"], name)
