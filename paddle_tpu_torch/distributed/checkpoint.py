"""Distributed checkpoints — the port of
``paddle_tpu/distributed/checkpoint.py`` (``save_state_dict``,
``load_state_dict``, ``AutoCheckpoint``).

A checkpoint is a directory holding ``state.pdparams``, the file the
reference writes through ``framework.io.save`` when orbax is absent;
the port writes it through its own ``framework.io.save`` (Paddle's
``.pdparams`` layout), so a checkpoint of either package loads into the
other. The reference's orbax branch (each host writing its own array
shards, asynchronously) has no counterpart: ``async_save`` is accepted
and the write is synchronous.

Across ranks (a process group of several ranks): rank 0 writes and every
rank waits at a barrier, so that the file is whole when any rank goes
on. Given a model instead of a dict, ``save_state_dict`` writes the
model's FULL state: each parameter that model parallelism split
(``meta_parallel.shard_model``) is gathered from the model-parallel
group first; ``load_state_dict(path, model)`` reads the file on every
rank and sets this rank's shard of each entry into the model.
"""
from __future__ import annotations

import os
import shutil

import numpy as np
import torch

from ..framework.io import load as _load
from ..framework.io import save as _save
from . import collective as C
from . import env

__all__ = ["save_state_dict", "load_state_dict", "full_state_dict",
           "AutoCheckpoint"]

FILE = "state.pdparams"


def _multi() -> bool:
    return env.is_initialized() and env.get_world_size() > 1


def _layers(model):
    """The module under a ``HybridParallelModel`` or a ZeRO wrapper."""
    model = getattr(model, "_model", model)
    return getattr(model, "_layers", model)


def full_state_dict(model) -> dict:
    """The model's whole state: each model-parallel parameter gathered
    over the model's group (``_mp_group``) and joined as
    ``meta_parallel._slice`` cut it; every other entry as it is."""
    state = model.state_dict()
    inner = _layers(model)
    group = getattr(inner, "_mp_group", None)
    if group is None or group.nranks == 1:
        return state
    split = {n: p for n, p in inner.named_parameters()
             if getattr(p, "_mp_split", False)}
    out = {}
    for k, v in state.items():
        p = split.get(k)
        if p is None:
            out[k] = v
            continue
        parts = C.all_gather(None, v.detach().contiguous(), group=group)
        dim, groups = p._mp_dim, p._mp_groups
        out[k] = torch.cat([part.chunk(groups, dim=dim)[i] for i in
                            range(groups) for part in parts.unbind(0)],
                           dim=dim)
    return out


def save_state_dict(state_dict, path, async_save=False):
    """Write ``state_dict`` (a dict, or a model: its
    :func:`full_state_dict`) as ``path/state.pdparams``; across ranks
    rank 0 writes and every rank waits until it has. Returns None (the
    reference returns its orbax checkpointer, None without orbax)."""
    if not isinstance(state_dict, dict):
        state_dict = full_state_dict(state_dict)
    if not _multi() or env.get_rank() == 0:
        _save(state_dict, os.path.join(path, FILE))
    if _multi():
        env.barrier()
    return None


def load_state_dict(path, template=None):
    """The state dict of ``path/state.pdparams`` (CPU tensors).
    ``template`` a model:
    this rank's shard of each entry is set into it (each model-parallel
    parameter cut as ``shard_model`` cuts it) and the rank's dict
    returned."""
    # read to the host: each entry lands on its parameter's device when
    # set into a model
    state = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
             for k, v in _load(os.path.join(os.path.abspath(path), FILE),
                               return_numpy=True).items()}
    if template is None or isinstance(template, dict):
        return state
    from .fleet.meta_parallel import model_specs, shard_state_dict

    inner = _layers(template)
    group = getattr(inner, "_mp_group", None)
    if group is not None and group.nranks > 1:
        state = shard_state_dict(state, model_specs(inner), group.rank,
                                 group.nranks)
    missing, unexpected = template.set_state_dict(state)
    if missing or unexpected:
        raise KeyError(f"checkpoint {path}: missing {missing}, unexpected "
                       f"{unexpected}")
    return state


def _snapshots(directory):
    return sorted((d for d in os.listdir(directory) if d.startswith("step_")),
                  key=lambda d: int(d.split("_")[1]))


class AutoCheckpoint:
    """Periodic train-state snapshots with resume: ``step(state_dict_fn)``
    counts a step and every ``save_interval_steps`` writes
    ``state_dict_fn()`` under ``directory/step_{n}`` (rank 0, every rank
    waiting), keeping the newest ``max_to_keep``; ``latest()`` is the
    newest snapshot's directory (None: none yet)."""

    def __init__(self, directory, save_interval_steps=100, max_to_keep=3):
        self.dir = directory
        self.interval = save_interval_steps
        self.max_to_keep = max_to_keep
        self._step = 0
        os.makedirs(directory, exist_ok=True)

    def step(self, state_dict_fn):
        self._step += 1
        if self._step % self.interval == 0:
            p = os.path.join(self.dir, f"step_{self._step}")
            save_state_dict(state_dict_fn(), p, async_save=True)
            if not _multi() or env.get_rank() == 0:
                self._gc()
        return self._step

    def _gc(self):
        for d in _snapshots(self.dir)[: -self.max_to_keep]:
            shutil.rmtree(os.path.join(self.dir, d), ignore_errors=True)

    def latest(self):
        snaps = _snapshots(self.dir)
        return os.path.join(self.dir, snaps[-1]) if snaps else None
