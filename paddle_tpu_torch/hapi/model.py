"""The high-level ``Model`` API — the port of ``paddle_tpu/hapi/model.py``
(``Model``: ``prepare``, ``fit``, ``evaluate``, ``predict``,
``train_batch``, ``eval_batch``, ``predict_batch``, ``save``, ``load``,
``parameters``, ``summary``; and ``summary``).

The reference jits one functional step (forward, loss, backward and the
optimizer in one XLA computation). The port runs the step eagerly on the
network's device: the forward under ``_amp_ctx(level)`` and the
reference's key scope (``core.rng.trace_rng_scope`` of one key a step, so
dropout draws the reference's bits), the loss's mean in float32,
``backward``, ``optimizer.step()`` (the fused Adam kernel for ``Adam`` and
``AdamW`` on the card) and ``clear_grad()``. The reference's quirks stay:

- a frozen (``stop_gradient``) parameter takes no update;
- ``_split_batch`` takes the first ``len(inputs)`` fields as inputs (the
  rest labels), else all but the labels' count, else all but one;
- ``fit`` steps the optimizer's scheduler once an epoch, and an
  ``LRScheduler`` callback once a batch more;
- ``on_epoch_end`` fires after the epoch's evaluation, so monitors read
  ``eval_*``;
- ``train_batch`` returns ``[float(loss)] + metrics``: one host read a
  step, as the reference's;
- ``predict_batch`` switches the network to eval and back to train.

``amp_configs`` is the reference's (a level string, or a dict with
``"level"``); a dict may also name ``"dtype": "float16"``, and the step
then scales its loss with a ``GradScaler`` (made with the dict's
``init_loss_scaling``, ``decr_every_n_nan_or_inf`` ... where given),
whose found-inf flag costs one host read a step. The reference runs
bfloat16 only and has no scaler.
"""
from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from .._device import resolve_device
from ..core import rng as rng_mod
from ..core.tensor import as_port
from ..framework import load as _load
from ..framework import save as _save
from ..io.dataloader import DataLoader
from ..metric import Metric
from . import callbacks as cbs_mod

__all__ = ["Model", "summary"]


#: the ``amp_configs`` keys a float16 step passes to its ``GradScaler``
_SCALER_KEYS = ("init_loss_scaling", "incr_ratio", "decr_ratio",
                "incr_every_n_steps", "decr_every_n_nan_or_inf",
                "use_dynamic_loss_scaling")


def _as_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _set_training(net, flag: bool) -> None:
    for layer in net.sublayers(include_self=True):
        layer.training = flag


class Model:
    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._inputs = _as_list(inputs)
        self._labels = _as_list(labels)
        self._optimizer = None
        self._loss = None
        self._metrics = []
        self._amp_level = "O0"
        self._amp_dtype = "bfloat16"
        self._scaler = None
        self.stop_training = False

    # --------------------------------------------------------------- prepare
    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        self._optimizer = optimizer
        self._loss = loss
        self._metrics = _as_list(metrics)
        for m in self._metrics:
            assert isinstance(m, Metric), \
                "metrics must be paddle.metric.Metric"
        if isinstance(amp_configs, str):
            self._amp_level = amp_configs
        elif isinstance(amp_configs, dict):
            self._amp_level = amp_configs.get("level", "O1")
            self._amp_dtype = amp_configs.get("dtype", "bfloat16")
        elif amp_configs is not None:
            self._amp_level = "O1"
        if self._amp_level in ("O1", "O2") and self._amp_dtype == "float16":
            from ..amp import GradScaler

            self._scaler = GradScaler(**{k: amp_configs[k]
                                         for k in _SCALER_KEYS
                                         if k in amp_configs})
        return self

    def _device(self) -> torch.device:
        for p in self.network.parameters():
            return p.device
        return resolve_device(None)

    def _tensors(self, xs) -> list:
        """Inputs or labels as port tensors on the network's device; a
        host array is copied with ``non_blocking=True`` (no host
        synchronisation, as the DataLoader's batches)."""
        dev = self._device()
        out = []
        for x in _as_list(xs):
            if not isinstance(x, torch.Tensor):
                x = torch.as_tensor(np.asarray(x))
            if x.device != dev:
                x = x.to(dev, non_blocking=True)
            out.append(as_port(x))
        return out

    # --------------------------------------------------------------- steps
    def _forward_loss(self, ins, lbs, training: bool):
        """``(loss float32 scalar, outputs)`` of one forward."""
        _set_training(self.network, training)
        with rng_mod.trace_rng_scope(rng_mod.next_rng_key()):
            with _amp_ctx(self._amp_level, self._amp_dtype):
                out = self.network(*ins)
            outs = list(out) if isinstance(out, (tuple, list)) else [out]
            if self._loss is None:
                return torch.zeros((), dtype=torch.float32,
                                   device=self._device()), outs
            lv = self._loss(*(outs + lbs))
            if isinstance(lv, (list, tuple)):
                total = lv[0]
                for extra in lv[1:]:
                    total = total + extra
                lv = total
            if lv.dim() > 0:
                lv = lv.mean()
        return lv.float(), outs

    def _split_batch(self, data):
        arrays = list(data) if isinstance(data, (list, tuple)) else [data]
        if self._labels:
            ni = len(self._inputs) or (len(arrays) - len(self._labels))
        else:
            ni = len(self._inputs) or max(1, len(arrays) - 1)
        return tuple(arrays[:ni]), tuple(arrays[ni:])

    def train_batch(self, inputs, labels=None, update=True):
        ins, lbs = self._tensors(inputs), self._tensors(labels)
        loss, outs = self._forward_loss(ins, lbs, True)
        opt = self._optimizer
        if self._scaler is not None:
            self._scaler.scale(loss).backward()
            self._scaler.step(opt)
        else:
            loss.backward()
            opt.step()
        opt.clear_grad()
        metrics = self._update_metrics(outs, lbs)
        value = float(loss.detach())
        return [value] + metrics if metrics else [value]

    def eval_batch(self, inputs, labels=None):
        ins, lbs = self._tensors(inputs), self._tensors(labels)
        with torch.no_grad():
            loss, outs = self._forward_loss(ins, lbs, False)
        metrics = self._update_metrics(outs, lbs)
        value = float(loss.detach())
        return [value] + metrics if metrics else [value]

    def predict_batch(self, inputs):
        self.network.eval()
        with torch.no_grad():
            outs = as_port(self.network(*self._tensors(inputs)))
        self.network.train()
        return outs

    def _update_metrics(self, outs, labels):
        vals = []
        for m in self._metrics:
            pred = outs[0].detach()
            lab = labels[0] if labels else None
            res = m.compute(pred, lab)
            vals.append(m.update(res if isinstance(res, torch.Tensor)
                                 else res[0]))
        return vals

    # --------------------------------------------------------------- fit
    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            accumulate_grad_batches=1, num_iters=None):
        train_loader = self._to_loader(train_data, batch_size, shuffle,
                                       drop_last, num_workers)
        eval_loader = self._to_loader(eval_data, batch_size, False, False,
                                      num_workers)
        cbks = cbs_mod.config_callbacks(
            callbacks, model=self, epochs=epochs,
            steps=_safe_len(train_loader), log_freq=log_freq,
            save_freq=save_freq, save_dir=save_dir, verbose=verbose,
            metrics=["loss"] + self._metrics_names())
        cbks.on_begin("train")
        self.stop_training = False
        logs = {}
        for epoch in range(epochs):
            if self.stop_training:
                break
            cbks.on_epoch_begin(epoch)
            logs = self._run_one_epoch(train_loader, cbks, "train", num_iters)
            sched = self._optimizer._lr_scheduler \
                if self._optimizer is not None else None
            if sched is not None:
                sched.step()
            if eval_loader is not None and (epoch % eval_freq == 0
                                            or epoch == epochs - 1):
                eval_logs = self.evaluate(eval_loader, verbose=0,
                                          _invoke_cbks=False)
                logs.update({f"eval_{k}": v for k, v in eval_logs.items()})
            # epoch-end fires AFTER eval so monitors (EarlyStopping,
            # ReduceLROnPlateau) can read eval_* metrics
            cbks.on_epoch_end(epoch, logs)
        cbks.on_end("train", logs)
        return self

    def _run_one_epoch(self, loader, cbks, mode, num_iters=None):
        logs = {}
        for m in self._metrics:
            m.reset()
        for step, batch in enumerate(loader):
            if num_iters is not None and step >= num_iters:
                break
            cbks.on_batch_begin(mode, step, logs)
            ins, lbs = self._split_batch(batch)
            if mode == "train":
                res = self.train_batch(ins, lbs)
            else:
                res = self.eval_batch(ins, lbs)
            logs["loss"] = res[0]
            logs["step"] = step
            logs["batch_size"] = ins[0].shape[0] if ins else 1
            for name, m in zip(self._metrics_names(), self._metrics):
                logs[name] = m.accumulate()
            cbks.on_batch_end(mode, step, logs)
        return logs

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_iters=None,
                 _invoke_cbks=True):
        loader = self._to_loader(eval_data, batch_size, False, False,
                                 num_workers)
        for m in self._metrics:
            m.reset()
        losses = []
        for step, batch in enumerate(loader):
            if num_iters is not None and step >= num_iters:
                break
            ins, lbs = self._split_batch(batch)
            losses.append(self.eval_batch(ins, lbs)[0])
        logs = {"loss": float(np.mean(losses)) if losses else 0.0}
        for name, m in zip(self._metrics_names(), self._metrics):
            logs[name] = m.accumulate()
        return logs

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, verbose=1, callbacks=None):
        loader = self._to_loader(test_data, batch_size, False, False,
                                 num_workers)
        outputs = []
        for batch in loader:
            ins, _ = self._split_batch(batch)
            out = self.predict_batch(list(ins))
            outs = out if isinstance(out, (list, tuple)) else [out]
            outputs.append([as_port(o).numpy() for o in outs])
        if stack_outputs and outputs:
            n_out = len(outputs[0])
            return [np.concatenate([b[i] for b in outputs])
                    for i in range(n_out)]
        return outputs

    def _to_loader(self, data, batch_size, shuffle, drop_last, num_workers):
        if data is None:
            return None
        if isinstance(data, DataLoader):
            return data
        if hasattr(data, "__getitem__") or hasattr(data, "__iter__"):
            return DataLoader(data, places=self._device(),
                              batch_size=batch_size, shuffle=shuffle,
                              drop_last=drop_last, num_workers=num_workers)
        return data

    def _metrics_names(self):
        names = []
        for m in self._metrics:
            n = m.name()
            names.extend(n if isinstance(n, list) else [n])
        return names

    # --------------------------------------------------------------- io
    def save(self, path, training=True):
        _save(self.network.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None:
            _save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        self.network.set_state_dict(_load(path + ".pdparams"))
        if not reset_optimizer and self._optimizer is not None \
                and os.path.exists(path + ".pdopt"):
            self._optimizer.set_state_dict(_load(path + ".pdopt"))

    def parameters(self, *args, **kwargs):
        return self.network.parameters()

    def summary(self, input_size=None, dtype=None):
        return summary(self.network, input_size, dtype)


def _amp_ctx(level, dtype="bfloat16"):
    if level in ("O1", "O2"):
        from ..amp import auto_cast

        return auto_cast(True, level=level, dtype=dtype)
    return contextlib.nullcontext()


def _safe_len(loader):
    try:
        return len(loader)
    except Exception:  # noqa: BLE001 — an iterable loader has no length
        return None


def summary(net, input_size=None, dtypes=None):
    """Print a table of the parameters (name, shape, count) and return
    ``{"total_params", "trainable_params"}``."""
    rows = []
    total = 0
    trainable = 0
    for name, p in net.named_parameters():
        n = int(np.prod(tuple(p.shape))) if p.dim() else 1
        total += n
        if p.requires_grad:
            trainable += n
        rows.append((name, tuple(p.shape), n))
    width = max([len(r[0]) for r in rows], default=20) + 2
    lines = [f"{'Layer (param)':<{width}}{'Shape':<24}{'Param #':<12}",
             "-" * (width + 36)]
    for name, shape, n in rows:
        lines.append(f"{name:<{width}}{str(list(shape)):<24}{n:<12}")
    lines.append("-" * (width + 36))
    lines.append(f"Total params: {total:,}")
    lines.append(f"Trainable params: {trainable:,}")
    print("\n".join(lines))
    return {"total_params": total, "trainable_params": trainable}
