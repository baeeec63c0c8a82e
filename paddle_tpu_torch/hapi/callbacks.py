"""Callbacks — the port of ``paddle_tpu/hapi/callbacks.py``
(``Callback``, ``CallbackList``, ``ProgBarLogger``, ``ModelCheckpoint``,
``EarlyStopping``, ``LRScheduler``, ``VisualDL``, ``ReduceLROnPlateau``,
``config_callbacks``), host Python as there, with the reference's
dispatch: ``on_batch_end(mode, ...)`` calls ``on_{mode}_batch_end``,
``on_begin(mode)`` ``on_{mode}_begin``. ``VisualDL`` writes its JSONL
file (VisualDL itself is not a dependency of the port)."""
from __future__ import annotations

import numbers
import os
import time


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_model(self, model):
        self.model = model

    def set_params(self, params):
        self.params = params or {}

    def on_begin(self, mode, logs=None):
        getattr(self, f"on_{mode}_begin", lambda logs=None: None)(logs)

    def on_end(self, mode, logs=None):
        getattr(self, f"on_{mode}_end", lambda logs=None: None)(logs)

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_batch_begin(self, mode, step, logs=None):
        getattr(self, f"on_{mode}_batch_begin", lambda step, logs=None: None)(step, logs)

    def on_batch_end(self, mode, step, logs=None):
        getattr(self, f"on_{mode}_batch_end", lambda step, logs=None: None)(step, logs)

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks):
        self.callbacks = callbacks

    def _call(self, name, *args):
        for c in self.callbacks:
            getattr(c, name)(*args)

    def set_model(self, model):
        for c in self.callbacks:
            c.set_model(model)

    def set_params(self, params):
        for c in self.callbacks:
            c.set_params(params)

    def on_begin(self, mode, logs=None):
        self._call("on_begin", mode, logs)

    def on_end(self, mode, logs=None):
        self._call("on_end", mode, logs)

    def on_epoch_begin(self, epoch, logs=None):
        self._call("on_epoch_begin", epoch, logs)

    def on_epoch_end(self, epoch, logs=None):
        self._call("on_epoch_end", epoch, logs)

    def on_batch_begin(self, mode, step, logs=None):
        self._call("on_batch_begin", mode, step, logs)

    def on_batch_end(self, mode, step, logs=None):
        self._call("on_batch_end", mode, step, logs)


class ProgBarLogger(Callback):
    def __init__(self, log_freq=1, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self.t0 = time.time()
        if self.verbose:
            total = self.params.get("epochs")
            print(f"Epoch {epoch + 1}/{total}")

    def on_train_batch_end(self, step, logs=None):
        if self.verbose and step % self.log_freq == 0:
            items = [f"{k}: {_fmt(v)}" for k, v in (logs or {}).items()
                     if k not in ("step", "batch_size")]
            print(f"step {step}: " + ", ".join(items))

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            dt = time.time() - self.t0
            items = [f"{k}: {_fmt(v)}" for k, v in (logs or {}).items()
                     if k not in ("step", "batch_size")]
            print(f"Epoch {epoch + 1} done in {dt:.1f}s: " + ", ".join(items))


def _fmt(v):
    if isinstance(v, numbers.Number):
        return f"{v:.4f}"
    if isinstance(v, list):
        return "[" + ", ".join(_fmt(x) for x in v) + "]"
    return str(v)


class ModelCheckpoint(Callback):
    def __init__(self, save_freq=1, save_dir=None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and epoch % self.save_freq == 0:
            os.makedirs(self.save_dir, exist_ok=True)
            self.model.save(os.path.join(self.save_dir, str(epoch)))

    def on_train_end(self, logs=None):
        if self.save_dir:
            os.makedirs(self.save_dir, exist_ok=True)
            self.model.save(os.path.join(self.save_dir, "final"))


class EarlyStopping(Callback):
    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.wait = 0
        self.best = None
        if mode == "max" or (mode == "auto" and "acc" in monitor):
            self.better = lambda a, b: a > b + self.min_delta
        else:
            self.better = lambda a, b: a < b - self.min_delta

    def on_epoch_end(self, epoch, logs=None):
        v = (logs or {}).get(self.monitor)
        if v is None:
            return
        if isinstance(v, list):
            v = v[0]
        if self.best is None or self.better(v, self.best):
            self.best = v
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.model.stop_training = True


class LRScheduler(Callback):
    def __init__(self, by_step=True, by_epoch=False):
        super().__init__()
        self.by_step = by_step
        self.by_epoch = by_epoch

    def on_train_batch_end(self, step, logs=None):
        sched = getattr(self.model._optimizer, "_lr_scheduler", None)
        if self.by_step and sched is not None:
            sched.step()


class VisualDL(Callback):
    """Metric logging to a JSONL file (VisualDL itself is not in this image)."""

    def __init__(self, log_dir="./log"):
        super().__init__()
        self.log_dir = log_dir
        self._fh = None

    def on_train_begin(self, logs=None):
        os.makedirs(self.log_dir, exist_ok=True)
        self._fh = open(os.path.join(self.log_dir, "metrics.jsonl"), "a")

    def on_epoch_end(self, epoch, logs=None):
        if self._fh:
            import json

            rec = {"epoch": epoch}
            for k, v in (logs or {}).items():
                if isinstance(v, numbers.Number):
                    rec[k] = v
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()

    def on_train_end(self, logs=None):
        if self._fh:
            self._fh.close()


def config_callbacks(callbacks=None, model=None, batch_size=None, epochs=None,
                     steps=None, log_freq=2, verbose=2, save_freq=1, save_dir=None,
                     metrics=None, mode="train"):
    cbks = list(callbacks or [])
    if not any(isinstance(c, ProgBarLogger) for c in cbks) and verbose:
        cbks = [ProgBarLogger(log_freq, verbose=verbose)] + cbks
    if save_dir and not any(isinstance(c, ModelCheckpoint) for c in cbks):
        cbks.append(ModelCheckpoint(save_freq, save_dir))
    cl = CallbackList(cbks)
    cl.set_model(model)
    cl.set_params({
        "batch_size": batch_size, "epochs": epochs, "steps": steps,
        "verbose": verbose, "metrics": metrics or ["loss"],
    })
    return cl


class ReduceLROnPlateau(Callback):
    """Reduce the optimizer lr when a monitored metric stops improving
    (reference hapi/callbacks.py ReduceLROnPlateau — the callback form of
    optimizer.lr.ReduceOnPlateau)."""

    def __init__(self, monitor="loss", factor=0.1, patience=10, verbose=1,
                 mode="auto", min_delta=1e-4, cooldown=0, min_lr=0):
        super().__init__()
        self.monitor = monitor
        self.factor = float(factor)
        self.patience = int(patience)
        self.verbose = verbose
        self.min_delta = float(min_delta)
        self.cooldown = int(cooldown)
        self.min_lr = float(min_lr)
        if mode == "min" or (mode == "auto" and "acc" not in monitor):
            self._cmp = lambda cur, best: cur < best - self.min_delta
            self._best = float("inf")
        else:
            self._cmp = lambda cur, best: cur > best + self.min_delta
            self._best = -float("inf")
        self._wait = 0
        self._cooldown_left = 0

    def _get_metric(self, logs):
        v = (logs or {}).get(self.monitor)
        if isinstance(v, (list, tuple)):
            v = v[0]
        return None if v is None else float(v)

    def on_eval_end(self, logs=None):
        self._step(logs)

    def on_epoch_end(self, epoch, logs=None):
        self._step(logs)

    def _step(self, logs):
        cur = self._get_metric(logs)
        if cur is None:
            return
        if self._cooldown_left > 0:
            self._cooldown_left -= 1
            self._wait = 0
            return  # hold: no comparisons while cooling down
        if self._cmp(cur, self._best):
            self._best = cur
            self._wait = 0
            return
        self._wait += 1
        if self._wait >= self.patience:
            opt = getattr(self.model, "_optimizer", None)
            if opt is None:
                return
            lr = opt.get_lr()
            new_lr = max(lr * self.factor, self.min_lr)
            if new_lr < lr:
                try:
                    opt.set_lr(new_lr)
                except RuntimeError:
                    # LRScheduler-driven optimizer: scale the schedule's base
                    # and refresh its cached last_lr at the current epoch
                    sched = opt._learning_rate
                    if hasattr(sched, "base_lr"):
                        # scale by the clamped ratio so min_lr is honored
                        sched.base_lr *= new_lr / lr
                        sched.step(sched.last_epoch)
                    else:  # pragma: no cover - schedulers all carry base_lr
                        raise
                if self.verbose:
                    print(f"ReduceLROnPlateau: lr {lr:.3g} -> {new_lr:.3g}")
            self._wait = 0
            self._cooldown_left = self.cooldown
