"""``paddle.metric`` — the port of ``paddle_tpu/metric/__init__.py``
(``Metric``, ``Accuracy``, ``Precision``, ``Recall``, ``Auc``,
``accuracy``).

The metrics accumulate on the host in numpy, as the reference's do:
``Accuracy.compute`` reads ``pred`` once and ranks it with
``np.argsort(-pred)`` as the reference does, so ties rank as the
reference ranks them. ``accuracy()`` is a device function, as in the
reference (``jnp.argsort`` is stable there, ``torch.argsort(stable=True)``
here: a tie ranks the lower index first).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.tensor import as_port

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy"]


def _host(x) -> np.ndarray:
    """``x`` as a host array (one read of a device tensor)."""
    if isinstance(x, torch.Tensor):
        return as_port(x).numpy()
    return np.asarray(x)


class Metric:
    def __init__(self):
        pass

    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        raise NotImplementedError

    def compute(self, *args):
        return args


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None):
        super().__init__()
        self.topk = topk if isinstance(topk, (list, tuple)) else (topk,)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def compute(self, pred, label, *args):
        """``[..., maxk]`` float32 hits: whether the label is the k-th
        ranked class, ranked on the host."""
        pred = _host(pred)
        label = _host(label)
        idx = np.argsort(-pred, axis=-1)[..., : self.maxk]
        if label.ndim == pred.ndim:
            label = label.argmax(axis=-1) if label.shape[-1] != 1 \
                else label.squeeze(-1)
        correct = idx == label[..., None]
        return as_port(torch.from_numpy(correct.astype(np.float32)))

    def update(self, correct, *args):
        c = _host(correct)
        accs = []
        num = c.reshape(-1, c.shape[-1]).shape[0]
        for k in self.topk:
            ck = c[..., :k].any(axis=-1).sum()
            self.total[self.topk.index(k)] += ck
            self.count[self.topk.index(k)] += num
            accs.append(float(ck) / max(num, 1))
        return accs[0] if len(accs) == 1 else accs

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def accumulate(self):
        res = [t / max(c, 1) for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return [self._name]
        return [f"{self._name}_top{k}" for k in self.topk]


def _binary_counts(preds, labels):
    pred_pos = np.rint(_host(preds)).astype(bool).reshape(-1)
    lab = _host(labels).astype(bool).reshape(-1)
    return pred_pos, lab


class Precision(Metric):
    def __init__(self, name="precision"):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        pred_pos, lab = _binary_counts(preds, labels)
        self.tp += int((pred_pos & lab).sum())
        self.fp += int((pred_pos & ~lab).sum())

    def reset(self):
        self.tp = 0
        self.fp = 0

    def accumulate(self):
        return self.tp / max(self.tp + self.fp, 1)

    def name(self):
        return self._name


class Recall(Metric):
    def __init__(self, name="recall"):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        pred_pos, lab = _binary_counts(preds, labels)
        self.tp += int((pred_pos & lab).sum())
        self.fn += int((~pred_pos & lab).sum())

    def reset(self):
        self.tp = 0
        self.fn = 0

    def accumulate(self):
        return self.tp / max(self.tp + self.fn, 1)

    def name(self):
        return self._name


class Auc(Metric):
    def __init__(self, curve="ROC", num_thresholds=4095, name="auc"):
        super().__init__()
        self._name = name
        self.num_thresholds = num_thresholds
        self.reset()

    def update(self, preds, labels):
        preds = _host(preds)
        labels = _host(labels)
        if preds.ndim == 2 and preds.shape[1] == 2:
            preds = preds[:, 1]
        preds = preds.reshape(-1)
        labels = labels.reshape(-1).astype(bool)
        idx = np.minimum((preds * self.num_thresholds).astype(np.int64),
                         self.num_thresholds - 1)
        np.add.at(self._stat_pos, idx[labels], 1)
        np.add.at(self._stat_neg, idx[~labels], 1)

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds, dtype=np.int64)
        self._stat_neg = np.zeros(self.num_thresholds, dtype=np.int64)

    def accumulate(self):
        tot_pos = self._stat_pos.sum()
        tot_neg = self._stat_neg.sum()
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        # integrate over thresholds from high to low
        pos = np.cumsum(self._stat_pos[::-1])
        neg = np.cumsum(self._stat_neg[::-1])
        tpr = pos / tot_pos
        fpr = neg / tot_neg
        return float(np.trapezoid(tpr, fpr))

    def name(self):
        return self._name


def accuracy(input, label, k=1, correct=None, total=None,  # noqa: A002
             name=None):
    """The top-``k`` accuracy of ``input`` against ``label`` as a float32
    scalar tensor, on the input's device (no gradient to the label). Ties
    rank as ``argsort(-input)`` ranks them, the lower index first."""
    pred = input if isinstance(input, torch.Tensor) else torch.as_tensor(
        np.asarray(input))
    lab = (label if isinstance(label, torch.Tensor) else torch.as_tensor(
        np.asarray(label))).detach().to(pred.device)
    topk_idx = torch.argsort(-pred, dim=-1, stable=True)[..., :k]
    hit = (topk_idx == lab.reshape(-1, 1)).any(dim=-1)
    return as_port(hit.to(torch.float32).mean())
