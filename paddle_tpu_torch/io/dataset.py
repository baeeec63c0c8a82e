"""Datasets (reference: ``paddle_tpu/io/dataset.py``; Paddle's
``python/paddle/fluid/dataloader/dataset.py``). ``random_split`` draws
from Python's ``random``, as the reference does, so one ``random.seed``
gives both packages the same split."""
from __future__ import annotations

import bisect
import random

import numpy as np


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset does not support indexing")

    def __len__(self):
        raise RuntimeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    """Items ``tuple(t[idx] for t in tensors)``: tensors or arrays that
    share their first dimension."""

    def __init__(self, tensors):
        lens = {t.shape[0] for t in tensors}
        if len(lens) != 1:
            raise ValueError("all tensors must share dim 0")
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    """Item ``idx`` of every dataset, flattened into one tuple."""

    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            item = d[idx]
            out.extend(item if isinstance(item, (list, tuple)) else [item])
        return tuple(out)

    def __len__(self):
        return min(len(d) for d in self.datasets)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cum = np.cumsum([len(d) for d in self.datasets]).tolist()

    def __len__(self):
        return self.cum[-1]

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        di = bisect.bisect_right(self.cum, idx)
        prev = 0 if di == 0 else self.cum[di - 1]
        return self.datasets[di][idx - prev]


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    """Disjoint ``Subset``s of ``lengths`` items (or fractions of the
    dataset, the last taking the rest) over one ``random.shuffle`` of the
    indices. ``generator`` is accepted and unused, as in the reference."""
    n = len(dataset)
    if sum(lengths) != n:
        if all(0 < frac < 1 for frac in lengths):
            lengths = [int(frac * n) for frac in lengths]
            lengths[-1] = n - sum(lengths[:-1])
        else:
            raise ValueError("sum of lengths != dataset size")
    idx = list(range(n))
    random.shuffle(idx)
    out, off = [], 0
    for length in lengths:
        out.append(Subset(dataset, idx[off:off + length]))
        off += length
    return out


RandomSplit = random_split
