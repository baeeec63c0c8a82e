"""Length bucketing and padding — the port of
``paddle_tpu/io/bucketing.py`` (``bucket_boundaries``, ``pad_to_bucket``,
``LengthBucketSampler``, ``pad_sequence_batch``), host numpy as there.

The reference bucketed for XLA, where every new sequence length is a new
compilation. On the card a new length costs no compilation, but a padded
ladder still bounds the distinct shapes a kernel plan or a CUDA graph sees
and keeps each batch's padding under the gap between two boundaries.
'pow2' gives 16, 32, 64, ... (log #shapes); 'linear' min_len, +step, ...
(tighter padding, more shapes). ``shuffle`` draws from numpy's global
generator, so one ``np.random.seed`` gives both packages the same batches.
"""
from __future__ import annotations

import numpy as np

from .sampler import BatchSampler

__all__ = ["bucket_boundaries", "pad_to_bucket", "LengthBucketSampler",
           "pad_sequence_batch"]


def bucket_boundaries(max_len: int, scheme: str = "pow2", min_len: int = 16,
                      step: int = 64):
    """The padded-length ladder. 'pow2': 16, 32, 64, ... (log #shapes);
    'linear': min_len, +step, ... (tighter padding, more shapes)."""
    bounds = []
    if scheme == "pow2":
        b = max(1, min_len)
        while b < max_len:
            bounds.append(b)
            b *= 2
    elif scheme == "linear":
        b = min_len
        while b < max_len:
            bounds.append(b)
            b += step
    else:
        raise ValueError(f"unknown bucketing scheme {scheme!r}")
    bounds.append(max_len)
    return bounds


def pad_to_bucket(seq, boundaries, pad_value=0, axis=0):
    """Pad one array's `axis` up to the smallest boundary >= its length.
    Returns (padded, original_length)."""
    arr = np.asarray(seq)
    n = arr.shape[axis]
    target = next((b for b in boundaries if b >= n), None)
    if target is None:
        raise ValueError(f"sequence length {n} exceeds the largest bucket "
                         f"boundary {boundaries[-1]}")
    if target == n:
        return arr, n
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, target - n)
    return np.pad(arr, widths, constant_values=pad_value), n


def pad_sequence_batch(seqs, boundaries=None, pad_value=0):
    """Pad a list of 1-D+ sequences to ONE bucket boundary (the smallest that
    fits the longest member). Returns (batch [n, T, ...], lengths [n])."""
    seqs = [np.asarray(s) for s in seqs]
    longest = max(s.shape[0] for s in seqs)
    if boundaries is None:
        boundaries = [longest]
    target = next((b for b in boundaries if b >= longest), None)
    if target is None:
        raise ValueError(f"length {longest} exceeds bucket ladder {boundaries}")
    out = np.full((len(seqs), target) + seqs[0].shape[1:], pad_value,
                  dtype=seqs[0].dtype)
    lengths = np.zeros(len(seqs), np.int64)
    for i, s in enumerate(seqs):
        out[i, : s.shape[0]] = s
        lengths[i] = s.shape[0]
    return out, lengths


class LengthBucketSampler(BatchSampler):
    """Batch sampler that groups samples of similar length so each batch pads
    to one bucket boundary — the compiled-shape count is bounded by the ladder
    size (reference analog: the batch-by-LoD readers; rationale above).

    length_fn(dataset, idx) -> int; shuffle shuffles within buckets and batch
    order (deterministic under numpy seed).
    """

    def __init__(self, dataset, length_fn, boundaries, batch_size=1,
                 shuffle=False, drop_last=False):
        self.dataset = dataset
        self.boundaries = list(boundaries)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._buckets: dict[int, list[int]] = {b: [] for b in self.boundaries}
        for i in range(len(dataset)):
            n = int(length_fn(dataset, i))
            target = next((b for b in self.boundaries if b >= n), None)
            if target is None:
                raise ValueError(
                    f"sample {i} length {n} exceeds ladder {self.boundaries}")
            self._buckets[target].append(i)

    def __iter__(self):
        batches = []
        for b, idxs in self._buckets.items():
            idxs = list(idxs)
            if self.shuffle:
                np.random.shuffle(idxs)
            for k in range(0, len(idxs), self.batch_size):
                chunk = idxs[k : k + self.batch_size]
                if len(chunk) < self.batch_size and self.drop_last:
                    continue
                batches.append(chunk)
        if self.shuffle:
            np.random.shuffle(batches)
        return iter(batches)

    def __len__(self):
        n = 0
        for idxs in self._buckets.values():
            if self.drop_last:
                n += len(idxs) // self.batch_size
            else:
                n += (len(idxs) + self.batch_size - 1) // self.batch_size
        return n

    def bucket_of(self, idx_batch):
        """The padded length this batch should use (all members share it)."""
        for b, idxs in self._buckets.items():
            if idx_batch and idx_batch[0] in idxs:
                return b
        raise KeyError(idx_batch)
