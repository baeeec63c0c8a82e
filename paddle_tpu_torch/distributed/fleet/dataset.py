"""Dataset / DataFeed for massive slot-based training data — the port of
``paddle_tpu/distributed/fleet/dataset.py``, host code kept as it is
there (records, batches and ``global_shuffle``'s owners are the
reference's).

Reference analog: `paddle/fluid/framework/data_set.cc` + `data_feed.cc`
(C++ channel-based datasets feeding PS trainers) and the python façade
`python/paddle/fluid/dataset.py` (InMemoryDataset / QueueDataset with
load_into_memory, local_shuffle, global_shuffle, release_memory).

The trainer's dense math runs on the card; what this module provides is
the host-side ingest pipeline — multithreaded file readers feeding the
native blocking queue (csrc/queue.cc via runtime.blocking_queue),
slot-based line parsing, shuffling, and batching into numpy arrays ready
for `DistEmbedding`/dense feeds. A record is `(float label, {slot:
[int]}, {slot: [float]})`, its dicts in the declared slot order.

Line format (the reference's slot data feed): whitespace-separated
`label slot:feasign slot:feasign ...`; dense slots use `slot:v1,v2,...`.
"""
from __future__ import annotations

import os
import threading

import numpy as np

from ...runtime.blocking_queue import BlockingQueue


def parse_slot_line(line: str, sparse_slots, dense_slots=()):
    """One line -> (label, {slot: [ids]}, {slot: [floats]})."""
    parts = line.strip().split()
    if not parts:
        return None
    label = float(parts[0])
    sparse = {s: [] for s in sparse_slots}
    dense = {s: [] for s in dense_slots}
    for tok in parts[1:]:
        if ":" not in tok:
            continue
        slot, val = tok.split(":", 1)
        if slot in sparse:
            sparse[slot].append(int(val))
        elif slot in dense:
            dense[slot].extend(float(v) for v in val.split(","))
    return label, sparse, dense


class DatasetBase:
    def __init__(self):
        self._filelist: list[str] = []
        self.batch_size = 1
        self.thread_num = 1
        self.sparse_slots: list[str] = []
        self.dense_slots: list[str] = []
        self._parse_fn = None

    # ------------------------------------------------- reference config API
    def set_filelist(self, filelist):
        self._filelist = list(filelist)

    def set_batch_size(self, batch_size):
        self.batch_size = int(batch_size)

    def set_thread(self, thread_num):
        self.thread_num = int(thread_num)

    def set_use_var(self, sparse_slots, dense_slots=()):
        """Declare the slots to extract (reference: set_use_var(var_list))."""
        self.sparse_slots = list(sparse_slots)
        self.dense_slots = list(dense_slots)

    def set_parse_ins_id(self, parse_fn):
        """Custom line parser override."""
        self._parse_fn = parse_fn

    def _parse(self, line):
        if self._parse_fn is not None:
            return self._parse_fn(line)
        return parse_slot_line(line, self.sparse_slots, self.dense_slots)

    def _batchify(self, records):
        """records: list of (label, sparse{slot:[ids]}, dense{slot:[floats]}).
        Sparse slots pad to the batch's max ids-per-instance (pad id 0)."""
        labels = np.asarray([r[0] for r in records], np.float32)
        out = {"label": labels}
        for s in self.sparse_slots:
            rows = [r[1][s] for r in records]
            width = max(1, max((len(r) for r in rows), default=1))
            arr = np.zeros((len(rows), width), np.int64)
            for i, r in enumerate(rows):
                arr[i, :len(r)] = r
            out[s] = arr
        for s in self.dense_slots:
            out[s] = np.asarray([r[2][s] for r in records], np.float32)
        return out


class InMemoryDataset(DatasetBase):
    """reference: fluid/dataset.py InMemoryDataset — load, shuffle, iterate."""

    def __init__(self):
        super().__init__()
        self._records = []
        self._rng = np.random.RandomState(0)

    def load_into_memory(self):
        self._records = []
        for path in self._filelist:
            with open(path) as f:
                for line in f:
                    rec = self._parse(line)
                    if rec is not None:
                        self._records.append(rec)
        return len(self._records)

    def get_memory_data_size(self):
        return len(self._records)

    def local_shuffle(self):
        self._rng.shuffle(self._records)

    def global_shuffle(self, fleet=None, thread_num=None):
        """Exchange records across workers by hash (reference: data_set.cc
        GlobalShuffle — records are re-sent to their hash-owner worker via the
        PS service). Single-host (no PS client): equals local_shuffle."""
        import pickle
        import zlib

        from ..ps import runtime as ps_runtime

        client = getattr(self, "_ps_client", None) or ps_runtime._client
        if client is None:
            self.local_shuffle()
            return
        role = getattr(self, "_role", None) or ps_runtime._get_role()
        n, me = role.worker_num(), role.worker_index()
        # partition deterministically by record content hash
        parts: list[list] = [[] for _ in range(n)]
        for rec in self._records:
            owner = zlib.crc32(repr(rec).encode()) % n
            parts[owner].append(rec)
        # ship each partition to its owner's mailbox on server 0
        for w in range(n):
            if parts[w]:
                client.put_blob(f"gshuffle/{w}", pickle.dumps(parts[w], 4))
        client.barrier()  # all puts visible before any take
        blobs = client.take_blobs(f"gshuffle/{me}")
        self._records = [r for b in blobs for r in pickle.loads(b)]
        self.local_shuffle()
        client.barrier()  # takes complete before the next phase reuses keys

    def release_memory(self):
        self._records = []

    def __iter__(self):
        for i in range(0, len(self._records), self.batch_size):
            chunk = self._records[i:i + self.batch_size]
            if chunk:
                yield self._batchify(chunk)


class QueueDataset(DatasetBase):
    """reference: fluid/dataset.py QueueDataset — streaming reader threads
    feed a bounded channel; the trainer drains batches without materializing
    the dataset (the data_feed.cc channel pattern, native queue underneath)."""

    def __init__(self, capacity=64):
        super().__init__()
        self.capacity = capacity

    def __iter__(self):
        q = BlockingQueue(self.capacity)
        n_readers = max(1, min(self.thread_num, len(self._filelist) or 1))
        files = list(self._filelist)
        lock = threading.Lock()
        done = [0]
        _SENTINEL = ("__done__",)

        errors = []

        def reader():
            try:
                while True:
                    with lock:
                        if not files:
                            break
                        path = files.pop()
                    buf = []
                    with open(path) as f:
                        for line in f:
                            rec = self._parse(line)
                            if rec is None:
                                continue
                            buf.append(rec)
                            if len(buf) >= self.batch_size:
                                q.put(self._batchify(buf))
                                buf = []
                    if buf:
                        q.put(self._batchify(buf))
            except Exception as e:  # surface reader failures to the consumer
                with lock:
                    errors.append(e)
            finally:
                # always count down so the consumer can't hang on a dead reader
                with lock:
                    done[0] += 1
                    if done[0] == n_readers:
                        q.put(_SENTINEL)

        threads = [threading.Thread(target=reader, daemon=True)
                   for _ in range(n_readers)]
        for t in threads:
            t.start()
        while True:
            item = q.get()
            if isinstance(item, tuple) and item == _SENTINEL:
                break
            yield item
        for t in threads:
            t.join(timeout=5)
        if errors:
            raise errors[0]
