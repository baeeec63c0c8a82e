"""``DataLoader`` — the port of ``paddle_tpu/io/dataloader.py``
(``DataLoader``, ``default_collate_fn``, ``WorkerInfo``,
``get_worker_info``), with its single, threaded and multiprocess paths.

- single (``num_workers=0``): the batches fetched and collated in the
  caller's thread;
- threaded (``use_shared_memory=False``): worker threads fetch and collate
  into a bounded queue (capacity ``num_workers * prefetch_factor``, the
  port's copy of the reference's ``runtime.blocking_queue`` semantics on
  ``queue.Queue``), with a reorder buffer so batches come out in order;
- multiprocess (``num_workers > 0``, the default): forked workers fetch
  and collate to numpy and hand each batch back through one POSIX
  shared-memory segment, ``(name, offsets, dtypes)`` over a small result
  queue, with the reference's bounded prefetch window, reorder buffer,
  dead-worker and timeout errors, and every segment unlinked on exit.

**Workers never touch CUDA.** By the time a training loop builds its
loader the parent holds a CUDA context, which a forked child must not
use. Workers stay numpy-only, as the reference's never touch jax, and a
dataset that holds CUDA tensors raises in the parent before any fork
(:func:`_check_fork_safe`). The consumer turns each batch into the port's
``Tensor``\\ s on the loader's device: ``places`` if given, else
``set_device``'s choice, else the card (CPU tensors when the caller asked
for the CPU), copied with ``non_blocking=True`` so a batch's copy is no
host synchronisation the card counts. The same numpy seed gives the
reference's batches in the reference's order.
"""
from __future__ import annotations

import multiprocessing as _mp
import queue as _pyqueue
import threading
import time
import traceback
from multiprocessing import shared_memory as _shm

import numpy as np
import torch

from ..core.tensor import Tensor, _device_of
from .dataset import IterableDataset
from .sampler import BatchSampler

__all__ = ["DataLoader", "default_collate_fn", "WorkerInfo",
           "get_worker_info"]


def _collate_with(batch, leaf):
    """One collation recursion; ``leaf`` wraps the stacked numpy result
    (a device tensor for the consumer-side default, identity for
    workers)."""
    sample = batch[0]
    if isinstance(sample, (list, tuple)):
        return [_collate_with([b[i] for b in batch], leaf)
                for i in range(len(sample))]
    if isinstance(sample, dict):
        return {k: _collate_with([b[k] for b in batch], leaf) for k in sample}
    if isinstance(sample, torch.Tensor):
        return leaf(np.stack([_host(b) for b in batch]))
    if isinstance(sample, np.ndarray):
        return leaf(np.stack(batch))
    if isinstance(sample, (int, float, np.number)):
        return leaf(np.asarray(batch))
    return batch


def _host(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def _on(device):
    """The leaf of a consumer-side collation: a numpy array as a port
    ``Tensor`` on ``device``."""
    def leaf(a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        if device.type != "cpu":
            t = t.to(device, non_blocking=True)
        return t.as_subclass(Tensor)

    return leaf


def default_collate_fn(batch):
    """Stack a list of samples field by field into port ``Tensor``\\ s on
    the current place (``set_device``'s, else the card)."""
    return _collate_with(batch, _on(_device_of(None)))


def _to_tensor_tree(obj, device):
    if isinstance(obj, (list, tuple)):
        return [_to_tensor_tree(v, device) for v in obj]
    if isinstance(obj, dict):
        return {k: _to_tensor_tree(v, device) for k, v in obj.items()}
    if isinstance(obj, np.ndarray):
        return _on(device)(obj)
    return obj


def _cuda_tensors(obj, depth=0) -> bool:
    """Whether ``obj`` holds a CUDA tensor: itself, its items, or the
    attributes of a dataset object (two levels deep)."""
    if isinstance(obj, torch.Tensor):
        return obj.is_cuda
    if depth > 2:
        return False
    if isinstance(obj, dict):
        return any(_cuda_tensors(v, depth + 1) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return any(_cuda_tensors(v, depth + 1) for v in obj[:64])
    if hasattr(obj, "__dict__") and not isinstance(obj, type):
        return any(_cuda_tensors(v, depth + 1) for v in vars(obj).values())
    return False


def _check_fork_safe(dataset) -> None:
    """Raise before forking when the dataset's state holds CUDA tensors:
    a forked child must never touch CUDA. (A sample that a child would
    make on the card fails in that child, which sends the error back.)"""
    if _cuda_tensors(dataset):
        raise RuntimeError(
            "DataLoader(num_workers > 0) forks worker processes, and this "
            "dataset holds CUDA tensors, which a forked child must never "
            "touch (the parent's CUDA context is not usable there). Keep "
            "the dataset's data in numpy arrays or CPU tensors, or pass "
            "num_workers=0 or use_shared_memory=False (threads)")


class _BoundedQueue:
    """The reference's ``runtime.blocking_queue.BlockingQueue`` semantics
    on ``queue.Queue``: ``put`` blocks while full until ``close``;
    ``get`` blocks until an item arrives and raises ``queue.Empty`` once
    closed and drained."""

    def __init__(self, capacity: int):
        self._q: _pyqueue.Queue = _pyqueue.Queue(maxsize=capacity)
        self._closed = threading.Event()

    def put(self, item) -> bool:
        while not self._closed.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except _pyqueue.Full:
                continue
        return False

    def get(self, timeout=None):
        while True:
            try:
                return self._q.get(timeout=timeout if timeout else 0.1)
            except _pyqueue.Empty:
                if self._closed.is_set() or timeout:
                    raise

    def close(self) -> None:
        self._closed.set()


class DataLoader:
    def __init__(self, dataset, feed_list=None, places=None, return_list=True,
                 batch_sampler=None, batch_size=1, shuffle=False,
                 drop_last=False, collate_fn=None, num_workers=0,
                 use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False):
        self.dataset = dataset
        self.return_list = return_list
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.prefetch_factor = max(2, prefetch_factor)
        self.use_shared_memory = use_shared_memory
        self.worker_init_fn = worker_init_fn
        self.timeout = timeout
        if isinstance(places, (list, tuple)):
            places = places[0] if places else None
        #: where the batches land
        self.device = _device_of(places)
        self._iterable_mode = isinstance(dataset, IterableDataset)
        if self._iterable_mode:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            self.batch_sampler = BatchSampler(
                dataset=dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last)

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("length of IterableDataset loader is unknown")
        return len(self.batch_sampler)

    def __call__(self):
        return self.__iter__()

    def __iter__(self):
        if self._iterable_mode:
            return self._iter_iterable()
        if self.num_workers == 0:
            return self._iter_single()
        if self.use_shared_memory:
            return self._iter_multiprocess()
        return self._iter_threaded()

    def _collate(self, batch):
        if self.collate_fn is default_collate_fn:
            return _collate_with(batch, _on(self.device))
        return self.collate_fn(batch)

    def _fetch(self, indices):
        return self._collate([self.dataset[i] for i in indices])

    def _iter_single(self):
        for indices in self.batch_sampler:
            yield self._fetch(indices)

    def _iter_iterable(self):
        batch = []
        for item in self.dataset:
            batch.append(item)
            if len(batch) == self.batch_size:
                yield self._collate(batch)
                batch = []
        if batch and not self.drop_last:
            yield self._collate(batch)

    # ------------------------------------------------------- threaded path
    def _iter_threaded(self):
        out_q = _BoundedQueue(self.num_workers * self.prefetch_factor)
        idx_q: _pyqueue.Queue = _pyqueue.Queue()
        batches = list(self.batch_sampler)
        n_batches = len(batches)
        for i, b in enumerate(batches):
            idx_q.put((i, b))
        for _ in range(self.num_workers):
            idx_q.put(None)
        reorder: dict[int, object] = {}
        stop = threading.Event()

        def worker(wid):
            _worker_tls.info = WorkerInfo(wid, self.num_workers, wid,
                                          self.dataset)
            while not stop.is_set():
                task = idx_q.get()
                if task is None:
                    break
                i, indices = task
                try:
                    out_q.put((i, self._fetch(indices)))
                except Exception as e:  # noqa: BLE001 — the consumer raises
                    out_q.put((i, e))

        threads = [threading.Thread(target=worker, args=(w,), daemon=True)
                   for w in range(self.num_workers)]
        for t in threads:
            t.start()
        user_timeout = self.timeout if self.timeout and self.timeout > 0 \
            else None
        try:
            next_idx = 0
            while next_idx < n_batches:
                while next_idx in reorder:
                    item = reorder.pop(next_idx)
                    if isinstance(item, Exception):
                        raise item
                    yield item
                    next_idx += 1
                if next_idx >= n_batches:
                    break
                try:
                    i, data = out_q.get(timeout=user_timeout)
                except _pyqueue.Empty:
                    raise RuntimeError(f"DataLoader worker(s) timed out "
                                       f"after {user_timeout}s") from None
                if i == next_idx:
                    if isinstance(data, Exception):
                        raise data
                    yield data
                    next_idx += 1
                else:
                    reorder[i] = data
        finally:
            stop.set()
            out_q.close()

    # ----------------------------------------------------- multiprocess path
    def _iter_multiprocess(self):
        """Fork worker processes; batches come back through shared memory
        (the reference's ``_iter_multiprocess``)."""
        batches = list(self.batch_sampler)
        _check_fork_safe(self.dataset)
        ctx = _mp.get_context("fork")
        idx_q = ctx.Queue()
        res_q = ctx.Queue()
        n_batches = len(batches)
        # bounded prefetch: only num_workers * prefetch_factor index tuples
        # are outstanding, so at most that many segments exist at once
        window = self.num_workers * self.prefetch_factor
        feed_iter = iter(enumerate(batches))

        def feed_one():
            task = next(feed_iter, None)
            if task is None:
                idx_q.put(None)
            else:
                idx_q.put((task[0], list(task[1])))

        for _ in range(min(window, n_batches) + (0 if n_batches else 1)):
            feed_one()
        collate = (None if self.collate_fn is default_collate_fn
                   else self.collate_fn)
        procs = [ctx.Process(target=_mp_worker_loop,
                             args=(self.dataset, collate, idx_q, res_q,
                                   self.worker_init_fn, wid,
                                   self.num_workers),
                             daemon=True)
                 for wid in range(self.num_workers)]
        for p in procs:
            p.start()
        user_timeout = self.timeout if self.timeout and self.timeout > 0 \
            else None
        reorder: dict[int, object] = {}
        last_progress = time.time()
        try:
            next_idx = 0
            while next_idx < n_batches:
                while next_idx in reorder:
                    item = reorder.pop(next_idx)
                    feed_one()
                    yield item
                    next_idx += 1
                if next_idx >= n_batches:
                    break
                try:
                    # poll: keep waiting while workers are alive (the
                    # reference blocks unless the user set a timeout)
                    i, shm_name, payload = res_q.get(
                        timeout=user_timeout if user_timeout else 5.0)
                except _pyqueue.Empty:
                    if user_timeout:
                        raise RuntimeError(
                            f"DataLoader worker(s) timed out after "
                            f"{user_timeout}s") from None
                    # exitcode 0 = a clean exit at the epoch's end
                    dead = [p.pid for p in procs
                            if p.exitcode not in (None, 0)]
                    alive = any(p.is_alive() for p in procs)
                    stalled = time.time() - last_progress > 30
                    if not alive and (dead or stalled):
                        raise RuntimeError(
                            f"all DataLoader workers exited (dead: {dead}) "
                            f"without producing batch {next_idx}") from None
                    if dead and stalled:
                        # a dead worker may have taken this batch's indices
                        raise RuntimeError(
                            f"DataLoader stalled >30s waiting for batch "
                            f"{next_idx} with dead worker(s) {dead}") from None
                    continue
                last_progress = time.time()
                if shm_name is None:  # worker exception: the traceback
                    raise RuntimeError(f"DataLoader worker failed:\n{payload}")
                data = _read_shm_batch(shm_name, payload, self.device)
                if i == next_idx:
                    feed_one()
                    yield data
                    next_idx += 1
                else:
                    reorder[i] = data
        finally:
            for p in procs:
                p.terminate()
            for p in procs:
                p.join(timeout=5)
            # drain pending results and unlink their segments: workers
            # create them untracked, so nothing else would reclaim them
            while True:
                try:
                    _, shm_name, _ = res_q.get_nowait()
                except (_pyqueue.Empty, OSError, ValueError):
                    break
                if shm_name is not None:
                    try:
                        seg = _shm.SharedMemory(name=shm_name)
                        seg.close()
                        seg.unlink()
                    except FileNotFoundError:
                        pass
            idx_q.close()
            res_q.close()


# ------------------------------------------------- multiprocess worker helpers
def _shm_untracked(*args, **kwargs):
    """A SharedMemory segment opened WITHOUT resource-tracker registration:
    the parent unlinks every segment after reading it, and registering
    both ends with the shared tracker races its cache (Python 3.12's
    counterpart of 3.13's ``track=False``)."""
    from multiprocessing import resource_tracker

    orig = resource_tracker.register
    resource_tracker.register = lambda *a, **k: None
    try:
        return _shm.SharedMemory(*args, **kwargs)
    finally:
        resource_tracker.register = orig


def _np_collate(batch):
    """Collate to numpy only: workers never make a tensor."""
    return _collate_with(batch, lambda a: a)


def _tree_flatten_np(obj, flat):
    """Nested list/dict of arrays -> (structure with leaf indices, flat
    list)."""
    if isinstance(obj, (list, tuple)):
        return [_tree_flatten_np(v, flat) for v in obj]
    if isinstance(obj, dict):
        return {k: _tree_flatten_np(v, flat) for k, v in obj.items()}
    if isinstance(obj, torch.Tensor):
        flat.append(_host(obj))
        return ("__leaf__", len(flat) - 1)
    if isinstance(obj, np.ndarray):
        flat.append(obj)
        return ("__leaf__", len(flat) - 1)
    return ("__const__", obj)


def _tree_unflatten(struct, leaves):
    if isinstance(struct, list):
        return [_tree_unflatten(v, leaves) for v in struct]
    if isinstance(struct, dict):
        return {k: _tree_unflatten(v, leaves) for k, v in struct.items()}
    if isinstance(struct, tuple) and len(struct) == 2 \
            and struct[0] == "__leaf__":
        return leaves[struct[1]]
    if isinstance(struct, tuple) and len(struct) == 2 \
            and struct[0] == "__const__":
        return struct[1]
    return struct


class WorkerInfo:
    """Per-worker metadata visible inside dataset code."""

    def __init__(self, id, num_workers, seed, dataset):  # noqa: A002
        self.id = id
        self.num_workers = num_workers
        self.seed = seed
        self.dataset = dataset

    def __repr__(self):
        return (f"WorkerInfo(id={self.id}, num_workers={self.num_workers}, "
                f"seed={self.seed})")


_worker_info: WorkerInfo | None = None  # process-wide (fork workers)
_worker_tls = threading.local()  # per-thread (threaded workers)


def get_worker_info():
    """Inside a DataLoader worker: that worker's WorkerInfo; None in the
    main process."""
    return getattr(_worker_tls, "info", None) or _worker_info


def _mp_worker_loop(dataset, collate, idx_q, res_q, init_fn, wid,
                    num_workers=0):
    global _worker_info
    _worker_info = WorkerInfo(wid, num_workers, wid, dataset)
    if init_fn is not None:
        init_fn(wid)
    while True:
        task = idx_q.get()
        if task is None:
            break
        i, indices = task
        try:
            batch = [dataset[j] for j in indices]
            data = collate(batch) if collate is not None \
                else _np_collate(batch)
            flat: list = []
            struct = _tree_flatten_np(data, flat)
            total = sum(a.nbytes for a in flat)
            shm = _shm_untracked(create=True, size=max(total, 1))
            metas = []
            off = 0
            for a in flat:
                a = np.ascontiguousarray(a)
                view = np.ndarray(a.shape, a.dtype, buffer=shm.buf,
                                  offset=off)
                view[...] = a
                metas.append((tuple(a.shape), a.dtype.str, off))
                off += a.nbytes
            res_q.put((i, shm.name, (struct, metas)))
            shm.close()  # the parent owns unlink
        except Exception:  # noqa: BLE001 — the full traceback to the parent
            res_q.put((i, None, traceback.format_exc()))


def _read_shm_batch(shm_name, payload, device):
    struct, metas = payload
    # tracked attach: unlink() below sends the matching unregister
    shm = _shm.SharedMemory(name=shm_name)
    try:
        leaves = []
        for shape, dtype, off in metas:
            view = np.ndarray(shape, np.dtype(dtype), buffer=shm.buf,
                              offset=off)
            leaves.append(np.array(view))  # copy out before unlink
    finally:
        shm.close()
        try:
            shm.unlink()
        except FileNotFoundError:
            pass
    return _to_tensor_tree(_tree_unflatten(struct, leaves), device)
