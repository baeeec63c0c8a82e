"""A bounded blocking queue — the port of
``paddle_tpu/runtime/blocking_queue.py``.

Python objects cannot cross a C++ queue unserialised, so the native ring
of ``csrc/queue.cc`` (:data:`.native.QUEUE`, built at first use) holds
opaque tickets while the payloads wait in a Python slab, as in the
reference. Where the native build fails the queue is a ``queue.Queue``;
``native`` says which one an instance uses.
"""
from __future__ import annotations

import queue as _pyqueue
import threading

__all__ = ["BlockingQueue"]


class BlockingQueue:
    def __init__(self, capacity: int = 8):
        from .native import QUEUE

        lib = QUEUE.build()
        self._native = _NativeQueue(lib, capacity) if lib is not None \
            else None
        self._q: _pyqueue.Queue = _pyqueue.Queue(maxsize=capacity)
        self._closed = threading.Event()

    @property
    def native(self) -> bool:
        return self._native is not None

    def put(self, item, timeout=None):
        if self._native is not None:
            return self._native.put(item, timeout)
        while not self._closed.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except _pyqueue.Full:
                continue
        return False

    def get(self, timeout=None):
        if self._native is not None:
            return self._native.get(timeout)
        while True:
            try:
                return self._q.get(timeout=timeout if timeout else None)
            except _pyqueue.Empty:
                if self._closed.is_set():
                    raise
                continue

    def close(self):
        if self._native is not None:
            self._native.close()
        self._closed.set()

    def qsize(self):
        if self._native is not None:
            return self._native.size()
        return self._q.qsize()


class _NativeQueue:
    """The C++ SPMC ring of tickets; the payloads in a Python slab."""

    def __init__(self, lib, capacity):
        self._lib = lib
        self._h = lib.ptq_queue_new(capacity)
        self._slab: dict[int, object] = {}
        self._slab_lock = threading.Lock()
        self._ticket = 0

    def put(self, item, timeout=None):
        with self._slab_lock:
            t = self._ticket
            self._ticket += 1
            self._slab[t] = item
        ok = self._lib.ptq_queue_put(self._h, t, int((timeout or -1) * 1000))
        if not ok:
            with self._slab_lock:
                self._slab.pop(t, None)
        return bool(ok)

    def get(self, timeout=None):
        t = self._lib.ptq_queue_get(self._h, int((timeout or -1) * 1000))
        if t < 0:
            raise _pyqueue.Empty
        with self._slab_lock:
            return self._slab.pop(t)

    def size(self):
        return self._lib.ptq_queue_size(self._h)

    def close(self):
        self._lib.ptq_queue_close(self._h)
