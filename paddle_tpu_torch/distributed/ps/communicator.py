"""The asynchronous communicator — the port of
``paddle_tpu/distributed/ps/communicator.py``: background gradient
sends with merging, and a receive thread that keeps dense parameters
fresh.

Reference analog: paddle/fluid/distributed/ps/service/communicator/
communicator.h:1 (AsyncCommunicator: per-var send queues, MergeVars batching
k grads into one RPC, an independent send thread, RecvThread pulling fresh
params) and communicator.cc (geo mode delta queues).

The train loop never blocks on the PS: `push_dense` / `push_sparse`
enqueue host arrays and return; the send thread merges queued grads per
var (dense: sum; sparse: sum-by-id) and issues one RPC per var per flush.
Transient connection failures retry with backoff instead of killing the
trainer, as in the reference.

The refresh is where the port differs. The reference's receive thread
rebinds each registered parameter's array (an atomic swap of an
immutable JAX array). A torch parameter is mutable and the trainer
thread's operations run with the interpreter lock released, so swapping
its storage from another thread could free memory an operation is
reading. So the receive thread pulls every `pull_interval` seconds and,
holding the communicator's lock, copies the values onto the parameter's
device into a fresh tensor that it stages; the trainer thread's
`refresh()` (``ThePS.step`` calls it after each step's pushes), holding
the same lock, rebinds each staged parameter's data to its fresh tensor
on the same ``Parameter`` object. Nothing is ever copied into a tensor
autograd may have saved, and a step's forward and backward see one
version of the weights.
"""
from __future__ import annotations

import queue
import threading
import time

import numpy as np
import torch


class AsyncCommunicator:
    """reference communicator.h AsyncCommunicator::Start/Stop/Send."""

    def __init__(self, client, send_interval=0.005, max_merge=8,
                 pull_interval=0.05, retry=3, retry_backoff=0.2):
        self._client = client
        self._send_interval = float(send_interval)
        self._max_merge = int(max_merge)
        self._pull_interval = float(pull_interval)
        self._retry = int(retry)
        self._backoff = float(retry_backoff)
        self._q: queue.Queue = queue.Queue()
        self._dense_params: list = []  # (name, param) refreshed by recv thread
        self._fresh: dict = {}  # name -> (param, fresh tensor) staged
        self._fresh_lock = threading.Lock()
        self._running = False
        self._send_thread = None
        self._recv_thread = None
        self._idle = threading.Event()
        self._idle.set()
        self.sent_batches = 0
        self.merged_grads = 0
        self.dropped_batches = 0
        self.last_error: BaseException | None = None
        self.refreshes = 0  # parameters rebound by refresh()

    # ------------------------------------------------------------ lifecycle
    def start(self):
        if self._running:
            return self
        self._running = True
        self._send_thread = threading.Thread(target=self._send_loop,
                                             daemon=True)
        self._send_thread.start()
        if self._dense_params:
            self._recv_thread = threading.Thread(target=self._recv_loop,
                                                 daemon=True)
            self._recv_thread.start()
        return self

    def stop(self):
        if not self._running:
            return
        try:
            self.flush()
        finally:  # threads must be torn down even if flush times out
            self._running = False
            if self._send_thread:
                self._send_thread.join(timeout=5)
            if self._recv_thread:
                self._recv_thread.join(timeout=5)

    def flush(self, timeout=30.0):
        """Block until every queued grad has been sent or dropped (reference
        Communicator barrier on the send queue). `_idle` is cleared by the
        send thread BEFORE it drains, so an in-flight RPC whose items left
        the queue still holds flush here."""
        deadline = time.monotonic() + timeout
        while (not self._q.empty() or not self._idle.is_set()) \
                and time.monotonic() < deadline:
            time.sleep(0.002)
        if not self._q.empty() or not self._idle.is_set():
            raise TimeoutError("communicator flush timed out")
        if self.last_error is not None:
            err, self.last_error = self.last_error, None  # report once
            dropped, self.dropped_batches = self.dropped_batches, 0
            raise RuntimeError(
                f"communicator dropped {dropped} batch(es); "
                f"last error: {err!r}")

    def register_dense(self, name, param):
        """Dense params the recv thread keeps fresh."""
        self._dense_params.append((name, param))

    # ------------------------------------------------------------ producers
    def push_dense(self, name, grad):
        self._q.put(("dense", name, np.asarray(grad, np.float32)))

    def push_sparse(self, name, ids, grads):
        self._q.put(("sparse", name,
                     (np.asarray(ids, np.int64),
                      np.asarray(grads, np.float32))))

    # ------------------------------------------------------------ threads
    def _drain(self):
        """Pull everything queued (bounded), merged per (kind, name)."""
        dense: dict[str, np.ndarray] = {}
        sparse: dict[str, list] = {}
        n = 0
        while n < self._max_merge * 16:
            try:
                kind, name, payload = self._q.get_nowait()
            except queue.Empty:
                break
            n += 1
            if kind == "dense":
                # MergeVars: k queued grads collapse into one sum
                dense[name] = payload if name not in dense \
                    else dense[name] + payload
            else:
                sparse.setdefault(name, []).append(payload)
        return dense, sparse, n

    def _with_retry(self, fn, *args):
        last = None
        for attempt in range(self._retry):
            try:
                return fn(*args)
            except (ConnectionError, OSError, RuntimeError) as e:
                last = e
                time.sleep(self._backoff * (2 ** attempt))
        raise last

    def _send_loop(self):
        while self._running or not self._q.empty():
            # clear idle BEFORE draining: flush() must keep waiting while an
            # RPC for already-dequeued items is in flight
            self._idle.clear()
            dense, sparse, n = self._drain()
            if not n:
                self._idle.set()
                time.sleep(self._send_interval)
                continue
            try:
                for name, g in dense.items():
                    self._with_retry(self._client.push_dense, name, g, True)
                for name, payloads in sparse.items():
                    ids = np.concatenate([p[0] for p in payloads])
                    grads = np.concatenate([p[1] for p in payloads])
                    if len(payloads) > 1:
                        # merge duplicate ids into one row-grad before the RPC
                        uids, inv = np.unique(ids, return_inverse=True)
                        merged = np.zeros((uids.size, grads.shape[1]),
                                          np.float32)
                        np.add.at(merged, inv, grads)
                        ids, grads = uids, merged
                    self._with_retry(self._client.push_sparse, name, ids,
                                     grads)
                self.sent_batches += 1
                self.merged_grads += n
            except Exception as e:  # noqa: BLE001 — retries exhausted: the
                # send thread must SURVIVE (drop this batch, record, keep
                # serving the queue) — a dead sender turns every later push
                # into silent unbounded queue growth
                import sys

                self.dropped_batches += 1
                self.last_error = e
                print(f"[paddle_tpu_torch] AsyncCommunicator dropped a gradient "
                      f"batch after {self._retry} retries: {e!r}",
                      file=sys.stderr, flush=True)
            finally:
                self._idle.set()

    def _recv_loop(self):
        while self._running:
            time.sleep(self._pull_interval)
            for name, p in self._dense_params:
                try:
                    vals = self._with_retry(self._client.pull_dense, name)
                except Exception:  # noqa: BLE001 — keep trainer alive
                    continue
                with self._fresh_lock:  # the copy onto the card inside it
                    self._fresh[name] = (p, torch.from_numpy(
                        vals.reshape(tuple(p.shape))).to(p.device, p.dtype))

    def refresh(self) -> int:
        """Rebind every parameter the receive thread staged to its fresh
        tensor (on the trainer's thread); returns how many."""
        with self._fresh_lock:
            staged, self._fresh = self._fresh, {}
            for p, fresh in staged.values():
                p.data = fresh
        self.refreshes += len(staged)
        return len(staged)
