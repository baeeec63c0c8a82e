"""The parameter server's transport — the port of
``paddle_tpu/distributed/ps/service.py``, kept as it is there so that a
port and a reference process serve each other: a threaded socket server
and a client of every server.

The wire: a 4-byte little-endian length, then a pickle (protocol 4) of a
tuple of builtins and numpy arrays (never a torch tensor). The snapshot
files of ``save_tables`` / ``load_tables`` are the reference's too.

Reference analog: paddle/fluid/distributed/ps/service/{brpc_ps_server.cc,
brpc_ps_client.cc} — brpc RPC replaced with a length-prefixed pickled-message
protocol (the table math itself is native, csrc/ps_table.cc). Sharding policy
matches the reference: dense tables live whole on one server chosen by
name-hash; sparse rows shard across ALL servers by id modulo.
"""
from __future__ import annotations

import os
import pickle
import socket
import socketserver
import struct
import threading
import zlib

import numpy as np

from .tables import _OPT, DenseTable, SparseTable


def _opt_name(code) -> str:
    """optimizer int code -> registry name (snapshot restore re-creation)."""
    for name, c in _OPT.items():
        if c == code:
            return name
    return "sgd"


def _send_msg(sock, obj):
    data = pickle.dumps(obj, protocol=4)
    sock.sendall(struct.pack("<I", len(data)) + data)


def _recv_msg(sock):
    hdr = _recvn(sock, 4)
    (n,) = struct.unpack("<I", hdr)
    return pickle.loads(_recvn(sock, n))


def _recvn(sock, n):
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return buf


class _Handler(socketserver.BaseRequestHandler):
    def handle(self):
        srv: PsServer = self.server.ps  # type: ignore[attr-defined]
        sock = self.request
        try:
            while True:
                op, *args = _recv_msg(sock)
                if op == "stop":
                    _send_msg(sock, ("ok",))
                    srv.shutdown_async()
                    return
                try:
                    out = srv.dispatch(op, args)
                    _send_msg(sock, ("ok", out))
                except Exception as e:  # report errors to the worker
                    _send_msg(sock, ("err", repr(e)))
        except (ConnectionError, OSError):
            return


class _TCPServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


class PsServer:
    """One PS shard. reference: brpc_ps_server.cc (service loop) +
    table registry keyed by table name."""

    def __init__(self, port=0, n_workers=1, host=None):
        self._dense: dict[str, DenseTable] = {}
        self._sparse: dict[str, SparseTable] = {}
        self._create_lock = threading.Lock()  # guards table creation races
        self._blobs: dict[str, list] = {}  # global-shuffle mailboxes
        self._n_workers = n_workers
        self._barrier_lock = threading.Condition()
        self._barrier_count = 0
        self._barrier_gen = 0
        # The wire format is pickle with NO auth layer (trusted-cluster
        # assumption, same as the reference's brpc PS): callers that know
        # their advertised endpoint pass its interface as `host` so the port
        # is not exposed on every NIC; PADDLE_PS_BIND_HOST overrides, and the
        # default remains all-interfaces so launcher-driven multi-host jobs
        # (controller advertises node.ip) keep working.
        host = host or os.environ.get("PADDLE_PS_BIND_HOST", "0.0.0.0")
        self._tcp = _TCPServer((host, port), _Handler)
        self._tcp.ps = self  # type: ignore[attr-defined]
        self.port = self._tcp.server_address[1]
        self._thread = None

    # ------------------------------------------------------------ lifecycle
    def start(self, block=False):
        if block:
            self._tcp.serve_forever(poll_interval=0.05)
        else:
            self._thread = threading.Thread(target=self._tcp.serve_forever,
                                            kwargs={"poll_interval": 0.05},
                                            daemon=True)
            self._thread.start()
        return self

    def shutdown_async(self):
        threading.Thread(target=self._tcp.shutdown, daemon=True).start()

    def stop(self):
        self._tcp.shutdown()
        self._tcp.server_close()

    # ------------------------------------------------------------ dispatch
    def dispatch(self, op, args):
        if op == "create_dense":
            name, size, optimizer, lr = args
            with self._create_lock:  # concurrent workers race to create
                created = name not in self._dense
                if created:
                    self._dense[name] = DenseTable(size, optimizer, lr)
            # whether THIS call created it: a (re)joining worker must only
            # write its init into a table that didn't exist — never clobber
            # live/restored state (fault-recovery contract)
            return created
        if op == "create_sparse":
            name, dim, optimizer, lr, seed = args
            with self._create_lock:
                if name not in self._sparse:
                    self._sparse[name] = SparseTable(dim, optimizer, lr,
                                                     seed=seed)
            return None
        if op == "assign_dense":
            name, values = args
            self._dense[name].assign(values)
            return None
        if op == "pull_dense":
            (name,) = args
            return self._dense[name].read()
        if op == "push_dense":
            name, grad, apply_now = args
            t = self._dense[name]
            t.push_grad(grad)
            if apply_now:
                t.apply()
            return None
        if op == "apply_dense":
            (name,) = args
            return self._dense[name].apply()
        if op == "pull_sparse":
            name, ids = args
            return self._sparse[name].pull(ids)
        if op == "push_sparse":
            name, ids, grads = args
            self._sparse[name].push_grad(ids, grads)
            return None
        if op == "sparse_size":
            (name,) = args
            return self._sparse[name].size()
        if op == "export_sparse":
            (name,) = args
            return self._sparse[name].export()
        if op == "assign_sparse":
            name, ids, values = args
            self._sparse[name].assign_rows(ids, values)
            return None
        if op == "save_tables":
            # snapshot EVERY table this shard owns to one file (reference
            # brpc_ps_server Save RPC -> table->Save(dirname)). FULL state:
            # weights AND optimizer accumulators AND init seeds, plus the
            # sharding layout so a mismatched restore fails loudly.
            path, shard_idx, n_shards = args
            snap = {
                "shard_idx": shard_idx, "n_shards": n_shards,
                "dense": {n: {"values": t.read(), "acc": t.read_acc(),
                              "optimizer": _opt_name(t.optimizer),
                              "lr": t.lr, "epsilon": t.epsilon}
                          for n, t in self._dense.items()},
                "sparse": {},
            }
            for n, t in self._sparse.items():
                ids, rows, acc = t.export_state()
                snap["sparse"][n] = {
                    "ids": ids, "rows": rows, "acc": acc, "dim": t.dim,
                    "optimizer": _opt_name(t.optimizer), "lr": t.lr,
                    "epsilon": t.epsilon, "seed": t.seed,
                    "init_range": t.init_range,
                }
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            with open(path, "wb") as f:
                pickle.dump(snap, f, protocol=4)
            return len(snap["dense"]) + len(snap["sparse"])
        if op == "load_tables":
            # restore (re-creating tables as needed): the Load RPC — a
            # RESTARTED server recovers its authoritative state from disk
            path, shard_idx, n_shards = args
            with open(path, "rb") as f:
                snap = pickle.load(f)
            if snap.get("n_shards") != n_shards or \
                    snap.get("shard_idx") != shard_idx:
                # sparse rows are partitioned id % n_shards at SAVE time; a
                # different cluster size would silently strand rows on
                # servers the client never queries
                raise ValueError(
                    f"snapshot was saved as shard {snap.get('shard_idx')} of "
                    f"{snap.get('n_shards')} but is being loaded as shard "
                    f"{shard_idx} of {n_shards}; restore onto the same "
                    "server count/order")
            with self._create_lock:
                for n, d in snap["dense"].items():
                    if n not in self._dense:
                        self._dense[n] = DenseTable(
                            d["values"].size, d["optimizer"], d["lr"],
                            epsilon=d.get("epsilon", 1e-6))
                    self._dense[n].assign(d["values"])
                    self._dense[n].assign_acc(d["acc"])
                for n, d in snap["sparse"].items():
                    if n not in self._sparse:
                        self._sparse[n] = SparseTable(
                            d["dim"], d["optimizer"], d["lr"],
                            epsilon=d.get("epsilon", 1e-6),
                            seed=d.get("seed", 0),
                            init_range=d.get("init_range", 0.05))
                    if d["ids"].size:
                        self._sparse[n].assign_state(d["ids"], d["rows"],
                                                     d["acc"])
            return len(snap["dense"]) + len(snap["sparse"])
        if op == "barrier":
            return self._barrier()
        if op == "put_blob":
            # opaque blob mailbox (dataset global_shuffle record exchange;
            # reference: data_set.cc GlobalShuffle sends records via PS RPC)
            key, blob = args
            with self._create_lock:
                self._blobs.setdefault(key, []).append(blob)
            return None
        if op == "take_blobs":
            (key,) = args
            with self._create_lock:
                return self._blobs.pop(key, [])
        raise ValueError(f"unknown PS op {op!r}")

    def _barrier(self):
        """All-worker barrier (reference: PSClient barrier via brpc)."""
        with self._barrier_lock:
            gen = self._barrier_gen
            self._barrier_count += 1
            if self._barrier_count >= self._n_workers:
                self._barrier_count = 0
                self._barrier_gen += 1
                self._barrier_lock.notify_all()
                return None
            deadline = 60.0
            import time

            end = time.monotonic() + deadline
            while gen == self._barrier_gen:
                remaining = end - time.monotonic()
                if remaining <= 0 or not self._barrier_lock.wait(timeout=remaining):
                    if gen == self._barrier_gen:
                        # withdraw our arrival so a retry can't release a
                        # barrier the missing workers never reached
                        self._barrier_count = max(0, self._barrier_count - 1)
                        raise TimeoutError("PS barrier timed out")
        return None


class PsClient:
    """Connects to every server; shards requests (reference: brpc_ps_client.cc).

    Dense table `name` lives on server hash(name) % n. Sparse table rows shard
    by id % n across all servers.
    """

    def __init__(self, endpoints: list[str], connect_timeout=120.0):
        import time

        self._eps = list(endpoints)
        self._socks = []
        self._locks = []
        for ep in self._eps:
            host, port = ep.rsplit(":", 1)
            deadline = time.time() + connect_timeout
            while True:
                try:
                    s = socket.create_connection((host, int(port)), timeout=30)
                    break
                except OSError:
                    # servers may still be starting (reference: brpc client
                    # retries until the service registers)
                    if time.time() > deadline:
                        raise
                    time.sleep(0.5)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._socks.append(s)
            self._locks.append(threading.Lock())
        self._sparse_dims: dict[str, int] = {}
        # per-server sockets are independent: fan requests out concurrently
        # (reference: brpc_ps_client issues async RPCs per shard)
        from concurrent.futures import ThreadPoolExecutor

        self._pool = (ThreadPoolExecutor(max_workers=len(self._socks))
                      if len(self._socks) > 1 else None)

    @property
    def n_servers(self):
        return len(self._socks)

    def _call(self, server_idx, *msg):
        with self._locks[server_idx]:
            _send_msg(self._socks[server_idx], msg)
            resp = _recv_msg(self._socks[server_idx])
        if resp[0] == "err":
            raise RuntimeError(f"PS server {self._eps[server_idx]}: {resp[1]}")
        return resp[1] if len(resp) > 1 else None

    def _dense_home(self, name):
        # deterministic across processes (python hash() is seed-randomized)
        return zlib.crc32(name.encode()) % self.n_servers

    def _fanout(self, calls):
        """Run [(server_idx, msg-tuple), ...] concurrently; returns results
        in input order."""
        if self._pool is None or len(calls) <= 1:
            return [self._call(i, *msg) for i, msg in calls]
        futs = [self._pool.submit(self._call, i, *msg) for i, msg in calls]
        return [f.result() for f in futs]

    # ------------------------------------------------------------ dense
    def create_dense(self, name, size, optimizer="sgd", lr=0.01,
                     init: np.ndarray | None = None):
        i = self._dense_home(name)
        created = self._call(i, "create_dense", name, int(size), optimizer,
                             float(lr))
        if init is not None and created:
            self._call(i, "assign_dense", name, np.asarray(init, np.float32))

    def pull_dense(self, name) -> np.ndarray:
        return self._call(self._dense_home(name), "pull_dense", name)

    def push_dense(self, name, grad, apply_now=True):
        self._call(self._dense_home(name), "push_dense", name,
                   np.asarray(grad, np.float32), bool(apply_now))

    # ------------------------------------------------------------ sparse
    def create_sparse(self, name, dim, optimizer="adagrad", lr=0.05, seed=0):
        self._sparse_dims[name] = int(dim)
        self._fanout([(i, ("create_sparse", name, int(dim), optimizer,
                           float(lr), int(seed) + i))
                      for i in range(self.n_servers)])

    def _shard_masks(self, ids):
        shard = ids % self.n_servers  # one pass over ids
        return [(i, m) for i in range(self.n_servers)
                for m in [shard == i] if m.any()]

    def pull_sparse(self, name, ids) -> np.ndarray:
        ids = np.ascontiguousarray(ids, np.int64).reshape(-1)
        dim = self._sparse_dims[name]
        out = np.empty((ids.size, dim), np.float32)
        pairs = self._shard_masks(ids)
        results = self._fanout([(i, ("pull_sparse", name, ids[m]))
                                for i, m in pairs])
        for (_, m), r in zip(pairs, results):
            out[m] = r
        return out

    def push_sparse(self, name, ids, grads):
        ids = np.ascontiguousarray(ids, np.int64).reshape(-1)
        g = np.ascontiguousarray(grads, np.float32).reshape(ids.size, -1)
        self._fanout([(i, ("push_sparse", name, ids[m], g[m]))
                      for i, m in self._shard_masks(ids)])

    def sparse_size(self, name) -> int:
        return sum(self._fanout([(i, ("sparse_size", name))
                                 for i in range(self.n_servers)]))

    def export_sparse(self, name):
        results = self._fanout([(i, ("export_sparse", name))
                                for i in range(self.n_servers)])
        ids = [a for a, _ in results]
        rows = [b for _, b in results]
        return np.concatenate(ids), np.concatenate(rows)

    # ------------------------------------------------------------ blobs
    def put_blob(self, key, blob, server_idx=0):
        self._call(server_idx, "put_blob", key, blob)

    def take_blobs(self, key, server_idx=0):
        return self._call(server_idx, "take_blobs", key)

    # ------------------------------------------------------------ snapshot
    def save_tables(self, dirname: str) -> int:
        """Each shard snapshots its FULL table state (weights + optimizer
        accumulators + init seeds) to dirname/shard_<i>.snap (reference
        fleet.save_persistables in PS mode)."""
        results = self._fanout([
            (i, ("save_tables", os.path.join(dirname, f"shard_{i}.snap"),
                 i, self.n_servers))
            for i in range(self.n_servers)])
        return sum(results)

    def load_tables(self, dirname: str) -> int:
        results = self._fanout([
            (i, ("load_tables", os.path.join(dirname, f"shard_{i}.snap"),
                 i, self.n_servers))
            for i in range(self.n_servers)])
        return sum(results)

    def assign_sparse(self, name, ids, values):
        ids = np.ascontiguousarray(ids, np.int64).reshape(-1)
        v = np.ascontiguousarray(values, np.float32).reshape(ids.size, -1)
        self._fanout([(i, ("assign_sparse", name, ids[m], v[m]))
                      for i, m in self._shard_masks(ids)])

    # ------------------------------------------------------------ control
    def barrier(self):
        # barrier on server 0 only (single rendezvous point)
        self._call(0, "barrier")

    def stop_servers(self):
        for i, s in enumerate(self._socks):
            try:
                with self._locks[i]:
                    _send_msg(s, ("stop",))
                    _recv_msg(s)
            except (ConnectionError, OSError):
                pass

    def close(self):
        if self._pool is not None:
            self._pool.shutdown(wait=False)
        for s in self._socks:
            try:
                s.close()
            except OSError:
                pass
