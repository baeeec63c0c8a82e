"""The rendezvous store — the port of ``paddle_tpu/runtime/tcp_store.py``
(``TCPStore``, the reference's ``paddle.distributed.TCPStore``): a
key-value server on one host and a client on each, with ``set``,
``get``, ``add``, ``wait`` and ``discard``.

It uses the native store of ``csrc/tcp_store.cc`` (built with ``g++`` by
:mod:`.native` at first use) and, where that build fails, the same
pure-Python socket implementation as the reference, with the same wire
protocol. ``TCPStore.native`` says which one an instance uses. This is
host code: nothing of it runs on a device."""
from __future__ import annotations

import ctypes
import socket
import struct
import threading
import time


class TCPStore:
    """Thread-safety: every op is a short request/response guarded by one lock
    (`wait` polls `get` client-side rather than blocking on the socket), so a
    single TCPStore may be shared across threads. For hot concurrent use (e.g.
    a heartbeat thread) prefer `clone()` — a second connection to the same
    server — to avoid serializing on the lock."""

    def __init__(self, host: str, port: int, world_size: int = 1,
                 is_master: bool = False, timeout: float = 30.0):
        self.host = host
        self.port = port
        self.is_master = is_master
        self.timeout = timeout
        self._server = None
        self._client = None
        self._py_server = None
        self._oplock = threading.Lock()
        from .native import build

        l = build()
        self.native = False
        if l is not None:
            if is_master:
                self._server = l.ptq_store_server_new(port)
            self._client = l.ptq_store_client_new(host.encode(), port)
            self._lib = l
            if self._client:
                self.native = True
                return
        # python fallback
        self._lib = None
        if is_master:
            self._py_server = _PyServer(port)
        self._sock = _connect(host, port, timeout)

    def clone(self) -> "TCPStore":
        """New client connection to the same server (own socket, own lock)."""
        return TCPStore(self.host, self.port, is_master=False,
                        timeout=self.timeout)

    # ------------------------------------------------------------- ops
    def set(self, key: str, value):
        data = value if isinstance(value, bytes) else str(value).encode()
        with self._oplock:
            if self._lib:
                self._lib.ptq_store_set(self._client, key.encode(), data, len(data))
                return
            _send(self._sock, b"S", key, data)
            self._sock.recv(1)

    def get(self, key: str) -> bytes:
        with self._oplock:
            if self._lib:
                buf = ctypes.create_string_buffer(1 << 20)
                n = self._lib.ptq_store_get(self._client, key.encode(), buf, len(buf), -1)
                if n > len(buf):
                    # native copies min(vlen, cap) but reports the true length —
                    # re-fetch with a right-sized buffer, never truncate silently
                    buf = ctypes.create_string_buffer(n)
                    n = self._lib.ptq_store_get(self._client, key.encode(), buf, len(buf), -1)
                if n == -1:
                    raise KeyError(key)
                if n < -1:  # native -2: broken/closed connection, not a miss
                    raise ConnectionError(
                        f"TCPStore connection to {self.host}:{self.port} lost")
                return buf.raw[:n]
            _send(self._sock, b"G", key)
            (n,) = struct.unpack("<i", _recvn(self._sock, 4))
            if n < 0:
                raise KeyError(key)
            return _recvn(self._sock, n)

    def add(self, key: str, amount: int) -> int:
        with self._oplock:
            if self._lib:
                return int(self._lib.ptq_store_add(self._client, key.encode(), amount))
            _send(self._sock, b"A", key, struct.pack("<q", amount))
            (v,) = struct.unpack("<q", _recvn(self._sock, 8))
            return v

    def discard(self, key: str):
        """Release a consumed key's payload. The wire protocol has no delete, so
        this tombstones with an empty value — the key stays present (wait() on it
        still succeeds) but its payload memory is returned."""
        self.set(key, b"")

    def wait(self, keys, timeout=None):
        """Client-side polling wait: never holds the socket/lock across a
        blocking server call, so other threads' ops interleave cleanly."""
        keys = [keys] if isinstance(keys, str) else keys
        deadline = None if timeout is None else time.time() + timeout
        for k in keys:
            while True:
                try:
                    self.get(k)
                    break
                except KeyError:
                    if deadline is not None and time.time() > deadline:
                        raise TimeoutError(f"timed out waiting for key {k!r}")
                    time.sleep(0.05)

    def __del__(self):
        try:
            if self._lib:
                if self._client:
                    self._lib.ptq_store_client_free(self._client)
                if self._server:
                    self._lib.ptq_store_server_free(self._server)
            elif self._py_server:
                self._py_server.stop()
        except Exception:
            pass


# ----------------------------------------------------------------- py fallback
def _connect(host, port, timeout):
    deadline = time.time() + timeout
    while True:
        try:
            s = socket.create_connection((host, port), timeout=2)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            return s
        except OSError:
            if time.time() > deadline:
                raise
            time.sleep(0.1)


def _send(sock, op, key, payload=b""):
    kb = key.encode()
    msg = op + struct.pack("<I", len(kb)) + kb
    if op == b"S":
        msg += struct.pack("<I", len(payload)) + payload
    elif op == b"A":
        msg += payload
    sock.sendall(msg)


def _recvn(sock, n):
    out = b""
    while len(out) < n:
        chunk = sock.recv(n - len(out))
        if not chunk:
            raise ConnectionError("store connection closed")
        out += chunk
    return out


class _PyServer:
    def __init__(self, port):
        self._kv = {}
        self._cv = threading.Condition()
        self._stop = False
        self._ls = socket.socket()
        self._ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._ls.bind(("0.0.0.0", port))
        self._ls.listen(64)
        self._t = threading.Thread(target=self._loop, daemon=True)
        self._t.start()

    def _loop(self):
        while not self._stop:
            try:
                fd, _ = self._ls.accept()
            except OSError:
                break
            threading.Thread(target=self._serve, args=(fd,), daemon=True).start()

    def _serve(self, sock):
        try:
            while True:
                op = _recvn(sock, 1)
                (klen,) = struct.unpack("<I", _recvn(sock, 4))
                key = _recvn(sock, klen).decode()
                if op == b"S":
                    (vlen,) = struct.unpack("<I", _recvn(sock, 4))
                    val = _recvn(sock, vlen)
                    with self._cv:
                        self._kv[key] = val
                        self._cv.notify_all()
                    sock.sendall(b"\x01")
                elif op == b"G":
                    with self._cv:
                        val = self._kv.get(key)
                    if val is None:
                        sock.sendall(struct.pack("<i", -1))
                    else:
                        sock.sendall(struct.pack("<i", len(val)) + val)
                elif op == b"A":
                    (delta,) = struct.unpack("<q", _recvn(sock, 8))
                    with self._cv:
                        cur = int(self._kv.get(key, b"0"))
                        nv = cur + delta
                        self._kv[key] = str(nv).encode()
                        self._cv.notify_all()
                    sock.sendall(struct.pack("<q", nv))
                elif op == b"W":
                    with self._cv:
                        while key not in self._kv and not self._stop:
                            self._cv.wait(timeout=1.0)
                    sock.sendall(b"\x01")
                else:
                    break
        except (ConnectionError, OSError):
            pass
        finally:
            sock.close()

    def stop(self):
        self._stop = True
        try:
            self._ls.close()
        except OSError:
            pass
