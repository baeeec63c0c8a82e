"""Carrier + MessageBus — the port of
``paddle_tpu/distributed/fleet_executor/carrier.py``.

A carrier owns its rank's interceptors and pumps their mailbox on one
loop thread; the bus routes a message by task id, in process to a local
carrier, else over a length-prefixed pickle socket (``serve`` binds
``PADDLE_PS_BIND_HOST``, all interfaces by default). Two things are the
port's own:

- a payload crosses the wire as host tensors (a CUDA tensor is copied to
  the host before pickling) and the receiving carrier moves it to its
  own device;
- a carrier's loop thread sets its CUDA device before it runs anything:
  the current device is per thread, so a stage on card 1 would
  otherwise launch on card 0. Grad mode is per thread too: the loop runs
  under the mode of the thread that started the carrier (``run`` under
  ``torch.no_grad()`` runs its stages without a graph).
"""
from __future__ import annotations

import os
import pickle
import socket
import socketserver
import struct
import threading

import torch
from torch.utils._pytree import tree_map

from .interceptor import Message


def _to_host(msg: Message) -> Message:
    """``msg`` with its payload's CUDA tensors copied to the host."""
    payload = tree_map(lambda t: t.detach().cpu() if isinstance(
        t, torch.Tensor) and t.device.type != "cpu" else t, msg.payload)
    return Message(msg.type, msg.src_id, msg.dst_id, payload, msg.scope_idx)


def _to_device(payload, device):
    return tree_map(lambda t: t.to(device, non_blocking=True) if isinstance(
        t, torch.Tensor) and t.device != device else t, payload)


class MessageBus:
    """Routes messages to local carriers by rank, or over TCP to remote ones."""

    def __init__(self):
        self._local: dict[int, "Carrier"] = {}
        self._remote: dict[int, str] = {}  # rank -> host:port
        self._socks: dict[int, socket.socket] = {}
        self._lock = threading.Lock()

    def register_carrier(self, carrier: "Carrier"):
        self._local[carrier.rank] = carrier

    def register_remote(self, rank: int, endpoint: str):
        self._remote[rank] = endpoint

    def route_to_rank(self, rank: int, msg: Message):
        if rank in self._local:
            self._local[rank].deliver(msg)
            return
        ep = self._remote[rank]
        with self._lock:
            s = self._socks.get(rank)
            if s is None:
                host, port = ep.rsplit(":", 1)
                s = socket.create_connection((host, int(port)), timeout=30)
                self._socks[rank] = s
            data = pickle.dumps(_to_host(msg), protocol=4)
            s.sendall(struct.pack("<I", len(data)) + data)

    def serve(self, port=0):
        """Accept remote messages for this process's carriers."""
        bus = self

        class H(socketserver.BaseRequestHandler):
            def handle(self):
                try:
                    while True:
                        hdr = b""
                        while len(hdr) < 4:
                            c = self.request.recv(4 - len(hdr))
                            if not c:
                                return
                            hdr += c
                        (n,) = struct.unpack("<I", hdr)
                        buf = b""
                        while len(buf) < n:
                            c = self.request.recv(n - len(buf))
                            if not c:
                                return
                            buf += c
                        msg = pickle.loads(buf)
                        for carrier in bus._local.values():
                            if msg.dst_id in carrier._interceptors:
                                carrier.deliver(msg)
                                break
                except OSError:
                    return

        class S(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        # pickle wire format with no auth: a trusted network is assumed.
        # Default stays all-interfaces so remote carriers that
        # registered a real NIC endpoint can connect; PADDLE_PS_BIND_HOST
        # narrows the bind on deployments that want loopback-only.
        host = os.environ.get("PADDLE_PS_BIND_HOST", "0.0.0.0")
        srv = S((host, port), H)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        return srv, srv.server_address[1]

    def close(self):
        for s in self._socks.values():
            try:
                s.close()
            except OSError:
                pass


class Carrier:
    """Owns a rank's interceptors and drives their ``handle`` on one
    thread; ``device``: where its stages run (None: as given)."""

    def __init__(self, rank: int, bus: MessageBus, device=None):
        self.rank = rank
        self.bus = bus
        self.device = None if device is None else torch.device(device)
        self._interceptors: dict[int, object] = {}
        self._task_ranks: dict[int, int] = {}
        self._mailbox: list[Message] = []
        self._cv = threading.Condition()
        self._done: set[int] = set()
        self._stop = False
        self._thread = None
        bus.register_carrier(self)

    def add_interceptor(self, interceptor):
        interceptor.carrier = self
        self._interceptors[interceptor.task_id] = interceptor
        self._task_ranks[interceptor.task_id] = self.rank
        return interceptor

    def set_task_rank(self, task_id: int, rank: int):
        """Record that `task_id` lives on another rank's carrier."""
        self._task_ranks[task_id] = rank

    # ---------------------------------------------------------- routing
    def route(self, msg: Message):
        rank = self._task_ranks.get(msg.dst_id, self.rank)
        if rank == self.rank and msg.dst_id in self._interceptors:
            self.deliver(msg)
        else:
            self.bus.route_to_rank(rank, msg)

    def deliver(self, msg: Message):
        with self._cv:
            self._mailbox.append(msg)
            self._cv.notify()

    def on_interceptor_done(self, task_id: int):
        with self._cv:
            self._done.add(task_id)
            self._cv.notify()

    # ---------------------------------------------------------- loop
    def start(self):
        self._grad = torch.is_grad_enabled()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        # kick sources via their mailbox so ALL interceptor execution happens
        # on the single carrier loop thread (no concurrent handle/_emit races)
        for ic in self._interceptors.values():
            if hasattr(ic, "start"):
                self.deliver(Message("START", dst_id=ic.task_id))
        return self

    def _loop(self):
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        torch.set_grad_enabled(self._grad)
        while True:
            with self._cv:
                while not self._mailbox and not self._stop:
                    self._cv.wait(timeout=0.1)
                if self._stop:
                    return
                msg = self._mailbox.pop(0)
            ic = self._interceptors.get(msg.dst_id)
            if ic is not None:
                if self.device is not None and msg.payload is not None:
                    msg.payload = _to_device(msg.payload, self.device)
                ic.handle(msg)

    def wait(self, timeout=60.0):
        """Block until every local interceptor reports done."""
        import time

        deadline = time.time() + timeout
        with self._cv:
            while set(self._interceptors) - self._done:
                remaining = deadline - time.time()
                if remaining <= 0:
                    missing = set(self._interceptors) - self._done
                    raise TimeoutError(
                        f"carrier rank {self.rank}: interceptors {missing} "
                        "did not finish")
                self._cv.wait(timeout=min(0.1, remaining))

    def stop(self):
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        if self._thread:
            self._thread.join(timeout=5)
