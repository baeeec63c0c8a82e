"""Rendezvous master over the native TCPStore — the port of
``paddle_tpu/distributed/launch/master.py``, a copy over the port's
``runtime.TCPStore`` (reference:
python/paddle/distributed/launch/controllers/master.py — HTTPStore/ETCD masters).

One KV master per job: node 0 hosts the store server; every node registers a
peer record under the current *generation*, rank 0 publishes a consistent world
cut, and everyone reads it back. Heartbeats (timestamped keys) provide liveness
for elastic; a `/restart/{gen}` flag coordinates job-wide re-rendezvous.

Protocol (generation g):
  1. each node: set /peer/{g}/{rank} = {ip, endpoints}
  2. rank 0: wait until >= np_min registrations, grace-sleep, scan ranks,
     publish /world/{g} = [ranks]          (a consistent membership cut)
  3. all: wait /world/{g}; nodes not in the cut hold for /world/{g+1}
  4. any node that wants a job-wide relaunch sets /restart/{g}; every launcher
     polls it and moves to generation g+1.
"""
from __future__ import annotations

import json
import threading
import time

from ...runtime.tcp_store import TCPStore


class KVMaster:
    def __init__(self, endpoint: str, rank_hint: int, job_id: str = "default",
                 timeout: float = 120.0):
        host, _, port = endpoint.partition(":")
        self.endpoint = endpoint
        self.job_id = job_id
        self.timeout = timeout
        # Node 0 hosts the server; others connect as clients. rank_hint<0 means
        # "unknown" — try to bind; the loser of the bind race is a client.
        is_master = rank_hint == 0
        if rank_hint < 0:
            try:
                self.store = TCPStore(host, int(port), is_master=True, timeout=timeout)
                is_master = True
            except OSError:
                self.store = TCPStore(host, int(port), is_master=False, timeout=timeout)
        else:
            self.store = TCPStore(host, int(port), is_master=is_master, timeout=timeout)
        self.is_master = is_master
        self._hb_stop = threading.Event()
        self._hb_thread = None

    def _k(self, *parts) -> str:
        return "/".join(("", self.job_id) + tuple(str(p) for p in parts))

    # ---------------------------------------------------------------- peers
    def assign_rank(self) -> int:
        """One-time node-rank assignment (stable across generations)."""
        return self.store.add(self._k("noderank"), 1) - 1

    def num_known_nodes(self) -> int:
        return self.store.add(self._k("noderank"), 0)

    def register(self, generation: int, rank: int, record: dict):
        self.store.set(self._k("peer", generation, rank), json.dumps(record))

    def _registered(self, generation: int, np_max: int = 0):
        """Scan for peers registered in this generation (non-blocking). Scan
        range covers both counter-assigned and explicitly `--rank`ed nodes."""
        ranks = []
        for r in range(max(self.num_known_nodes(), np_max)):
            try:
                self.store.get(self._k("peer", generation, r))
                ranks.append(r)
            except KeyError:
                pass
        return ranks

    def publish_world(self, generation: int, np_min: int, np_max: int = 0,
                      grace: float = 1.0):
        """Rank 0: wait for quorum, take a consistent membership cut."""
        np_max = max(np_min, np_max)
        deadline = time.time() + self.timeout
        while len(self._registered(generation, np_max)) < np_min:
            if time.time() > deadline:
                raise TimeoutError(
                    f"rendezvous gen {generation}: quorum {np_min} not reached")
            time.sleep(0.1)
        time.sleep(grace)  # let stragglers of this generation in
        ranks = self._registered(generation, np_max)
        self.store.set(self._k("world", generation), json.dumps(ranks))
        return ranks

    def wait_world(self, generation: int):
        """Block for the published membership cut; return (ranks, records)."""
        key = self._k("world", generation)
        self.store.wait(key)
        ranks = json.loads(self.store.get(key))
        recs = {r: json.loads(self.store.get(self._k("peer", generation, r)))
                for r in ranks}
        return ranks, recs

    # -------------------------------------------------------------- restart
    def signal_restart(self, generation: int):
        self.store.set(self._k("restart", generation), "1")

    def restart_signaled(self, generation: int) -> bool:
        try:
            self.store.get(self._k("restart", generation))
            return True
        except KeyError:
            return False

    # ------------------------------------------------------------- heartbeat
    def start_heartbeat(self, rank: int, interval: float = 2.0):
        if self._hb_thread is not None and self._hb_thread.is_alive():
            return
        # Per-start Event (a revived heartbeat must not share the stopped
        # thread's flag) and a dedicated store connection (no lock contention
        # with the launcher loop's ops).
        stop = threading.Event()
        conn = self.store.clone()
        key = self._k("hb", rank)

        def beat():
            while not stop.is_set():
                try:
                    conn.set(key, str(time.time()))
                except (OSError, ConnectionError):
                    pass  # transient store outage; retry next tick
                stop.wait(interval)

        self._hb_stop = stop
        self._hb_thread = threading.Thread(target=beat, daemon=True)
        self._hb_thread.start()

    def stop_heartbeat(self):
        self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=5)
        self._hb_thread = None

    def alive_peers(self, nnodes_max: int = None, stale_after: float = 10.0):
        now = time.time()
        alive = []
        n = self.num_known_nodes() if nnodes_max is None else max(
            nnodes_max, self.num_known_nodes())
        for r in range(n):
            try:
                ts = float(self.store.get(self._k("hb", r)))
            except (KeyError, ValueError):
                continue
            if now - ts < stale_after:
                alive.append(r)
        return alive
