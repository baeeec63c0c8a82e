"""Elastic training — the port of ``paddle_tpu/distributed/fleet/elastic.py``
(``ElasticManager``, ``ElasticStatus``, ``ELASTIC_EXIT_CODE``), a copy:
it is host code over the launcher's store.

The registry is the launcher's KV master (``launch.master.KVMaster`` over
``runtime.TCPStore``): each node heartbeats a timestamped key, and
``watch()`` classifies the alive set against the ``[np_min, np_max]``
elastic range. A scale unit is a whole node; a restart re-rendezvouses
its trainers, whose process group is made anew.
"""
from __future__ import annotations

import time

ELASTIC_EXIT_CODE = 101  # manager.py:37
ELASTIC_TIMEOUT = 30  # manager.py:41


class ElasticStatus:
    COMPLETED = "completed"
    ERROR = "error"
    HOLD = "hold"  # alive < np_min: wait for peers (within timeout)
    RESTART = "restart"  # peer set changed but still viable: relaunch
    EXIT = "exit"  # unrecoverable


class ElasticManager:
    def __init__(self, master, node_rank: int, np_min: int, np_max: int,
                 timeout: float = ELASTIC_TIMEOUT, stale_after: float = 10.0):
        self.master = master
        self.node_rank = node_rank
        self.np_min = np_min
        self.np_max = np_max
        self.timeout = timeout
        self.stale_after = stale_after
        self._last_alive = None
        self._hold_since = None
        self.enabled = np_max > np_min

    def register(self, interval: float = 2.0):
        self.master.start_heartbeat(self.node_rank, interval=interval)

    def exit(self):
        self.master.stop_heartbeat()

    # ------------------------------------------------------------------ watch
    def alive(self):
        return self.master.alive_peers(self.np_max, stale_after=self.stale_after)

    def watch(self) -> str:
        """One poll of the peer set → ElasticStatus. The launcher loop calls this
        alongside pod.poll(); RESTART means kill + re-rendezvous (ranks are
        reassigned stably by previous rank order, reference manager.py
        _match/_update_hosts)."""
        alive = self.alive()
        n = len(alive)
        if self._last_alive is None:
            self._last_alive = alive
        if n < self.np_min:
            if self._hold_since is None:
                self._hold_since = time.time()
            if time.time() - self._hold_since > self.timeout:
                return ElasticStatus.EXIT
            return ElasticStatus.HOLD
        self._hold_since = None
        if set(alive) != set(self._last_alive):
            self._last_alive = alive
            return ElasticStatus.RESTART
        return ElasticStatus.COMPLETED

    # ----------------------------------------------------- fault tolerance
    def match(self, alive=None) -> bool:
        """True when the current alive set can run the job (reference
        manager.py:98 test_match_faulttolerance)."""
        alive = self.alive() if alive is None else alive
        return self.np_min <= len(alive) <= self.np_max
