"""FleetExecutor — the port of
``paddle_tpu/distributed/fleet_executor/fleet_executor.py``: build the
carriers of a task graph and run it.

Each ComputeInterceptor's ``run_fn`` is a pipeline stage's forward (a
callable on tensors on its carrier's device); the executor does the
host-side orchestration around it: micro-batch flow control with
credit-based backpressure, and messages between ranks (in-process for
carriers of one process, the TCP bus across processes). ``devices``
gives each rank's carrier its device (``{rank: device}`` or one for
all): its loop thread runs there and moves incoming payloads there.
"""
from __future__ import annotations

from .carrier import Carrier, MessageBus
from .interceptor import (
    AmplifierInterceptor, ComputeInterceptor, SinkInterceptor,
    SourceInterceptor,
)
from .task_node import TaskNode


_INTERCEPTORS = {
    "Source": SourceInterceptor,
    "Compute": ComputeInterceptor,
    "Amplifier": AmplifierInterceptor,
    "Sink": SinkInterceptor,
}


class FleetExecutor:
    def __init__(self, task_nodes: list[TaskNode], rank: int = 0,
                 bus: MessageBus | None = None, local_ranks=None,
                 devices=None):
        """`task_nodes`: the FULL graph (all ranks). This process instantiates
        interceptors for nodes whose rank is in `local_ranks` (default: all —
        single-process multi-carrier, the test topology)."""
        self.bus = bus or MessageBus()
        self.nodes = {n.task_id: n for n in task_nodes}
        ranks = sorted({n.rank for n in task_nodes})
        local = set(ranks if local_ranks is None else local_ranks)
        if not isinstance(devices, dict):
            devices = {r: devices for r in ranks}
        self.carriers: dict[int, Carrier] = {
            r: Carrier(r, self.bus, device=devices.get(r))
            for r in ranks if r in local
        }
        self._sinks: list[SinkInterceptor] = []
        for n in task_nodes:
            if n.rank not in self.carriers:
                continue
            cls = _INTERCEPTORS[n.type]
            ic = cls(n)
            self.carriers[n.rank].add_interceptor(ic)
            if isinstance(ic, SinkInterceptor):
                self._sinks.append(ic)
        # every carrier must know where every task lives
        for c in self.carriers.values():
            for n in task_nodes:
                c.set_task_rank(n.task_id, n.rank)

    def run(self, timeout=120.0):
        """Fire sources, wait for all carriers; returns sink results."""
        for c in self.carriers.values():
            c.start()
        try:
            for c in self.carriers.values():
                c.wait(timeout=timeout)
        finally:
            for c in self.carriers.values():
                c.stop()
        out = [list(s.results) for s in self._sinks]
        return out[0] if len(out) == 1 else out
