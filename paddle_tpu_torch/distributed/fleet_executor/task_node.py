"""TaskNode — the port of
``paddle_tpu/distributed/fleet_executor/task_node.py``: one schedulable
unit of the dataflow graph (rank, task id, runs a step, its callable,
its interceptor type, and the buffer credits of its edges).
"""
from __future__ import annotations


class TaskNode:
    def __init__(self, task_id: int, rank: int = 0, max_run_times: int = 1,
                 run_fn=None, type: str = "Compute", run_per_steps: int = 1,
                 send_down_per_steps: int = 1):
        self.task_id = task_id
        self.rank = rank
        self.max_run_times = max_run_times  # micro-batches per step
        self.run_fn = run_fn  # callable(payload) -> payload for downstream
        self.type = type  # Source | Compute | Amplifier | Sink
        # Amplifier knobs (reference: task_node.h run_per_steps_ /
        # send_down_per_steps_): re-run each upstream payload N times
        # (fan-out), emit downstream only every M runs (fan-in / grad-accum)
        self.run_per_steps = run_per_steps
        self.send_down_per_steps = send_down_per_steps
        self.upstreams: dict[int, int] = {}    # task_id -> buffer credits
        self.downstreams: dict[int, int] = {}  # task_id -> buffer credits

    def add_upstream_task(self, task_id: int, buffer_size: int = 2):
        self.upstreams[task_id] = buffer_size

    def add_downstream_task(self, task_id: int, buffer_size: int = 2):
        self.downstreams[task_id] = buffer_size

    def __repr__(self):
        return (f"TaskNode(id={self.task_id}, rank={self.rank}, "
                f"type={self.type}, runs={self.max_run_times})")
