"""Interceptors — the port of
``paddle_tpu/distributed/fleet_executor/interceptor.py``: ``Message`` and
the Compute, Amplifier, Source and Sink actors with the reference's
credit protocol. DATA_IS_READY flows downstream with its payload,
DATA_IS_USELESS flows upstream to return the buffer credit; an
interceptor runs when every upstream has data ready and every downstream
has a free credit. A payload is whatever a ``run_fn`` returns (tensors on
the carrier's device, typically).
"""
from __future__ import annotations

import dataclasses
import typing


@dataclasses.dataclass
class Message:
    """reference: interceptor_message.proto (DATA_IS_READY / DATA_IS_USELESS /
    START / STOP)."""

    type: str          # DATA_IS_READY | DATA_IS_USELESS | START | STOP
    src_id: int = -1
    dst_id: int = -1
    payload: typing.Any = None
    scope_idx: int = 0  # micro-batch index


class Interceptor:
    def __init__(self, node):
        self.node = node
        self.carrier = None  # set on registration

    @property
    def task_id(self):
        return self.node.task_id

    def send(self, dst_id: int, msg: Message):
        msg.src_id = self.task_id
        msg.dst_id = dst_id
        self.carrier.route(msg)

    def handle(self, msg: Message):  # pragma: no cover - abstract
        raise NotImplementedError


class ComputeInterceptor(Interceptor):
    """reference: compute_interceptor.cc — ready-count/credit bookkeeping."""

    def __init__(self, node):
        super().__init__(node)
        self.pending: dict[int, list] = {u: [] for u in node.upstreams}
        self.credits: dict[int, int] = dict(node.downstreams)
        self.run_count = 0

    def handle(self, msg: Message):
        if msg.type == "DATA_IS_READY":
            self.pending[msg.src_id].append(msg.payload)
        elif msg.type == "DATA_IS_USELESS":
            self.credits[msg.src_id] += 1
        elif msg.type == "STOP":
            return
        self._run_when_ready()

    def _can_run(self):
        if self.run_count >= self.node.max_run_times:
            return False
        ups_ready = all(len(q) > 0 for q in self.pending.values())
        down_free = all(c > 0 for c in self.credits.values())
        return ups_ready and down_free

    def _run_when_ready(self):
        while self._can_run():
            inputs = [q.pop(0) for q in self.pending.values()]
            out = (self.node.run_fn(*inputs) if self.node.run_fn is not None
                   else (inputs[0] if inputs else None))
            scope = self.run_count
            self.run_count += 1
            # return credits upstream, ship payload downstream
            for u in self.node.upstreams:
                self.send(u, Message("DATA_IS_USELESS", scope_idx=scope))
            for d in self.credits:
                self.credits[d] -= 1
                self.send(d, Message("DATA_IS_READY", payload=out,
                                     scope_idx=scope))
            if self.run_count >= self.node.max_run_times:
                self.carrier.on_interceptor_done(self.task_id)


class AmplifierInterceptor(ComputeInterceptor):
    """reference: amplifier_interceptor.cc — `run_per_steps` re-runs each
    upstream payload N times (fan-out), `send_down_per_steps` emits downstream
    only every M runs (fan-in / gradient accumulation). Knobs come from the
    TaskNode (reference: task_node.h)."""

    def __init__(self, node, run_per_steps=None, send_down_per_steps=None):
        super().__init__(node)
        self.run_per_steps = (run_per_steps if run_per_steps is not None
                              else getattr(node, "run_per_steps", 1))
        self.send_down_per_steps = (
            send_down_per_steps if send_down_per_steps is not None
            else getattr(node, "send_down_per_steps", 1))
        self._replay = 0       # runs consumed from the current payload
        self._current = None   # payload being replayed

    def _can_run(self):
        if self.run_count >= self.node.max_run_times:
            return False
        have_input = (self._replay > 0
                      or all(len(q) > 0 for q in self.pending.values()))
        down_free = all(c > 0 for c in self.credits.values())
        return have_input and down_free

    def _run_when_ready(self):
        while self._can_run():
            if self._replay == 0:
                self._current = [q.pop(0) for q in self.pending.values()]
                self._replay = self.run_per_steps
                # credit returns as soon as the payload is captured
                for u in self.node.upstreams:
                    self.send(u, Message("DATA_IS_USELESS",
                                         scope_idx=self.run_count))
            self._replay -= 1
            inputs = self._current or []
            out = (self.node.run_fn(*inputs) if self.node.run_fn is not None
                   else (inputs[0] if inputs else None))
            scope = self.run_count
            self.run_count += 1
            if self.run_count % self.send_down_per_steps == 0:
                for d in self.credits:
                    self.credits[d] -= 1
                    self.send(d, Message("DATA_IS_READY", payload=out,
                                         scope_idx=scope))
            if self.run_count >= self.node.max_run_times:
                self.carrier.on_interceptor_done(self.task_id)


class SourceInterceptor(Interceptor):
    """reference: source_interceptor.cc — emits max_run_times micro-batches,
    honoring downstream credits."""

    def __init__(self, node, feed_fn=None):
        super().__init__(node)
        self.feed_fn = feed_fn or node.run_fn
        self.credits: dict[int, int] = dict(node.downstreams)
        self.emitted = 0

    def handle(self, msg: Message):
        if msg.type == "DATA_IS_USELESS":
            self.credits[msg.src_id] += 1
        elif msg.type == "STOP":
            return
        self._emit()

    def start(self):
        """Marker for the carrier: kicked via a START mailbox message (handled
        on the loop thread) rather than called directly."""

    def _emit(self):
        while (self.emitted < self.node.max_run_times
               and all(c > 0 for c in self.credits.values())):
            payload = self.feed_fn(self.emitted) if self.feed_fn else self.emitted
            scope = self.emitted
            self.emitted += 1
            for d in self.credits:
                self.credits[d] -= 1
                self.send(d, Message("DATA_IS_READY", payload=payload,
                                     scope_idx=scope))
        if self.emitted >= self.node.max_run_times:
            self.carrier.on_interceptor_done(self.task_id)


class SinkInterceptor(Interceptor):
    """reference: sink_interceptor.cc — absorbs results, returns credits."""

    def __init__(self, node):
        super().__init__(node)
        self.results = []

    def handle(self, msg: Message):
        if msg.type != "DATA_IS_READY":
            return
        self.results.append(msg.payload)
        self.send(msg.src_id, Message("DATA_IS_USELESS",
                                      scope_idx=msg.scope_idx))
        if len(self.results) >= self.node.max_run_times:
            self.carrier.on_interceptor_done(self.task_id)
