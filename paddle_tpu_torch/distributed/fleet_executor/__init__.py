"""FleetExecutor — the port of ``paddle_tpu/distributed/fleet_executor/``,
an actor-style dataflow runtime: a per-rank ``Carrier`` running
``Interceptor``s (compute, amplifier, source, sink) connected by a
``MessageBus`` (in process, or a pickle socket across processes),
scheduled over a ``TaskNode`` graph. A ComputeInterceptor's ``run_fn`` is
one pipeline stage's step on its carrier's device; the runtime carries
the micro-batches between stages with credit-based backpressure.
"""
from .task_node import TaskNode  # noqa: F401
from .interceptor import (  # noqa: F401
    AmplifierInterceptor, ComputeInterceptor, Interceptor, Message,
    SinkInterceptor, SourceInterceptor,
)
from .carrier import Carrier, MessageBus  # noqa: F401
from .fleet_executor import FleetExecutor  # noqa: F401
