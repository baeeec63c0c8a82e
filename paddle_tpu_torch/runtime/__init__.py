"""paddle_tpu_torch.runtime — the port of ``paddle_tpu/runtime``: the
rendezvous store (``tcp_store.TCPStore``) and the bounded blocking queue
(``blocking_queue.BlockingQueue``), each over its native library of
``csrc/`` (:mod:`.native`, built at first use), with the reference's
pure-Python version where the build fails."""
from . import blocking_queue, native, tcp_store
from .blocking_queue import BlockingQueue
from .tcp_store import TCPStore


def build_native(force=False):
    """Build (once) and load the store's native library; None if it
    fails."""
    return native.build(force=force)


__all__ = ["blocking_queue", "native", "tcp_store", "BlockingQueue",
           "TCPStore", "build_native"]
