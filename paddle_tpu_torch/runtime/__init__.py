"""paddle_tpu_torch.runtime — the port of ``paddle_tpu/runtime``'s
rendezvous store: ``tcp_store.TCPStore`` over the native library of
``csrc/tcp_store.cc`` (:mod:`.native`, built at first use), with the
reference's pure-Python store where the build fails. The reference's
blocking queue (``runtime/blocking_queue.py``) is ROADMAP Queue 1 item
12e-2c."""
from . import native, tcp_store
from .tcp_store import TCPStore


def build_native(force=False):
    """Build (once) and load the native library; None if it fails."""
    return native.build(force=force)


__all__ = ["native", "tcp_store", "TCPStore", "build_native"]
