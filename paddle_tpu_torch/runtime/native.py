"""The native runtime libraries — the port of
``paddle_tpu/runtime/native.py``. Each C++ source of ``csrc/`` the port
uses is its own library, built with ``g++`` at first use into
``build/paddle_tpu_torch/<name>-<hash of source and flags>.so`` (reused
while the source is unchanged) and loaded with ctypes, as the profiler
builds ``csrc/host_tracer.cc``. Nothing is built at import.

- ``tcp_store`` (``csrc/tcp_store.cc``): the rendezvous store. The
  module-level ``build()``, ``lib``, ``native`` and ``error`` are its.
- ``PS_TABLE`` (``csrc/ps_table.cc``): the parameter server's dense and
  sparse tables (``ps_*``).
- ``QUEUE`` (``csrc/queue.cc``): the blocking queue's ring of tickets
  (``ptq_queue_*``).

A :class:`Library`'s ``build()`` returns the loaded library, or None
when ``g++`` or the load fails; then ``error`` holds the reason and its
users fall back to their pure-Python versions, as the reference's do.
``native`` says whether the library is in use.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

__all__ = ["Library", "PS_TABLE", "QUEUE", "build", "lib", "native",
           "error", "SOURCE"]

_CSRC = Path(__file__).resolve().parents[2] / "csrc"
SOURCE = _CSRC / "tcp_store.cc"
_GXX_FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17", "-pthread")


def _declare_store(l):
    vp, ci, cl, cp = (ctypes.c_void_p, ctypes.c_int, ctypes.c_long,
                      ctypes.c_char_p)
    l.ptq_store_server_new.restype = vp
    l.ptq_store_server_new.argtypes = [ci]
    l.ptq_store_server_free.argtypes = [vp]
    l.ptq_store_client_new.restype = vp
    l.ptq_store_client_new.argtypes = [cp, ci]
    l.ptq_store_client_free.argtypes = [vp]
    l.ptq_store_set.restype = ci
    l.ptq_store_set.argtypes = [vp, cp, cp, ci]
    l.ptq_store_get.restype = ci
    l.ptq_store_get.argtypes = [vp, cp, cp, ci, ci]
    l.ptq_store_add.restype = cl
    l.ptq_store_add.argtypes = [vp, cp, cl]
    l.ptq_store_wait.restype = ci
    l.ptq_store_wait.argtypes = [vp, cp, ci]


def _declare_queue(l):
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    l.ptq_queue_new.restype = vp
    l.ptq_queue_new.argtypes = [ci]
    l.ptq_queue_put.restype = ci
    l.ptq_queue_put.argtypes = [vp, cl, ci]
    l.ptq_queue_get.restype = cl
    l.ptq_queue_get.argtypes = [vp, ci]
    l.ptq_queue_size.restype = ci
    l.ptq_queue_size.argtypes = [vp]
    l.ptq_queue_close.argtypes = [vp]
    l.ptq_queue_free.argtypes = [vp]


def _declare_ps(l):
    vp, ci, i64, u64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                        ctypes.c_uint64)
    cf, cd = ctypes.c_float, ctypes.c_double
    f32p = ctypes.POINTER(ctypes.c_float)
    i64p = ctypes.POINTER(ctypes.c_int64)
    l.ps_dense_new.restype = vp
    l.ps_dense_new.argtypes = [i64]
    l.ps_dense_free.argtypes = [vp]
    l.ps_dense_assign.argtypes = [vp, f32p, i64]
    l.ps_dense_read.argtypes = [vp, f32p, i64]
    l.ps_dense_push_grad.argtypes = [vp, f32p, i64]
    l.ps_dense_apply.restype = cd
    l.ps_dense_apply.argtypes = [vp, ci, cf, cf]
    l.ps_dense_read_acc.argtypes = [vp, f32p, i64]
    l.ps_dense_assign_acc.argtypes = [vp, f32p, i64]
    l.ps_sparse_new.restype = vp
    l.ps_sparse_new.argtypes = [ci, u64, cf]
    l.ps_sparse_free.argtypes = [vp]
    l.ps_sparse_size.restype = i64
    l.ps_sparse_size.argtypes = [vp]
    l.ps_sparse_pull.argtypes = [vp, i64p, i64, f32p]
    l.ps_sparse_assign.argtypes = [vp, i64p, i64, f32p]
    l.ps_sparse_assign_state.argtypes = [vp, i64p, i64, f32p, f32p]
    l.ps_sparse_export_state.restype = i64
    l.ps_sparse_export_state.argtypes = [vp, i64p, f32p, f32p, i64]
    l.ps_sparse_push_grad.argtypes = [vp, i64p, i64, f32p, ci, cf, cf]
    l.ps_sparse_export.restype = i64
    l.ps_sparse_export.argtypes = [vp, i64p, f32p, i64]
    l.ps_sparse_erase.restype = i64
    l.ps_sparse_erase.argtypes = [vp, i64p, i64]


class Library:
    """One source of ``csrc/`` as a ctypes library: ``build()`` compiles
    it once a process (thread-safe; processes that build together each
    write their own temporary file and rename it into place)."""

    def __init__(self, name: str, declare):
        self.name = name
        self.source = _CSRC / f"{name}.cc"
        self._declare = declare
        self._lock = threading.Lock()
        self.lib = None
        #: whether the native library is loaded
        self.native = False
        #: why the native build or load failed (None: it did not fail)
        self.error = None

    def path(self) -> Path:
        from ..kernels._build import BUILD_DIR

        digest = hashlib.sha256(self.source.read_bytes() + " ".join(
            _GXX_FLAGS).encode()).hexdigest()
        return BUILD_DIR / f"{self.name}-{digest[:16]}.so"

    def _compile(self):
        out = self.path()
        if not out.exists():
            out.parent.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            proc = subprocess.run(["g++", *_GXX_FLAGS, "-o", str(tmp),
                                   str(self.source)], capture_output=True,
                                  text=True, timeout=120)
            if proc.returncode:
                raise OSError(f"g++ failed: {proc.stderr.strip()[-500:]}")
            os.replace(tmp, out)
        return ctypes.CDLL(str(out))

    def build(self, force: bool = False):
        """The loaded library, or None with ``error`` set. ``force``
        retries after a failure."""
        with self._lock:
            if self.lib is not None or (self.error is not None
                                        and not force):
                return self.lib
            try:
                l = self._compile()
                self._declare(l)
            except (OSError, AttributeError,
                    subprocess.SubprocessError) as e:
                self.error = f"{type(e).__name__}: {e}"
                return None
            self.lib, self.native, self.error = l, True, None
            return self.lib


_STORE = Library("tcp_store", _declare_store)
PS_TABLE = Library("ps_table", _declare_ps)
QUEUE = Library("queue", _declare_queue)

lib = None
#: whether the store's native library is loaded
native = False
#: why the store's native build or load failed (None: it did not fail)
error = None


def build(force: bool = False):
    """The store's library (built once a process), or None with
    ``error`` set. ``force`` retries after a failure."""
    global lib, native, error
    out = _STORE.build(force)
    lib, native, error = _STORE.lib, _STORE.native, _STORE.error
    return out
