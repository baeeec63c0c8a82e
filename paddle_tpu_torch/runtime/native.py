"""The native runtime library — the port of ``paddle_tpu/runtime/native.py``
for what the port uses of it: the TCP store of ``csrc/tcp_store.cc``,
built with ``g++`` at first use into ``build/paddle_tpu_torch/``
(``tcp_store-<hash of source and flags>.so``, reused while the source is
unchanged) and loaded with ctypes, as the profiler builds
``csrc/host_tracer.cc``. Nothing is built at import.

``build()`` returns the library, or None when ``g++`` or the load fails;
then ``error`` holds the reason and the store falls back to its
pure-Python implementation, as the reference does. ``native`` says
whether the library is in use.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

__all__ = ["build", "lib", "native", "error", "SOURCE"]

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "tcp_store.cc"
_GXX_FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17", "-pthread")

lib = None
#: whether the native library is loaded
native = False
#: why the native build or load failed (None: it did not fail)
error = None


def _compile():
    from ..kernels._build import BUILD_DIR

    src = SOURCE.read_bytes()
    digest = hashlib.sha256(src + " ".join(_GXX_FLAGS).encode()).hexdigest()
    out = BUILD_DIR / f"tcp_store-{digest[:16]}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.run(["g++", *_GXX_FLAGS, "-o", str(tmp),
                               str(SOURCE)], capture_output=True, text=True,
                              timeout=120)
        if proc.returncode:
            raise OSError(f"g++ failed: {proc.stderr.strip()[-500:]}")
        os.replace(tmp, out)
    return ctypes.CDLL(str(out))


def _declare(l):
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


def build(force: bool = False):
    """The loaded library (built once a process), or None with ``error``
    set. ``force`` retries after a failure."""
    global lib, native, error
    if lib is not None or (error is not None and not force):
        return lib
    try:
        l = _compile()
        _declare(l)
    except (OSError, AttributeError, subprocess.SubprocessError) as e:
        error = f"{type(e).__name__}: {e}"
        return None
    lib, native, error = l, True, None
    return lib
