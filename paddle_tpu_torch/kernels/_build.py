"""Build and load the port's CUDA kernels.

Each kernel is one CUDA C++ source under ``kernels/csrc/`` with a plain C
entry point (sources may include the shared headers ``csrc/*.cuh``). ``nvcc`` compiles it for Hopper (``sm_90a``) into a shared
library under ``build/paddle_tpu_torch/`` at the repository root, named by
a hash of the source and the flags, so an edited source rebuilds and an
unchanged one is reused. The library is loaded with ``ctypes``: no
PyTorch headers are compiled, which keeps a build to seconds.

Building happens at first use (``load``) or all at once (``build``, one
``nvcc`` process per source, started together). Nothing here runs at
import time: the CPU tests import every module on a machine with no
``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["KERNELS", "BUILD_DIR", "build", "load", "build_log"]

#: every kernel source of the port (``csrc/<name>.cu``)
KERNELS = ("ragged_paged_attention", "flash_attention", "fused_adam",
           "fused_layernorm")

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "paddle_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_NVCC_TIMEOUT_S = 600

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME")
    for cand in ((os.path.join(home, "bin", "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's kernels are compiled at first use")


def _library_path(name: str) -> Path:
    """The library of kernel ``name``, named by a hash of its source, the
    shared headers of ``csrc/`` and the flags."""
    src = (_CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(_CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names=KERNELS) -> dict[str, float]:
    """Compile every named kernel whose library is missing, one ``nvcc``
    per source, all running at once. Returns the seconds each build took
    (0.0 for a library that already existed). Raises RuntimeError with
    the compiler's output when a build fails."""
    started = {}
    for name in names:
        out = _library_path(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp, out, time.perf_counter())
    seconds = {name: 0.0 for name in names}
    for name, (proc, tmp, out, t0) in started.items():
        try:
            log, _ = proc.communicate(timeout=_NVCC_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            raise
        seconds[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name} "
                               f"(exit {proc.returncode}):\n{log}")
        os.replace(tmp, out)
    return seconds


def build_log(name: str) -> str:
    """The compiler output of the current build of ``name`` (ptxas
    register and shared-memory report), or "" when it was not built here."""
    log = _library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_library_path(name)))
        _loaded[name] = lib
    return lib
