"""``spawn(fn, nprocs)`` — the port of ``paddle_tpu/distributed/spawn.py``:
run ``fn(rank, nprocs, *args)`` in ``nprocs`` fresh processes and collect
what each returns.

The processes start with the ``spawn`` method, so each imports the module
that defines ``fn`` afresh: define ``fn`` at module level in a module
whose import is cheap and safe in a child. ``fn`` joins the process group
itself (``env.init_parallel_env``), with the rendezvous the caller passes
in ``args``. The parent waits at most ``timeout_s`` for all of them: a
rank that raises fails the call with its traceback, and a rank still
running at the deadline fails it with TimeoutError; either way every
child is ended before the call returns.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import tempfile
import time
import traceback

import torch

__all__ = ["spawn", "SpawnError"]


class SpawnError(RuntimeError):
    """A spawned rank raised or exited abnormally; the message carries its
    traceback or exit code."""


def _entry(fn, rank: int, nprocs: int, args: tuple, out: str) -> None:
    try:
        result = fn(rank, nprocs, *args)
    except BaseException:  # noqa: BLE001 — reported to the parent, then fail
        torch.save({"error": traceback.format_exc()}, out)
        raise SystemExit(1)
    torch.save({"result": result}, out)


_POLL_S = 0.05  # how often the parent looks at its children


def spawn(fn, nprocs: int, args: tuple = (), timeout_s: float = 600.0) -> list:
    """Run ``fn(rank, nprocs, *args)`` for every rank in its own process;
    returns the ranks' return values in rank order (they cross the
    process boundary through ``torch.save``)."""
    if nprocs < 1:
        raise ValueError(f"nprocs {nprocs} < 1")
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="spawn-") as d:
        outs = [os.path.join(d, f"rank{r}.pt") for r in range(nprocs)]
        procs = [ctx.Process(target=_entry,
                             args=(fn, r, nprocs, tuple(args), outs[r]))
                 for r in range(nprocs)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        try:
            while any(p.is_alive() for p in procs):
                for r, p in enumerate(procs):
                    if p.exitcode not in (None, 0):
                        raise SpawnError(_failure(r, p, outs[r]))
                if time.monotonic() > deadline:
                    hung = [r for r, p in enumerate(procs) if p.is_alive()]
                    raise TimeoutError(
                        f"spawned ranks {hung} still running after "
                        f"{timeout_s} s")
                time.sleep(_POLL_S)
            for r, p in enumerate(procs):
                if p.exitcode != 0:
                    raise SpawnError(_failure(r, p, outs[r]))
            return [torch.load(o, weights_only=False)["result"]
                    for o in outs]
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()


def _failure(rank: int, proc, out: str) -> str:
    if os.path.exists(out):
        return (f"rank {rank} raised:\n"
                f"{torch.load(out, weights_only=False)['error']}")
    return f"rank {rank} exited with code {proc.exitcode}"
