"""Pod/Container process model — the port of
``paddle_tpu/distributed/launch/pod.py``, a copy (reference:
python/paddle/distributed/launch/job/{pod,container}.py).

A Pod is the set of trainer processes on one node; each Container wraps one
subprocess with injected env and a per-rank logfile `workerlog.N`.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time


class Container:
    def __init__(self, entrypoint, env, log_path):
        self.entrypoint = entrypoint
        self.env = env
        self.log_path = log_path
        self.proc = None
        self._log_fd = None

    def start(self):
        os.makedirs(os.path.dirname(self.log_path) or ".", exist_ok=True)
        self._log_fd = open(self.log_path, "ab")
        full_env = dict(os.environ)
        full_env.update({k: str(v) for k, v in self.env.items()})
        self.proc = subprocess.Popen(
            self.entrypoint, env=full_env, stdout=self._log_fd, stderr=subprocess.STDOUT
        )

    @property
    def exit_code(self):
        return None if self.proc is None else self.proc.poll()

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def terminate(self, force=False):
        if self.proc is None:
            return
        if self.proc.poll() is None:
            self.proc.kill() if force else self.proc.terminate()
        if self._log_fd:
            self._log_fd.close()
            self._log_fd = None


class Pod:
    def __init__(self):
        self.containers: list[Container] = []
        self.restart_count = 0

    def add(self, container: Container):
        self.containers.append(container)

    def deploy(self):
        for c in self.containers:
            c.start()

    def poll(self):
        """Return ('running'|'done'|'failed', first bad exit code or 0)."""
        codes = [c.exit_code for c in self.containers]
        if any(c is not None and c != 0 for c in codes):
            return "failed", next(c for c in codes if c not in (None, 0))
        if all(c == 0 for c in codes):
            return "done", 0
        return "running", 0

    def join(self, timeout=None):
        deadline = None if timeout is None else time.time() + timeout
        while True:
            status, code = self.poll()
            if status != "running":
                return status, code
            if deadline and time.time() > deadline:
                return "running", 0
            time.sleep(0.2)

    def stop(self, force=False):
        for c in self.containers:
            c.terminate(force=force)
        for c in self.containers:
            if c.proc is not None:
                try:
                    c.proc.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    c.terminate(force=True)
        self.containers = []


def script_entrypoint(script: str, script_args) -> list:
    if script.endswith(".py"):
        return [sys.executable, "-u", script] + list(script_args)
    return [script] + list(script_args)
