"""Filesystem abstraction for checkpoints (local + HDFS) — the port of
``paddle_tpu/distributed/fleet/fs.py``, a copy (plain Python).

Reference analog: `python/paddle/distributed/fleet/utils/fs.py:57,119,423` —
`FS` base, `LocalFS`, `HDFSClient` (hadoop CLI wrapper with
`_handle_errors` retry decorator), used by fleet save/load and
auto-checkpoint for HDFS-resident snapshots.
"""
from __future__ import annotations

import functools
import os
import shutil
import subprocess
import time


class ExecuteError(Exception):
    pass


class FSFileExistsError(Exception):
    pass


class FSFileNotExistsError(Exception):
    pass


def _handle_errors(max_time_out=None):
    """Retry decorator (reference: fs.py:37 _handle_errors) — retries
    transient failures with backoff until the timeout."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(self, *args, **kwargs):
            time_out = max_time_out or getattr(self, "_time_out", 5.0)
            start = time.time()
            last = None
            sleep = 0.1
            while True:
                try:
                    return fn(self, *args, **kwargs)
                except (FSFileExistsError, FSFileNotExistsError):
                    raise  # deterministic errors: no point retrying
                except Exception as e:
                    last = e
                    if time.time() - start > time_out:
                        raise ExecuteError(
                            f"{fn.__name__} failed after retries: {last!r}"
                        ) from last
                    time.sleep(sleep)
                    sleep = min(sleep * 2, 1.0)

        return wrapper

    return deco


class FS:
    def ls_dir(self, path):  # pragma: no cover - interface
        raise NotImplementedError

    def is_file(self, path):
        raise NotImplementedError

    def is_dir(self, path):
        raise NotImplementedError

    def is_exist(self, path):
        raise NotImplementedError

    def upload(self, local_path, fs_path):
        raise NotImplementedError

    def download(self, fs_path, local_path):
        raise NotImplementedError

    def mkdirs(self, fs_path):
        raise NotImplementedError

    def delete(self, fs_path):
        raise NotImplementedError

    def mv(self, fs_src_path, fs_dst_path, overwrite=False):
        raise NotImplementedError

    def touch(self, fs_path, exist_ok=True):
        raise NotImplementedError


class LocalFS(FS):
    """reference: fs.py:119 LocalFS."""

    def ls_dir(self, path):
        if not self.is_exist(path):
            return [], []
        dirs, files = [], []
        for e in os.listdir(path):
            (dirs if os.path.isdir(os.path.join(path, e)) else files).append(e)
        return dirs, files

    def is_file(self, path):
        return os.path.isfile(path)

    def is_dir(self, path):
        return os.path.isdir(path)

    def is_exist(self, path):
        return os.path.exists(path)

    def mkdirs(self, path):
        os.makedirs(path, exist_ok=True)

    def delete(self, path):
        if self.is_file(path):
            os.remove(path)
        elif self.is_dir(path):
            shutil.rmtree(path, ignore_errors=True)

    def mv(self, src, dst, overwrite=False):
        if not self.is_exist(src):
            raise FSFileNotExistsError(src)
        if self.is_exist(dst):
            if not overwrite:
                raise FSFileExistsError(dst)
            self.delete(dst)
        shutil.move(src, dst)

    def upload(self, local_path, fs_path):
        if os.path.isdir(local_path):
            shutil.copytree(local_path, fs_path, dirs_exist_ok=True)
        else:
            shutil.copy2(local_path, fs_path)

    def download(self, fs_path, local_path):
        self.upload(fs_path, local_path)

    def touch(self, fs_path, exist_ok=True):
        if self.is_exist(fs_path):
            if not exist_ok:
                raise FSFileExistsError(fs_path)
            return
        with open(fs_path, "a"):
            pass

    def list_dirs(self, path):
        return self.ls_dir(path)[0]


class HDFSClient(FS):
    """reference: fs.py:423 HDFSClient — wraps the `hadoop fs` CLI with
    retries. Requires a hadoop binary on PATH (config via hadoop_home)."""

    def __init__(self, hadoop_home=None, configs=None, time_out=60.0,
                 sleep_inter=1.0):
        self._time_out = time_out
        base = (os.path.join(hadoop_home, "bin", "hadoop") if hadoop_home
                else "hadoop")
        self._cmd = [base, "fs"]
        for k, v in (configs or {}).items():
            self._cmd += ["-D", f"{k}={v}"]

    def _run(self, *args) -> str:
        proc = subprocess.run([*self._cmd, *args], capture_output=True,
                              text=True, timeout=self._time_out)
        if proc.returncode != 0:
            raise ExecuteError(
                f"hadoop fs {' '.join(args)} failed: {proc.stderr.strip()}")
        return proc.stdout

    @_handle_errors()
    def ls_dir(self, path):
        out = self._run("-ls", path)
        dirs, files = [], []
        for line in out.splitlines():
            parts = line.split()
            if len(parts) < 8:
                continue
            name = os.path.basename(parts[-1])
            (dirs if parts[0].startswith("d") else files).append(name)
        return dirs, files

    @_handle_errors()
    def is_exist(self, path):
        proc = subprocess.run([*self._cmd, "-test", "-e", path],
                              capture_output=True, timeout=self._time_out)
        return proc.returncode == 0

    @_handle_errors()
    def is_dir(self, path):
        proc = subprocess.run([*self._cmd, "-test", "-d", path],
                              capture_output=True, timeout=self._time_out)
        return proc.returncode == 0

    def is_file(self, path):
        return self.is_exist(path) and not self.is_dir(path)

    @_handle_errors()
    def upload(self, local_path, fs_path):
        self._run("-put", "-f", local_path, fs_path)

    @_handle_errors()
    def download(self, fs_path, local_path):
        self._run("-get", fs_path, local_path)

    @_handle_errors()
    def mkdirs(self, fs_path):
        self._run("-mkdir", "-p", fs_path)

    @_handle_errors()
    def delete(self, fs_path):
        self._run("-rm", "-r", "-skipTrash", fs_path)

    @_handle_errors()
    def mv(self, src, dst, overwrite=False):
        if overwrite and self.is_exist(dst):
            self.delete(dst)
        self._run("-mv", src, dst)

    @_handle_errors()
    def touch(self, fs_path, exist_ok=True):
        if self.is_exist(fs_path):
            if not exist_ok:
                raise FSFileExistsError(fs_path)
            return
        self._run("-touchz", fs_path)
