"""The port's launcher (``distributed.launch``), its store
(``runtime.TCPStore``, ``launch.master.KVMaster``) and
``fleet.elastic.ElasticManager`` against the JAX package's.

- the trainers' environment: ``CollectiveController.build_pod`` of both
  packages for the same arguments (no process started; the node's
  address and free ports pinned), equal but for the device variables
  the port sets by design: ``CUDA_VISIBLE_DEVICES`` where the reference
  sets ``TPU_VISIBLE_DEVICES``, and ``PADDLE_DISTRIBUTED_BACKEND=gloo``
  for processes sharing the node's card where the reference pins them to
  the CPU (``JAX_PLATFORMS=cpu``);
- the store, native (``csrc/tcp_store.cc``) and its pure-Python
  fallback: set / get / add / wait / discard / clone, and the KV master's
  generation protocol over it; ``ElasticManager`` against the reference
  test's fake master (``tests/test_launch_elastic.py``), step for step
  with the reference's manager;
- three launches of ``python -m paddle_tpu_torch.distributed.launch``
  with two trainers (whose script imports ``paddle_tpu_torch.distributed``
  only, never JAX): a run (an all-reduce over the launcher's rendezvous,
  ``workerlog.N``), a restart after a trainer's failure (generation 1
  succeeds), and restarts exhausted (the launcher exits with the
  trainer's code).
"""
import itertools
import os
import socket
import subprocess
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pod_envs(pkg, monkeypatch, argv):
    """``build_pod``'s containers for ``argv``: (entrypoint, env, log)."""
    import importlib

    ctx_mod = importlib.import_module(f"{pkg}.distributed.launch.context")
    ctl_mod = importlib.import_module(f"{pkg}.distributed.launch.controller")
    monkeypatch.setattr(ctx_mod, "_local_ip", lambda: "10.1.2.3")
    ports = itertools.count(7000)
    monkeypatch.setattr(ctx_mod.Node, "get_free_port",
                        lambda self: next(ports))
    ctrl = ctl_mod.CollectiveController(ctx_mod.Context(argv))
    ctrl.node_rank = 0
    ctrl.build_pod([0], {0: ctrl._make_record()})
    return [(c.entrypoint, c.env, c.log_path) for c in ctrl.pod.containers]


@pytest.mark.parametrize("argv", [
    ["--nproc_per_node", "2", "train.py", "--lr", "0.1"],
    ["--nproc_per_node", "1", "train.py"],
    ["--nproc_per_node", "2", "--devices", "0,1,2", "train.py"],
    ["--nproc_per_node", "4", "--master", "10.0.0.9:6170", "--rank", "0",
     "--devices", "0,1,2,3", "--job_id", "j7", "--log_dir", "logs",
     "train.py"]], ids=["shared", "one", "devices", "master"])
def test_trainer_environment_is_the_references(monkeypatch, argv):
    want = _pod_envs("paddle_tpu", monkeypatch, argv)
    got = _pod_envs("paddle_tpu_torch", monkeypatch, argv)
    assert len(got) == len(want)
    for (ge, genv, glog), (we, wenv, wlog) in zip(got, want):
        assert ge == we and glog == wlog
        wenv = dict(wenv)
        if wenv.pop("JAX_PLATFORMS", None) == "cpu":
            wenv["PADDLE_DISTRIBUTED_BACKEND"] = "gloo"
        if "TPU_VISIBLE_DEVICES" in wenv:
            wenv["CUDA_VISIBLE_DEVICES"] = wenv.pop("TPU_VISIBLE_DEVICES")
        assert genv == wenv
    assert "JAX_PLATFORMS" not in str(got)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_store_operations(monkeypatch, native):
    from paddle_tpu_torch.runtime import native as nat
    from paddle_tpu_torch.runtime import tcp_store

    if not native:
        monkeypatch.setattr(nat, "build", lambda force=False: None)
    port = _free_port()
    master = tcp_store.TCPStore("127.0.0.1", port, is_master=True)
    client = tcp_store.TCPStore("127.0.0.1", port)
    assert master.native == client.native == native
    if native:
        assert nat.error is None
    client.set("k", "v1")
    assert master.get("k") == b"v1"
    with pytest.raises(KeyError):
        master.get("absent")
    assert client.add("n", 2) == 2 and master.add("n", 3) == 5
    master.set("late", b"\x00\x01")
    client.wait(["k", "late"], timeout=5)
    with pytest.raises(TimeoutError):
        client.wait("never", timeout=0.2)
    client.discard("k")
    assert master.get("k") == b""
    assert client.clone().get("late") == b"\x00\x01"


def test_kv_master_generation_protocol():
    from paddle_tpu_torch.distributed.launch.master import KVMaster

    ep = f"127.0.0.1:{_free_port()}"
    m0 = KVMaster(ep, 0, job_id="t", timeout=10)
    m1 = KVMaster(ep, 1, job_id="t", timeout=10)
    assert m0.is_master and not m1.is_master
    assert [m0.assign_rank(), m1.assign_rank()] == [0, 1]
    m1.register(0, 1, {"ip": "b", "endpoints": ["b:2"]})
    m0.register(0, 0, {"ip": "a", "endpoints": ["a:1"]})
    assert m0.publish_world(0, 2, grace=0.0) == [0, 1]
    ranks, recs = m1.wait_world(0)
    assert ranks == [0, 1] and recs[1]["endpoints"] == ["b:2"]
    assert not m0.restart_signaled(0)
    m1.signal_restart(0)
    assert m0.restart_signaled(0)
    m0.start_heartbeat(0, interval=0.05)
    m1.start_heartbeat(1, interval=0.05)
    time.sleep(0.3)
    assert m0.alive_peers(2, stale_after=5.0) == [0, 1]
    m0.stop_heartbeat()
    m1.stop_heartbeat()


class _FakeMaster:
    """``tests/test_launch_elastic.py``'s fake master."""

    def __init__(self):
        self.hb = {}

    def start_heartbeat(self, rank, interval=2.0):
        self.hb[rank] = time.time()

    def stop_heartbeat(self):
        pass

    def alive_peers(self, nmax, stale_after=10.0):
        now = time.time()
        return [r for r, ts in sorted(self.hb.items())
                if now - ts < stale_after]


def _elastic_run(mod):
    m = _FakeMaster()
    em = mod.ElasticManager(m, node_rank=0, np_min=2, np_max=4, timeout=0.5,
                            stale_after=5.0)
    out = [em.enabled]
    m.hb = {0: time.time(), 1: time.time()}
    out += [em.match(), em.watch()]
    m.hb[2] = time.time()       # scale up
    out += [em.watch(), em.watch()]
    m.hb = {0: time.time()}     # below np_min: hold, then exit
    out.append(em.watch())
    time.sleep(0.6)
    out += [em.watch(), em.match()]
    em.register()
    em.exit()
    return out


def test_elastic_manager_matches_the_reference():
    import paddle_tpu.distributed.fleet.elastic as jel
    import paddle_tpu_torch.distributed.fleet.elastic as pel

    got = _elastic_run(pel)
    assert got == _elastic_run(jel)
    assert got == [True, True, "completed", "restart", "completed", "hold",
                   "exit", False]
    assert pel.ELASTIC_EXIT_CODE == jel.ELASTIC_EXIT_CODE == 101


#: the trainer: an all-reduce over the launcher's rendezvous; with
#: FAIL_GENERATIONS it exits 7 on rank 1 while the restart count is
#: below it
_TRAINER = """import os, sys
import torch
from paddle_tpu_torch import distributed as ptd
assert "jax" not in sys.modules
restart = int(os.environ["PADDLE_RESTART_COUNT"])
if os.environ["PADDLE_TRAINER_ID"] == "1" and \\
        restart < int(os.environ.get("FAIL_GENERATIONS", "0")):
    sys.exit(7)
ptd.init_parallel_env(timeout_s=60)
t = torch.ones(1) * (ptd.get_rank() + 1)
ptd.all_reduce(t)
print("rank", ptd.get_rank(), "world", ptd.get_world_size(), "sum",
      int(t.item()), "restart", restart,
      os.environ["PADDLE_DISTRIBUTED_BACKEND"], flush=True)
ptd.destroy_process_group()
"""


def _launch(tmp_path, fail_generations, max_restart):
    script = tmp_path / "trainer.py"
    script.write_text(_TRAINER)
    env = dict(os.environ, PYTHONPATH=ROOT,
               FAIL_GENERATIONS=str(fail_generations))
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node", "2", "--max_restart", str(max_restart),
         "--log_dir", str(tmp_path / "log"), str(script)],
        env=env, cwd=str(tmp_path), capture_output=True, text=True,
        timeout=180)
    logs = {p.name: p.read_text() for p in (tmp_path / "log").glob("*")}
    return proc.returncode, logs


@pytest.mark.parametrize("fail,max_restart,rc,restarts", [
    (0, 0, 0, 0), (1, 1, 0, 1), (2, 1, 7, None)],
    ids=["run", "restart", "exhausted"])
def test_launch_two_trainers(tmp_path, fail, max_restart, rc, restarts):
    code, logs = _launch(tmp_path, fail, max_restart)
    assert code == rc, logs
    assert sorted(logs) == ["workerlog.0", "workerlog.1"]
    if restarts is None:
        assert "sum" not in logs["workerlog.1"]
        return
    for r in (0, 1):
        last = logs[f"workerlog.{r}"].strip().splitlines()[-1].split()
        assert last == ["rank", str(r), "world", "2", "sum", "3", "restart",
                        str(restarts), "gloo"]
