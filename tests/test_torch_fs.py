"""The port's file systems (``distributed.fleet.fs``) and 1.x cluster
helpers (``distributed.utils``) against the JAX package's: the same
calls on both, the same answers (exact: these are host code).

- ``LocalFS``: a sequence of operations on a scratch tree, each one's
  result (or the exception it raises) recorded, in the two packages;
- ``HDFSClient``: the ``hadoop fs`` commands each method issues and what
  it makes of their output, against a fake ``hadoop`` on a directory of
  the test (``hadoop_home``) that logs its arguments and answers
  ``-ls`` / ``-test``;
- ``_handle_errors``: the retries, then ``ExecuteError``;
- ``utils``: ``get_cluster``'s trees, ``find_free_ports``, ``Hdfs``,
  ``add_arguments``, and two local trainers through
  ``start_local_trainers`` / ``watch_local_trainers`` (their logs and
  environment).
"""
import argparse
import os
import stat
import sys
import time

import pytest

import paddle_tpu.distributed.fleet.fs as jfs
import paddle_tpu.distributed.utils as jdu
import paddle_tpu_torch.distributed.fleet.fs as pfs
import paddle_tpu_torch.distributed.utils as pdu


def _local_ops(fs, mod, root):
    """A LocalFS session; the answers and the exceptions' names, in
    order."""
    out = []

    def rec(f, *a, **k):
        try:
            out.append(f(*a, **k))
        except (mod.FSFileExistsError, mod.FSFileNotExistsError) as e:
            out.append(type(e).__name__)

    d = os.path.join(root, "a", "b")
    rec(fs.mkdirs, d)
    rec(fs.is_dir, d)
    rec(fs.is_exist, d)
    f = os.path.join(d, "x.txt")
    rec(fs.touch, f)
    rec(fs.is_file, f)
    rec(fs.touch, f, exist_ok=False)
    rec(fs.ls_dir, d)
    dst = os.path.join(root, "y.txt")
    rec(fs.mv, f, dst)
    rec(fs.is_exist, f)
    rec(fs.mv, f, dst)
    rec(fs.touch, f)
    rec(fs.mv, dst, f, overwrite=False)
    rec(fs.mv, dst, f, overwrite=True)
    up = os.path.join(root, "copy.txt")
    rec(fs.upload, f, up)
    rec(fs.is_file, up)
    rec(fs.list_dirs, root)
    rec(fs.delete, up)
    rec(fs.is_exist, up)
    rec(fs.ls_dir, os.path.join(root, "missing"))
    rec(fs.delete, d)
    rec(fs.is_exist, d)
    return out


def test_localfs_answers_as_the_reference(tmp_path):
    want = _local_ops(jfs.LocalFS(), jfs, str(tmp_path / "ref"))
    got = _local_ops(pfs.LocalFS(), pfs, str(tmp_path / "port"))
    assert got == want
    assert "FSFileExistsError" in got and "FSFileNotExistsError" in got


_FAKE_HADOOP = """#!{python}
import sys
with open({log!r}, "a") as f:
    f.write(" ".join(sys.argv[1:]) + "\\n")
args = sys.argv[1:]
if "-ls" in args:
    print("drwxr-xr-x - u g 0 2024-01-01 00:00 /d/sub")
    print("-rw-r--r-- 3 u g 5 2024-01-01 00:00 /d/file.txt")
if "-test" in args:
    sys.exit(0 if args[-1].startswith("/d") and
             (args[-2] == "-e" or args[-1] == "/d") else 1)
"""


def _hdfs_ops(cls, home):
    c = cls(hadoop_home=home, configs={"fs.default.name": "hdfs://x"},
            time_out=5.0)
    return [c.ls_dir("/d"), c.is_exist("/d/file.txt"), c.is_exist("/e"),
            c.is_dir("/d"), c.is_file("/d/file.txt"), c.upload("a", "/d/a"),
            c.download("/d/a", "b"), c.mkdirs("/d/n"), c.delete("/d/n"),
            c.mv("/d/a", "/d/b", overwrite=True), c.touch("/e/t")]


def test_hdfs_client_issues_the_references_commands(tmp_path):
    logs = {}
    for name, cls in (("ref", jfs.HDFSClient), ("port", pfs.HDFSClient)):
        home = tmp_path / name
        (home / "bin").mkdir(parents=True)
        exe = home / "bin" / "hadoop"
        log = str(home / "log")
        exe.write_text(_FAKE_HADOOP.format(python=sys.executable, log=log))
        exe.chmod(exe.stat().st_mode | stat.S_IEXEC)
        logs[name] = (_hdfs_ops(cls, str(home)), open(log).read())
    assert logs["port"] == logs["ref"]
    assert logs["port"][0][0] == (["sub"], ["file.txt"])


@pytest.mark.parametrize("mod", [jfs, pfs], ids=["reference", "port"])
def test_handle_errors_retries_then_raises(mod):
    calls = []

    class Flaky:
        _time_out = 0.5

        @mod._handle_errors()
        def sometimes(self, fail_times):
            calls.append(1)
            if len(calls) <= fail_times:
                raise OSError("transient")
            return "ok"

    assert Flaky().sometimes(2) == "ok" and len(calls) == 3

    class AlwaysFail:
        _time_out = 0.3

        @mod._handle_errors()
        def boom(self):
            raise OSError("nope")

    with pytest.raises(mod.ExecuteError):
        AlwaysFail().boom()


def _tree(cluster, pod):
    return ([(p.rank, p.id, p.addr, [(t.rank, t.endpoint, t.accelerators)
                                     for t in p.trainers])
             for p in cluster.pods], pod.rank, cluster.trainers_nranks(),
            cluster.trainers_endpoints(), cluster.pods_nranks())


@pytest.mark.parametrize("devices", [None, [[0], [1]]])
def test_get_cluster_builds_the_references_tree(devices):
    args = (["10.0.0.1", "10.0.0.2"], "10.0.0.2",
            [["10.0.0.1:9000", "10.0.0.1:9001"],
             ["10.0.0.2:9000", "10.0.0.2:9001"]])
    want = jdu.get_cluster(*args, devices_per_proc=devices)
    got = pdu.get_cluster(*args, devices_per_proc=devices)
    assert _tree(*got) == _tree(*want)
    assert got[0].get_pod_by_id(0).addr == "10.0.0.1"


def test_utils_helpers():
    assert len(pdu.find_free_ports(3)) == 3
    h = pdu.Hdfs()
    assert not h.is_valid() and h == pdu.Hdfs()
    h.hdfs_ugi, h.hdfs_name, h.hdfs_path = "u", "n", "/p"
    assert h.is_valid() and h != pdu.Hdfs()
    for du in (jdu, pdu):
        p = argparse.ArgumentParser()
        du.add_arguments("lr", float, 0.1, "learning rate.", p)
        assert p.parse_args(["--lr", "0.5"]).lr == 0.5
    from paddle_tpu_torch.distributed import ops

    assert pdu.global_scatter is ops.global_scatter
    assert pdu.global_gather is ops.global_gather


def test_start_and_watch_local_trainers(tmp_path):
    cluster, pod = pdu.get_cluster(
        ["127.0.0.1"], "127.0.0.1", [["127.0.0.1:9100", "127.0.0.1:9101"]])
    script = tmp_path / "w.py"
    script.write_text("import os\nprint('rank', os.environ['PADDLE_TRAINER_ID'],"
                      " os.environ['PADDLE_TRAINERS_NUM'],"
                      " os.environ['PADDLE_CURRENT_ENDPOINT'])\n")
    procs = pdu.start_local_trainers(cluster, pod, str(script), [],
                                     log_dir=str(tmp_path))
    deadline = time.time() + 60
    while pdu.watch_local_trainers(procs, 2):
        assert time.time() < deadline
        time.sleep(0.1)
    pdu.terminate_local_procs(procs)
    logs = sorted(p.name for p in tmp_path.glob("workerlog.*"))
    assert logs == ["workerlog.0", "workerlog.1"]
    assert (tmp_path / "workerlog.1").read_text().split() == [
        "rank", "1", "2", "127.0.0.1:9101"]
