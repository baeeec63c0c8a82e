"""distributed.utils — the port of ``paddle_tpu/distributed/utils.py``, a
copy (plain Python; ``global_scatter`` / ``global_gather`` are the
port's, from :mod:`.ops`): the launch-era cluster model + process helpers
(reference: python/paddle/distributed/utils.py:36 __all__: Cluster, Pod,
Trainer, JobServer, Hdfs, get_cluster, find_free_ports,
start_local_trainers, watch_local_trainers, terminate_local_procs,
get_host_name_ip, add_arguments, get_logger, pull_worker_log,
global_scatter/global_gather re-exports).

The modern path is distributed.launch; this module keeps the 1.x utility
surface working for scripts that build their own multi-process harness —
the reference's own multi-GPU tests are the main consumer
(test_parallel_dygraph_dataparallel.py:29 start_local_trainers).
"""
from __future__ import annotations

import os
import socket
import subprocess
import sys
import time

__all__ = [
    "get_host_name_ip", "Trainer", "get_cluster", "start_local_trainers",
    "watch_local_trainers", "find_free_ports", "JobServer", "Cluster",
    "Pod", "Hdfs", "add_arguments", "terminate_local_procs", "get_logger",
    "pull_worker_log", "global_scatter", "global_gather",
]

from .ops import global_gather, global_scatter  # noqa: E402,F401


def get_host_name_ip():
    try:
        host = socket.gethostname()
        return host, socket.gethostbyname(socket.getfqdn(host))
    except OSError:
        return None


def find_free_ports(num):
    """reference: utils.py find_free_ports — distinct ephemeral ports."""
    ports = set()
    step = 0
    while len(ports) < num:
        with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
            s.bind(("", 0))
            ports.add(s.getsockname()[1])
        step += 1
        if step > 100 + num * 10:
            return None
    return ports


class Hdfs:
    """reference: utils.py Hdfs — checkpoint target descriptor."""

    def __init__(self):
        self.hdfs_ugi = None
        self.hdfs_name = None
        self.hdfs_path = None

    def is_valid(self):
        return all(v not in (None, "") for v in
                   (self.hdfs_ugi, self.hdfs_name, self.hdfs_path))

    def __eq__(self, other):
        return (self.hdfs_ugi == other.hdfs_ugi
                and self.hdfs_name == other.hdfs_name
                and self.hdfs_path == other.hdfs_path)

    def __ne__(self, other):
        return not self == other


class JobServer:
    def __init__(self):
        self.endpoint = None

    def __eq__(self, other):
        return self.endpoint == other.endpoint

    def __ne__(self, other):
        return not self == other


class Trainer:
    """One rank: gpu assignment + endpoint + global rank."""

    def __init__(self):
        self.accelerators = []
        self.gpus = self.accelerators  # 1.x spelling
        self.endpoint = None
        self.rank = None

    def __eq__(self, other):
        return (self.accelerators == other.accelerators
                and self.endpoint == other.endpoint
                and self.rank == other.rank)

    def __ne__(self, other):
        return not self == other


class Pod:
    """One host's set of trainers (distinct from launch.pod.Pod, which is
    the process-supervisor; this is the 1.x topology record)."""

    def __init__(self):
        self.rank = None
        self.id = None
        self.addr = None
        self.port = None
        self.trainers: list[Trainer] = []
        self.servers = []
        self.workers = []
        self.accelerators = []
        self.gpus = self.accelerators

    def __eq__(self, other):
        return (self.rank == other.rank and self.id == other.id
                and self.addr == other.addr and self.port == other.port
                and self.trainers == other.trainers)

    def __ne__(self, other):
        return not self == other


class Cluster:
    def __init__(self, hdfs=None):
        self.job_server = None
        self.pods: list[Pod] = []
        self.hdfs = hdfs
        self.job_stage_flag = None

    def trainers_nranks(self):
        return len(self.trainers_endpoints())

    def pods_nranks(self):
        return len(self.pods)

    def trainers_endpoints(self):
        return [t.endpoint for pod in self.pods for t in pod.trainers]

    def pods_endpoints(self):
        return [f"{pod.addr}:{pod.port}" for pod in self.pods]

    def get_pod_by_id(self, pod_id):
        for pod in self.pods:
            if pod.id == pod_id:
                return pod
        return None

    def __eq__(self, other):
        return self.pods == other.pods

    def __ne__(self, other):
        return not self == other


def get_cluster(node_ips, node_ip, trainer_endpoints, device_mode=None,
                devices_per_proc=None):
    """reference: utils.py get_cluster — build the Cluster/Pod/Trainer tree
    from per-node endpoint lists."""
    if devices_per_proc is None:
        devices_per_proc = trainer_endpoints and \
            [[i] for i in range(len(trainer_endpoints[0]))] or []
    cluster = Cluster()
    rank = 0
    for node_rank, ip in enumerate(node_ips):
        pod = Pod()
        pod.rank = node_rank
        pod.addr = ip
        pod.id = node_rank
        eps = trainer_endpoints[node_rank]
        for i, ep in enumerate(eps):
            t = Trainer()
            t.endpoint = ep
            t.rank = rank
            if i < len(devices_per_proc):
                dv = devices_per_proc[i]
                t.accelerators.extend(dv if isinstance(dv, (list, tuple))
                                      else [dv])
            pod.trainers.append(t)
            rank += 1
        cluster.pods.append(pod)
    return cluster, cluster.pods[node_ips.index(node_ip)]


class TrainerProc:
    def __init__(self):
        self.proc = None
        self.log_fn = None
        self.log_offset = None
        self.rank = None
        self.local_rank = None
        self.cmd = None


def start_local_trainers(cluster, pod, training_script,
                         training_script_args, log_dir=None, envs=None):
    """reference: utils.py start_local_trainers — spawn one python process
    per trainer with the PADDLE_* rank env contract."""
    current_env = dict(os.environ)
    current_env.update(envs or {})
    procs = []
    for idx, t in enumerate(pod.trainers):
        proc_env = dict(current_env)
        proc_env.update({
            "PADDLE_TRAINER_ID": str(t.rank),
            "PADDLE_CURRENT_ENDPOINT": str(t.endpoint),
            "PADDLE_TRAINERS_NUM": str(cluster.trainers_nranks()),
            "PADDLE_TRAINER_ENDPOINTS": ",".join(
                cluster.trainers_endpoints()),
        })
        if t.accelerators:
            proc_env["FLAGS_selected_accelerators"] = ",".join(
                str(g) for g in t.accelerators)
        cmd = [sys.executable, "-u", training_script] + list(
            training_script_args)
        fn = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            fn = open(os.path.join(log_dir, f"workerlog.{idx}"), "a")
            proc = subprocess.Popen(cmd, env=proc_env, stdout=fn, stderr=fn)
        else:
            proc = subprocess.Popen(cmd, env=proc_env)
        tp = TrainerProc()
        tp.proc = proc
        tp.rank = t.rank
        tp.local_rank = idx
        tp.log_fn = fn
        tp.cmd = cmd
        procs.append(tp)
    return procs


def watch_local_trainers(procs, nranks):
    """reference: utils.py watch_local_trainers — poll; raise on failure,
    return alive procs (empty when all finished cleanly)."""
    alive = []
    for p in procs:
        ret = p.proc.poll()
        if ret is None:
            alive.append(p)
        elif ret != 0:
            terminate_local_procs(procs)
            raise subprocess.CalledProcessError(ret, p.cmd)
    return alive


def terminate_local_procs(procs):
    for p in procs:
        if p.proc is not None and p.proc.poll() is None:
            p.proc.terminate()
    deadline = time.time() + 10
    for p in procs:
        if p.proc is None:
            continue
        while p.proc.poll() is None and time.time() < deadline:
            time.sleep(0.1)
        if p.proc.poll() is None:
            p.proc.kill()
        if p.log_fn:
            p.log_fn.close()


def add_arguments(argname, type, default, help, argparser):  # noqa: A002
    """reference: utils.py add_arguments — argparse helper."""
    argparser.add_argument(
        "--" + argname, default=default, type=type,
        help=help + f" Default: {default}.")


def get_logger(log_level=20, name="root"):
    import logging

    logger = logging.getLogger(name)
    logger.setLevel(log_level)
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter(
            "%(levelname)s %(asctime)s %(message)s"))
        logger.addHandler(h)
    return logger


def pull_worker_log(tp):
    if tp.log_fn is None:
        return
    with open(tp.log_fn.name) as f:
        f.seek(tp.log_offset or 0)
        data = f.read()
        tp.log_offset = f.tell()
    if data:
        sys.stdout.write(data)
