"""Launch context: CLI args + environment — the port of
``paddle_tpu/distributed/launch/context.py`` (reference:
python/paddle/distributed/launch/context/__init__.py and args_envs.py).

The same arguments as the reference's. A trainer process a rank:
``--nproc_per_node`` of them on a node; with ``--devices`` the card ids
are partitioned across them (``CUDA_VISIBLE_DEVICES``), without it the
node's processes share what the node sees (one card: the ranks share it,
over gloo).

A node's address is ``POD_IP`` where the environment gives it, else
``127.0.0.1``: the launcher asks no network service for it (a job over
several nodes sets ``POD_IP`` on each, and ``--master``).
"""
from __future__ import annotations

import argparse
import os
import socket


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="paddle_tpu_torch.distributed.launch",
        description="distributed launcher (reference: python -m paddle.distributed.launch)",
    )
    p.add_argument("--master", default=os.environ.get("PADDLE_MASTER"),
                   help="ip:port of the rendezvous store; node 0 hosts it")
    p.add_argument("--nnodes", default=os.environ.get("PADDLE_NNODES", "1"),
                   help="number of nodes, or elastic range 'min:max'")
    p.add_argument("--rank", type=int, default=int(os.environ.get("PADDLE_RANK", "-1")),
                   help="node rank; -1 = assign via store")
    p.add_argument("--nproc_per_node", type=int,
                   default=int(os.environ.get("PADDLE_NPROC_PER_NODE", "1")))
    p.add_argument("--job_id", default=os.environ.get("PADDLE_JOB_ID", "default"))
    p.add_argument("--log_dir", default=os.environ.get("PADDLE_LOG_DIR", "log"))
    p.add_argument("--log_level", default="INFO")
    p.add_argument("--devices", default=os.environ.get("PADDLE_DEVICES"),
                   help="visible device ids for this node (comma list)")
    p.add_argument("--run_mode", default="collective", choices=["collective", "ps"])
    p.add_argument("--server_num", type=int, default=int(os.environ.get("PADDLE_SERVER_NUM", "0")))
    p.add_argument("--trainer_num", type=int, default=int(os.environ.get("PADDLE_TRAINER_NUM", "0")))
    p.add_argument("--elastic_timeout", type=float,
                   default=float(os.environ.get("PADDLE_ELASTIC_TIMEOUT", "30")))
    p.add_argument("--max_restart", type=int,
                   default=int(os.environ.get("PADDLE_MAX_RESTART", "3")))
    p.add_argument("training_script", help="script to run (or python -m module)")
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


class Node:
    def __init__(self):
        self.ip = _local_ip()
        self.free_ports = []

    def get_free_port(self) -> int:
        s = socket.socket()
        s.bind(("", 0))
        port = s.getsockname()[1]
        s.close()
        return port


def _local_ip() -> str:
    return os.environ.get("POD_IP") or "127.0.0.1"


class Context:
    def __init__(self, argv=None):
        self.args = parse_args(argv)
        self.node = Node()
        self.envs = dict(os.environ)
        lo, sep, hi = str(self.args.nnodes).partition(":")
        self.nnodes_min = int(lo)
        self.nnodes_max = int(hi) if sep else int(lo)

    @property
    def is_elastic(self) -> bool:
        return self.nnodes_max > self.nnodes_min
