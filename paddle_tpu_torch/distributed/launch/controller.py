"""Launch controllers — the port of
``paddle_tpu/distributed/launch/controller.py`` (reference:
python/paddle/distributed/launch/controllers/{controller,collective,ps}.py).

CollectiveController drives the generation-based rendezvous protocol in
`master.py`: every relaunch (trainer failure, elastic scale event) advances a
job-wide generation coordinated through the KV store's `/restart/{gen}` flag, so
all nodes re-register fresh endpoints and read back the same membership cut.
Elastic decisions (scale up/down, hold, give up) are made by rank 0 through the
fleet `ElasticManager` and broadcast via the same flags.

Each trainer gets the reference's ``PADDLE_*`` environment; what differs
is the device: ``--devices`` becomes ``CUDA_VISIBLE_DEVICES`` (the
reference sets ``TPU_VISIBLE_DEVICES``), and trainers that share the
node's card stay on it, their backend gloo
(``PADDLE_DISTRIBUTED_BACKEND``, which ``env.init_parallel_env`` reads;
NCCL refuses two ranks on one card). Nothing pins a trainer to the CPU.
``PADDLE_MASTER`` is the address the trainers' ``init_parallel_env()``
rendezvouses at (rank 0 serves it). The parameter-server controller
gives its servers and trainers the reference's environment, and its
trainers share the node's card.
"""
from __future__ import annotations

import os
import time

from ..fleet.elastic import ELASTIC_EXIT_CODE, ElasticManager, ElasticStatus
from .context import Context
from .master import KVMaster
from .pod import Container, Pod, script_entrypoint


class CollectiveController:
    def __init__(self, ctx: Context):
        self.ctx = ctx
        self.pod = Pod()
        self.master = None
        self.node_rank = None
        self.generation = 0
        self.restart_count = 0
        self.elastic = None

    # ------------------------------------------------------------ rendezvous
    def _make_record(self):
        node = self.ctx.node
        eps = [f"{node.ip}:{node.get_free_port()}"
               for _ in range(self.ctx.args.nproc_per_node)]
        return {"ip": node.ip, "endpoints": eps}

    def _rendezvous(self):
        """Returns (member_ranks, {rank: record}) for this generation, or None
        if this node was left out of the cut (late join — hold for next gen)."""
        args = self.ctx.args
        if self.ctx.nnodes_max == 1 and not args.master:
            self.node_rank = 0
            return [0], {0: self._make_record()}

        if self.master is None:
            self.master = KVMaster(args.master, args.rank, job_id=args.job_id)
            self.node_rank = args.rank if args.rank >= 0 else self.master.assign_rank()
            if self.ctx.is_elastic:
                self.elastic = ElasticManager(
                    self.master, self.node_rank, self.ctx.nnodes_min,
                    self.ctx.nnodes_max, timeout=args.elastic_timeout)
        self.master.register(self.generation, self.node_rank,
                             self._make_record())
        if self.node_rank == 0:
            self.master.publish_world(self.generation, self.ctx.nnodes_min,
                                      self.ctx.nnodes_max)
        ranks, recs = self.master.wait_world(self.generation)
        self.master.start_heartbeat(self.node_rank)
        if self.node_rank not in ranks:
            return None
        return ranks, recs

    # ------------------------------------------------------------ pod build
    def build_pod(self, ranks, recs):
        args = self.ctx.args
        all_eps = [ep for r in ranks for ep in recs[r]["endpoints"]]
        world = len(all_eps)
        my_pos = ranks.index(self.node_rank)
        rank_base = sum(len(recs[r]["endpoints"]) for r in ranks[:my_pos])
        # the trainers' rendezvous: master host, store port + 1 + generation
        # (the store server lives in the node-0 launcher; trainer rank 0
        # serves a fresh rendezvous each generation)
        if args.master:
            mhost, _, mport = args.master.partition(":")
            coord = f"{mhost}:{int(mport) + 1 + self.generation}"
        else:
            coord = all_eps[0]

        entry = script_entrypoint(args.training_script, args.training_script_args)
        for local_rank in range(args.nproc_per_node):
            grank = rank_base + local_rank
            env = {
                "PADDLE_MASTER": coord,
                "PADDLE_NNODES": len(ranks),
                "PADDLE_NODE_RANK": self.node_rank,
                "PADDLE_TRAINERS_NUM": world,
                "PADDLE_TRAINER_ID": grank,
                "PADDLE_LOCAL_RANK": local_rank,
                "PADDLE_TRAINER_ENDPOINTS": ",".join(all_eps),
                "PADDLE_CURRENT_ENDPOINT": all_eps[grank],
                "PADDLE_JOB_ID": args.job_id,
                "PADDLE_RESTART_COUNT": self.restart_count,
            }
            if args.devices:
                # partition the visible device ids across local procs; every
                # proc gets >=1 device and every device goes to some proc
                ids = args.devices.split(",")
                if args.nproc_per_node > len(ids):
                    raise ValueError(
                        f"nproc_per_node={args.nproc_per_node} exceeds the "
                        f"{len(ids)} visible devices ({args.devices!r})")
                per, extra = divmod(len(ids), args.nproc_per_node)
                lo = local_rank * per + min(local_rank, extra)
                hi = lo + per + (1 if local_rank < extra else 0)
                mine = ids[lo:hi]
                env["PADDLE_DEVICES"] = ",".join(mine)
                env["CUDA_VISIBLE_DEVICES"] = ",".join(mine)
            elif args.nproc_per_node > 1:
                # the node's procs share what it sees: ranks on one card
                # communicate over gloo (NCCL refuses two ranks a card)
                env["PADDLE_DISTRIBUTED_BACKEND"] = "gloo"
            log = os.path.join(args.log_dir, f"workerlog.{grank}")
            self.pod.add(Container(entry, env, log))

    # ---------------------------------------------------------------- watch
    def _advance_generation(self):
        self.pod.stop(force=True)
        self.pod = Pod()
        self.generation += 1
        self.restart_count += 1

    def run(self) -> int:
        while True:
            world = self._rendezvous()
            if world is None:
                # late join: hold until the job relaunches (our heartbeat makes
                # rank 0 signal a restart), then enter the next generation.
                while not self.master.restart_signaled(self.generation):
                    time.sleep(0.5)
                self.generation += 1
                continue
            ranks, recs = world
            self.build_pod(ranks, recs)
            self.pod.deploy()
            code = self._watch(ranks)
            if code is not None:
                return code

    def _watch(self, ranks):
        """Returns an exit code, or None to re-rendezvous at the next generation."""
        last_code = 1
        while True:
            status, code = self.pod.join(timeout=1.0)
            if status == "done":
                return 0
            if status == "failed":
                last_code = code
                if self.restart_count >= self.ctx.args.max_restart:
                    if self.master is not None:
                        self.master.signal_restart(self.generation)
                    self.pod.stop(force=True)
                    return last_code
                if self.master is not None:
                    self.master.signal_restart(self.generation)
                else:
                    self._advance_generation()
                    return None
            if self.master is not None and self.master.restart_signaled(self.generation):
                self._advance_generation()
                return None
            if self.elastic is not None and self.node_rank == 0:
                ev = self.elastic.watch()
                if ev == ElasticStatus.RESTART:
                    self.master.signal_restart(self.generation)
                elif ev == ElasticStatus.EXIT:
                    self.pod.stop(force=True)
                    return ELASTIC_EXIT_CODE

    def stop(self):
        if self.master is not None:
            self.master.stop_heartbeat()
        self.pod.stop(force=True)


class PSController(CollectiveController):
    """Parameter-server launch (reference launch/controllers/ps.py): spawns
    --server_num PS servers and --trainer_num trainers on this node."""

    def run(self) -> int:
        self.build_ps_pod()
        self.pod.deploy()
        status, code = self.pod.join()
        return 0 if status == "done" else code

    def build_ps_pod(self):
        args = self.ctx.args
        if args.server_num + args.trainer_num == 0:
            raise ValueError(
                "--run_mode ps needs --server_num and/or --trainer_num > 0")
        node = self.ctx.node
        server_eps = [f"{node.ip}:{node.get_free_port()}" for _ in range(args.server_num)]
        trainer_eps = [f"{node.ip}:{node.get_free_port()}" for _ in range(args.trainer_num)]
        entry = script_entrypoint(args.training_script, args.training_script_args)
        common = {
            "PADDLE_PSERVERS_IP_PORT_LIST": ",".join(server_eps),
            "PADDLE_TRAINER_ENDPOINTS": ",".join(trainer_eps),
            "PADDLE_TRAINERS_NUM": args.trainer_num,
            "PADDLE_JOB_ID": args.job_id,
        }
        for i, ep in enumerate(server_eps):
            env = dict(common, TRAINING_ROLE="PSERVER", PADDLE_PORT=ep.rsplit(":", 1)[1],
                       POD_IP=node.ip, PADDLE_RANK=i)
            self.pod.add(Container(entry, env, os.path.join(args.log_dir, f"serverlog.{i}")))
        for i in range(args.trainer_num):
            env = dict(common, TRAINING_ROLE="TRAINER", PADDLE_TRAINER_ID=i,
                       PADDLE_CURRENT_ENDPOINT=trainer_eps[i])
            self.pod.add(Container(entry, env, os.path.join(args.log_dir, f"workerlog.{i}")))
