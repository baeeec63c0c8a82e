"""The fleet façade — the port of
``paddle_tpu/distributed/fleet/fleet_base.py`` (``Fleet``,
``HybridParallelOptimizer``, ``UtilBase``, the module-level ``fleet``).

``Fleet.init`` builds the topology from ``strategy.hybrid_configs`` over
the process group this rank joined (``distributed.init_parallel_env``;
with one process and no group, a world of one): degrees that multiply to
1 make pure data parallelism over every rank, as the reference's over
every device. ``distributed_model`` dispatches as the reference does: a
``PipelineLayer``, or a pipeline degree above 1, to ``PipelineParallel``,
anything else to ``HybridParallelModel``.

``init(role_maker, is_collective=False)`` is the parameter-server mode
(the reference's ``fleet_base.py:33-162``): the role maker (default a
``PaddleCloudRoleMaker`` of the launcher's environment) says whether
this process is a server or a worker; ``init_server`` / ``run_server``
serve the tables, ``init_worker`` connects, ``barrier_worker`` and
``stop_worker`` end the job, ``save_persistables`` /
``load_persistables`` snapshot and restore every server's tables through
the PS client. There the worker queries (``is_first_worker``,
``worker_index``, ``worker_num``) answer from the role, where the
reference asks its collective rank.
"""
from __future__ import annotations

import numpy as np

from .. import env as env_mod
from ..topology import CommunicateTopology, HybridCommunicateGroup
from .distributed_strategy import DistributedStrategy
from .hybrid_train import HybridParallelModel
from .meta_parallel import PipelineLayer
from .pipeline_parallel import PipelineParallel

__all__ = ["Fleet", "HybridParallelOptimizer", "UtilBase", "fleet", "init",
           "distributed_model", "distributed_optimizer",
           "get_hybrid_communicate_group"]


class Fleet:
    def __init__(self):
        self.reset()

    def reset(self):
        """Forget the topology and the strategy, so that ``init`` can build
        another."""
        self._is_initialized = False
        self._hcg = None
        self._user_defined_strategy = DistributedStrategy()
        self._role = None
        return self

    def init(self, role_maker=None, is_collective=True, strategy=None):
        if strategy is not None:
            self._user_defined_strategy = strategy
        if not is_collective:
            from ..ps import runtime as ps_runtime
            from ..ps.role_maker import PaddleCloudRoleMaker

            self._role = role_maker or PaddleCloudRoleMaker()
            ps_runtime.set_role(self._role)
            self._is_initialized = True
            return self
        hc = self._user_defined_strategy.hybrid_configs
        names = ["data", "pipe", "sharding", "model"]
        degrees = [hc.get("dp_degree", 1), hc.get("pp_degree", 1),
                   hc.get("sharding_degree", 1), hc.get("mp_degree", 1)]
        if hc.get("sep_degree", 1) > 1:
            names.append("sep")
            degrees.append(hc["sep_degree"])
        if int(np.prod(degrees)) == 1:
            degrees[0] = env_mod.get_world_size()   # pure data parallel
        self._hcg = HybridCommunicateGroup(CommunicateTopology(names,
                                                               degrees))
        self._is_initialized = True
        return self

    def is_first_worker(self):
        if self._role is not None:
            return self._role.is_first_worker()
        return env_mod.get_rank() == 0

    def worker_index(self):
        if self._role is not None:
            return self._role.worker_index()
        return env_mod.get_rank()

    def worker_num(self):
        if self._role is not None:
            return self._role.worker_num()
        return max(1, env_mod.get_world_size())

    def is_worker(self):
        return self._role.is_worker() if self._role is not None else True

    def is_server(self):
        return self._role.is_server() if self._role is not None else False

    # ---------------------------------------------------- PS lifecycle
    def init_server(self, *args, **kwargs):
        """This process's PS shard on the role's port (the reference's
        arguments are taken and ignored, as there)."""
        from ..ps import runtime as ps_runtime

        return ps_runtime.init_server(self._role)

    def run_server(self):
        from ..ps import runtime as ps_runtime

        return ps_runtime.run_server(block=True)

    def init_worker(self):
        from ..ps import runtime as ps_runtime

        return ps_runtime.init_worker(self._role)

    def barrier_worker(self):
        if self._role is not None and self._role.is_worker():
            from ..ps import runtime as ps_runtime

            ps_runtime.barrier_worker()
            return
        env_mod.barrier()

    def stop_worker(self):
        if self._role is not None:
            from ..ps import runtime as ps_runtime

            ps_runtime.stop_worker()

    # ------------------------------------------------------------ io
    def save_persistables(self, executor=None, dirname=None,
                          main_program=None, mode=0):
        """PS mode: every server shard snapshots its tables to `dirname`
        (reference fleet.save_persistables -> brpc Save RPC); returns the
        tables saved. A restarted server recovers with load_persistables.
        Collective mode: save the model's state_dict instead (None)."""
        from ..ps import runtime as ps_runtime

        if dirname and ps_runtime._client is not None:
            return ps_runtime.get_ps_client().save_tables(dirname)
        return None

    def load_persistables(self, executor=None, dirname=None,
                          main_program=None, mode=0):
        from ..ps import runtime as ps_runtime

        if dirname and ps_runtime._client is not None:
            return ps_runtime.get_ps_client().load_tables(dirname)
        return None

    def get_hybrid_communicate_group(self):
        return self._hcg

    @property
    def hcg(self):
        return self._hcg

    def distributed_model(self, model, loss_fn=None):
        if not self._is_initialized:
            raise RuntimeError("call fleet.init first")
        if isinstance(model, PipelineLayer) \
                or self._hcg.get_pipe_parallel_world_size() > 1:
            if not isinstance(model, PipelineLayer):
                raise TypeError("pipeline parallelism needs a PipelineLayer")
            return PipelineParallel(model, self._hcg,
                                    self._user_defined_strategy)
        return HybridParallelModel(model, self._hcg,
                                   self._user_defined_strategy,
                                   loss_fn=loss_fn)

    def distributed_optimizer(self, optimizer, strategy=None):
        if strategy is not None:
            self._user_defined_strategy = strategy
        return HybridParallelOptimizer(optimizer, self._hcg,
                                       self._user_defined_strategy)

    def minimize(self, optimizer, loss, startup_program=None,
                 parameter_list=None, no_grad_set=None):
        loss.backward()
        optimizer.step()
        optimizer.clear_grad()
        return [], []

    @property
    def util(self):
        return UtilBase()


class UtilBase:
    """``fleet.util``: ``all_reduce`` of a host array over the workers,
    ``barrier``, ``get_file_shard`` (a file list split evenly over the
    workers) and ``print_on_rank``."""

    def all_reduce(self, input, mode="sum", comm_world="worker"):
        import torch

        from .. import collective as C

        op = {"sum": C.ReduceOp.SUM, "max": C.ReduceOp.MAX,
              "min": C.ReduceOp.MIN}[mode]
        t = torch.as_tensor(np.asarray(input)).clone()
        if env_mod.is_initialized():
            C.all_reduce(t, op=op)
        return t.numpy()

    def barrier(self, comm_world="worker"):
        env_mod.barrier()

    def get_file_shard(self, files):
        me, n = fleet.worker_index(), fleet.worker_num()
        per, rem = len(files) // n, len(files) % n
        start = per * me + min(me, rem)
        end = start + per + (1 if me < rem else 0)
        return list(files[start:end])

    def print_on_rank(self, message, rank_id=0):
        if fleet.worker_index() == rank_id:
            print(message)


class HybridParallelOptimizer:
    """The user's optimizer inside the meta-optimizers the strategy turns
    on (``create_meta_optimizer``). ``step`` runs them; the hybrid step
    (``HybridParallelModel.train_batch``) updates with the innermost
    optimizer, as the reference's does. A ``ClipGradByGlobalNorm`` of the
    optimizer takes the whole model's norm there."""

    def __init__(self, optimizer, hcg, strategy):
        from .meta_optimizers import create_meta_optimizer

        group = hcg.get_batch_group() if hcg is not None else None
        self._inner_opt = create_meta_optimizer(optimizer, strategy,
                                                group=group)
        self._hcg = hcg
        self._strategy = strategy

    def __getattr__(self, name):
        return getattr(self.__dict__["_inner_opt"], name)

    def step(self):
        self._inner_opt.step()

    def clear_grad(self, *a, **k):
        self._inner_opt.clear_grad()

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        return self._inner_opt.minimize(loss)

    def state_dict(self):
        return self._inner_opt.state_dict()

    def set_state_dict(self, sd):
        return self._inner_opt.set_state_dict(sd)


fleet = Fleet()
init = fleet.init
distributed_model = fleet.distributed_model
distributed_optimizer = fleet.distributed_optimizer


def get_hybrid_communicate_group():
    return fleet._hcg
