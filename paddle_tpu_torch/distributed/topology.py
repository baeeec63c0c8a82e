"""Hybrid-parallel topology — the port of
``paddle_tpu/distributed/topology.py`` (``CommunicateTopology``,
``HybridCommunicateGroup``).

``CommunicateTopology`` is host arithmetic over the rank grid, the
reference's own: rank r sits at ``coordinate[r]`` of
``itertools.product`` over the degrees, in ``hybrid_group_names`` order
(data, pipe, sharding, model), so model-parallel ranks are adjacent.

``HybridCommunicateGroup`` is where the port departs: the reference's
groups are axes of one device mesh, the port's are ``torch.distributed``
groups. For each axis it makes one group per comm list of
``get_comm_list(axis)``, on every rank in the same order (as
``new_group`` requires), and keeps the one this rank belongs to. This
rank's coordinate gives its rank on each axis (the reference, one
controller, answers 0).
"""
from __future__ import annotations

import itertools

import numpy as np

from . import collective as coll
from . import env as env_mod

__all__ = ["CommunicateTopology", "HybridCommunicateGroup"]


class CommunicateTopology:
    def __init__(self, hybrid_group_names=("data", "pipe", "sharding",
                                           "model"), dims=(1, 1, 1, 1)):
        self._parallel_names = list(hybrid_group_names)
        self._dims = list(dims)
        self.coordinate = list(itertools.product(*[range(d) for d in dims]))
        self._rank_of = {c: i for i, c in enumerate(self.coordinate)}

    def get_hybrid_group_names(self):
        return self._parallel_names

    def get_dim(self, axis_name):
        return self._dims[self._parallel_names.index(axis_name)]

    get_dim_size = get_dim

    def world_size(self):
        return int(np.prod(self._dims))

    def get_rank(self, **kwargs):
        coord = tuple(kwargs[n] for n in self._parallel_names)
        return self._rank_of[coord]

    def get_coord(self, rank):
        return dict(zip(self._parallel_names, self.coordinate[rank]))

    def get_axis_list(self, axis_name, index):
        ai = self._parallel_names.index(axis_name)
        return [r for r, c in enumerate(self.coordinate) if c[ai] == index]

    def get_comm_list(self, axis_name):
        """Groups of ranks that communicate along axis_name."""
        ai = self._parallel_names.index(axis_name)
        others = [i for i in range(len(self._dims)) if i != ai]
        groups = {}
        for r, c in enumerate(self.coordinate):
            key = tuple(c[i] for i in others)
            groups.setdefault(key, []).append(r)
        return list(groups.values())


class HybridCommunicateGroup:
    """This rank's place in a dp x pp x sharding x mp (+ sep) grid and a
    ``collective.Group`` for each axis (its comm list holding this rank).
    The process group must span the topology's world exactly."""

    AXIS_MAP = {"data": "dp", "pipe": "pp", "sharding": "sharding",
                "model": "mp", "sep": "sep"}

    def __init__(self, topology: CommunicateTopology):
        self._topo = topology
        names = topology.get_hybrid_group_names()
        world = env_mod.get_world_size()
        self._groups = {}
        if topology.world_size() != world:
            raise ValueError(f"the topology needs {topology.world_size()} "
                             f"ranks; the process group has {world}")
        self.global_rank = env_mod.get_rank()
        self._coord = topology.get_coord(self.global_rank)
        degree = {n: topology.get_dim(n) for n in names}
        self._dp_degree = degree.get("data", 1)
        self._pp_degree = degree.get("pipe", 1)
        self._sharding_degree = degree.get("sharding", 1)
        self._mp_degree = degree.get("model", 1)
        self._sep_degree = degree.get("sep", 1)
        if not env_mod.is_initialized():
            return          # one process, no process group: no groups
        for name in names:
            ax = self.AXIS_MAP.get(name, name)
            for ranks in topology.get_comm_list(name):
                g = coll.new_group(ranks)
                if self.global_rank in ranks:
                    self._groups[ax] = g
        # data and sharding together: the ranks that split the batch
        # (the reference's batch spec P(("dp", "sharding")))
        keep = [i for i, n in enumerate(names) if n not in ("data",
                                                            "sharding")]
        batch = {}
        for r, c in enumerate(topology.coordinate):
            batch.setdefault(tuple(c[i] for i in keep), []).append(r)
        for ranks in batch.values():
            g = coll.new_group(ranks)
            if self.global_rank in ranks:
                self._groups["batch"] = g

    @property
    def topology(self):
        return self._topo

    def get_parallel_mode(self):
        if self._pp_degree > 1:
            return "pipeline"
        if self._sharding_degree > 1:
            return "sharding"
        if self._mp_degree > 1:
            return "model"
        return "data"

    # degrees
    def get_data_parallel_world_size(self):
        return self._dp_degree

    def get_model_parallel_world_size(self):
        return self._mp_degree

    def get_pipe_parallel_world_size(self):
        return self._pp_degree

    def get_sharding_parallel_world_size(self):
        return self._sharding_degree

    # this rank's coordinate
    def _axis_rank(self, name):
        return self._coord.get(name, 0)

    def get_data_parallel_rank(self):
        return self._axis_rank("data")

    def get_model_parallel_rank(self):
        return self._axis_rank("model")

    def get_stage_id(self):
        return self._axis_rank("pipe")

    def get_sharding_parallel_rank(self):
        return self._axis_rank("sharding")

    def get_batch_rank(self):
        """This rank's index among the ranks that split the batch (data
        x sharding), and their count."""
        g = self._groups.get("batch")
        return (0, 1) if g is None else (g.rank, g.nranks)

    # groups
    def get_data_parallel_group(self):
        return self._groups.get("dp")

    def get_model_parallel_group(self):
        return self._groups.get("mp")

    def get_pipe_parallel_group(self):
        return self._groups.get("pp")

    def get_sharding_parallel_group(self):
        return self._groups.get("sharding")

    def get_batch_group(self):
        return self._groups.get("batch")

    def get_check_parallel_group(self):
        return self._groups.get("mp")

    def get_data_parallel_group_src_rank(self):
        return self._groups["dp"].ranks[0]

    def get_model_parallel_group_src_rank(self):
        return self._groups["mp"].ranks[0]

    # the reference's axis names
    def dp_axis(self):
        return "dp"

    def mp_axis(self):
        return "mp"

    def pp_axis(self):
        return "pp"

    def sharding_axis(self):
        return "sharding"
