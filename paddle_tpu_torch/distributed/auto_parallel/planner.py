"""Mesh planner — the port of
``paddle_tpu/distributed/auto_parallel/planner.py`` (``Plan``,
``plan_parallel``, ``estimate_step_time``, ``plan_mesh``): pick the (dp,
sp, sharding, mp) degrees for a model over some ranks by scoring every
power-of-two factorisation with the cost model. Plain numpy and Python:
for the same inputs the plans, candidates and times are the reference's.
The cost model's defaults describe a TPU v5p chip; pass a
``Cluster("h100", ...)`` for the card.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .cost_model import (ClusterSpec, CommCostModel, CompCostModel, ModelDesc,
                         estimate_partition)
from .process_mesh import ProcessMesh


def _divisors_pow2(n: int):
    d = 1
    while d <= n:
        if n % d == 0:
            yield d
        d *= 2


@dataclass
class Plan:
    """A chosen partition + the evidence: per-axis comm volumes/times and
    every candidate's score (so `why` is inspectable, not oracular)."""

    dp: int
    sp: int
    sharding: int
    mp: int
    time: float
    per_chip_bytes: float
    t_comp: float = 0.0
    t_comm: dict = field(default_factory=dict)
    comm_volumes: dict = field(default_factory=dict)
    candidates: list = field(default_factory=list)

    @property
    def axis_sizes(self) -> dict:
        return {"dp": self.dp, "sp": self.sp, "sharding": self.sharding,
                "mp": self.mp}

    def process_mesh(self, cluster=None) -> ProcessMesh:
        """Rank-mapped mesh: heaviest-comm axis innermost (ICI)."""
        from .cluster import Cluster
        from .mapper import build_process_mesh

        cluster = cluster or Cluster(
            n_hosts=1, chips_per_host=self.dp * self.sp * self.sharding * self.mp)
        comm = {a: float(v["bytes"]) * v["count"]
                for a, v in self.comm_volumes.items()}
        return build_process_mesh(cluster, self.axis_sizes, comm)


def plan_parallel(n_devices: int, model: ModelDesc, cluster=None,
                  zero_stage: int | None = None,
                  hbm_fraction: float = 0.6) -> Plan:
    """Search pow2 factorizations of n_devices into dp x sp x sharding x mp,
    score each with estimate_partition, and return the cheapest feasible
    Plan. Feasibility: per-chip memory under hbm_fraction * HBM, dp*sharding
    divides batch, sp divides seq AND heads (Ulysses regroups heads), mp
    divides hidden and heads. Near-ties resolve toward fewer splits.

    Reference analog: planner.py PlanSpace/PlanComp enumerate+cost; the
    wide-FFN-vs-long-seq decision test (tests/test_auto_parallel_planner.py)
    is the reference's "planner beats default dist attrs" check restated.
    """
    from .cluster import Cluster

    cluster = cluster or Cluster(n_hosts=1, chips_per_host=n_devices)
    spec = cluster.to_cluster_spec() if isinstance(cluster, Cluster) else cluster
    budget = spec.hbm_bytes * hbm_fraction

    candidates = []
    for mp in _divisors_pow2(n_devices):
        if model.hidden % mp or (model.heads and model.heads % mp):
            continue
        for sp in _divisors_pow2(n_devices // mp):
            if model.seq % sp or (model.heads and model.heads % sp):
                continue
            for sh in _divisors_pow2(n_devices // (mp * sp)):
                dp = n_devices // (mp * sp * sh)
                if model.batch % (dp * sh):
                    continue
                if zero_stage == 0 and sh > 1:
                    continue
                # route each axis's collectives over the medium the mapper
                # would give this layout (heaviest axis innermost -> ICI;
                # outer axes may span hosts -> DCN)
                placement = None
                if isinstance(cluster, Cluster) and cluster.n_hosts > 1:
                    from .cost_model import partition_comm_volumes
                    from .mapper import map_mesh

                    sizes = {"dp": dp, "sp": sp, "sharding": sh, "mp": mp}
                    vols = partition_comm_volumes(model, dp, sp, sh, mp)
                    _, placement = map_mesh(
                        cluster, sizes,
                        {a: float(v["bytes"]) * v["count"]
                         for a, v in vols.items()})
                est = estimate_partition(model, dp, sp, sh, mp, spec,
                                         placement=placement)
                est["feasible"] = est["per_chip_bytes"] <= budget
                # 5%-per-split-doubling penalty: near-ties resolve toward
                # the least-split (least fragile) layout
                splits = mp * sp * sh
                est["t_eff"] = est["time"] * (1.05 ** float(np.log2(splits)))
                candidates.append(est)

    feasible = [c for c in candidates if c["feasible"]]
    pool = feasible or candidates
    if not pool:
        raise ValueError(
            f"no pow2 partition of {n_devices} devices divides "
            f"batch={model.batch}/seq={model.seq}/hidden={model.hidden}")
    best = min(pool, key=lambda c: (c["t_eff"], c["mp"] * c["sp"] * c["sharding"]))
    return Plan(dp=best["dp"], sp=best["sp"], sharding=best["sharding"],
                mp=best["mp"], time=best["time"],
                per_chip_bytes=best["per_chip_bytes"],
                t_comp=best["t_comp"], t_comm=best["t_comm"],
                comm_volumes=best["comm_volumes"],
                candidates=sorted(candidates, key=lambda c: c["t_eff"]))


def estimate_step_time(dp, sh, mp, param_bytes, state_bytes,
                       step_flops, batch_bytes, cluster, comp=None):
    """Estimated per-step wall time for one (dp, sharding, mp) candidate:
    compute (roofline over the per-chip FLOP share) + the comm the layout
    implies. Returns (time_seconds, per_chip_bytes) — per-chip memory is the
    feasibility side."""
    comm = CommCostModel(cluster)
    comp = comp or CompCostModel(cluster)
    per_chip = param_bytes / mp + (state_bytes - param_bytes) / (mp * sh)
    # compute: the batch is partitioned over BOTH dp and sharding axes
    # (partitioner.partition_batch / hybrid_train._batch_spec), mp splits
    # each layer's FLOPs
    t = comp.matmul_time(step_flops / (dp * sh * mp)) if step_flops else 0.0
    if dp > 1:
        t += comm.all_reduce(param_bytes / (mp * sh), dp)
    if sh > 1:
        t += comm.all_gather(param_bytes / mp, sh) + \
            comm.reduce_scatter(param_bytes / mp, sh)
    if mp > 1:
        # per-step activation allreduce volume; floor it at a param-scale
        # estimate so mp is never modeled as free
        act = max(batch_bytes, param_bytes)
        t += comm.all_reduce(act, mp) * 4
    return t, per_chip


def plan_mesh(n_devices: int, n_params: int, dtype_bytes: int = 4,
              opt_slots: int = 2, cluster: ClusterSpec | None = None,
              batch_bytes: float = 0.0, step_flops: float | None = None,
              tokens_per_batch: float = 0.0) -> ProcessMesh:
    """Choose a [dp, sharding, mp] mesh for `n_devices` chips by searching all
    pow2 factorizations and minimizing estimated step TIME under the HBM
    constraint (reference: planner.py + cost_model-driven tuner; scaling-book
    recipe). When no FLOP estimate is available, step_flops defaults to the
    6*N*tokens training rule so compute still weighs against comm.
    """
    cluster = cluster or ClusterSpec()
    param_bytes = float(n_params) * dtype_bytes
    state_bytes = param_bytes * (1 + 1 + opt_slots)  # params + grads + slots
    budget = cluster.hbm_bytes * 0.6  # leave room for activations/workspace
    if step_flops is None:
        step_flops = 6.0 * float(n_params) * max(tokens_per_batch, 1.0)

    best = None
    for mp in _divisors_pow2(n_devices):
        rest = n_devices // mp
        for sh in _divisors_pow2(rest):
            dp = rest // sh
            t, per_chip = estimate_step_time(
                dp, sh, mp, param_bytes, state_bytes,
                step_flops, batch_bytes, cluster)
            if per_chip > budget:
                continue
            # 5%-per-split-doubling penalty: near-ties (inside the cost
            # model's noise) resolve toward the least-split layout
            t_eff = t * (1.05 ** float(np.log2(mp * sh)))
            key = (t_eff, mp * sh)
            if best is None or key < best[0]:
                best = (key, dp, sh, mp)
    if best is None:  # nothing fits: max sharding
        dp, sh, mp = 1, 1, n_devices
    else:
        _, dp, sh, mp = best
    ids = np.arange(n_devices).reshape(dp, sh, mp)
    return ProcessMesh(ids, dim_names=["dp", "sharding", "mp"])
