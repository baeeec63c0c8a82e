"""paddle.distributed.auto_parallel — the port of
``paddle_tpu/distributed/auto_parallel/``: semi-automatic parallelism
over ``torch.distributed`` ranks.

- ``ProcessMesh``: named dims over ranks; each dim's ``collective.Group``
  and the mesh's ``CommunicateTopology``;
- ``shard_tensor`` / ``shard_op`` / ``dist_attr``: annotations on tensors
  every rank holds whole; ``local_shard`` is a rank's piece;
- ``reshard`` / ``Resharder``: move a rank's piece between layouts with
  the port's collectives (all-gather, slice, all-to-all, send / recv);
- ``complete_param_specs`` / ``complete``: dims-mapping propagation over
  the model's ATen graph (``make_fx`` on fake CPU tensors);
- ``Partitioner``: completed specs into per-rank placements;
- ``Cluster`` / ``map_mesh`` / the cost model / ``plan_parallel``: the
  reference's planner, plain numpy, with an ``"h100"`` device row;
- ``Engine``: plan + complete + partition, then ``fleet``'s hybrid step
  over the mesh; ``fit`` / ``evaluate`` / ``predict`` / ``save`` /
  ``load``.
"""
from .cluster import Cluster, cpu_test_cluster
from .completion import complete, complete_param_specs
from .cost_model import (ClusterSpec, CommCostModel, CompCostModel, ModelDesc,
                         estimate_partition, partition_comm_volumes)
from .engine import Engine
from .interface import (
    TensorDistAttr,
    dist_attr,
    local_shard,
    shard_op,
    shard_tensor,
)
from .mapper import build_process_mesh, map_mesh
from .partitioner import Partitioner
from .planner import Plan, plan_mesh, plan_parallel
from .process_mesh import ProcessMesh
from .reshard import Resharder, needs_reshard, reshard

__all__ = [
    "ProcessMesh", "shard_tensor", "shard_op", "reshard", "dist_attr",
    "TensorDistAttr", "complete", "complete_param_specs", "Partitioner",
    "Resharder", "needs_reshard", "plan_mesh", "plan_parallel", "Plan",
    "Engine", "ClusterSpec", "CommCostModel", "CompCostModel", "ModelDesc",
    "estimate_partition", "partition_comm_volumes", "Cluster",
    "cpu_test_cluster", "map_mesh", "build_process_mesh",
]
