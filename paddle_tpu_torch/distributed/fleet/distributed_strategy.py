"""``DistributedStrategy`` — the port of
``paddle_tpu/distributed/fleet/distributed_strategy.py``: a plain mirror
of Paddle's strategy proto with the reference's fields and defaults.
``fleet`` reads ``hybrid_configs`` (the topology), ``amp`` /
``amp_configs``, ``recompute`` / ``recompute_configs``, ``sharding`` /
``sharding_configs``, ``pipeline_configs``, ``fuse_grad_size_in_MB`` (the
data-parallel bucket) and the meta-optimizer switches."""
from __future__ import annotations

import copy

__all__ = ["DistributedStrategy"]


class DistributedStrategy:
    def __init__(self):
        # feature switches (proto fields :280-311)
        self.amp = False
        self.amp_configs = {
            "init_loss_scaling": 32768.0, "custom_white_list": [],
            "custom_black_list": [], "use_pure_fp16": False, "use_bf16": True,
            "level": "O1",
        }
        self.recompute = False
        self.recompute_configs = {"checkpoints": [], "enable_offload": False}
        self.sharding = False
        self.sharding_configs = {
            "sharding_degree": 1, "stage": 1, "segment_broadcast_MB": 32.0,
            "offload": False,
        }
        self.pipeline = False
        self.pipeline_configs = {"accumulate_steps": 1, "micro_batch_size": 1,
                                 "schedule_mode": "1F1B"}
        self.tensor_parallel = False
        self.tensor_parallel_configs = {"tensor_parallel_degree": 1}
        self.gradient_merge = False
        self.gradient_merge_configs = {"k_steps": 1, "avg": True}
        self.lamb = False
        self.lars = False
        self.dgc = False
        self.localsgd = False
        self.fp16_allreduce = False
        self.find_unused_parameters = False
        self.fuse_all_reduce_ops = True
        self.fuse_grad_size_in_MB = 32
        self.nccl_comm_num = 1
        self.sync_batch_norm = False
        self.sequence_parallel = False
        self.sep_configs = {"degree": 1}
        # hybrid topology (proto HybridConfig:51)
        self.hybrid_configs = {
            "dp_degree": 1, "mp_degree": 1, "pp_degree": 1,
            "sharding_degree": 1, "sep_degree": 1,
        }
        self.heter_ccl_mode = False
        self.a_sync = False
        self.a_sync_configs = {}

    def __deepcopy__(self, memo):
        new = DistributedStrategy()
        for k, v in self.__dict__.items():
            setattr(new, k, copy.deepcopy(v, memo))
        return new

    def __repr__(self):
        on = [k for k, v in self.__dict__.items()
              if isinstance(v, bool) and v]
        return f"DistributedStrategy(enabled={on}, hybrid={self.hybrid_configs})"
