"""paddle_tpu_torch.distributed.fleet — the port of
``paddle_tpu/distributed/fleet``'s collective training: the ``fleet``
façade (``init``, ``distributed_model``, ``distributed_optimizer``,
``worker_index`` ...), ``DistributedStrategy``, the meta-optimizers, the
meta-parallel layers (tensor and pipeline parallelism), the hybrid step
and activation recompute. As in the reference, the name ``recompute``
here is the function; the module is
``importlib.import_module("paddle_tpu_torch.distributed.fleet.recompute")``.
The file systems (``fs``: ``LocalFS``, ``HDFSClient``) and elastic
training (``elastic``) are here too; the parameter-server roles,
datasets and data generators are ROADMAP Queue 1 item 12e-2c."""
from . import elastic, fs, meta_optimizers, meta_parallel
from .distributed_strategy import DistributedStrategy
from .fs import HDFSClient, LocalFS
from .fleet_base import (Fleet, HybridParallelOptimizer, UtilBase,
                         distributed_model, distributed_optimizer, fleet,
                         get_hybrid_communicate_group, init)
from .hybrid_train import HybridParallelModel, hybrid_train_step
from .meta_optimizers import (DGCMomentumOptimizer, GradientMergeOptimizer,
                              LocalSGDOptimizer)
from .meta_parallel import (ColumnParallelLinear, LayerDesc,
                            ParallelCrossEntropy, PipelineLayer,
                            RowParallelLinear, SegmentLayers,
                            SharedLayerDesc, VocabParallelEmbedding,
                            apply_megatron_specs, get_rng_state_tracker,
                            model_parallel_random_seed)
from .pipeline_parallel import PipelineParallel
from .recompute import RecomputeLayer, apply_recompute, recompute
from ..topology import CommunicateTopology, HybridCommunicateGroup

is_first_worker = fleet.is_first_worker
worker_index = fleet.worker_index
worker_num = fleet.worker_num
barrier_worker = fleet.barrier_worker

__all__ = ["fleet", "Fleet", "init", "distributed_model",
           "distributed_optimizer", "get_hybrid_communicate_group",
           "HybridParallelOptimizer", "UtilBase", "DistributedStrategy",
           "elastic", "fs", "HDFSClient", "LocalFS",
           "HybridParallelModel", "hybrid_train_step", "PipelineParallel",
           "meta_optimizers", "meta_parallel", "GradientMergeOptimizer",
           "LocalSGDOptimizer", "DGCMomentumOptimizer",
           "ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "ParallelCrossEntropy", "LayerDesc",
           "SharedLayerDesc", "SegmentLayers", "PipelineLayer",
           "apply_megatron_specs", "get_rng_state_tracker",
           "model_parallel_random_seed", "recompute", "apply_recompute",
           "RecomputeLayer", "CommunicateTopology", "HybridCommunicateGroup",
           "is_first_worker", "worker_index", "worker_num", "barrier_worker"]
