"""``paddle.io`` of the port: the map-style and iterable datasets and the
samplers (``paddle_tpu/io/dataset.py``, ``sampler.py``), the
``DataLoader`` with its single, threaded and multiprocess paths
(``dataloader.py``) and length bucketing (``bucketing.py``). Datasets
and workers are host Python and numpy; the loader hands each batch over
as port ``Tensor``\\ s on its device (the card unless the caller asked for
the CPU)."""
from .dataset import (ChainDataset, ComposeDataset, ConcatDataset, Dataset,
                      IterableDataset, RandomSplit, Subset, TensorDataset,
                      random_split)
from .sampler import (BatchSampler, DistributedBatchSampler, RandomSampler,
                      Sampler, SequenceSampler, WeightedRandomSampler)
from .dataloader import (DataLoader, WorkerInfo, default_collate_fn,
                         get_worker_info)
from .bucketing import (LengthBucketSampler, bucket_boundaries,
                        pad_sequence_batch, pad_to_bucket)

__all__ = ["ChainDataset", "ComposeDataset", "ConcatDataset", "Dataset",
           "IterableDataset", "RandomSplit", "Subset", "TensorDataset",
           "random_split", "BatchSampler", "DistributedBatchSampler",
           "RandomSampler", "Sampler", "SequenceSampler",
           "WeightedRandomSampler", "DataLoader", "WorkerInfo",
           "default_collate_fn", "get_worker_info", "LengthBucketSampler",
           "bucket_boundaries", "pad_sequence_batch", "pad_to_bucket"]
