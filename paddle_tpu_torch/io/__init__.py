"""``paddle.io`` of the port: the map-style and iterable datasets and the
samplers (``paddle_tpu/io/dataset.py``, ``sampler.py``). Host Python and
numpy: a dataset yields host arrays, and the caller moves a batch to the
card. ``DataLoader``, its workers and ``bucketing`` are ROADMAP Queue 1
item 12d."""
from .dataset import (ChainDataset, ComposeDataset, ConcatDataset, Dataset,
                      IterableDataset, RandomSplit, Subset, TensorDataset,
                      random_split)
from .sampler import (BatchSampler, DistributedBatchSampler, RandomSampler,
                      Sampler, SequenceSampler, WeightedRandomSampler)

__all__ = ["ChainDataset", "ComposeDataset", "ConcatDataset", "Dataset",
           "IterableDataset", "RandomSplit", "Subset", "TensorDataset",
           "random_split", "BatchSampler", "DistributedBatchSampler",
           "RandomSampler", "Sampler", "SequenceSampler",
           "WeightedRandomSampler"]
