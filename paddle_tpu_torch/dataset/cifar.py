"""CIFAR reader creators (reference: python/paddle/dataset/cifar.py:80-160).

Samples: (float32[3072] in [0, 1], int label).
"""
from __future__ import annotations


import numpy as np

__all__ = []


def _reader_creator(cls_name, mode, cycle=False):
    def reader():
        from ..vision import datasets

        ds = getattr(datasets, cls_name)(mode=mode)

        def one_pass():
            for img, label in ds:
                sample = np.asarray(img, dtype=np.float32).reshape(-1)
                yield sample / 255.0 if sample.max() > 1.5 else sample, int(label)

        if cycle:
            while True:
                for item in one_pass():
                    yield item
        else:
            for item in one_pass():
                yield item

    return reader


def train100():
    """reference: dataset/cifar.py:80."""
    return _reader_creator("Cifar100", "train")


def test100():
    """reference: dataset/cifar.py:100."""
    return _reader_creator("Cifar100", "test")


def train10(cycle=False):
    """reference: dataset/cifar.py:120."""
    return _reader_creator("Cifar10", "train", cycle=cycle)


def test10(cycle=False):
    """reference: dataset/cifar.py:143."""
    return _reader_creator("Cifar10", "test", cycle=cycle)
