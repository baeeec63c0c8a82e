"""MNIST reader creators (reference: python/paddle/dataset/mnist.py:98,120).

Samples: (float32[784] in [-1, 1], int label) — the reference normalizes
images to [-1, 1] and flattens to 784.
"""
from __future__ import annotations

import numpy as np

__all__ = []


def _reader_creator(mode):
    def reader():
        from ..vision.datasets import MNIST

        ds = MNIST(mode=mode)
        for img, label in ds:
            img = np.asarray(img, dtype=np.float32).reshape(-1)
            yield img / 127.5 - 1.0, int(label)

    return reader


def train():
    """reference: dataset/mnist.py:98."""
    return _reader_creator("train")


def test():
    """reference: dataset/mnist.py:120."""
    return _reader_creator("test")
