"""Flowers-102 reader creators (reference: python/paddle/dataset/flowers.py:144-214).

Samples: (float32 CHW image flattened per the reference's mapper, int label).
"""
from __future__ import annotations

import numpy as np

__all__ = []


def _reader_creator(mode, use_xmap=True, cycle=False):
    def reader():
        from ..vision.datasets import Flowers

        ds = Flowers(mode=mode)

        def one_pass():
            for img, label in ds:
                yield np.asarray(img, dtype=np.float32), int(label)

        if cycle:
            while True:
                for item in one_pass():
                    yield item
        else:
            for item in one_pass():
                yield item

    return reader


def train(mapper=None, buffered_size=1024, use_xmap=True, cycle=False):
    """reference: flowers.py:144."""
    return _reader_creator("train", use_xmap, cycle)


def test(mapper=None, buffered_size=1024, use_xmap=True, cycle=False):
    """reference: flowers.py:178."""
    return _reader_creator("test", use_xmap, cycle)


def valid(mapper=None, buffered_size=1024, use_xmap=True):
    """reference: flowers.py:212."""
    return _reader_creator("valid", use_xmap)
