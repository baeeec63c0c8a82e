"""VOC2012 segmentation reader creators (reference: python/paddle/dataset/voc2012.py).

Samples: (image CHW float32, segmentation label HW int64).
"""
from __future__ import annotations

import numpy as np

__all__ = []


def _reader_creator(mode):
    def reader():
        from ..vision.datasets import VOC2012

        for img, label in VOC2012(mode=mode):
            yield np.asarray(img, dtype=np.float32), np.asarray(label, dtype=np.int64)

    return reader


def train():
    return _reader_creator("train")


def test():
    return _reader_creator("test")


def val():
    return _reader_creator("valid")
