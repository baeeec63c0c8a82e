"""UCI housing reader creators (reference: python/paddle/dataset/uci_housing.py:92,117).

Samples: (float32[13] normalized features, float32[1] price).
"""
from __future__ import annotations

import numpy as np

__all__ = []

feature_names = [
    "CRIM", "ZN", "INDUS", "CHAS", "NOX", "RM", "AGE",
    "DIS", "RAD", "TAX", "PTRATIO", "B", "LSTAT", "convert",
]


def _reader_creator(mode):
    def reader():
        from ..text.datasets import UCIHousing

        ds = UCIHousing(mode=mode)
        for feat, price in ds:
            yield np.asarray(feat, dtype=np.float32), np.asarray(
                price, dtype=np.float32
            ).reshape(-1)

    return reader


def train():
    """reference: dataset/uci_housing.py:92."""
    return _reader_creator("train")


def test():
    """reference: dataset/uci_housing.py:117."""
    return _reader_creator("test")
