"""WMT14 en-fr reader creators (reference: python/paddle/dataset/wmt14.py:120,142).

Samples: (src ids, trg ids shifted-in, trg ids shifted-out).
"""
from __future__ import annotations

__all__ = []


def _reader_creator(mode, dict_size):
    def reader():
        from ..text.datasets import WMT14

        for src, trg_in, trg_out in WMT14(mode=mode, dict_size=dict_size):
            yield (
                [int(t) for t in src],
                [int(t) for t in trg_in],
                [int(t) for t in trg_out],
            )

    return reader


def train(dict_size):
    """reference: wmt14.py:120."""
    return _reader_creator("train", dict_size)


def test(dict_size):
    """reference: wmt14.py:142."""
    return _reader_creator("test", dict_size)
