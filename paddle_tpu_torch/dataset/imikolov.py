"""PTB/imikolov reader creators (reference: python/paddle/dataset/imikolov.py:120,145).

NGRAM samples: n-tuples of token ids; SEQ samples: (src_seq, trg_seq).
"""
from __future__ import annotations


__all__ = []


class DataType:
    NGRAM = 1
    SEQ = 2


def build_dict(min_word_freq=50):
    """reference: imikolov.py:55 — word → id map (synthetic vocab)."""
    return {f"w{i}": i for i in range(2074)}


def _reader_creator(mode, word_idx, n, data_type):
    def reader():
        from ..text.datasets import Imikolov

        ds = Imikolov(mode=mode, window_size=max(n, 2))
        for gram in ds:
            if data_type == DataType.NGRAM:
                yield tuple(int(g) for g in gram[:n])
            else:
                ids = [int(g) for g in gram]
                yield ids[:-1], ids[1:]

    return reader


def train(word_idx, n, data_type=DataType.NGRAM):
    """reference: imikolov.py:120."""
    return _reader_creator("train", word_idx, n, data_type)


def test(word_idx, n, data_type=DataType.NGRAM):
    """reference: imikolov.py:145."""
    return _reader_creator("test", word_idx, n, data_type)
