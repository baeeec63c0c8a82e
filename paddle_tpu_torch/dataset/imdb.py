"""IMDB reader creators (reference: python/paddle/dataset/imdb.py:108,130).

Samples: (list of token ids, 0/1 sentiment). word_idx mirrors the reference
signature; the synthetic corpus uses a fixed 5000-word vocabulary, so
word_dict() returns that range.
"""
from __future__ import annotations

__all__ = []


def word_dict():
    """reference: imdb.py:147 — token → id map."""
    return {f"w{i}": i for i in range(5000)}


def _reader_creator(mode, word_idx):
    def reader():
        from ..text.datasets import Imdb

        for doc, label in Imdb(mode=mode):
            yield [int(t) for t in doc], int(label)

    return reader


def train(word_idx):
    """reference: imdb.py:108."""
    return _reader_creator("train", word_idx)


def test(word_idx):
    """reference: imdb.py:130."""
    return _reader_creator("test", word_idx)
