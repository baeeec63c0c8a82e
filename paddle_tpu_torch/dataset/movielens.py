"""MovieLens reader creators (reference: python/paddle/dataset/movielens.py).

Samples: [uid, gender, age, job, mid, title ids, category ids, score].
"""
from __future__ import annotations


__all__ = []


def _reader_creator(mode):
    def reader():
        from ..text.datasets import Movielens

        for item in Movielens(mode=mode):
            uid, gender, age, job, mid, title, categories, rating = item
            yield [
                int(uid), int(gender), int(age), int(job), int(mid),
                [int(t) for t in title], [int(c) for c in categories],
                float(rating),
            ]

    return reader


def train():
    return _reader_creator("train")


def test():
    return _reader_creator("test")


def max_user_id():
    """reference: movielens.py:204."""
    return 6040


def max_movie_id():
    """reference: movielens.py:211."""
    return 3952


def max_job_id():
    """reference: movielens.py:218."""
    return 20


def age_table():
    """reference: movielens.py:40 — bucketized ages."""
    return [1, 18, 25, 35, 45, 50, 56]
