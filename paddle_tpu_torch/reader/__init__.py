"""The reader-composition library (reference: ``paddle_tpu/reader/``;
Paddle's ``python/paddle/reader/__init__.py``).

A *reader creator* is a zero-argument callable returning an iterable of
samples; these decorators compose creators.
"""
from .decorator import (  # noqa: F401
    ComposeNotAligned,
    buffered,
    cache,
    chain,
    compose,
    firstn,
    map_readers,
    multiprocess_reader,
    shuffle,
    xmap_readers,
)

__all__ = []
