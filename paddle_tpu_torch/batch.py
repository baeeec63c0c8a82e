"""``paddle.batch`` (reference: ``paddle_tpu/batch.py``; Paddle's
``python/paddle/batch.py``): a reader decorator."""
from __future__ import annotations


def batch(reader, batch_size, drop_last=False):
    """A reader creator of lists of ``batch_size`` samples of ``reader``;
    the last, shorter list is kept unless ``drop_last``."""

    def batch_reader():
        b = []
        for item in reader():
            b.append(item)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b

    return batch_reader
