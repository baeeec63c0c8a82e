"""WMT16 multimodal reader creators (reference: python/paddle/dataset/wmt16.py:232-330).

Samples: (src ids, trg ids shifted-in, trg ids shifted-out).
"""
from __future__ import annotations

__all__ = []


def _reader_creator(mode, src_dict_size, trg_dict_size, src_lang):
    def reader():
        from ..text.datasets import WMT16

        ds = WMT16(
            mode=mode,
            src_dict_size=src_dict_size,
            trg_dict_size=trg_dict_size,
            lang=src_lang,
        )
        for src, trg_in, trg_out in ds:
            yield (
                [int(t) for t in src],
                [int(t) for t in trg_in],
                [int(t) for t in trg_out],
            )

    return reader


def train(src_dict_size, trg_dict_size, src_lang="en"):
    """reference: wmt16.py:232."""
    return _reader_creator("train", src_dict_size, trg_dict_size, src_lang)


def test(src_dict_size, trg_dict_size, src_lang="en"):
    """reference: wmt16.py:281."""
    return _reader_creator("test", src_dict_size, trg_dict_size, src_lang)


def validation(src_dict_size, trg_dict_size, src_lang="en"):
    """reference: wmt16.py:330."""
    return _reader_creator("val", src_dict_size, trg_dict_size, src_lang)


def get_dict(lang, dict_size, reverse=False):
    """reference: wmt16.py:379 — synthetic vocab map."""
    d = {f"{lang}{i}": i for i in range(dict_size)}
    if reverse:
        return {v: k for k, v in d.items()}
    return d
