"""CoNLL-2005 SRL reader creator (reference: python/paddle/dataset/conll05.py:214).

Samples: 8 feature sequences + label sequence, matching the reference's
(word, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2, pred, mark, label) layout.
"""
from __future__ import annotations

__all__ = []


def get_dict():
    """reference: conll05.py:178 — (word_dict, verb_dict, label_dict)."""
    from ..text.datasets import Conll05st

    word_dict = {f"w{i}": i for i in range(Conll05st.WORD_DICT_LEN)}
    verb_dict = {f"v{i}": i for i in range(Conll05st.PRED_DICT_LEN)}
    label_dict = {f"l{i}": i for i in range(Conll05st.LABEL_DICT_LEN)}
    return word_dict, verb_dict, label_dict


def test():
    """reference: conll05.py:214."""

    def reader():
        from ..text.datasets import Conll05st

        for item in Conll05st(mode="test"):
            pred_idx, mark, word, n2, n1, c0, p1, p2, labels = item
            yield (
                [int(w) for w in word],
                [int(w) for w in n2],
                [int(w) for w in n1],
                [int(w) for w in c0],
                [int(w) for w in p1],
                [int(w) for w in p2],
                [int(w) for w in pred_idx],
                [int(w) for w in mark],
                [int(l) for l in labels],
            )

    return reader
