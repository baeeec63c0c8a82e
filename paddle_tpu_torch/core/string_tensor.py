"""Host-side string and vocabulary tensors — the port of
``paddle_tpu/core/string_tensor.py`` (plain Python and numpy, kept here
as the port's own copy).

A ``StringTensor`` is a 1-D batch of Python strings and a ``VocabTensor``
a token -> id map; strings never reach the device. Their consumer is the
tokenizer (``text.tokenizer_ops``), whose output is a batch of ids on
the device asked for.
"""
from __future__ import annotations

import numpy as np

__all__ = ["StringTensor", "VocabTensor", "to_string_tensor", "to_map_tensor"]


class StringTensor:
    """1-D (batch) array of python strings, dtype 'pstring'."""

    dtype = "pstring"
    place = "cpu"

    def __init__(self, values, name=None):
        if isinstance(values, StringTensor):
            values = values._values
        if isinstance(values, str):
            values = [values]
        self._values = [str(v) for v in values]
        self.name = name

    @property
    def shape(self):
        return [len(self._values)]

    def numpy(self):
        return np.asarray(self._values, dtype=object)

    def tolist(self):
        return list(self._values)

    def __len__(self):
        return len(self._values)

    def __getitem__(self, i):
        out = self._values[i]
        return StringTensor(out) if isinstance(out, list) else out

    def __iter__(self):
        return iter(self._values)

    def __eq__(self, other):
        if isinstance(other, StringTensor):
            return self._values == other._values
        return NotImplemented

    def __repr__(self):
        head = ", ".join(repr(v) for v in self._values[:4])
        tail = ", ..." if len(self._values) > 4 else ""
        return f"StringTensor(shape={self.shape}, [{head}{tail}])"


class VocabTensor:
    """token -> id map (reference VarType.VOCAB via set_vocab)."""

    dtype = "vocab"
    place = "cpu"

    def __init__(self, mapping: dict, name=None):
        self._map = {str(k): int(v) for k, v in dict(mapping).items()}
        self.name = name

    def get_map_tensor(self):
        return dict(self._map)

    def __getitem__(self, token):
        return self._map[token]

    def __contains__(self, token):
        return token in self._map

    def get(self, token, default=None):
        return self._map.get(token, default)

    def __len__(self):
        return len(self._map)

    def __repr__(self):
        return f"VocabTensor({len(self._map)} tokens)"


def to_string_tensor(string_values, name=None) -> StringTensor:
    """reference test_faster_tokenizer_op.py:33 — a STRINGS tensor on cpu."""
    return StringTensor(string_values, name=name)


def to_map_tensor(string_dict, name=None) -> VocabTensor:
    """reference test_faster_tokenizer_op.py:49 — a VOCAB tensor on cpu."""
    return VocabTensor(string_dict, name=name)
