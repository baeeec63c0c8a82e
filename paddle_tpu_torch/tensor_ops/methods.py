"""Tensor methods — the port of ``paddle_tpu/tensor_ops/methods.py``.

``install()`` puts every function of the tensor library that
``torch.Tensor`` lacks on the port's ``Tensor`` subclass as a method
(``x.astype``, ``x.logsumexp(axis=)``, ``x.gather_nd(idx)`` ...), never
on ``torch.Tensor`` itself. A name torch already has keeps torch's
method, as the reference's ``install`` keeps a name its Tensor already
has; the operators are torch's."""
from __future__ import annotations

import torch

from ..core.tensor import Tensor
from . import creation, linalg, logic, manipulation, math, random, search

_SKIP = {"to_tensor"}

METHODS = {}
for _mod in (creation, math, manipulation, logic, search, linalg, random):
    for _name in _mod.__all__:
        _fn = getattr(_mod, _name)
        if callable(_fn) and _name not in _SKIP:
            METHODS.setdefault(_name, _fn)


def install() -> list:
    """Install the methods ``torch.Tensor`` lacks; returns their names."""
    added = []
    for name, fn in METHODS.items():
        if hasattr(torch.Tensor, name) or name in Tensor.__dict__:
            continue
        setattr(Tensor, name, fn)
        added.append(name)
    return added
