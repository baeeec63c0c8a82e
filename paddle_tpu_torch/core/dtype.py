"""Dtypes — the port of ``paddle_tpu/core/dtype.py``.

Paddle names a dtype by a string (``"float32"``, ``"int64"`` ...); the
port's dtypes are torch's own, so the root names ``paddle_tpu_torch.
float32`` ... are ``torch.float32`` ... and ``x.dtype ==
paddle.float32`` holds for any tensor. :func:`convert_dtype` gives the
canonical name of any spelling (a string or its alias, a torch or numpy
dtype, a Python type); :func:`to_torch_dtype` the torch dtype.

The default dtype (``float32``) is what a Python float becomes in
``to_tensor`` and what the creation and random functions make; it is
this module's own setting and leaves ``torch.get_default_dtype`` alone.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["convert_dtype", "to_torch_dtype", "get_default_dtype",
           "set_default_dtype", "is_floating", "is_integer", "DTYPES"]

#: canonical name -> torch dtype
DTYPES = {
    "bool": torch.bool,
    "uint8": torch.uint8,
    "int8": torch.int8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float64": torch.float64,
    "complex64": torch.complex64,
    "complex128": torch.complex128,
}
_TORCH_TO_NAME = {v: k for k, v in DTYPES.items()}

_ALIASES = {
    "float": "float32",
    "double": "float64",
    "half": "float16",
    "int": "int32",
    "long": "int64",
    "bfloat": "bfloat16",
    "bool_": "bool",
}

_DEFAULT_DTYPE = "float32"


def convert_dtype(dtype) -> str | None:
    """The canonical name of ``dtype`` (None stays None); raises
    ValueError for a dtype the port does not have."""
    if dtype is None:
        return None
    if isinstance(dtype, torch.dtype):
        if dtype in _TORCH_TO_NAME:
            return _TORCH_TO_NAME[dtype]
        raise ValueError(f"Unknown dtype: {dtype!r}")
    if isinstance(dtype, str):
        name = _ALIASES.get(dtype, dtype)
        if name in DTYPES:
            return name
        raise ValueError(f"Unknown dtype: {dtype!r}")
    name = getattr(dtype, "name", None) or np.dtype(dtype).name
    name = _ALIASES.get(name, name)
    if name in DTYPES:
        return name
    raise ValueError(f"Unknown dtype: {dtype!r}")


def to_torch_dtype(dtype) -> torch.dtype | None:
    """The torch dtype of any spelling ``convert_dtype`` takes."""
    if dtype is None:
        return None
    return DTYPES[convert_dtype(dtype)]


def set_default_dtype(dtype) -> None:
    """Set the float dtype Python floats and the creation functions
    default to; only float dtypes are taken."""
    global _DEFAULT_DTYPE
    name = convert_dtype(dtype)
    if name not in ("float16", "bfloat16", "float32", "float64"):
        raise TypeError(f"set_default_dtype only accepts float dtypes, got "
                        f"{dtype}")
    _DEFAULT_DTYPE = name


def get_default_dtype() -> str:
    return _DEFAULT_DTYPE


def is_floating(dtype) -> bool:
    return convert_dtype(dtype) in ("float16", "bfloat16", "float32",
                                    "float64")


def is_integer(dtype) -> bool:
    return convert_dtype(dtype) in ("uint8", "int8", "int16", "int32",
                                    "int64")
