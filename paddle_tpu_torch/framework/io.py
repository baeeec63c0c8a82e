"""``paddle.save`` / ``paddle.load`` — the port of
``paddle_tpu/framework/io.py``: the same files as the reference (and as
PaddlePaddle), both ways.

- A state dict is pickled as ``{structured_name: ndarray,
  "StructuredToParameterName@@": {structured_name: name}}``; for pickle
  protocols 2 and 3 an array of more than ``(2**30 - 1) / itemsize``
  elements is sliced into ``name@@.i`` parts listed under
  ``"UnpackBigParamInfor@@"`` and re-merged on load.
- Any other object is pickled with each tensor as a ``(name, ndarray)``
  pair, which the loader turns back into a tensor.
- ``save(tensor, path, use_binary_format=True)`` and ``load`` of such a
  file speak the C++ LoDTensor stream: version u32, LoD levels, version
  u32, a ``VarType.TensorDesc`` proto, the raw data.

Tensors become numpy arrays on save (a CUDA tensor is copied to the host;
bfloat16 is widened to float32, which loads back into a bfloat16
parameter exactly), and arrays become the port's ``Tensor`` on load, on
``set_device``'s place (``return_numpy=True``: the arrays). A bfloat16
LoDTensor stream loads as bfloat16 (float32 with ``return_numpy``: numpy
has no bfloat16).
"""
from __future__ import annotations

import math
import os
import pickle
import struct

import numpy as np
import torch

from ..core.tensor import to_tensor

__all__ = ["save", "load", "save_binary_tensor", "load_binary_tensor",
           "load_binary_vars"]

_NAME_TABLE_KEY = "StructuredToParameterName@@"
_UNPACK_KEY = "UnpackBigParamInfor@@"

# framework.proto VarType.Type <-> numpy (POD entries only)
_PROTO_TO_NP = {
    0: np.dtype(np.bool_), 1: np.dtype(np.int16), 2: np.dtype(np.int32),
    3: np.dtype(np.int64), 4: np.dtype(np.float16), 5: np.dtype(np.float32),
    6: np.dtype(np.float64), 20: np.dtype(np.uint8), 21: np.dtype(np.int8),
    23: np.dtype(np.complex64), 24: np.dtype(np.complex128),
}
_NP_TO_PROTO = {v: k for k, v in _PROTO_TO_NP.items()}


_BF16 = 22  # VarType.BF16: raw bfloat16 words


def _np_dtype_for_proto(code):
    if code == _BF16:
        return np.dtype(np.uint16)  # the raw words; see _read_lod_tensor
    if code in _PROTO_TO_NP:
        return _PROTO_TO_NP[code]
    raise ValueError(f"unsupported VarType.Type {code} in tensor stream")


def _proto_for_np_dtype(dt):
    dt = np.dtype(dt)
    if dt in _NP_TO_PROTO:
        return _NP_TO_PROTO[dt]
    raise ValueError(f"dtype {dt} has no VarType.Type mapping")


# ------------------------------------------------------- mini-proto TensorDesc
def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_varint(buf: bytes, pos: int):
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _tensor_desc_bytes(dtype_code: int, dims) -> bytes:
    """VarType.TensorDesc: required Type data_type = 1; repeated int64 dims = 2
    (proto2 -> unpacked: one tag per dim). framework.proto:161."""
    out = b"\x08" + _varint(dtype_code)
    for d in dims:
        out += b"\x10" + _varint(int(d) & 0xFFFFFFFFFFFFFFFF)
    return out


def _parse_tensor_desc(buf: bytes):
    pos, dtype_code, dims = 0, None, []
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 0:
            dtype_code, pos = _read_varint(buf, pos)
        elif field == 2 and wire == 0:
            d, pos = _read_varint(buf, pos)
            if d >= 1 << 63:
                d -= 1 << 64
            dims.append(d)
        elif field == 2 and wire == 2:  # tolerate packed encoding
            ln, pos = _read_varint(buf, pos)
            end = pos + ln
            while pos < end:
                d, pos = _read_varint(buf, pos)
                if d >= 1 << 63:
                    d -= 1 << 64
                dims.append(d)
        else:  # skip unknown field
            if wire == 0:
                _, pos = _read_varint(buf, pos)
            elif wire == 2:
                ln, pos = _read_varint(buf, pos)
                pos += ln
            else:
                raise ValueError(f"unexpected wire type {wire} in TensorDesc")
    if dtype_code is None:
        raise ValueError("TensorDesc missing data_type")
    return dtype_code, dims


# ------------------------------------------------- binary LoDTensor stream
def _write_lod_tensor(f, arr: np.ndarray, lod=(), dtype_code=None):
    arr = np.ascontiguousarray(arr)
    f.write(struct.pack("<I", 0))  # LoDTensor version
    f.write(struct.pack("<Q", len(lod)))  # lod_level
    for level in lod:
        level = np.asarray(level, np.uint64)
        f.write(struct.pack("<Q", level.nbytes))
        f.write(level.tobytes())
    f.write(struct.pack("<I", 0))  # Tensor version
    if dtype_code is None:
        dtype_code = _proto_for_np_dtype(arr.dtype)
    desc = _tensor_desc_bytes(dtype_code, arr.shape)
    f.write(struct.pack("<i", len(desc)))
    f.write(desc)
    f.write(arr.tobytes())


def _read_lod_tensor(f):
    (version,) = struct.unpack("<I", f.read(4))
    if version != 0:
        raise ValueError(f"unsupported LoDTensor version {version}")
    (lod_level,) = struct.unpack("<Q", f.read(8))
    lod = []
    for _ in range(lod_level):
        (nbytes,) = struct.unpack("<Q", f.read(8))
        lod.append(np.frombuffer(f.read(nbytes), np.uint64))
    (tversion,) = struct.unpack("<I", f.read(4))
    if tversion != 0:
        raise ValueError(f"unsupported Tensor version {tversion}")
    (desc_size,) = struct.unpack("<i", f.read(4))
    dtype_code, dims = _parse_tensor_desc(f.read(desc_size))
    dt = _np_dtype_for_proto(dtype_code)
    numel = int(np.prod(dims)) if dims else 1
    data = f.read(numel * dt.itemsize)
    arr = np.frombuffer(data, dt).reshape(dims).copy()
    if dtype_code == _BF16:  # the words as bfloat16 (torch has it)
        arr = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return arr, lod


def save_binary_tensor(path_or_file, arr, lod=()):
    """Write one var in the C++ LoDTensor stream format (``save_vars``):
    a bfloat16 tensor as its raw words under ``VarType.BF16``."""
    code = None
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            code, t = _BF16, t.view(torch.int16)
        arr = torch.Tensor.numpy(t)
    else:
        arr = np.asarray(arr)
    if hasattr(path_or_file, "write"):
        _write_lod_tensor(path_or_file, arr, lod, code)
        return
    with open(path_or_file, "wb") as f:
        _write_lod_tensor(f, arr, lod, code)


def load_binary_tensor(path_or_file):
    """One var of a LoDTensor stream: an ndarray (a bfloat16 var as a
    CPU ``torch.bfloat16`` tensor)."""
    if hasattr(path_or_file, "read"):
        return _read_lod_tensor(path_or_file)[0]
    with open(path_or_file, "rb") as f:
        return _read_lod_tensor(f)[0]


def load_binary_vars(path, names):
    """Load a combined `__params__`-style file: the named vars' LoDTensor
    streams concatenated in order (reference fluid/io.py load_vars with a
    single filename)."""
    out = {}
    with open(path, "rb") as f:
        for name in names:
            out[name] = _read_lod_tensor(f)[0]
    return out


# ---------------------------------------------------------------- pickle side
def _host(v: torch.Tensor) -> np.ndarray:
    """A tensor's values as a host ndarray (bfloat16 widened to float32)."""
    t = v.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return torch.Tensor.numpy(t.cpu())


def _to_ndarray(v):
    if isinstance(v, torch.Tensor):
        return _host(v)
    return v


def _is_state_dict(obj) -> bool:
    if not isinstance(obj, dict) or not obj:
        return False
    return all(
        isinstance(v, (torch.Tensor, np.ndarray)) or np.isscalar(v)
        or (isinstance(k, str) and k in (_NAME_TABLE_KEY, "LR_Scheduler"))
        for k, v in obj.items())


def _unpack_big_params(saved: dict, protocol: int) -> dict:
    """Slice >1G-element ndarrays for pickle protocol 2/3 (reference
    fluid/framework.py:1768 _unpack_saved_dict)."""
    if not 1 < protocol < 4:
        return saved
    unpack_infor = {}
    out = dict(saved)
    for key, value in saved.items():
        if not isinstance(value, np.ndarray):
            continue
        max_elems = int((2**30 - 1) / value.dtype.itemsize)
        n = int(np.prod(value.shape))
        if n <= max_elems:
            continue
        unpack_infor[key] = {"OriginShape": value.shape, "slices": []}
        flat = value.flatten()
        out.pop(key)
        for i in range(int(math.ceil(n / max_elems))):
            part = f"{key}@@.{i}"
            unpack_infor[key]["slices"].append(part)
            out[part] = flat[i * max_elems:(i + 1) * max_elems]
    if unpack_infor:
        out[_UNPACK_KEY] = unpack_infor
    return out


def _pack_loaded_dict(obj: dict) -> dict:
    """Re-merge sliced big params (reference fluid/io.py:1804)."""
    if _UNPACK_KEY not in obj:
        return obj
    for key, info in obj[_UNPACK_KEY].items():
        slices = [obj[part] for part in info["slices"]]
        obj[key] = np.concatenate(slices).reshape(info["OriginShape"])
        for part in info["slices"]:
            obj.pop(part)
    obj.pop(_UNPACK_KEY)
    return obj


def _pack_nested(obj):
    """Nested (non-state-dict) objects: tensors become (name, ndarray)
    tuples — exactly what real Paddle's reduce_varbase emits, so its load
    reconstructs them (reference io.py:243 reduce_varbase)."""
    if isinstance(obj, torch.Tensor):
        return (getattr(obj, "name", None) or "tensor", _host(obj))
    if isinstance(obj, dict):
        return {k: _pack_nested(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_pack_nested(v) for v in obj)
    return obj


class _TensorPayload:
    """Round-1/2 private format — kept so old checkpoints still load."""

    __slots__ = ("array",)

    def __init__(self, array: np.ndarray):
        self.array = array


def _looks_like_reduced_tensor(obj) -> bool:
    return (isinstance(obj, tuple) and len(obj) == 2
            and isinstance(obj[0], (str, type(None)))
            and isinstance(obj[1], np.ndarray))


def _tensor(arr):
    """A loaded array (or bfloat16 tensor) as the port's Tensor."""
    if isinstance(arr, torch.Tensor):
        return to_tensor(arr)
    return to_tensor(np.asarray(arr))


def _unpack_loaded(obj, return_numpy, _root=True):
    if isinstance(obj, torch.Tensor):  # a bfloat16 LoDTensor stream
        return _host(obj) if return_numpy else _tensor(obj)
    if isinstance(obj, _TensorPayload):
        return obj.array if return_numpy else _tensor(obj.array)
    if _looks_like_reduced_tensor(obj):
        _, arr = obj  # a torch tensor carries no Paddle name
        return arr if return_numpy else _tensor(arr)
    if isinstance(obj, np.ndarray):
        return obj if return_numpy else _tensor(obj)
    if isinstance(obj, dict):
        if _UNPACK_KEY in obj:
            obj = _pack_loaded_dict(obj)
        # the name table is top-level save metadata (reference pops it only
        # at the root); a nested dict may legitimately hold whole inner
        # state dicts — leave their keys alone
        return {k: _unpack_loaded(v, return_numpy, _root=False)
                for k, v in obj.items() if not (_root and k == _NAME_TABLE_KEY)}
    if isinstance(obj, (list, tuple)) and not _looks_like_reduced_tensor(obj):
        return type(obj)(_unpack_loaded(v, return_numpy, _root=False)
                         for v in obj)
    return obj


def save(obj, path, protocol=4, **configs):
    """reference io.py:572. State dicts are written in real Paddle's
    `.pdparams` layout; use_binary_format=True writes a single tensor in the
    C++ LoDTensor stream format."""
    if not 1 < protocol < 5:  # reference: "Expected 1<'protocol'<5"
        raise ValueError(
            f"Expected 1<'protocol'<5, but received protocol={protocol}")
    d = os.path.dirname(path) if isinstance(path, str) else None
    if d:
        os.makedirs(d, exist_ok=True)
    if configs.get("use_binary_format"):
        if not isinstance(obj, (torch.Tensor, np.ndarray)):
            raise TypeError(
                "use_binary_format=True expects a single Tensor, got "
                f"{type(obj)}")
        save_binary_tensor(path, obj)
        return
    if _is_state_dict(obj):
        saved = {}
        name_table = {}
        for k, v in obj.items():
            if isinstance(v, torch.Tensor):
                # bfloat16 widens losslessly to float32, as the
                # reference saves it (set_state_dict casts back)
                saved[k] = _host(v)
                name_table[k] = getattr(v, "name", None) or k
            else:
                saved[k] = _to_ndarray(v)
        saved[_NAME_TABLE_KEY] = name_table
        saved = _unpack_big_params(saved, protocol)
    else:
        saved = _pack_nested(obj)
    if hasattr(path, "write"):
        pickle.dump(saved, path, protocol=protocol)
        return
    with open(path, "wb") as f:
        pickle.dump(saved, f, protocol=protocol)


def load(path, return_numpy=False, **configs):
    """reference io.py:788. Accepts files written by real Paddle
    (`paddle.save` state dicts, nested pickles with reduce-tuples, binary
    var streams) and by this framework (incl. the old private format)."""
    import io as _io

    if hasattr(path, "read"):  # file-like (may be unseekable): buffer it
        f = _io.BytesIO(path.read())
        close = False
    else:
        f = open(path, "rb")
        close = True
    try:
        first = f.read(1)
        f.seek(0)
        if first == b"\x80":  # pickle protocol >= 2 (all we ever write)
            obj = pickle.load(f)
            return _unpack_loaded(obj, return_numpy)
        try:  # not a pickle: try the binary var stream
            return _unpack_loaded(_read_lod_tensor(f)[0], return_numpy)
        except Exception as e:  # noqa: BLE001
            raise ValueError(
                f"{path!r} is neither a pickle nor a LoDTensor stream: {e}"
            ) from None
    finally:
        if close:
            f.close()
