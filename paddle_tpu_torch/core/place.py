"""Places — the port of ``paddle_tpu/core/place.py``: ``Place``,
``CPUPlace``, ``CUDAPlace``, ``set_device``, ``get_device``,
``device_count``.

A place names a torch device: ``CPUPlace()`` the host, ``CUDAPlace(i)``
card ``i``. ``set_device("gpu")`` / ``("gpu:1")`` / ``("cpu")`` records
the caller's choice, which every entry point given ``device=None`` then
reads (``_device.resolve_device``); with no choice made the default is
the card, and a card chosen but absent raises there. The reference's
``TPUPlace`` has no counterpart: the port runs on no TPU.
"""
from __future__ import annotations

import torch

from .. import _device

__all__ = ["Place", "CPUPlace", "CUDAPlace", "CUDAPinnedPlace",
           "set_device", "get_device", "device_count",
           "is_compiled_with_cuda"]


class Place:
    """A device identity: ``device_type`` and an index."""

    device_type = "undefined"

    def __init__(self, device_id: int = 0):
        self._device_id = int(device_id)

    def get_device_id(self) -> int:
        return self._device_id

    def torch_device(self) -> torch.device:
        return torch.device("cpu") if self.device_type == "cpu" \
            else torch.device("cuda", self._device_id)

    def __eq__(self, other):
        return (isinstance(other, Place)
                and self.device_type == other.device_type
                and self._device_id == other._device_id)

    def __hash__(self):
        return hash((self.device_type, self._device_id))

    def __repr__(self):
        return f"Place({self.device_type}:{self._device_id})"


class CPUPlace(Place):
    device_type = "cpu"

    def __init__(self):
        super().__init__(0)


class CUDAPlace(Place):
    """Card ``device_id`` (Paddle calls its type ``gpu``)."""
    device_type = "gpu"


class CUDAPinnedPlace(CPUPlace):
    """Page-locked host memory: a host place (tensors made for it are
    pinned by ``to_tensor``)."""


def place_of(device: torch.device) -> Place:
    """The place of a torch device."""
    if device.type == "cuda":
        return CUDAPlace(device.index or 0)
    return CPUPlace()


def set_device(device: str) -> Place:
    """``paddle.set_device``: ``"gpu"``, ``"gpu:i"`` (``"cuda"`` alike)
    or ``"cpu"``; every entry point given no device runs there. Returns
    the place."""
    name, _, idx = str(device).partition(":")
    idx = int(idx) if idx else 0
    if name in ("gpu", "cuda"):
        place = CUDAPlace(idx)
    elif name == "cpu":
        place = CPUPlace()
    else:
        raise ValueError(f"Unsupported device {device!r}; use 'gpu[:i]' or "
                         f"'cpu'")
    _device._CURRENT = place.torch_device()
    return place


def _current_place() -> Place:
    cur = _device._CURRENT
    return CUDAPlace(0) if cur is None else place_of(cur)


def get_device() -> str:
    """``"cpu"`` or ``"gpu:i"``: the place entry points run on (the card
    when no choice was made)."""
    p = _current_place()
    return "cpu" if p.device_type == "cpu" else f"gpu:{p.get_device_id()}"


def device_count() -> int:
    """The CUDA cards visible to this process."""
    return torch.cuda.device_count()


def is_compiled_with_cuda() -> bool:
    """True: the port's kernels are CUDA C++ (built at first use on the
    card). Whether a card is present is ``device_count()``."""
    return True
