"""Device memory statistics — the port of ``paddle_tpu/core/memory.py``
over torch's CUDA caching allocator (``torch.cuda.memory_stats``).

``memory_stats`` gives the reference's keys (``bytes_in_use``,
``peak_bytes_in_use``, ``bytes_limit``, ``pool_bytes``, ``num_allocs``)
beside torch's own. A CPU device reports nothing (``{}``, as the
reference's backends that keep no stats); with no device given the
stats are the card's, which must be present. The reference's
``set_preallocate`` has no counterpart: torch's allocator grows on
demand and has no preallocating pool.
"""
from __future__ import annotations

import gc

import torch

from .._device import resolve_device

__all__ = ["memory_stats", "memory_allocated", "max_memory_allocated",
           "memory_reserved", "set_memory_fraction", "empty_cache",
           "device_memory_limit"]


def _dev(device=None) -> torch.device:
    if isinstance(device, int):
        device = torch.device("cuda", device)
    elif device is not None and hasattr(device, "torch_device"):
        device = device.torch_device()
    return resolve_device(device)


def memory_stats(device=None) -> dict:
    """The allocator's statistics of ``device`` (None: ``set_device``'s
    choice, else the card): the reference's names first, then torch's
    own keys; ``{}`` for a CPU device."""
    dev = _dev(device)
    if dev.type != "cuda":
        return {}
    raw = dict(torch.cuda.memory_stats(dev))
    ref = {"bytes_in_use": raw.get("allocated_bytes.all.current", 0),
           "peak_bytes_in_use": raw.get("allocated_bytes.all.peak", 0),
           "pool_bytes": raw.get("reserved_bytes.all.current", 0),
           "num_allocs": raw.get("allocation.all.allocated", 0),
           "bytes_limit": torch.cuda.get_device_properties(dev)
           .total_memory}
    return {**ref, **raw}


def memory_allocated(device=None) -> int:
    """Live bytes in the device allocator."""
    return int(memory_stats(device).get("bytes_in_use", 0))


def max_memory_allocated(device=None) -> int:
    return int(memory_stats(device).get("peak_bytes_in_use", 0))


def memory_reserved(device=None) -> int:
    """Bytes the caching allocator holds (at least the allocated)."""
    return int(memory_stats(device).get("pool_bytes", 0))


def device_memory_limit(device=None) -> int:
    """The card's memory in bytes (0 for a CPU device)."""
    return int(memory_stats(device).get("bytes_limit", 0))


def set_memory_fraction(fraction: float, device=None) -> None:
    """Cap this process's share of the card's memory
    (``FLAGS_fraction_of_gpu_memory_to_use``)."""
    if not 0.0 < fraction <= 1.0:
        raise ValueError(f"fraction must be in (0, 1]; got {fraction}")
    torch.cuda.set_per_process_memory_fraction(float(fraction), _dev(device))


def empty_cache() -> None:
    """Release the allocator's cached blocks (after collecting garbage)."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
