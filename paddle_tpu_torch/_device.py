"""Where the port's entry points run.

Every entry point takes an explicit ``device``. ``None`` means the
caller's choice made with ``paddle_tpu_torch.set_device`` (``"gpu"``,
``"gpu:1"``, ``"cpu"``), and with no choice made the card: the port is
written for one NVIDIA Hopper GPU, and a caller who wants the CPU (the
tests, which hold the port against the JAX package) says so. A missing
card is an error, never a silent move to the CPU.
"""
from __future__ import annotations

import torch

#: the device ``set_device`` chose (a ``torch.device``), or None: the card
_CURRENT = None


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``set_device``'s choice, else ``cuda``; anything else
    as given. Raises RuntimeError when the resolved device is CUDA and no
    CUDA device is present."""
    if device is None:
        device = _CURRENT if _CURRENT is not None else "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: pass device='cpu' (or call "
            "set_device('cpu')) to run the port on the CPU (its kernels "
            "then take their plain PyTorch versions)")
    return dev
