"""Where the port's entry points run.

Every entry point takes an explicit ``device``. ``None`` means the card:
the port is written for one NVIDIA Hopper GPU, and a caller who wants the
CPU (the tests, which hold the port against the JAX package) says so. A
missing card is an error, never a silent move to the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; anything else as given. Raises RuntimeError
    when the resolved device is CUDA and no CUDA device is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: pass device='cpu' to run the "
            "port on the CPU (its kernels then take their plain PyTorch "
            "versions)")
    return dev
