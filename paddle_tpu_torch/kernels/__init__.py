"""Kernels of the port: the plain PyTorch composites and the hand-written
Hopper kernels that replace the JAX package's Pallas kernels.

The submodules are exported as modules (``paged_attention`` and
``ragged_paged_attention`` are also the names of functions inside them):

- :mod:`.attention` — ``sdpa_reference``, the composite attention;
- :mod:`.paged_attention` — ``paged_write``, ``ragged_mask``,
  ``paged_gather`` and the ``paged_attention`` dispatch;
- :mod:`.ragged_paged_attention` — the Hopper kernel's wrapper, its plain
  version and its launch counter;
- :mod:`._build` — builds and loads the CUDA sources under ``csrc/``.
"""
from . import attention, paged_attention, ragged_paged_attention

__all__ = ["attention", "paged_attention", "ragged_paged_attention"]
