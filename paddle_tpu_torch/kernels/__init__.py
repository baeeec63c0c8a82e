"""Kernels of the port: the plain PyTorch composites and the hand-written
Hopper kernels that replace the JAX package's Pallas kernels.

The submodules are exported as modules (``paged_attention``,
``ragged_paged_attention`` and ``flash_attention`` are also the names of
functions inside them):

- :mod:`.attention` — ``sdpa_reference``, the composite attention, and
  the ``sdpa`` dispatch;
- :mod:`.paged_attention` — ``paged_write``, ``ragged_mask``,
  ``paged_gather`` and the ``paged_attention`` dispatch;
- :mod:`.ragged_paged_attention`, :mod:`.flash_attention`,
  :mod:`.fused_optimizer`, :mod:`.fused_layernorm`, :mod:`.dropout`,
  :mod:`.global_norm` — each Hopper kernel's wrapper, its plain version
  and its launch counters;
- :mod:`._build` — builds and loads the CUDA sources under ``csrc/``.
"""
from . import (attention, dropout, flash_attention, fused_layernorm,
               fused_optimizer, global_norm, paged_attention,
               ragged_paged_attention)

__all__ = ["attention", "dropout", "flash_attention", "fused_layernorm",
           "fused_optimizer", "global_norm", "paged_attention",
           "ragged_paged_attention"]
