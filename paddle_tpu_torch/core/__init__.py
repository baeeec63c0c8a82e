"""paddle_tpu_torch.core — the port of the parts of ``paddle_tpu/core`` the
training path needs: ``rng``, the random-key schedule."""
from . import rng

__all__ = ["rng"]
