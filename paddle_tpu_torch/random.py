"""Counter-based random numbers — the port of the parts of ``jax.random``
that the JAX package's sampling calls (``key``, ``fold_in``, ``split``,
``random_bits``, ``uniform``, ``gumbel``, ``categorical``), for the
``threefry2x32`` generator with ``jax_threefry_partitionable`` on, the
default of the JAX release the reference is pinned to.

The same key gives the same bits as the reference, so a sampled token of
the port equals the reference's wherever the logits are equal. A key is
a ``[..., 2]`` int64 tensor holding two unsigned 32-bit words; every
operation is torch integer arithmetic on int64 masked to 32 bits, so it
runs on whatever device its tensors live on and never reads them back to
the host. Leading dimensions of a key tensor are batch dimensions: each
key draws its own stream.

- ``key(seed)``: the 64-bit seed bit-cast to ``(seed >> 32, seed &
  0xFFFFFFFF)``;
- ``fold_in(key, data)``: ``threefry2x32(key, (0, data))``;
- ``split(key, num)``: ``threefry2x32(key, (hi(i), lo(i)))`` for ``i <
  num``;
- ``random_bits(key, shape)``: the same hash of each element's flat
  index, the two output words xor-ed;
- ``uniform``: the top 23 bits as a float32 mantissa in ``[1, 2)``, minus
  1, scaled to ``[minval, maxval)``;
- ``gumbel``: ``-log(-log(uniform(tiny, 1)))`` (the reference's "low"
  mode);
- ``categorical(key, logits)``: ``argmax(logits + gumbel)``.
"""
from __future__ import annotations

import torch

from ._device import resolve_device

__all__ = ["key", "fold_in", "split", "random_bits", "uniform", "gumbel",
           "categorical", "threefry2x32"]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
#: the smallest normal float32, ``uniform``'s lower bound in ``gumbel``
_TINY = float(torch.finfo(torch.float32).tiny)


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of the counter pairs ``(x1,
    x2)`` under the key words ``(k1, k2)``; int64 tensors holding 32-bit
    words, broadcast together. Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x1, x2


def key(seed: int, device=None) -> torch.Tensor:
    """The key of an integer seed: ``[2]`` int64 on ``device`` (``None``
    = the card; raises when there is none)."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return torch.tensor([seed >> 32, seed & _MASK], dtype=torch.int64,
                        device=resolve_device(device))


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """Each key of ``keys [..., 2]`` with ``data`` (an int or an integer
    tensor broadcast against the keys' batch dimensions) folded in:
    ``[..., 2]``."""
    data = torch.as_tensor(data, device=keys.device).to(torch.int64) & _MASK
    y1, y2 = threefry2x32(keys[..., 0], keys[..., 1],
                          torch.zeros_like(data), data)
    return torch.stack(torch.broadcast_tensors(y1, y2), dim=-1)


def _counters(shape, device):
    """The flat element index of each position of ``shape``, as (high,
    low) 32-bit words."""
    n = 1
    for d in shape:
        n *= int(d)
    idx = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    return idx >> 32, idx & _MASK


def split(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``num`` new keys from each key of ``keys [..., 2]``: ``[..., num,
    2]``."""
    hi, lo = _counters((num,), keys.device)
    y1, y2 = threefry2x32(keys[..., 0, None], keys[..., 1, None], hi, lo)
    return torch.stack([y1, y2], dim=-1)


def random_bits(keys: torch.Tensor, shape) -> torch.Tensor:
    """32 random bits for each position of ``shape`` under each key of
    ``keys [..., 2]``: int64 ``[..., *shape]`` in ``[0, 2**32)``."""
    shape = tuple(shape)
    hi, lo = _counters(shape, keys.device)
    lead = keys.shape[:-1]
    pad = (None,) * len(shape)
    k1 = keys[..., 0][(..., *pad)]
    k2 = keys[..., 1][(..., *pad)]
    y1, y2 = threefry2x32(k1, k2, hi, lo)
    return (y1 ^ y2).expand(*lead, *shape)


def uniform(keys: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """float32 uniform in ``[minval, maxval)``: ``[..., *shape]``."""
    bits = random_bits(keys, shape)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    one = f.new_tensor(1.0)
    lo = f.new_tensor(minval)
    span = f.new_tensor(maxval) - lo  # rounded to float32 as the reference
    return torch.maximum(lo, (f - one) * span + lo)


def gumbel(keys: torch.Tensor, shape) -> torch.Tensor:
    """float32 standard Gumbel noise: ``[..., *shape]``."""
    return -torch.log(-torch.log(uniform(keys, shape, _TINY, 1.0)))


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """Sample an index of the last axis of float32 ``logits`` per row.

    ``keys`` is either one key ``[2]``, whose noise covers the whole of
    ``logits`` (each element's counter is its flat index, as the
    reference draws ``categorical(key, logits)``), or one key per row,
    ``logits.shape[:-1] + (2,)``, each drawing noise for its own row
    (the reference's ``vmap`` over rows). Returns int64 ``logits.shape[:-1]``."""
    if keys.dim() == 1:
        noise = gumbel(keys, logits.shape)
    else:
        noise = gumbel(keys, logits.shape[-1:])
    return torch.argmax(noise + logits, dim=-1)
