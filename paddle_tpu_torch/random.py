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
  index, the two output words xor-ed; with ``bit_width=64`` the two words
  joined, ``(w1 << 32) | w2``;
- a *window* ``(full_shape, starts)`` draws a slice of a larger tensor:
  each position of ``shape`` takes the counter of its flat index in
  ``full_shape``, at ``starts`` plus its own coordinates. The bits of a
  window are the same slice of the full tensor's bits, since a counter
  depends on the key and the index only (the partitionable threefry): a
  rank holding a slice draws its part of the one mask the reference
  draws over the whole tensor;
- ``uniform``: the top 23 bits as a float32 mantissa in ``[1, 2)``, minus
  1, scaled to ``[minval, maxval)``; in float64 (what the reference draws
  for a Python-float probability, its process running with x64 on) the
  top 52 bits of the 64-bit word;
- ``bernoulli(key, p, shape)``: ``uniform(key, shape, float64) < p``;
- ``gumbel``: ``-log(-log(uniform(tiny, 1)))`` (the reference's "low"
  mode);
- ``categorical(key, logits)``: ``argmax(logits + gumbel)``.
"""
from __future__ import annotations

import torch

from ._device import resolve_device

__all__ = ["key", "fold_in", "split", "random_bits", "uniform", "gumbel",
           "categorical", "bernoulli", "threefry2x32", "window_counters"]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
#: the smallest normal float32, ``uniform``'s lower bound in ``gumbel``
_TINY = float(torch.finfo(torch.float32).tiny)
#: the exponent word of 1.0 in float64
_ONE_F64 = 0x3FF0000000000000


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


def window_counters(shape, window):
    """``(dims, strides, base)``: the flat index in ``full_shape`` of the
    position with coordinates ``c`` of ``shape`` is ``base + sum(c[d] *
    strides[d])``, over ``dims`` with unit dimensions dropped and
    adjacent ones merged where the slice is whole along the inner one.
    Raises where the slice leaves the full shape."""
    full, starts = (tuple(int(v) for v in t) for t in window)
    shape = tuple(int(v) for v in shape)
    if not len(full) == len(starts) == len(shape):
        raise ValueError(f"window {window} does not match shape {shape}")
    stride, base, fstrides = 1, 0, [0] * len(full)
    for d in range(len(full) - 1, -1, -1):
        if starts[d] < 0 or starts[d] + shape[d] > full[d]:
            raise ValueError(f"window {window}: shape {shape} leaves the "
                             f"full shape along dimension {d}")
        fstrides[d] = stride
        base += starts[d] * stride
        stride *= full[d]
    dims, strides = [], []
    for s, st in zip(shape, fstrides):
        if s == 1:
            continue
        if dims and strides[-1] == s * st:
            dims[-1] *= s
            strides[-1] = st
        else:
            dims.append(s)
            strides.append(st)
    return dims, strides, base


def _counters(shape, device, window=None):
    """The flat element index of each position of ``shape`` (with a
    ``window``, its flat index in the full shape), as (high, low) 32-bit
    words."""
    if window is None:
        n = 1
        for d in shape:
            n *= int(d)
        idx = torch.arange(n, dtype=torch.int64, device=device)
    else:
        dims, strides, base = window_counters(shape, window)
        idx = torch.full((), base, dtype=torch.int64, device=device)
        for i, (n, st) in enumerate(zip(dims, strides)):
            pos = torch.arange(n, dtype=torch.int64, device=device) * st
            idx = idx + pos.view((n,) + (1,) * (len(dims) - i - 1))
    idx = idx.reshape(tuple(shape))
    return idx >> 32, idx & _MASK


def split(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``num`` new keys from each key of ``keys [..., 2]``: ``[..., num,
    2]``."""
    hi, lo = _counters((num,), keys.device)
    y1, y2 = threefry2x32(keys[..., 0, None], keys[..., 1, None], hi, lo)
    return torch.stack([y1, y2], dim=-1)


def _words(keys: torch.Tensor, shape, window=None):
    """The two output words of the hash of each position of ``shape``
    (in ``window``'s full shape, where given) under each key of ``keys
    [..., 2]``: int64 ``[..., *shape]`` each."""
    shape = tuple(shape)
    hi, lo = _counters(shape, keys.device, window)
    pad = (None,) * len(shape)
    k1 = keys[..., 0][(..., *pad)]
    k2 = keys[..., 1][(..., *pad)]
    lead = keys.shape[:-1]
    return tuple(w.expand(*lead, *shape)
                 for w in threefry2x32(k1, k2, hi, lo))


def random_bits(keys: torch.Tensor, shape, bit_width: int = 32,
                window=None) -> torch.Tensor:
    """Random bits for each position of ``shape`` under each key of
    ``keys [..., 2]``: int64 ``[..., *shape]``. 32 bits: values in ``[0,
    2**32)``; 64 bits: the unsigned 64-bit words as int64 (a word of
    ``2**63`` or more reads negative; ``.numpy().view(np.uint64)`` gives
    the reference's values)."""
    y1, y2 = _words(keys, shape, window)
    if bit_width == 32:
        return y1 ^ y2
    if bit_width == 64:
        return (y1 << 32) | y2  # the shift wraps into the sign bit
    raise ValueError(f"bit_width must be 32 or 64; got {bit_width}")


def uniform(keys: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0, dtype=torch.float32,
            window=None) -> torch.Tensor:
    """Uniform in ``[minval, maxval)`` of ``dtype`` (float32 or float64):
    ``[..., *shape]``."""
    if dtype == torch.float32:
        bits = random_bits(keys, shape, window=window)
        f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    elif dtype == torch.float64:
        y1, y2 = _words(keys, shape, window)
        # the 64-bit word shifted right by 12, formed from its halves so
        # that no shift crosses the sign bit of int64
        f = ((y1 << 20) | (y2 >> 12) | _ONE_F64).view(torch.float64)
    else:
        raise TypeError(f"uniform draws float32 or float64; got {dtype}")
    # filled on the device (new_tensor would copy from the host and wait)
    one, lo, hi = (torch.full((), v, dtype=f.dtype, device=f.device)
                   for v in (1.0, minval, maxval))
    span = hi - lo  # rounded to dtype as the reference
    # the reference's compiled ``u * span + lo`` is one multiply-add,
    # rounded once; addcmul rounds once too
    return torch.maximum(lo, torch.addcmul(lo, f - one, span))


def bernoulli(keys: torch.Tensor, p: float, shape,
              window=None) -> torch.Tensor:
    """``True`` with probability ``p`` at each position of ``shape``: bool
    ``[..., *shape]``. ``p`` is a Python float, compared in float64 with
    float64 uniforms, as the reference draws ``jax.random.bernoulli(key,
    p, shape)`` with x64 on."""
    return uniform(keys, shape, dtype=torch.float64,
                   window=window) < float(p)


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
