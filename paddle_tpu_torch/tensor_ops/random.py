"""Random functions — the port of ``paddle_tpu/tensor_ops/random.py``.

Every draw takes the next key of the port's key schedule
(``core.rng.next_rng_key``: the process-wide generator ``seed`` resets,
split at every draw, as the reference's) and hashes it with the port's
threefry (:mod:`paddle_tpu_torch.random`), so for the same seed the
draws are the reference's: bit for bit for ``rand``, ``uniform``,
``randint``, ``randint_like``, ``bernoulli``, ``randperm``,
``multinomial`` and ``uniform_``, and within float32 (or float64)
rounding for ``randn``, ``normal``, ``standard_normal``, ``normal_`` and
``exponential_``, whose ``erfinv`` / ``log1p`` are torch's, not XLA's.
``poisson`` does not match: the reference runs XLA's rejection sampler,
whose loop draws a data-dependent number of keys; the port draws from
torch's Poisson sampler seeded by the key's words (one key consumed, so
later draws stay aligned). As in the reference, ``normal`` and
``multinomial``'s noise are float64 (its default float with x64 on).

The integer arithmetic of ``randint`` (unsigned 64-bit remainders) runs
on the host; the result moves to ``set_device``'s place."""
from __future__ import annotations

import numpy as np
import torch

from .. import random as prng
from .._device import resolve_device
from ..core.dtype import get_default_dtype, to_torch_dtype
from ..core.rng import key_words, next_rng_key, split_words
from ..core.tensor import as_port, as_tensor_arg

__all__ = [
    "rand", "randn", "randint", "randint_like", "uniform", "normal",
    "standard_normal", "bernoulli", "multinomial", "randperm", "poisson",
    "uniform_", "normal_", "exponential_",
]

_SQRT2 = float(np.sqrt(2))


def _shape(shape) -> tuple:
    if isinstance(shape, torch.Tensor):
        return tuple(int(v) for v in shape.tolist())
    if isinstance(shape, int):
        return (shape,)
    return tuple(int(s.item()) if isinstance(s, torch.Tensor) else int(s)
                 for s in shape)


def _dt(dtype) -> torch.dtype:
    return to_torch_dtype(dtype or get_default_dtype())


def _key(words, device) -> torch.Tensor:
    return torch.tensor(words, dtype=torch.int64, device=device)


def _uniform(words, shape, dtype, lo=0.0, hi=1.0, device=None):
    """Uniform ``[lo, hi)`` of float32 or float64 (another float dtype:
    drawn in float32, then cast)."""
    dev = resolve_device(device)
    draw = dtype if dtype in (torch.float32, torch.float64) \
        else torch.float32
    u = prng.uniform(_key(words, dev), shape, lo, hi, dtype=draw)
    return u.to(dtype)


def _normal(words, shape, dtype, device=None):
    """``sqrt(2) * erfinv(u)``, ``u`` uniform over ``(-1, 1)``."""
    draw = dtype if dtype in (torch.float32, torch.float64) \
        else torch.float32
    npdt = np.float32 if draw == torch.float32 else np.float64
    lo = float(np.nextafter(npdt(-1.0), npdt(0.0)))
    u = _uniform(words, shape, draw, lo, 1.0, device)
    return (torch.erfinv(u) * torch.tensor(_SQRT2, dtype=draw,
                                           device=u.device)).to(dtype)


def _gumbel(words, shape, dtype, device=None):
    tiny = float(torch.finfo(dtype).tiny)
    u = _uniform(words, shape, dtype, tiny, 1.0, device)
    return -torch.log(-torch.log(u))


def rand(shape, dtype=None, name=None):
    return as_port(_uniform(next_rng_key(), _shape(shape), _dt(dtype)))


def randn(shape, dtype=None, name=None):
    return as_port(_normal(next_rng_key(), _shape(shape), _dt(dtype)))


standard_normal = randn


def _randint_words(words, shape, low, high, dtype):
    """The reference's ``randint``: two draws of ``nbits`` bits, their
    remainders by the span combined in unsigned ``nbits`` arithmetic."""
    nbits = torch.iinfo(dtype).bits
    if nbits not in (32, 64):
        raise TypeError(f"randint draws 32- or 64-bit integers; got {dtype}")
    utype = np.uint64 if nbits == 64 else np.uint32
    k1, k2 = split_words(words, 2)
    cpu = torch.device("cpu")
    hi_bits, lo_bits = (prng.random_bits(_key(k, cpu), shape, nbits)
                        .numpy() for k in (k1, k2))
    if nbits == 64:
        hi_bits, lo_bits = hi_bits.view(np.uint64), lo_bits.view(np.uint64)
    else:
        hi_bits, lo_bits = hi_bits.astype(np.uint32), lo_bits.astype(
            np.uint32)
    info = np.iinfo(np.int64 if nbits == 64 else np.int32)
    low = int(np.clip(low, info.min, info.max))
    high_c = int(np.clip(high, info.min, info.max))
    span = utype(1) if high_c <= low else utype((high_c - low)
                                                % (1 << nbits))
    if high > info.max and high_c > low:
        span = utype(span + utype(1))
    with np.errstate(over="ignore"):
        mult = utype(utype(1 << (nbits // 2)) % span) if span else utype(0)
        mult = utype(mult * mult) % span if span else utype(0)
        off = (hi_bits % span) * mult + lo_bits % span if span else \
            hi_bits * 0
        off = off % span if span else off
    out = (np.int64(low) + off.astype(np.int64)) if nbits == 64 else \
        (np.int32(low) + off.astype(np.int32))
    return torch.from_numpy(np.asarray(out)).to(dtype)


def randint(low=0, high=None, shape=(1,), dtype="int64", name=None):
    if high is None:
        low, high = 0, low
    out = _randint_words(next_rng_key(), _shape(shape), int(low), int(high),
                         to_torch_dtype(dtype))
    return as_port(out.to(resolve_device(None)))


def randint_like(x, low=0, high=None, dtype=None, name=None):
    x = as_tensor_arg(x)
    if high is None:
        low, high = 0, low
    dt = to_torch_dtype(dtype) if dtype else x.dtype
    out = _randint_words(next_rng_key(), tuple(x.shape), int(low), int(high),
                         dt)
    return as_port(out.to(x.device))


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None):
    words = key_words(seed) if seed else next_rng_key()
    return as_port(_uniform(words, _shape(shape), _dt(dtype), float(min),
                            float(max)))


def normal(mean=0.0, std=1.0, shape=None, name=None):
    """float64 draws (the reference's default float) times ``std`` plus
    ``mean``; tensor ``mean`` / ``std`` broadcast to the shape."""
    if isinstance(mean, torch.Tensor) or isinstance(std, torch.Tensor):
        m, s = (v if isinstance(v, torch.Tensor) else None
                for v in (mean, std))
        like = m if m is not None else s
        shp = torch.broadcast_shapes(
            tuple(m.shape) if m is not None else (),
            tuple(s.shape) if s is not None else ())
        z = _normal(next_rng_key(), shp, torch.float64, like.device)
        return as_port(z * std + mean)
    z = _normal(next_rng_key(), _shape(shape), torch.float64)
    return as_port(z * std + mean)


def bernoulli(x, name=None):
    """1 where a uniform of ``x``'s dtype falls below ``x``."""
    x = as_tensor_arg(x)
    u = _uniform(next_rng_key(), tuple(x.shape), x.dtype, device=x.device)
    return as_port((u < x).to(x.dtype))


def multinomial(x, num_samples=1, replacement=False, name=None):
    """Indices drawn with probabilities ``x`` (the last axis): with
    replacement the reference's ``categorical`` (one-dimensional ``x``),
    without it the Gumbel top-k over float64 noise."""
    x = as_tensor_arg(x)
    logits = torch.log(torch.clamp(x, min=1e-30))
    words = next_rng_key()
    if replacement:
        if x.dim() != 1:
            raise ValueError("multinomial with replacement draws from a "
                             "one-dimensional x (the reference's shape "
                             "rule)")
        g = _gumbel(words, (int(num_samples), x.shape[-1]), logits.dtype,
                    x.device)
        out = torch.argmax(g + logits, dim=-1)
    else:
        g = _gumbel(words, tuple(logits.shape), torch.float64, x.device)
        out = torch.topk(logits + g, int(num_samples), dim=-1).indices
    return as_port(out.to(torch.int64))


def randperm(n, dtype="int64", name=None):
    """The reference's shuffle: ``ceil(3 ln n / ln(2**32 - 1))`` rounds of
    a stable sort of ``arange(n)`` by 32-bit keys."""
    dev = resolve_device(None)
    x = torch.arange(int(n), dtype=torch.int64, device=dev)
    rounds = int(np.ceil(3 * np.log(max(1, int(n)))
                         / np.log(np.iinfo(np.uint32).max)))
    words = next_rng_key()
    for _ in range(rounds):
        words, sub = split_words(words, 2)
        keys = prng.random_bits(_key(sub, dev), (int(n),))
        x = x[torch.sort(keys, stable=True).indices]
    return as_port(x.to(to_torch_dtype(dtype)))


def poisson(x, name=None):
    x = as_tensor_arg(x)
    k1, k2 = next_rng_key()
    gen = torch.Generator(device=x.device).manual_seed((k1 << 32) | k2)
    return as_port(torch.poisson(x.detach().double(), generator=gen)
                   .to(x.dtype))


def uniform_(x, min=-1.0, max=1.0, seed=0, name=None):
    words = key_words(seed) if seed else next_rng_key()
    with torch.no_grad():
        torch.Tensor.copy_(x, _uniform(words, tuple(x.shape), x.dtype,
                                       float(min), float(max), x.device))
    return x


def normal_(x, mean=0.0, std=1.0, name=None):
    z = _normal(next_rng_key(), tuple(x.shape), x.dtype, x.device)
    with torch.no_grad():
        torch.Tensor.copy_(x, z * std + mean)
    return x


def exponential_(x, lam=1.0, name=None):
    u = _uniform(next_rng_key(), tuple(x.shape), x.dtype, device=x.device)
    with torch.no_grad():
        torch.Tensor.copy_(x, -torch.log1p(-u) / lam)
    return x
