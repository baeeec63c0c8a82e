"""The random-key schedule — the port of ``paddle_tpu/core/rng.py``
(``Generator``, ``trace_rng_scope``, ``next_rng_key``, ``seed``).

Every draw of randomness (dropout) takes the next key from one place,
``next_rng_key()``, and the key comes from one of two sources, as in the
reference:

- outside a scope, the process-wide ``Generator``, which splits its key at
  every draw (``self._key, sub = split(self._key)``);
- inside ``trace_rng_scope(base_key)``, a counter folded into the base key:
  draw ``n`` of the scope is ``fold_in(base_key, n)``, ``n`` counting from
  1. The reference runs this under ``jax.jit``, where the counter is a
  Python int fixed at trace time; the port's scope counts the same way
  each time it is entered, so a training step that enters it with the
  same base key draws the same keys.

A key here is a pair of Python ints, its two 32-bit words, and ``split``
and ``fold_in`` of a key run on the host (:func:`split_words`,
:func:`fold_in_words`: ``random.threefry2x32`` on ints). A draw schedule
thus costs no device launch and no read from the device: a kernel takes
the two words as launch arguments. ``random``'s tensor functions take
``torch.tensor(words)``.

Recompute (``distributed.fleet.recompute``) replays the keys of a
checkpointed block in its second forward: :func:`rng_snapshot` copies the
active source before the first forward and :func:`replaying` installs the
copy for the second, so the recomputed masks equal the first ones.

A scope may also carry a :class:`ShardWindow`: the rows (and heads)
that this rank holds of the tensors the reference masks whole. A
hybrid-parallel step gives it (``distributed.fleet.hybrid_train``), and
``nn.functional.dropout`` draws a rank's slice of the reference's one
mask through it (``kernels.dropout``'s window). The snapshot of a scope
keeps its window, so a recompute draws the same slice.

``RNGStatesTracker`` keeps named streams for tensor parallelism, as the
reference's does: ``rng_state(name)`` makes a named ``Generator`` the
process-wide source inside its block, and ``seed`` reseeds every named
stream from the new seed.
"""
from __future__ import annotations

import contextlib
import functools
import threading

import numpy as np

from ..random import threefry2x32

__all__ = ["Generator", "trace_rng_scope", "default_generator", "seed",
           "next_rng_key", "key_words", "fold_in_words", "split_words",
           "rng_snapshot", "replaying", "RNGStatesTracker",
           "get_rng_tracker", "ShardWindow", "shard_window"]

_MASK = 0xFFFFFFFF


def key_words(seed: int) -> tuple[int, int]:
    """The key of an integer seed, as ``jax.random.key(seed)`` makes it:
    the 64-bit seed's high and low words."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return seed >> 32, seed & _MASK


def _as_words(key) -> tuple[int, int]:
    """A key given as two words (a pair, a ``[2]`` tensor or array, read
    to the host once) as a pair of ints."""
    k1, k2 = (int(w) for w in (key.tolist() if hasattr(key, "tolist")
                               else key))
    return k1 & _MASK, k2 & _MASK


@functools.lru_cache(maxsize=8192)
def fold_in_words(key: tuple[int, int], data: int) -> tuple[int, int]:
    """``fold_in(key, data)`` on the host: ``threefry2x32(key, (0,
    data))`` with ``data`` taken as an unsigned 32-bit word, as
    ``jax.random.fold_in`` takes it. Memoised: a training step that enters
    its scope with the same base key draws the same folds every step."""
    return threefry2x32(key[0], key[1], 0, int(data) & _MASK)


def split_words(key: tuple[int, int], num: int = 2) -> list:
    """``split(key, num)`` on the host: key ``i`` is ``threefry2x32(key,
    (hi(i), lo(i)))``."""
    return [threefry2x32(key[0], key[1], i >> 32, i & _MASK)
            for i in range(num)]


class Generator:
    """The eager source: a key made from ``seed`` at the first draw, split
    at every draw into the next state and the key handed out."""

    def __init__(self, seed: int = 0):
        self._seed = int(seed)
        self._key = None  # made from the seed at the first draw
        self._lock = threading.Lock()

    def manual_seed(self, seed: int):
        with self._lock:
            self._seed = int(seed)
            self._key = None
        return self

    @property
    def initial_seed(self) -> int:
        return self._seed

    def next_key(self) -> tuple[int, int]:
        with self._lock:
            if self._key is None:
                self._key = key_words(self._seed)
            self._key, sub = split_words(self._key)
            return sub

    def get_state(self) -> np.ndarray:
        """The current key's two words, ``uint32 [2]`` (the reference's
        ``key_data``)."""
        with self._lock:
            if self._key is None:
                self._key = key_words(self._seed)
            return np.asarray(self._key, dtype=np.uint32)

    def set_state(self, state) -> None:
        key = _as_words(np.asarray(state).reshape(-1))
        with self._lock:
            self._key = key

    def copy(self) -> "Generator":
        """An independent generator at this one's state."""
        out = Generator(self._seed)
        out._key = self._key
        return out


_default_generator = Generator(int(np.random.randint(0, 2**31 - 1)))


class ShardWindow:
    """Where this rank's activations lie in the tensors the reference
    masks whole: ``rows = (index, count)``, the rank holds part ``index``
    of ``count`` equal parts along dimension 0 (the batch); ``heads``
    likewise along the heads dimension of an attention layout ``[b, h,
    s, d]``; None: the rank holds the whole dimension."""

    def __init__(self, rows=None, heads=None):
        self.rows = None if rows is None else tuple(int(v) for v in rows)
        self.heads = None if heads is None else tuple(int(v) for v in heads)

    def of(self, shape, heads_axis=None):
        """``(full_shape, starts)`` of a tensor of ``shape`` (its heads
        along ``heads_axis``, if any), or None where the rank holds it
        whole."""
        full, starts = list(shape), [0] * len(shape)
        for axis, part in ((0, self.rows), (heads_axis, self.heads)):
            if part is not None and axis is not None and len(shape) > axis \
                    and part[1] > 1:
                starts[axis] = part[0] * shape[axis]
                full[axis] = part[1] * shape[axis]
        if full == list(shape):
            return None
        return tuple(full), tuple(starts)


class _TraceRNG:
    """A scope's source: the counter folded into the base key, and the
    scope's :class:`ShardWindow`."""

    def __init__(self, base_key, counter: int = 0, window=None):
        self.base_key = _as_words(base_key)
        self.counter = counter
        self.window = window

    def next_key(self) -> tuple[int, int]:
        self.counter += 1
        return fold_in_words(self.base_key, self.counter)

    def copy(self) -> "_TraceRNG":
        return _TraceRNG(self.base_key, self.counter, self.window)


_tls = threading.local()


def _trace_rng():
    return getattr(_tls, "trace_rng", None)


@contextlib.contextmanager
def trace_rng_scope(base_key, window: ShardWindow | None = None):
    """Draw ``fold_in(base_key, n)`` for the ``n``-th draw inside the
    scope. ``base_key``: two 32-bit words (a pair of ints, or a ``[2]``
    integer tensor or array, read once); ``window``: this rank's slice
    of the masked tensors (module docstring)."""
    prev = _trace_rng()
    _tls.trace_rng = _TraceRNG(base_key, window=window)
    try:
        yield
    finally:
        _tls.trace_rng = prev


def default_generator() -> Generator:
    return _default_generator


def seed(s: int) -> Generator:
    """``paddle.seed``: reseed the process-wide generator, the named
    streams of :func:`get_rng_tracker` and torch's default generators
    (which draw a module's initial weights when no generator is given,
    as the reference's initialisers draw from its seed)."""
    _default_generator.manual_seed(s)
    get_rng_tracker().reset(s)
    import torch

    torch.manual_seed(int(s))
    return _default_generator


def next_rng_key() -> tuple[int, int]:
    """The key of the next draw, as two 32-bit words (see the module
    docstring for its source)."""
    src = _trace_rng()
    if src is not None:
        return src.next_key()
    return _default_generator.next_key()


def shard_window() -> ShardWindow | None:
    """The active scope's :class:`ShardWindow` (None: no scope, or the
    rank holds its tensors whole)."""
    # a replayed process-wide generator (``replaying``) carries none
    return getattr(_trace_rng(), "window", None)


def rng_snapshot():
    """A copy of the source the next draw would come from (the scope's
    counter, else the process-wide generator), for :func:`replaying`."""
    src = _trace_rng()
    return (src if src is not None else _default_generator).copy()


@contextlib.contextmanager
def replaying(snapshot):
    """Draw from a copy of ``snapshot`` inside the block, on this thread,
    leaving the live sources untouched: the draws repeat those made after
    the snapshot was taken."""
    prev = _trace_rng()
    _tls.trace_rng = snapshot.copy()
    try:
        yield
    finally:
        _tls.trace_rng = prev


class RNGStatesTracker:
    """Named random streams for tensor parallelism: a "global" stream is
    the same on every rank (dropout on replicated activations), a "local"
    one differs per rank (dropout on sharded ones). Each stream is a
    :class:`Generator`; ``rng_state(name)`` makes it the process-wide
    source for the block."""

    def __init__(self):
        self._states: dict[str, Generator] = {}

    def reset(self, base_seed: int | None = None):
        """No seed: forget every stream. A seed: reseed stream ``i`` (in
        name order) with ``base_seed + 1000 + i``."""
        if base_seed is None:
            self._states.clear()
        else:
            for i, (_, gen) in enumerate(sorted(self._states.items())):
                gen.manual_seed(base_seed + 1000 + i)

    def add(self, name: str, seed: int):
        if name in self._states:
            raise ValueError(f"RNG state {name!r} already added")
        self._states[name] = Generator(seed)

    def states(self) -> dict:
        return dict(self._states)

    @contextlib.contextmanager
    def rng_state(self, name: str = "global_seed"):
        if name not in self._states:
            raise ValueError(f"RNG state {name!r} not added; call add() first")
        global _default_generator
        prev = _default_generator
        _default_generator = self._states[name]
        try:
            yield
        finally:
            _default_generator = prev


_rng_tracker = RNGStatesTracker()


def get_rng_tracker() -> RNGStatesTracker:
    return _rng_tracker
