"""The port's key schedule (``paddle_tpu_torch.core.rng``) and its 64-bit
draws (``paddle_tpu_torch.random``) against the JAX package's
``paddle_tpu.core.rng`` and ``jax.random`` under the x64 mode that
``import paddle_tpu`` turns on.

Keys, splits and folds are integer arithmetic: the port's host-side words
must equal the reference's ``key_data`` exactly. The 64-bit bits, the
float64 uniforms and the Bernoulli draws are bit manipulation and one
compare: equal bit for bit (the uniforms over ``[minval, maxval)`` round
one multiply-add, as XLA's compiled ``u * span + lo`` does).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu  # noqa: F401  (x64 on, as the reference's dropout runs)
import paddle_tpu_torch
from paddle_tpu.core import rng as J
from paddle_tpu_torch import random as R
from paddle_tpu_torch.core import rng as T

SEEDS = [0, 1, 2**31 - 2]
SHAPES = [(1,), (7,), (3, 97), (2, 3, 5), (4, 1, 33)]


def _data(k):
    return tuple(int(w) for w in np.asarray(jax.random.key_data(k)))


@pytest.mark.parametrize("seed", SEEDS)
def test_generator_keys_equal_reference(seed):
    jg, tg = J.Generator(seed), T.Generator(seed)
    np.testing.assert_array_equal(tg.get_state(),
                                  np.asarray(jg.get_state()))
    for _ in range(10):
        assert tg.next_key() == _data(jg.next_key())
    np.testing.assert_array_equal(tg.get_state(),
                                  np.asarray(jg.get_state()))
    # set_state moves both to the same place
    state = np.asarray(jg.get_state())
    tg2 = T.Generator(99)
    tg2.set_state(state)
    assert tg2.next_key() == _data(jg.next_key())


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5])
def test_trace_scope_counters_equal_reference(seed):
    base = jax.random.key(seed)
    with J.trace_rng_scope(base):
        want = [_data(J.next_rng_key()) for _ in range(80)]
    with T.trace_rng_scope(np.asarray(jax.random.key_data(base))):
        got = [T.next_rng_key() for _ in range(80)]
    assert got == want
    # a pair of ints serves as well as the key's data, and the scope
    # counts from 1 again on every entry
    with T.trace_rng_scope(_data(base)):
        assert T.next_rng_key() == want[0]
    # folds of the tensor implementation equal the host's
    tk = torch.tensor(_data(base), dtype=torch.int64)
    folds = R.fold_in(tk.expand(80, 2), torch.arange(1, 81))
    assert [tuple(r) for r in folds.tolist()] == want


def test_outside_a_scope_the_default_generator_draws():
    paddle_tpu_torch.seed(5)
    J.seed(5)
    got = [T.next_rng_key() for _ in range(3)]
    want = [_data(J.next_rng_key()) for _ in range(3)]
    assert got == want
    assert T.default_generator().initial_seed == 5


def test_snapshot_replays_draws():
    with T.trace_rng_scope((3, 4)):
        T.next_rng_key()
        snap = T.rng_snapshot()
        first = [T.next_rng_key() for _ in range(3)]
        with T.replaying(snap):
            again = [T.next_rng_key() for _ in range(3)]
        assert again == first
        assert T.next_rng_key() == T.fold_in_words((3, 4), 5)
    paddle_tpu_torch.seed(11)
    snap = T.rng_snapshot()
    first = [T.next_rng_key() for _ in range(2)]
    with T.replaying(snap):
        assert [T.next_rng_key() for _ in range(2)] == first


@pytest.mark.parametrize("seed", SEEDS + [2**31 + 5])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_64_bit_draws_bit_for_bit(seed, shape):
    jk, tk = jax.random.key(seed), R.key(seed, "cpu")
    want = np.asarray(jax.random.bits(jk, shape, jnp.uint64))
    got = R.random_bits(tk, shape, bit_width=64).numpy().view(np.uint64)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        R.uniform(tk, shape, dtype=torch.float64).numpy(),
        np.asarray(jax.random.uniform(jk, shape, jnp.float64)))
    for lo, hi in ((-2.5, 3.1), (0.25, 0.5)):
        for dt, jdt in ((torch.float64, jnp.float64),
                        (torch.float32, jnp.float32)):
            np.testing.assert_array_equal(
                R.uniform(tk, shape, lo, hi, dtype=dt).numpy(),
                np.asarray(jax.random.uniform(jk, shape, jdt, minval=lo,
                                              maxval=hi)))
    for p in (0.0, 0.1, 0.5, 0.9, 1.0):
        np.testing.assert_array_equal(
            R.bernoulli(tk, p, shape).numpy(),
            np.asarray(jax.random.bernoulli(jk, p, shape)))


def test_bad_bit_width_and_dtype_raise():
    tk = R.key(0, "cpu")
    with pytest.raises(ValueError, match="bit_width"):
        R.random_bits(tk, (3,), bit_width=16)
    with pytest.raises(TypeError, match="float32 or float64"):
        R.uniform(tk, (3,), dtype=torch.bfloat16)
