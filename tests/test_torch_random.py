"""The port's threefry random numbers (``paddle_tpu_torch.random``) against
``jax.random`` under the x64 mode that ``import paddle_tpu`` turns on and
the partitionable threefry the JAX package runs with.

Keys, folds, splits, raw bits and uniforms are integer arithmetic and bit
manipulation: they must be equal bit for bit. The Gumbel noise applies
two float32 logarithms, and the two libraries' ``log`` may each round one
ulp apart: each log stage is held within 1 ulp of its own output, and the
composed noise within the bound that follows from it — an inner error of
one ulp of ``y = -log(u)`` moves ``-log(y)`` by at most ``ulp(y) / y <=
2**-23``, plus the outer log's own ulp.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu  # noqa: F401  (x64 on, as the JAX engine runs)
from paddle_tpu_torch import random as R

SEEDS = [0, 1, 2**31 + 5]


def _data(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


def test_partitionable_threefry_is_on():
    assert jax.config.jax_threefry_partitionable
    assert jax.config.jax_enable_x64


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_fold_in_bit_for_bit(seed):
    jk, tk = jax.random.key(seed), R.key(seed, "cpu")
    np.testing.assert_array_equal(tk.numpy(), _data(jk))
    rids = torch.arange(10)
    per_rid = R.fold_in(tk.expand(10, 2), rids)
    ts = torch.arange(65)
    for rid in range(10):
        jr = jax.random.fold_in(jk, rid)
        np.testing.assert_array_equal(per_rid[rid].numpy(), _data(jr))
        want = np.stack([_data(jax.random.fold_in(jr, t)) for t in range(65)])
        got = R.fold_in(per_rid[rid].expand(65, 2), ts)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", [2, 3, 64])
def test_split_bit_for_bit(seed, num):
    jk, tk = jax.random.key(seed), R.key(seed, "cpu")
    np.testing.assert_array_equal(R.split(tk, num).numpy(),
                                  _data(jax.random.split(jk, num)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(7,), (3, 97), (2, 3, 5)])
def test_random_bits_and_uniform_bit_for_bit(seed, shape):
    jk, tk = jax.random.key(seed), R.key(seed, "cpu")
    bits = jax.random.bits(jk, shape, jnp.uint32)
    np.testing.assert_array_equal(R.random_bits(tk, shape).numpy(),
                                  np.asarray(bits).astype(np.int64))
    np.testing.assert_array_equal(
        R.uniform(tk, shape).numpy(),
        np.asarray(jax.random.uniform(jk, shape, jnp.float32)))
    tiny = float(np.finfo(np.float32).tiny)
    np.testing.assert_array_equal(
        R.uniform(tk, shape, tiny, 1.0).numpy(),
        np.asarray(jax.random.uniform(jk, shape, jnp.float32, minval=tiny)))


@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_within_one_ulp_per_log(seed):
    shape = (4, 1000)
    jk, tk = jax.random.key(seed), R.key(seed, "cpu")
    tiny = float(np.finfo(np.float32).tiny)
    u = R.uniform(tk, shape, tiny, 1.0)
    inner_t = -torch.log(u)
    inner_j = np.asarray(-jnp.log(jnp.asarray(u.numpy())))
    assert (np.abs(inner_t.numpy() - inner_j)
            <= np.spacing(np.abs(inner_j))).all()
    outer_t = (-torch.log(inner_t)).numpy()
    outer_j = np.asarray(-jnp.log(jnp.asarray(inner_t.numpy())))
    assert (np.abs(outer_t - outer_j) <= np.spacing(np.abs(outer_j))).all()
    want = np.asarray(jax.random.gumbel(jk, shape, jnp.float32))
    got = R.gumbel(tk, shape).numpy()
    bound = 2.0 ** -23 + np.spacing(np.abs(want))
    assert (np.abs(got - want) <= bound).all()


@pytest.mark.parametrize("seed", SEEDS)
def test_categorical_whole_array_and_per_row_keys(seed):
    rng = np.random.default_rng(seed % 97)
    logits = rng.standard_normal((4, 97)).astype(np.float32)
    jk, tk = jax.random.key(seed), R.key(seed, "cpu")
    want = np.asarray(jax.random.categorical(jk, jnp.asarray(logits)))
    got = R.categorical(tk, torch.from_numpy(logits))
    np.testing.assert_array_equal(got.numpy(), want)
    # the engine's form: one key per row, each row drawn as a [1, V] call
    keys = jax.vmap(lambda r: jax.random.fold_in(jk, r))(jnp.arange(4))
    want = np.asarray(jax.vmap(lambda k, l: jax.random.categorical(
        k, l[None])[0])(keys, jnp.asarray(logits)))
    tkeys = R.fold_in(tk.expand(4, 2), torch.arange(4))
    np.testing.assert_array_equal(
        R.categorical(tkeys, torch.from_numpy(logits)).numpy(), want)


def test_key_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        R.key(0)
