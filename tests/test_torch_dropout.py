"""The port's dropout (``nn.functional.dropout``, ``nn.Dropout``, the
attention dropout of ``scaled_dot_product_attention`` and the kernel
module's plain path) against the JAX package's under the same
``trace_rng_scope`` key.

Dropout draws the reference's float64 Bernoulli bits and divides kept
values by ``1 - p`` rounded to the activation's dtype: the output and its
gradient must equal the reference's bit for bit, in float32, bf16 and
float64 (divided in float64, as the reference divides it).
The attention output itself is computed by two implementations (the
port's plain attention and the reference's composite), so there the
mask must be equal and the values within float32 rounding (atol 1e-6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core import rng as J
from paddle_tpu.core import tape
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.core import rng as T
from paddle_tpu_torch.kernels import dropout as kd
from paddle_tpu_torch.nn import functional as TF

KEY = 3
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16),
          "f64": (torch.float64, jnp.float64)}


def _words(k):
    return tuple(int(w) for w in np.asarray(jax.random.key_data(k)))


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("mode", kd.MODES)
@pytest.mark.parametrize("axis", [None, 0, [0, 1]], ids=["all", "0", "01"])
@pytest.mark.parametrize("p", [0.1, 0.5])
@pytest.mark.parametrize("dtype", DTYPES)
def test_dropout_and_grad_bit_for_bit(dtype, p, axis, mode):
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(int(p * 10))
    x = jnp.asarray(rng.standard_normal((4, 6, 5)), jdt)
    g = jnp.asarray(rng.standard_normal((4, 6, 5)), jdt)
    key = jax.random.key(KEY)

    def f(a):
        with tape.no_grad(), J.trace_rng_scope(key):
            return JF.dropout(Tensor(a), p, axis=axis, mode=mode)._value

    want, vjp = jax.vjp(f, x)
    (want_g,) = vjp(g)
    wide = np.float64 if tdt == torch.float64 else np.float32
    tx = torch.tensor(np.asarray(x, wide)).to(tdt).requires_grad_()
    with T.trace_rng_scope(_words(key)):
        got = TF.dropout(tx, p, axis=axis, mode=mode)
    got.backward(torch.tensor(np.asarray(g, wide)).to(tdt))
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.detach().to(torch.float64).numpy(),
                                  np.asarray(want, np.float64))
    np.testing.assert_array_equal(tx.grad.to(torch.float64).numpy(),
                                  np.asarray(want_g, np.float64))


def test_p_zero_and_eval_draw_no_key():
    x = torch.randn(3, 4)
    with T.trace_rng_scope((1, 2)):
        assert TF.dropout(x, 0.0) is x
        assert TF.dropout(x, 0.5, training=False) is x
        # downscale_in_infer is returned unscaled at inference, as in the
        # reference (a reference caveat, ROADMAP Queue 3)
        assert TF.dropout(x, 0.5, training=False,
                          mode="downscale_in_infer") is x
        layer = tnn.Dropout(0.5).eval()
        assert layer(x) is x
        assert T.next_rng_key() == T.fold_in_words((1, 2), 1)


def test_dropout_layer_draws_in_training_mode():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 16)).astype(np.float32)
    key = jax.random.key(9)
    with tape.no_grad(), J.trace_rng_scope(key):
        from paddle_tpu import nn as jnn

        want = jnn.Dropout(0.1, axis=[0, 2])(Tensor(jnp.asarray(x)))._value
    layer = tnn.Dropout(0.1, axis=[0, 2])
    assert layer.training and "p=0.1" in repr(layer)
    with T.trace_rng_scope(_words(key)):
        got = layer(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_sdpa_dropout_on_the_output_matches_reference(causal):
    """The reference drops the attention output, not the probabilities:
    with ``dropout_p=0.2`` in training the zero pattern equals the
    reference's and the kept values match within float32 rounding."""
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((2, 3, 8, 16)).astype(np.float32)
               for _ in range(3))
    key = jax.random.key(21)
    with tape.no_grad(), J.trace_rng_scope(key):
        want = np.asarray(JF.scaled_dot_product_attention(
            *(Tensor(jnp.asarray(a)) for a in (q, k, v)), dropout_p=0.2,
            is_causal=causal, training=True)._value)
    with T.trace_rng_scope(_words(key)):
        got = TF.scaled_dot_product_attention(
            *(torch.from_numpy(a) for a in (q, k, v)), dropout_p=0.2,
            is_causal=causal, training=True).numpy()
    np.testing.assert_array_equal(got == 0, want == 0)
    assert 0 < (got == 0).mean() < 0.5
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    # out of training: no dropout, and no key drawn
    with T.trace_rng_scope((5, 6)):
        plain = TF.scaled_dot_product_attention(
            *(torch.from_numpy(a) for a in (q, k, v)), dropout_p=0.2,
            is_causal=causal, training=False).numpy()
        assert T.next_rng_key() == T.fold_in_words((5, 6), 1)
    assert not (plain == 0).any()


@pytest.mark.parametrize("p,dtype", [(0.1, torch.float32),
                                     (0.5, torch.bfloat16),
                                     (0.3, torch.float32)])
def test_launch_args_are_the_host_folded_key(p, dtype):
    """The kernel's key words are ``fold_in(base, n)``'s, its threshold
    keeps exactly the reference's float64 ``uniform < 1 - p``, and its
    divisor is ``1 - p`` rounded to the activation's dtype."""
    base = jax.random.key(17)
    with T.trace_rng_scope(_words(base)):
        for n in range(1, 6):
            k1, k2, threshold, q, upscale = kd.launch_args(
                T.next_rng_key(), p, dtype)
            assert (k1, k2) == _words(jax.random.fold_in(base, n))
    assert upscale
    u = R_uniform_words((k1, k2), (999,))
    mantissa = (u * 2.0 ** 52).astype(np.int64)
    np.testing.assert_array_equal(mantissa < threshold, u < 1.0 - p)
    assert q == float(jnp.asarray(1.0 - p, jnp.float32 if dtype ==
                                  torch.float32 else jnp.bfloat16))
    assert kd.launch_args((1, 2), p, dtype, "downscale_in_infer")[4] is False
    with pytest.raises(ValueError, match="mode"):
        kd.launch_args((1, 2), p, dtype, "nope")


def R_uniform_words(words, shape):
    from paddle_tpu_torch import random as R

    return R.uniform(torch.tensor(words, dtype=torch.int64), shape,
                     dtype=torch.float64).numpy()


def test_cpu_tensors_take_the_plain_version():
    before = (kd.fwd_launches, kd.bwd_launches, kd.reference_calls)
    x = torch.randn(4, 5, requires_grad=True)
    kd.dropout(x, (1, 2), 0.5).sum().backward()
    assert (kd.fwd_launches, kd.bwd_launches) == before[:2]
    assert kd.reference_calls == before[2] + 2
    assert kd.mask_shape((4, 5, 6), [0, 2]) == (4, 1, 6)
    assert kd.mask_shape((4, 5, 6), -1) == (1, 1, 1)  # as the reference


@pytest.mark.parametrize("shape,axis", [((4, 6, 5), None), ((1,), None),
                                        ((3, 13), None), ((4, 6, 5), [0, 2]),
                                        ((2, 3, 4), 1)],
                         ids=["all", "one", "odd", "axis-02", "axis-1"])
def test_packed_mask_path_matches_unpacked_bools(shape, axis):
    """The plain mask path: ``pack_mask`` keeps bit ``j % 8`` of byte ``j //
    8`` (the layout the kernels write), ``unpack_mask`` inverts it, and the
    forward's bits and the backward from them equal the boolean mask
    applied as the reference applies it."""
    rng = np.random.default_rng(len(shape))
    keep = torch.from_numpy(rng.random(shape) < 0.7)
    bits = kd.pack_mask(keep)
    flat = keep.reshape(-1).numpy()
    want = np.packbits(flat, bitorder="little")
    np.testing.assert_array_equal(bits.numpy(), want)
    assert torch.equal(kd.unpack_mask(bits, shape), keep)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    key = (11, 12)
    y, fbits = kd.dropout_forward_reference(x, key, 0.3, axis=axis)
    assert torch.equal(y, kd.dropout_reference(x, key, 0.3, axis=axis))
    mshape = kd.mask_shape(shape, axis)
    mask = kd.unpack_mask(fbits, mshape)
    assert fbits.numel() == -(-int(np.prod(mshape)) // 8)
    for mode in kd.MODES:
        dx = kd.dropout_backward_reference(x, fbits, 0.3, mode, axis)
        q = kd.launch_args(key, 0.3, torch.float32, mode)[3]
        kept = x / torch.tensor(q) if mode == kd.MODES[0] else x
        assert torch.equal(dx, torch.where(mask, kept, torch.zeros(())))
    with pytest.raises(ValueError, match="mask bytes"):
        kd.unpack_mask(bits[:-1], shape)


def test_broadcast_launch_arguments():
    # kept and broadcast dimensions merged, strides of the mask's shape
    assert kd._broadcast_args((8, 16, 1024, 64), (8, 16, 1024, 64)) == (
        0, [], [])
    assert kd._broadcast_args((8, 16, 1024, 64), (8, 16, 1, 1)) == (
        2, [128, 65536], [1, 0])
    assert kd._broadcast_args((3, 5, 7, 11), (1, 1, 7, 1)) == (
        3, [15, 7, 11], [0, 1, 0])
    assert kd._broadcast_args((4, 1, 6), (4, 1, 1)) == (2, [4, 6], [1, 0])
