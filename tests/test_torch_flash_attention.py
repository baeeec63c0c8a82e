"""The port's attention dispatch (``kernels.attention.sdpa`` and
``nn.functional.scaled_dot_product_attention``) against the JAX package's
at a small size, forward and gradients.

On the CPU the JAX ``sdpa`` is its composite (``sdpa_reference``) and the
port's takes the flash kernel's plain version; the splash case runs the
JAX package's ``_splash`` in interpret mode, as ``tests/test_kernels.py``
does. Inputs and output cotangents are made with numpy from a seed.
Tolerances: float32 atol 1e-5 against the composite (two
implementations of one float32 computation, summed in other orders);
2e-3 against splash, which multiplies q by the scale before the product
and walks the keys in blocks, as ``tests/test_kernels.py`` holds it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels.attention import sdpa as jax_sdpa
from paddle_tpu.kernels.flash_attention import _splash
from paddle_tpu_torch.kernels import attention
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.nn import functional as nnf

ATOL = 1e-5
SPLASH_TOL = 2e-3


def _case(seed, b, h, s_q, s_k, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, s_q, d), np.float32)
    k = rng.standard_normal((b, h, s_k, d), np.float32)
    v = rng.standard_normal((b, h, s_k, d), np.float32)
    ct = rng.standard_normal((b, h, s_q, d), np.float32)  # output cotangent
    return q, k, v, ct


def _port_fwd_bwd(fn, q, k, v, ct):
    x = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = fn(*x)
    out.backward(torch.from_numpy(ct))
    return [out.detach().numpy()] + [t.grad.numpy() for t in x]


def _jax_fwd_bwd(fn, q, k, v, ct):
    out, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (q, k, v)))
    return [np.asarray(out)] + [np.asarray(g) for g in vjp(jnp.asarray(ct))]


@pytest.mark.parametrize("s_q,s_k,causal", [
    (16, 16, True), (16, 16, False), (6, 19, True), (19, 6, True),
    (11, 23, False)],
    ids=["causal", "non-causal", "causal-offset", "rows-see-no-key",
         "non-causal-rect"])
def test_sdpa_matches_reference_forward_and_grad(s_q, s_k, causal):
    q, k, v, ct = _case(s_q * 100 + s_k, 2, 3, s_q, s_k, 16)
    got = _port_fwd_bwd(
        lambda *x: attention.sdpa(*x, is_causal=causal), q, k, v, ct)
    want = _jax_fwd_bwd(
        lambda *x: jax_sdpa(*x, is_causal=causal), q, k, v, ct)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0, err_msg=name)


def test_functional_sdpa_is_the_dispatch():
    q, k, v, ct = _case(1, 1, 2, 9, 9, 8)
    got = _port_fwd_bwd(lambda *x: nnf.scaled_dot_product_attention(
        *x, is_causal=True, training=True), q, k, v, ct)
    want = _port_fwd_bwd(lambda *x: attention.sdpa(*x, is_causal=True),
                         q, k, v, ct)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_mask_takes_the_composite():
    q, k, v, _ = _case(2, 1, 2, 5, 7, 8)
    mask = np.random.default_rng(3).random((5, 7)) < 0.7
    mask[:, 0] = True
    calls = fa.reference_calls
    got = attention.sdpa(*(torch.from_numpy(a) for a in (q, k, v)),
                         mask=torch.from_numpy(mask))
    assert fa.reference_calls == calls  # not the flash route
    want = jax_sdpa(*(jnp.asarray(a) for a in (q, k, v)),
                    mask=jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_causal_rectangular_matches_splash_interpret():
    """s_q = 128, s_k = 256: the bottom-right offset the splash route
    serves, forward and gradient."""
    q, k, v, ct = _case(7, 1, 2, 128, 256, 128)
    scale = 1.0 / 128 ** 0.5
    got = _port_fwd_bwd(lambda *x: fa.flash_attention(*x, causal=True),
                        q, k, v, ct)
    want = _jax_fwd_bwd(lambda *x: _splash(*x, scale, True), q, k, v, ct)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, atol=SPLASH_TOL, rtol=SPLASH_TOL,
                                   err_msg=name)


def test_cpu_tensors_launch_no_kernel():
    q, k, v, ct = _case(4, 1, 2, 8, 8, 64)
    before = (fa.fwd_launches, fa.bwd_launches, fa.reference_calls)
    _port_fwd_bwd(lambda *x: fa.flash_attention(*x, causal=True), q, k, v, ct)
    assert (fa.fwd_launches, fa.bwd_launches) == before[:2]
    assert fa.reference_calls == before[2] + 1


def test_attention_dropout_raises_in_training():
    q = torch.zeros(1, 1, 4, 8)
    with pytest.raises(NotImplementedError, match="item 5"):
        nnf.scaled_dot_product_attention(q, q, q, dropout_p=0.1,
                                         training=True)
    nnf.scaled_dot_product_attention(q, q, q, dropout_p=0.1, training=False)


def test_wrapper_checks_shapes_and_dtypes():
    q = torch.zeros(1, 2, 4, 8)
    with pytest.raises(ValueError):
        fa.flash_attention(q, torch.zeros(1, 2, 4, 16), torch.zeros(1, 2, 4, 16))
    with pytest.raises(TypeError):
        fa.flash_attention(q.double(), q.double(), q.double())
