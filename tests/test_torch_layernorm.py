"""The port's LayerNorm (``paddle_tpu_torch.kernels.fused_layernorm``,
``nn.functional.layer_norm``, ``nn.LayerNorm``) against the JAX package's.

The same inputs (numpy, from seeds) go through
``paddle_tpu.kernels.fused_layernorm.fused_layer_norm`` in interpret mode
and its VJP, as ``tests/test_fused_layernorm_kernel.py`` runs it, and
through the port's ``fused_layer_norm`` on the CPU (its plain versions
under the autograd function): y, dx, dgamma and dbeta. Row counts that
are no multiple of 8 (which the TPU kernel refuses) go against
``paddle_tpu.nn.functional.layer_norm`` and its eager gradients.

Tolerances: float32 within atol 1e-5 + rtol 1e-5 (the row sums are taken
in other orders); bfloat16 within one bf16 step, rtol 2**-7 (both compute
in float32 and round once to bfloat16, so a value that lands near a
rounding boundary may round the other way).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.kernels.fused_layernorm import fused_layer_norm as jfused
from paddle_tpu_torch.kernels import fused_layernorm as fl
from paddle_tpu_torch.nn import LayerNorm
from paddle_tpu_torch.nn import functional as F

TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
       "bfloat16": dict(atol=1e-6, rtol=2 ** -7)}
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(shape, seed):
    """x, gamma, beta and a cotangent dy, float32 numpy."""
    rng = np.random.default_rng(seed)
    d = shape[-1]
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    g = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    b = (0.1 * rng.standard_normal(d)).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    return x, g, b, dy


def _port(x, g, b, dy, dtype, fn):
    """y, dx, dgamma, dbeta of ``fn(x, g, b)`` on the CPU, as float32."""
    xs = [torch.tensor(a).to(_TDT[dtype]).requires_grad_()
          for a in (x, g, b)]
    y = fn(*xs)
    y.backward(torch.tensor(dy).to(_TDT[dtype]))
    assert y.dtype == _TDT[dtype]
    return [t.detach().float().numpy() for t in [y] + [a.grad for a in xs]]


def _close(got, want, dtype):
    for name, g, w in zip(("y", "dx", "dgamma", "dbeta"), got, want):
        np.testing.assert_allclose(g, w, err_msg=name, **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(64, 128), (8, 16, 256), (8, 2048)])
def test_fused_layer_norm_matches_the_pallas_kernel(shape, dtype):
    x, g, b, dy = _inputs(shape, seed=sum(shape))
    jx, jg, jb, jdy = (jnp.asarray(a, _JDT[dtype]) for a in (x, g, b, dy))
    jy, vjp = jax.vjp(lambda *a: jfused(*a, 1e-5, True), jx, jg, jb)
    want = [np.asarray(t, np.float32) for t in (jy, *vjp(jdy))]
    # the port's inputs: the same bf16 values the reference rounded to
    x, g, b, dy = (np.asarray(a, np.float32) for a in (jx, jg, jb, jdy))
    calls = fl.reference_calls
    got = _port(x, g, b, dy, dtype, lambda *a: fl.fused_layer_norm(*a, 1e-5))
    assert fl.reference_calls == calls + 2  # the plain forward and dx
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(13, 96), (3, 5, 40)])
def test_layer_norm_matches_the_reference_functional(shape, dtype):
    """Rows that are no multiple of 8, through both packages'
    ``nn.functional.layer_norm`` (the reference takes its XLA chain)."""
    x, g, b, dy = _inputs(shape, seed=7 + shape[0])
    jt = [paddle.to_tensor(jnp.asarray(a, _JDT[dtype]), stop_gradient=False)
          for a in (x, g, b)]
    jy = JF.layer_norm(jt[0], shape[-1], jt[1], jt[2], 1e-5)
    (jy * paddle.to_tensor(jnp.asarray(dy, _JDT[dtype]))).sum().backward()
    want = [np.asarray(t._value, np.float32)
            for t in [jy] + [a.grad for a in jt]]
    x, g, b = (np.asarray(t._value, np.float32) for t in jt)
    dy = np.asarray(jnp.asarray(dy, _JDT[dtype]), np.float32)
    got = _port(x, g, b, dy, dtype,
                lambda *a: F.layer_norm(a[0], shape[-1], a[1], a[2], 1e-5))
    # the reference's XLA chain rounds its intermediate gradients to bf16
    # (the cast back to x's dtype sits inside the chain), the port keeps
    # them in float32 as its kernel does: in bf16 only y is held
    if dtype == "bfloat16":
        got, want = got[:1], want[:1]
    _close(got, want, dtype)


@pytest.mark.parametrize("form", ["no-affine", "two-dims"])
def test_composite_forms_match_the_reference_functional(form):
    """The forms the kernel does not serve take the composite in both
    packages: no weight and bias, or two normalised dimensions."""
    x, *_ = _inputs((6, 4, 10), seed=3)
    rng = np.random.default_rng(4)
    if form == "no-affine":
        shape, w, b = 10, None, None
    else:
        shape = (4, 10)
        w = (1 + 0.1 * rng.standard_normal((4, 10))).astype(np.float32)
        b = (0.1 * rng.standard_normal((4, 10))).astype(np.float32)
    jy = JF.layer_norm(paddle.to_tensor(x), shape,
                       None if w is None else paddle.to_tensor(w),
                       None if b is None else paddle.to_tensor(b), 1e-5)
    calls = fl.reference_calls
    got = F.layer_norm(torch.from_numpy(x), shape,
                       None if w is None else torch.from_numpy(w),
                       None if b is None else torch.from_numpy(b), 1e-5)
    assert fl.reference_calls == calls  # not the fused path
    np.testing.assert_allclose(got.numpy(), np.asarray(jy._value),
                               **TOL["float32"])


def test_layer_norm_module_matches_the_reference_layer():
    x, g, b, _ = _inputs((5, 7, 48), seed=11)
    jln = paddle.nn.LayerNorm(48, epsilon=1e-5)
    jln.weight.set_value(g)
    jln.bias.set_value(b)
    ln = LayerNorm(48, 1e-5, device="cpu")
    assert [n for n, _ in ln.named_parameters()] == ["weight", "bias"]
    assert torch.equal(ln.weight, torch.ones(48))
    assert torch.equal(ln.bias, torch.zeros(48))
    ln.load_state_dict({"weight": torch.from_numpy(g),
                        "bias": torch.from_numpy(b)})
    with torch.no_grad():
        got = ln(torch.from_numpy(x)).numpy()
    want = np.asarray(jln(paddle.to_tensor(x))._value)
    np.testing.assert_allclose(got, want, **TOL["float32"])
