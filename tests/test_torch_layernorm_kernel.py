"""The port's LayerNorm kernels (forward and dx) and their plain versions.

This file imports no JAX, so it runs on the card too:
``python -m pytest --noconftest tests/test_torch_layernorm_kernel.py -q``
(``--noconftest`` skips the suite's JAX-only conftest). Here on the CPU
the plain versions and the autograd function are held against numpy in
float64, and the CUDA cases skip with the reason; on the card they hold
the Hopper kernels against the plain versions on the same inputs, with
the criteria ``chip_smoke.py`` uses.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import fused_layernorm as fl


def _numpy_ln(x, g, b, dy, eps=1e-5):
    """y, dx, dgamma, dbeta of LayerNorm in float64."""
    x, g, b, dy = (a.astype(np.float64) for a in (x, g, b, dy))
    mu = x.mean(-1, keepdims=True)
    rstd = 1 / np.sqrt(((x - mu) ** 2).mean(-1, keepdims=True) + eps)
    xhat = (x - mu) * rstd
    wdy = dy * g
    dx = rstd * (wdy - wdy.mean(-1, keepdims=True)
                 - xhat * (wdy * xhat).mean(-1, keepdims=True))
    return xhat * g + b, dx, (dy * xhat).sum(0), dy.sum(0)


@pytest.mark.parametrize("rows,d", [(13, 40), (64, 7), (2, 300)])
def test_plain_versions_match_numpy(rows, d):
    rng = np.random.default_rng(rows + d)
    x = (rng.standard_normal((rows, d)) * 3 + 1).astype(np.float32)
    g = (1 + 0.2 * rng.standard_normal(d)).astype(np.float32)
    b = rng.standard_normal(d).astype(np.float32)
    dy = rng.standard_normal((rows, d)).astype(np.float32)
    xs = [torch.from_numpy(a).requires_grad_() for a in (x, g, b)]
    calls = fl.reference_calls
    y = fl.fused_layer_norm(*xs)
    y.backward(torch.from_numpy(dy))
    assert fl.reference_calls == calls + 2
    got = [y.detach()] + [a.grad for a in xs]
    # float32 against float64; the row sums grow with rows (dgamma, dbeta)
    for name, t, w in zip(("y", "dx", "dgamma", "dbeta"), got,
                          _numpy_ln(x, g, b, dy)):
        np.testing.assert_allclose(t.numpy(), w, atol=1e-4, rtol=1e-5,
                                   err_msg=name)


def test_contract_raises():
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="gamma and beta"):
        fl.layer_norm_forward(x, torch.ones(7), torch.zeros(7), 1e-5)
    with pytest.raises(TypeError, match="one dtype"):
        fl.layer_norm_forward(x, torch.ones(8), torch.zeros(8).double(), 1e-5)
    mu = torch.zeros(4, 1)
    with pytest.raises(ValueError, match="dy must match"):
        fl.layer_norm_dx(x, torch.ones(8), mu, mu, torch.zeros(4, 9))


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels have no CPU "
                    "mode (chip_smoke.py and this file on the card run them)")


# float32: kernel against the plain version on the same inputs, only the
# order of the row sums differs. bfloat16: kernel and plain version each
# against the plain version in float32 on the upcast inputs; the kernel's
# max abs error may be at most twice the plain one's plus 1e-3
TOL_FP32 = dict(atol=2e-5, rtol=1e-5)
BF16_ERR_RATIO, BF16_ERR_FLOOR = 2.0, 1e-3
SHAPES = [(8192, 1024), (4096, 2048), (8, 2048), (1001, 64), (37, 99),
          (3, 20), (5, 8192)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("rows,d", SHAPES,
                         ids=[f"{r}x{d}" for r, d in SHAPES])
def test_kernels_match_plain_on_cuda(rows, d, dtype):
    _cuda_or_skip()
    gen = torch.Generator(device="cuda").manual_seed(rows + d)

    def mk(*shape, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale
                + shift).to(dtype)

    x, dy = mk(rows, d, scale=2.0, shift=0.5), mk(rows, d)
    g, b = mk(d, scale=0.1, shift=1.0), mk(d, scale=0.1)
    launches = (fl.fwd_launches, fl.dx_launches)
    y, mu, rstd = fl.layer_norm_forward(x, g, b, 1e-5)
    yp, mup, rstdp = fl.fused_layer_norm_reference(x, g, b, 1e-5)
    dx = fl.layer_norm_dx(x, g, mup, rstdp, dy)
    dxp = fl.layer_norm_dx_reference(x, g, mup, rstdp, dy)
    torch.cuda.synchronize()
    assert (fl.fwd_launches, fl.dx_launches) == (launches[0] + 1,
                                                 launches[1] + 1)
    torch.testing.assert_close(mu, mup, **TOL_FP32)
    torch.testing.assert_close(rstd, rstdp, **TOL_FP32)
    if dtype == torch.float32:
        torch.testing.assert_close(y, yp, **TOL_FP32)
        torch.testing.assert_close(dx, dxp, **TOL_FP32)
        return
    yf, _, _ = fl.fused_layer_norm_reference(x.float(), g.float(), b.float(),
                                             1e-5)
    dxf = fl.layer_norm_dx_reference(x.float(), g.float(), mup, rstdp,
                                     dy.float())
    for name, got, plain, exact in (("y", y, yp, yf), ("dx", dx, dxp, dxf)):
        e_kernel = (got.float() - exact).abs().max().item()
        e_plain = (plain.float() - exact).abs().max().item()
        assert e_kernel <= BF16_ERR_RATIO * e_plain + BF16_ERR_FLOOR, (
            f"{name}: kernel {e_kernel:.3e}, plain bf16 {e_plain:.3e} "
            f"against float32")


def test_kernel_raises_past_max_d_on_cuda():
    _cuda_or_skip()
    d = fl.MAX_D + 1
    x = torch.zeros(2, d, device="cuda")
    with pytest.raises(ValueError, match="d <="):
        fl.layer_norm_forward(x, torch.ones(d, device="cuda"),
                              torch.zeros(d, device="cuda"), 1e-5)
