"""The port's LayerNorm kernels (forward and backward) and their plain
versions.

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


@pytest.mark.parametrize("need", [(True, False), (False, True), (True, True)],
                         ids=["dx", "params", "all"])
def test_backward_returns_what_is_asked_on_cpu(need):
    """The autograd function's three ``needs_input_grad`` cases, through
    ``layer_norm_backward`` on CPU tensors: what is not asked for is None,
    what is equals the plain version's."""
    rng = np.random.default_rng(5)
    x, dy = (torch.from_numpy(rng.standard_normal((9, 24)).astype(np.float32))
             for _ in range(2))
    g = torch.from_numpy((1 + 0.1 * rng.standard_normal(24)).astype(
        np.float32))
    _, mu, rstd = fl.fused_layer_norm_reference(x, g, g, 1e-5)
    want = fl.layer_norm_backward_reference(x, g, mu, rstd, dy)
    got = fl.layer_norm_backward(x, g, mu, rstd, dy, dx=need[0],
                                 params=need[1])
    for t, w, asked in zip(got, want, (need[0], need[1], need[1])):
        assert (t is None) != asked
        if asked:
            assert torch.equal(t, w)
    xs = [t.clone().requires_grad_(r) for t, r in
          ((x, need[0]), (g, need[1]), (torch.zeros(24), need[1]))]
    fl.fused_layer_norm(*xs).backward(dy)
    for t, w, asked in zip(xs, want, (need[0], need[1], need[1])):
        assert (t.grad is None) != asked
        if asked:
            torch.testing.assert_close(t.grad, w, atol=0, rtol=0)


@pytest.mark.parametrize("rows,d,aligned,want", [
    (8192, 1024, True, (("rows", 4), 132)),
    (8192, 768, True, (("rows", 3), 132)),
    (8192, 512, True, (("rows", 2), 132)),
    (37, 99, True, (("strips", False), 5)),
    (1001, 64, True, (("rows", 1), 63)),
    (1001, 776, True, (("rows", 4), 132)),
    (513, 512, True, (("rows", 2), 65)),
    (4096, 2048, True, (("strips", True), 512)),
    (8192, 1024, False, (("strips", False), 1024))])
def test_backward_plan_picks_the_program(rows, d, aligned, want):
    assert fl.backward_plan(rows, d, torch.bfloat16, aligned, 132) == want


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
# max abs error may be at most twice the plain one's plus 1e-3. dgamma and
# dbeta: float32 sums over the rows in two orders, each within its depth
# of sequential additions (at most about 150 here) times 2**-24 of the sum
# of the terms' magnitudes: within SUM_RTOL of it, plus one step of gamma's
# dtype (2**-7 of the value for bfloat16, which rounds both once)
TOL_FP32 = dict(atol=2e-5, rtol=1e-5)
BF16_ERR_RATIO, BF16_ERR_FLOOR = 2.0, 1e-3
SUM_RTOL = 2e-5
SHAPES = [(8192, 1024), (4096, 2048), (8, 2048), (1001, 64), (37, 99),
          (3, 20), (5, 8192), (8192, 768), (8192, 512), (1001, 776)]


def _sums_within(got, plain, terms, dtype):
    """dgamma or dbeta against the plain version's float32 sums."""
    step = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
    limit = SUM_RTOL * terms + step * plain.float().abs()
    return bool(((got.float() - plain.float()).abs() <= limit).all())


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
    launches = (fl.fwd_launches, fl.dx_launches, fl.reduce_launches)
    y, mu, rstd = fl.layer_norm_forward(x, g, b, 1e-5)
    yp, mup, rstdp = fl.fused_layer_norm_reference(x, g, b, 1e-5)
    dx, dg, db = fl.layer_norm_backward(x, g, mup, rstdp, dy)
    again = fl.layer_norm_backward(x, g, mup, rstdp, dy)
    dxp, dgp, dbp = fl.layer_norm_backward_reference(x, g, mup, rstdp, dy)
    torch.cuda.synchronize()
    assert (fl.fwd_launches, fl.dx_launches, fl.reduce_launches) == (
        launches[0] + 1, launches[1] + 2, launches[2] + 2)
    assert all(torch.equal(a, b) for a, b in zip((dx, dg, db), again))
    torch.testing.assert_close(mu, mup, **TOL_FP32)
    torch.testing.assert_close(rstd, rstdp, **TOL_FP32)
    xhat = (x.float() - mup) * rstdp
    terms = ((dy.float() * xhat).abs().sum(0), dy.float().abs().sum(0))
    for got, plain, t in ((dg, dgp, terms[0]), (db, dbp, terms[1])):
        assert got.dtype == g.dtype and _sums_within(got, plain, t, dtype)
    if dtype == torch.float32:
        torch.testing.assert_close(y, yp, **TOL_FP32)
        torch.testing.assert_close(dx, dxp, **TOL_FP32)
        return
    yf, _, _ = fl.fused_layer_norm_reference(x.float(), g.float(), b.float(),
                                             1e-5)
    dxf = fl.layer_norm_backward_reference(x.float(), g.float(), mup, rstdp,
                                           dy.float())[0]
    for name, got, plain, exact in (("y", y, yp, yf), ("dx", dx, dxp, dxf)):
        e_kernel = (got.float() - exact).abs().max().item()
        e_plain = (plain.float() - exact).abs().max().item()
        assert e_kernel <= BF16_ERR_RATIO * e_plain + BF16_ERR_FLOOR, (
            f"{name}: kernel {e_kernel:.3e}, plain bf16 {e_plain:.3e} "
            f"against float32")


@pytest.mark.parametrize("need", [(True, False, False), (False, True, True),
                                  (True, True, True), (True, False, True)],
                         ids=["dx", "params", "all", "dx-dbeta"])
def test_autograd_backward_launches_on_cuda(need):
    """The ``needs_input_grad`` cases on the card: dx alone launches the
    backward kernel without the reduction; either parameter adds it; each
    result equals the same call's through ``layer_norm_backward``."""
    _cuda_or_skip()
    gen = torch.Generator(device="cuda").manual_seed(11)
    x, dy = (torch.randn(512, 768, generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(2))
    g = torch.ones(768, device="cuda", dtype=torch.bfloat16)
    xs = [t.clone().requires_grad_(r) for t, r in
          zip((x, g, torch.zeros_like(g)), need)]
    launches = (fl.dx_launches, fl.reduce_launches)
    fl.fused_layer_norm(*xs).backward(dy)
    torch.cuda.synchronize()
    assert (fl.dx_launches - launches[0],
            fl.reduce_launches - launches[1]) == (1, int(any(need[1:])))
    _, mu, rstd = fl.layer_norm_forward(x, g, torch.zeros_like(g), 1e-5)
    want = fl.layer_norm_backward(x, g, mu, rstd, dy)
    for t, w, asked in zip(xs, want, need):
        assert (t.grad is None) != asked
        if asked:
            assert torch.equal(t.grad.view(w.shape), w)


def test_kernel_raises_past_max_d_on_cuda():
    _cuda_or_skip()
    d = fl.MAX_D + 1
    x = torch.zeros(2, d, device="cuda")
    with pytest.raises(ValueError, match="d <="):
        fl.layer_norm_forward(x, torch.ones(d, device="cuda"),
                              torch.zeros(d, device="cuda"), 1e-5)
