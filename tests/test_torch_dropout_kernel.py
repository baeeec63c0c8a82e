"""The dropout and global-norm kernels of the port on their own, and the
fused Adam update with a clip scale: on the card each against its plain
version (dropout and Adam bit for bit; the global norm's sum of squares
and scale within a relative 2e-5, float32 sums in two orders), and on the
CPU what the wrappers compute from shapes and rates.

This file imports no JAX, so it runs on the card too:
``python -m pytest --noconftest tests/test_torch_dropout_kernel.py -q``.
The CUDA cases skip here with the reason.
"""
import pytest
import torch

from paddle_tpu_torch.kernels import dropout as kd
from paddle_tpu_torch.kernels import fused_optimizer as fo
from paddle_tpu_torch.kernels import global_norm as gn

NORM_RTOL = 2e-5


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs the dropout, global norm and "
                    "fused Adam kernels against their plain versions")


@pytest.mark.parametrize("p", [0.0, 1.0])
def test_edge_rates_keep_all_or_nothing(p):
    _, _, threshold, q, _ = kd.launch_args((1, 2), p, torch.float32)
    assert threshold == (2 ** 52 if p == 0.0 else 0)
    x = torch.randn(1000)
    y = kd.dropout_reference(x, (1, 2), p)
    assert torch.equal(y, x) if p == 0.0 else not y.any()


def test_plain_version_keeps_one_minus_p_and_scales():
    x = torch.ones(200_000)
    y = kd.dropout_reference(x, (5, 6), 0.25)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.75) < 0.005
    assert torch.equal(y[kept], torch.full_like(y[kept], 1 / 0.75))
    down = kd.dropout_reference(x, (5, 6), 0.25, "downscale_in_infer")
    assert torch.equal(down != 0, kept) and torch.equal(down[kept],
                                                        x[kept])


@pytest.mark.parametrize("shape,axis", [
    ((1,), None), ((1_000_003,), None), ((8, 16, 64, 64), None),
    ((8, 16, 64, 64), 0), ((8, 16, 64, 64), [1, 3])],
    ids=["one", "odd", "attention", "axis-0", "axis-13"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64], ids=["f32", "bf16", "f64"])
def test_dropout_kernel_matches_plain_on_cuda(dtype, shape, axis):
    _cuda_or_skip()
    gen = torch.Generator(device="cuda").manual_seed(len(shape))
    x = torch.randn(shape, generator=gen, device="cuda").to(
        dtype).requires_grad_()
    dy = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    for p in (0.1, 0.5):
        key = (7, int(p * 10))
        fwd, bwd = kd.fwd_launches, kd.bwd_launches
        y = kd.dropout(x, key, p, axis=axis)
        (g,) = torch.autograd.grad(y, x, dy)
        torch.cuda.synchronize()
        assert (kd.fwd_launches - fwd, kd.bwd_launches - bwd) == (1, 1)
        xd = x.detach()
        assert torch.equal(y, kd.dropout_reference(xd, key, p, axis=axis))
        assert torch.equal(g, kd.dropout_reference(dy, key, p, axis=axis))


def test_global_norm_kernel_matches_plain_on_cuda():
    _cuda_or_skip()
    gen = torch.Generator(device="cuda").manual_seed(3)
    grads = [torch.randn(n, generator=gen, device="cuda").to(dt)
             for n, dt in ((1, torch.float32), (4097, torch.bfloat16),
                           (1_000_003, torch.float32),
                           (3 * 1024 * 1024, torch.bfloat16))]
    launches = gn.launches
    total, scale = gn.global_norm_scale(grads, 0.5)
    want_total, want_scale = gn.global_norm_scale_reference(grads, 0.5)
    torch.cuda.synchronize()
    assert gn.launches - launches == len(gn.norm_launch_plan(
        [g.numel() for g in grads], gn.kernel_param_bytes())) + 1
    for a, w in ((total, want_total), (scale, want_scale)):
        assert ((a - w).abs() / w.abs()).item() <= NORM_RTOL
    assert gn.global_norm_scale(grads, 1e9)[1].item() == 1.0


def test_adam_with_clip_scale_matches_plain_on_cuda():
    _cuda_or_skip()
    gen = torch.Generator(device="cuda").manual_seed(4)
    scale = torch.tensor(0.3712, device="cuda")
    groups, plain = [], []
    for n, g_dtype in ((5, torch.float32), (4097, torch.bfloat16),
                       (100_003, torch.bfloat16)):
        p, m = (torch.randn(n, generator=gen, device="cuda")
                for _ in range(2))
        v = torch.rand(n, generator=gen, device="cuda")
        g = torch.randn(n, generator=gen, device="cuda").to(g_dtype)
        out = torch.empty(n, dtype=torch.bfloat16, device="cuda")
        groups.append((p, g, m, v, 0.999, out))
        plain.append((p.clone(), g, m.clone(), v.clone(), 0.999,
                      torch.empty_like(out)))
    hyper = dict(beta1=0.9, beta2=0.999, eps=1e-8)
    fo.fused_adam_update_many(groups, 1e-3, 0.1, 0.001, scale=scale, **hyper)
    for p, g, m, v, decay, out in plain:
        fo.fused_adam_update_reference(p, g, m, v, 1e-3, 0.1, 0.001,
                                       decay=decay, p_out=out, scale=scale,
                                       **hyper)
    torch.cuda.synchronize()
    for got, want in zip(groups, plain):
        for i in (0, 2, 3, 5):
            assert torch.equal(got[i], want[i])
