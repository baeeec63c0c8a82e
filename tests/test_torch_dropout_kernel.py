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
    ((8, 16, 64, 64), 0), ((8, 16, 64, 64), [1, 3]), ((3, 5, 7, 11), [2])],
    ids=["one", "odd", "attention", "axis-0", "axis-13", "axis-2"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64], ids=["f32", "bf16", "f64"])
def test_dropout_kernel_matches_plain_on_cuda(dtype, shape, axis):
    """Forward (y and its bits) and backward (the stored bits applied to
    dy, no key) against the plain versions bit for bit, through autograd;
    the backward also against the key's mask applied to dy."""
    _cuda_or_skip()
    gen = torch.Generator(device="cuda").manual_seed(len(shape))
    x = torch.randn(shape, generator=gen, device="cuda").to(
        dtype).requires_grad_()
    dy = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    fwd_per_call = 1 if kd.mask_shape(shape, axis) == shape else 2
    for p in (0.1, 0.5):
        for mode in kd.MODES:
            key = (7, int(p * 10))
            fwd, bwd = kd.fwd_launches, kd.bwd_launches
            y = kd.dropout(x, key, p, mode, axis=axis)
            (g,) = torch.autograd.grad(y, x, dy)
            torch.cuda.synchronize()
            assert (kd.fwd_launches - fwd, kd.bwd_launches - bwd) == (
                fwd_per_call, 1)
            xd = x.detach()
            want, bits = kd.dropout_forward_reference(xd, key, p, mode, axis)
            got, got_bits = kd.dropout_forward(xd, key, p, mode, axis,
                                               mask=True)
            assert torch.equal(y, want) and torch.equal(got, want)
            assert torch.equal(got_bits, bits)
            assert torch.equal(g, kd.dropout_backward_reference(
                dy, bits, p, mode, axis))
            assert torch.equal(g, kd.dropout_reference(dy, key, p, mode,
                                                       axis))


#: (full shape, slice starts, slice shape, axis): a head slice of the
#: attention layout [b, h, s, d] (rows and heads: not one contiguous
#: index range), a row slice of [b, s, H], and broadcast-axis masks
WINDOWS = [((4, 8, 16, 8), (2, 4, 0, 0), (2, 4, 16, 8), None),
           ((4, 16, 32), (1, 0, 0), (1, 16, 32), None),
           ((4, 8, 16, 8), (0, 2, 0, 0), (4, 2, 16, 8), [0, 1]),
           ((4, 8, 16, 8), (2, 6, 0, 0), (2, 2, 16, 8), [1, 3])]
_WINDOW_IDS = ["heads", "rows", "axis-01", "axis-13"]


def _window_slice(full, starts, shape):
    return tuple(slice(s, s + n) for s, n in zip(starts, shape))


@pytest.mark.parametrize("full,starts,shape,axis", WINDOWS, ids=_WINDOW_IDS)
def test_window_bits_are_the_full_masks_slice(full, starts, shape, axis):
    """A window's mask is the same slice of the full tensor's mask, its
    output the full output's slice and its packed bits the slice's mask
    in the local layout, so the backward takes them as they are."""
    key, p = (9, 4), 0.3
    x = torch.randn(full, dtype=torch.float64)
    sl = _window_slice(full, starts, shape)
    y_full = kd.dropout_reference(x, key, p, axis=axis)
    y, bits = kd.dropout_forward_reference(x[sl].contiguous(), key, p,
                                           axis=axis, window=(full, starts))
    assert torch.equal(y, y_full[sl])
    keep_full = kd.unpack_mask(
        kd.dropout_forward_reference(x, key, p, axis=axis)[1],
        kd.mask_shape(full, axis))
    msl = _window_slice(kd.mask_shape(full, axis),
                        kd.mask_window(shape, axis, (full, starts))[1],
                        kd.mask_shape(shape, axis))
    assert torch.equal(kd.unpack_mask(bits, kd.mask_shape(shape, axis)),
                       keep_full[msl])
    # no window: the bits of the slice's own indices, which differ
    assert not torch.equal(kd.dropout_reference(x[sl].contiguous(), key, p,
                                                axis=axis), y_full[sl])


@pytest.mark.parametrize("full,starts,shape,axis", WINDOWS, ids=_WINDOW_IDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_window_kernel_matches_plain_on_cuda(dtype, full, starts, shape,
                                             axis):
    """The windowed forward (y and its bits; two launches, the slice's
    bits then their application) and the backward of its bits against
    the plain versions bit for bit."""
    _cuda_or_skip()
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    dy = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    win = (full, starts)
    before = kd.fwd_launches
    y, bits = kd.dropout_forward(x, (9, 4), 0.3, axis=axis, mask=True,
                                 window=win)
    assert kd.fwd_launches - before == 2
    yp, bitsp = kd.dropout_forward_reference(x, (9, 4), 0.3, axis=axis,
                                             window=win)
    assert torch.equal(y, yp) and torch.equal(bits, bitsp)
    assert torch.equal(kd.dropout_backward(dy, bits, 0.3, axis=axis),
                       kd.dropout_backward_reference(dy, bitsp, 0.3,
                                                     axis=axis))


def test_forward_without_autograd_writes_no_bits_on_cuda():
    _cuda_or_skip()
    x = torch.randn(4096, device="cuda", dtype=torch.bfloat16)
    y, bits = kd.dropout_forward(x, (3, 4), 0.1)
    assert bits is None
    with torch.no_grad():
        assert torch.equal(kd.dropout(x.requires_grad_(), (3, 4), 0.1), y)
    assert torch.equal(y, kd.dropout_reference(x.detach(), (3, 4), 0.1))


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
