"""The port's float32 convolution on the card is full float32: with
cuDNN's TF32 allowed process-wide (PyTorch's default), a float32
``nn.functional.conv2d`` and its two gradients stay within 1e-4 of the
largest value of the same convolution in float64, where TF32's 10-bit
mantissa is some 4e-4 off; the process-wide flag is as it was
afterwards. bf16 runs too.

This file imports no JAX, so it runs on the card:
``python -m pytest --noconftest tests/test_torch_conv_card.py -q``. On a
machine without a CUDA device it skips with the reason."""
import pytest
import torch

from paddle_tpu_torch.nn import functional as F

RTOL = 1e-4

needs_card = pytest.mark.skipif(not torch.cuda.is_available(),
                                reason="needs a CUDA device: cuDNN's TF32 "
                                       "flag acts on the card only")


def _rel(got, want):
    return ((got.double() - want).abs().max() / want.abs().max()).item()


@needs_card
@pytest.mark.parametrize("stride,padding", [(1, 1), (2, "SAME"), (2, 3)])
def test_float32_conv_ignores_a_process_wide_tf32(stride, padding):
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((4, 64, 28, 28), generator=gen, device="cuda",
                    requires_grad=True)
    w = (torch.randn((128, 64, 3, 3), generator=gen, device="cuda")
         / 24).requires_grad_(True)
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        out = F.conv2d(x, w, None, stride, padding)
        cot = torch.randn(out.shape, generator=gen, device="cuda")
        dx, dw = torch.autograd.grad(out, (x, w), cot)
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = before
    x64, w64 = (t.detach().double().requires_grad_(True) for t in (x, w))
    out64 = F.conv2d(x64, w64, None, stride, padding)
    dx64, dw64 = torch.autograd.grad(out64, (x64, w64), cot.double())
    for got, want in ((out, out64), (dx, dx64), (dw, dw64)):
        assert _rel(got, want) <= RTOL


@needs_card
def test_bf16_conv_runs_and_keeps_its_dtype():
    x = torch.randn((2, 8, 9, 9), device="cuda", dtype=torch.bfloat16)
    w = torch.randn((4, 8, 3, 3), device="cuda", dtype=torch.bfloat16)
    out = F.conv2d(x, w, None, 2, 1)
    assert out.dtype == torch.bfloat16 and out.shape == (2, 4, 5, 5)
    want = F.conv2d(x.double(), w.double(), None, 2, 1)
    assert _rel(out, want) <= 2e-2
