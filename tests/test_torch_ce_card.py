"""The chunked head + cross-entropy backward's last step on its own
(``nn.functional._ce_input_grads``): ``dh`` and ``dw`` formed from the
float32 logit gradient and rounded once to the inputs' dtype.

This file imports no JAX, so it runs on the card too:
``python -m pytest --noconftest tests/test_torch_ce_card.py -q``. On the
CPU the products are float32; on the card with bf16 inputs they are two
bf16 products of the gradient's ``hi + lo`` parts with float32
accumulation (16 of its 24 significant bits), held there against the
float64 products rounded to bf16: each entry within one bf16 step (see
``_one_step_apart``) and at most 2% of entries different. A float32 sum
of ``dh``'s 50,304 terms moves the result by about ``sqrt(50304) *
2**-24``, which rounds one bf16 step away for about 0.7% of entries, and
the split's 16 bits add about 0.4%; the gradient rounded to bf16 first
(the backward's earlier way) differs on about 40%. The CUDA case skips here
with the reason.
"""
import pytest
import torch

from paddle_tpu_torch.nn.functional import _ce_input_grads, _split_bf16


def _case(seed, rows=64, vocab=1000, d=64):
    gen = torch.Generator().manual_seed(seed)
    grad = torch.softmax(3 * torch.randn(rows, vocab, generator=gen), -1)
    grad[torch.arange(rows), torch.arange(rows) % vocab] -= 1.0
    h = torch.randn(rows, d, generator=gen).to(torch.bfloat16)
    w = torch.randn(vocab, d, generator=gen).to(torch.bfloat16)
    return grad / rows, h, w


def test_split_bf16_keeps_sixteen_bits():
    x = _case(0)[0]
    hi, lo = _split_bf16(x)
    assert hi.dtype == lo.dtype == torch.bfloat16
    assert torch.equal(hi, x.to(torch.bfloat16))
    assert torch.equal(lo, (x - hi.float()).to(torch.bfloat16))
    err = (x.double() - hi.double() - lo.double()).abs()
    assert (err <= x.double().abs() * 2.0 ** -16).all()


@pytest.mark.parametrize("transpose_y", [True, False])
def test_cpu_products_are_float32_rounded_once(transpose_y):
    grad, h, w = _case(1)
    if not transpose_y:
        w = w.t().contiguous()
    dh, dw = _ce_input_grads(grad, h, w, transpose_y, True, True)
    wt = w.float() if transpose_y else w.float().t()
    assert torch.equal(dh, (grad @ wt).to(torch.bfloat16))
    want_dw = grad.t() @ h.float()
    assert torch.equal(dw, (want_dw if transpose_y else want_dw.t())
                       .to(torch.bfloat16))


def _one_step_apart(got, want):
    """Share of entries that differ. Every entry must be within one bf16
    step of its own magnitude, plus 2**-16 of the tensor's largest: an
    entry near zero is a sum whose terms cancel, and there the float32
    sums' order and the split's 16 bits move it by an amount set by the
    terms' magnitude, not by the small result's."""
    got, want = got.float(), want.float()
    diff = got != want
    bound = want.abs() * 2.0 ** -7 + want.abs().max() * 2.0 ** -16
    assert ((got - want).abs() <= bound).all()
    return diff.float().mean().item()


@pytest.mark.parametrize("transpose_y", [True, False])
def test_cuda_hi_lo_products_match_float64(transpose_y):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hi + lo split runs only on "
                    "the card's bf16 tensor-core products")
    grad, h, w = _case(2, rows=2048, vocab=50304, d=1024)
    if not transpose_y:
        w = w.t().contiguous()
    wt = w.double() if transpose_y else w.double().t()
    dw64 = grad.double().t() @ h.double()
    want = ((grad.double() @ wt).to(torch.bfloat16),
            (dw64 if transpose_y else dw64.t()).to(torch.bfloat16))
    got = _ce_input_grads(grad.cuda(), h.cuda(), w.cuda(), transpose_y,
                          True, True)
    for g, wnt in zip(got, want):
        assert g.dtype == wnt.dtype and g.shape == wnt.shape
        assert _one_step_apart(g.cpu(), wnt) <= 0.02
