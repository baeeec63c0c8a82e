"""The port's flash-attention and fused-Adam kernels and their plain
versions.

This file imports no JAX, so it runs on the card too:
``python -m pytest --noconftest tests/test_torch_flash_kernel.py -q``
(``--noconftest`` skips the suite's JAX-only conftest). Here on the CPU
the plain versions are held against numpy loops in float64, and the CUDA
cases skip with the reason; on the card they hold the Hopper kernels
against the plain versions on the same inputs.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.kernels import fused_optimizer as fo


def _loop_attention(q, k, v, causal):
    """Query by query in float64; causal bottom-right, and a row that sees
    no key is uniform over every key (the -1e30 fill of the plain
    version)."""
    b, h, s_q, d = q.shape
    s_k = k.shape[2]
    out = np.zeros(q.shape, np.float64)
    for bb in range(b):
        for hh in range(h):
            for i in range(s_q):
                logits = k[bb, hh].astype(np.float64) @ q[bb, hh, i] / np.sqrt(d)
                if causal:
                    lim = i + s_k - s_q
                    logits = np.where(np.arange(s_k) <= lim, logits,
                                      -1e30 if lim >= 0 else 0.0)
                p = np.exp(logits - logits.max())
                out[bb, hh, i] = (p / p.sum()) @ v[bb, hh]
    return out


@pytest.mark.parametrize("s_q,s_k,causal", [
    (7, 7, True), (5, 12, True), (9, 4, True), (6, 11, False)],
    ids=["square", "splash-offset", "rows-see-no-key", "non-causal"])
def test_plain_version_matches_loop(s_q, s_k, causal):
    rng = np.random.default_rng(s_q * 31 + s_k)
    q = rng.standard_normal((2, 3, s_q, 8), np.float32)
    k = rng.standard_normal((2, 3, s_k, 8), np.float32)
    v = rng.standard_normal((2, 3, s_k, 8), np.float32)
    calls = fa.reference_calls
    got = fa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                             causal=causal)
    assert fa.reference_calls == calls + 1
    # float32 logits and softmax against a float64 loop
    np.testing.assert_allclose(got.numpy(), _loop_attention(q, k, v, causal),
                               atol=1e-5, rtol=0)


def test_plain_adam_matches_numpy():
    rng = np.random.default_rng(7)
    n = 1001
    p, g, m = (rng.standard_normal(n).astype(np.float32) for _ in range(3))
    v = rng.random(n).astype(np.float32)
    lr, bc1, bc2, b1, b2, eps, decay = 1e-3, 0.19, 0.0029, 0.9, 0.999, 1e-8, 0.99
    f = np.float32
    want_p = p * f(decay)
    want_m = f(b1) * m + f(1 - b1) * g
    want_v = f(b2) * v + f(1 - b2) * (g * g)
    want_p = want_p - f(lr) * (want_m / f(bc1)) / (
        np.sqrt(want_v / f(bc2)) + f(eps))
    tp, tm, tv = (torch.from_numpy(a.copy()) for a in (p, m, v))
    out = torch.empty(n, dtype=torch.bfloat16)
    fo.fused_adam_update(tp, torch.from_numpy(g), tm, tv, lr, bc1, bc2,
                         beta1=b1, beta2=b2, eps=eps, decay=decay, p_out=out)
    # the same float32 operations in the same order: equal to the bit
    np.testing.assert_array_equal(tm.numpy(), want_m)
    np.testing.assert_array_equal(tv.numpy(), want_v)
    np.testing.assert_array_equal(tp.numpy(), want_p)
    np.testing.assert_array_equal(out.float().numpy(),
                                  tp.to(torch.bfloat16).float().numpy())


def test_kernel_entry_points_refuse_cpu_tensors():
    q = torch.zeros(1, 1, 4, 64)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_forward(q, q, q)


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels have no CPU "
                    "mode (chip_smoke.py and this file on the card run them)")


# fp32: the kernel against the plain version, summation order only.
# bf16: kernel and plain version round at different points (the plain
# version rounds the probabilities and dP to bf16), so both are held
# against the plain version in float32 on the upcast inputs, and the
# kernel's max abs error may be at most twice the plain one's plus 1e-3
TOL_FP32 = dict(atol=1e-4, rtol=1e-4)
BF16_ERR_RATIO, BF16_ERR_FLOOR = 2.0, 1e-3


def _outputs(fn, q, k, v, do, causal):
    x = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fn(*x, causal=causal)
    out.backward(do)
    return [out.detach()] + [t.grad for t in x]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape,causal", [
    ((2, 4, 256, 64), True), ((1, 4, 200, 128), True),
    ((2, 2, 130, 64), False), ((1, 4, (96, 200), 64), True),
    ((1, 2, (150, 70), 128), True)],
    ids=["causal-d64", "causal-tail-d128", "noncausal-tail", "splash-offset",
         "rows-see-no-key"])
def test_flash_kernel_matches_plain_on_cuda(shape, causal, dtype):
    _cuda_or_skip()
    b, h, s, d = shape
    s_q, s_k = s if isinstance(s, tuple) else (s, s)
    gen = torch.Generator(device="cuda").manual_seed(s_q + 7 * s_k + d)
    q = torch.randn((b, h, s_q, d), generator=gen, device="cuda").to(dtype)
    k = torch.randn((b, h, s_k, d), generator=gen, device="cuda").to(dtype)
    v = torch.randn((b, h, s_k, d), generator=gen, device="cuda").to(dtype)
    do = torch.randn((b, h, s_q, d), generator=gen, device="cuda").to(dtype)
    got = _outputs(fa.flash_attention, q, k, v, do, causal)
    plain = _outputs(fa.flash_attention_reference, q, k, v, do, causal)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        for g, p in zip(got, plain):
            torch.testing.assert_close(g, p, **TOL_FP32)
        return
    exact = _outputs(fa.flash_attention_reference,
                     *(t.float() for t in (q, k, v, do)), causal)
    for name, g, p, e in zip(("o", "dq", "dk", "dv"), got, plain, exact):
        e_kernel = (g.float() - e).abs().max().item()
        e_plain = (p.float() - e).abs().max().item()
        assert e_kernel <= BF16_ERR_RATIO * e_plain + BF16_ERR_FLOOR, (
            f"{name}: kernel {e_kernel:.3e}, plain bf16 {e_plain:.3e} "
            f"against float32")


@pytest.mark.parametrize("g_dtype", [torch.float32, torch.bfloat16],
                         ids=["g-fp32", "g-bf16"])
def test_adam_kernel_equals_plain_on_cuda(g_dtype):
    _cuda_or_skip()
    gen = torch.Generator(device="cuda").manual_seed(3)
    n = 1_000_003  # a tail past the last 4-element group
    p = torch.randn(n, generator=gen, device="cuda")
    g = torch.randn(n, generator=gen, device="cuda").to(g_dtype)
    m = torch.randn(n, generator=gen, device="cuda")
    v = torch.rand(n, generator=gen, device="cuda")
    args = dict(beta1=0.9, beta2=0.999, eps=1e-8, decay=1 - 1e-6)
    state = [[t.clone() for t in (p, m, v)] + [torch.empty(
        n, dtype=torch.bfloat16, device="cuda")] for _ in range(2)]
    launches = fo.launches
    fo.fused_adam_update(state[0][0], g, state[0][1], state[0][2], 1e-4,
                         0.1, 0.001, p_out=state[0][3], **args)
    torch.cuda.synchronize()
    assert fo.launches == launches + 1
    fo.fused_adam_update_reference(state[1][0], g, state[1][1], state[1][2],
                                   1e-4, 0.1, 0.001, p_out=state[1][3],
                                   **args)
    # each operation rounded on its own, in the plain version's order
    for got, want in zip(*state):
        assert torch.equal(got, want)


# the bf16 backward at the training shape and the tails, and its dq from
# float32 bulk adds whose order changes between runs: two runs on the same
# inputs agree within one bf16 step of the larger value plus 1e-5 (float32
# reassociation of up to 16 key tiles' parts before the one rounding);
# dk and dv are the same bit for bit
DQ_RUN_RTOL, DQ_RUN_ATOL = 2.0 ** -7, 1e-5


@pytest.mark.parametrize("shape", [(8, 16, 1024, 1024, 64),
                                   (2, 8, 1000, 1000, 64),
                                   (1, 8, 200, 333, 128)],
                         ids=["train", "causal-tail", "rect-tail-d128"])
def test_bf16_backward_at_the_training_shape_and_tails_on_cuda(shape):
    _cuda_or_skip()
    b, h, s_q, s_k, d = shape
    gen = torch.Generator(device="cuda").manual_seed(s_q + s_k + d)
    q, do = (torch.randn((b, h, s_q, d), generator=gen, device="cuda")
             .bfloat16() for _ in range(2))
    k, v = (torch.randn((b, h, s_k, d), generator=gen, device="cuda")
            .bfloat16() for _ in range(2))
    launches = fa.bwd_launches
    got = _outputs(fa.flash_attention, q, k, v, do, True)
    torch.cuda.synchronize()
    assert fa.bwd_launches == launches + 1
    plain = _outputs(fa.flash_attention_reference, q, k, v, do, True)
    exact = _outputs(fa.flash_attention_reference,
                     *(t.float() for t in (q, k, v, do)), True)
    for name, g, p, e in zip(("dq", "dk", "dv"), got[1:], plain[1:],
                             exact[1:]):
        e_kernel = (g.float() - e).abs().max().item()
        e_plain = (p.float() - e).abs().max().item()
        assert e_kernel <= BF16_ERR_RATIO * e_plain + BF16_ERR_FLOOR, (
            f"{name}: kernel {e_kernel:.3e}, plain bf16 {e_plain:.3e} "
            f"against float32")


def test_bf16_backward_runs_agree_on_cuda():
    _cuda_or_skip()
    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v, do = (torch.randn((8, 16, 1024, 64), generator=gen,
                               device="cuda").bfloat16() for _ in range(4))
    o, lse = fa.flash_attention_forward(q, k, v, causal=True)
    runs = [fa.flash_attention_backward(q, k, v, o, lse, do, causal=True)
            for _ in range(2)]
    torch.cuda.synchronize()
    (dq1, dk1, dv1), (dq2, dk2, dv2) = runs
    assert torch.equal(dk1, dk2) and torch.equal(dv1, dv2)
    torch.testing.assert_close(dq1.float(), dq2.float(), rtol=DQ_RUN_RTOL,
                               atol=DQ_RUN_ATOL)


# the float32 backward (3xTF32) adds each key tile's part of dq into the
# float32 output in no fixed order: two runs on the same inputs differ by
# float32 reassociation of at most 16 parts (a few ulps of their largest,
# about 1e-6 of the value; 3e-8 measured on the H100), held to rtol 1e-5
# plus atol 1e-6; o, lse, dk and dv are the same bit for bit
DQ_RUN_FP32_RTOL, DQ_RUN_FP32_ATOL = 1e-5, 1e-6


def test_fp32_runs_agree_on_cuda():
    _cuda_or_skip()
    gen = torch.Generator(device="cuda").manual_seed(6)
    q, k, v, do = (torch.randn((8, 16, 1024, 64), generator=gen,
                               device="cuda") for _ in range(4))
    (o, lse), (o2, lse2) = (fa.flash_attention_forward(q, k, v, causal=True)
                            for _ in range(2))
    runs = [fa.flash_attention_backward(q, k, v, o, lse, do, causal=True)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    (dq1, dk1, dv1), (dq2, dk2, dv2) = runs
    assert torch.equal(dk1, dk2) and torch.equal(dv1, dv2)
    torch.testing.assert_close(dq1, dq2, rtol=DQ_RUN_FP32_RTOL,
                               atol=DQ_RUN_FP32_ATOL)


def test_fp32_at_the_training_shape_matches_plain_on_cuda():
    """Phase 10's float32 attention (gpt3-350m: 16 heads of 64, batch 8,
    seq 1024, causal): one forward and one backward launch, against the
    plain version at TOL_FP32."""
    _cuda_or_skip()
    gen = torch.Generator(device="cuda").manual_seed(8)
    q, k, v, do = (torch.randn((8, 16, 1024, 64), generator=gen,
                               device="cuda") for _ in range(4))
    fwd, bwd = fa.fwd_launches, fa.bwd_launches
    got = _outputs(fa.flash_attention, q, k, v, do, True)
    torch.cuda.synchronize()
    assert (fa.fwd_launches, fa.bwd_launches) == (fwd + 1, bwd + 1)
    plain = _outputs(fa.flash_attention_reference, q, k, v, do, True)
    for name, g, p in zip(("o", "dq", "dk", "dv"), got, plain):
        torch.testing.assert_close(g, p, **TOL_FP32, msg=name)


@pytest.mark.parametrize("shape,causal", [
    ((1, 2, 1, 1, 64), True), ((1, 2, 65, 63, 64), True),
    ((1, 2, 63, 65, 128), False), ((2, 3, 130, 70, 128), False),
    ((1, 1, 64, 64, 64), True), ((3, 2, 1, 200, 64), True)],
    ids=["one-by-one", "tail-rows-see-no-key", "short-rect-d128",
         "noncausal-rect-d128", "one-tile", "one-query"])
def test_bf16_backward_at_edge_shapes_on_cuda(shape, causal):
    _cuda_or_skip()
    b, h, s_q, s_k, d = shape
    gen = torch.Generator(device="cuda").manual_seed(3 * s_q + s_k + d)
    q, do = (torch.randn((b, h, s_q, d), generator=gen, device="cuda")
             .bfloat16() for _ in range(2))
    k, v = (torch.randn((b, h, s_k, d), generator=gen, device="cuda")
            .bfloat16() for _ in range(2))
    got = _outputs(fa.flash_attention, q, k, v, do, causal)
    plain = _outputs(fa.flash_attention_reference, q, k, v, do, causal)
    exact = _outputs(fa.flash_attention_reference,
                     *(t.float() for t in (q, k, v, do)), causal)
    torch.cuda.synchronize()
    for name, g, p, e in zip(("o", "dq", "dk", "dv"), got, plain, exact):
        assert torch.isfinite(g).all(), name
        e_kernel = (g.float() - e).abs().max().item()
        e_plain = (p.float() - e).abs().max().item()
        assert e_kernel <= BF16_ERR_RATIO * e_plain + BF16_ERR_FLOOR, (
            f"{name}: kernel {e_kernel:.3e}, plain bf16 {e_plain:.3e}")


# the bf16 forward (wgmma, TMA ring) at chip_smoke.py's FLASH_CASES shapes
# and the edge shapes; its lse against the float32 logsumexp of the
# upcast inputs within LSE_ATOL (float32 products summed in another
# order, exp2 of pre-scaled logits) and LSE_RTOL (which only matters for
# a row that sees no key: -1e30 + log s_k)
LSE_ATOL, LSE_RTOL = 1e-4, 1e-6
FWD_SHAPES = [  # (b, h, s_q, s_k, d, causal)
    (8, 16, 1024, 1024, 64, True), (2, 16, 512, 512, 128, True),
    (2, 4, 384, 384, 64, False), (2, 8, 1000, 1000, 64, True),
    (1, 8, 200, 333, 128, True), (2, 16, 256, 640, 128, True),
    (1, 16, 4096, 4096, 64, True),
    (1, 2, 1, 1, 64, True), (3, 2, 1, 200, 64, True),
    (1, 1, 64, 64, 64, True), (1, 2, 128, 128, 64, True),
    (1, 2, 150, 70, 128, True), (1, 2, 65, 63, 64, True),
    (2, 3, 130, 70, 128, False), (1, 2, 63, 65, 128, False)]
FWD_IDS = ["train", "causal-d128", "noncausal", "causal-tail",
           "rect-tail-d128", "splash-offset", "splash-route", "one-by-one",
           "one-query", "one-tile", "one-block", "rows-see-no-key-d128",
           "tail-rows-see-no-key", "noncausal-rect-d128", "short-rect-d128"]


def _lse_reference(q, k, causal):
    logits = (q.float() @ k.float().transpose(-1, -2)) * (q.shape[-1] ** -0.5)
    if causal:
        s_q, s_k = logits.shape[-2:]
        keep = torch.ones(s_q, s_k, dtype=torch.bool,
                          device=q.device).tril(s_k - s_q)
        logits = logits.masked_fill(~keep, -1e30)
    return torch.logsumexp(logits, dim=-1)


@pytest.mark.parametrize("shape", FWD_SHAPES, ids=FWD_IDS)
def test_bf16_forward_matches_plain_on_cuda(shape):
    _cuda_or_skip()
    b, h, s_q, s_k, d, causal = shape
    gen = torch.Generator(device="cuda").manual_seed(5 * s_q + s_k + d)
    q = torch.randn((b, h, s_q, d), generator=gen, device="cuda").bfloat16()
    k, v = (torch.randn((b, h, s_k, d), generator=gen, device="cuda")
            .bfloat16() for _ in range(2))
    launches = fa.fwd_launches
    o, lse = fa.flash_attention_forward(q, k, v, causal=causal)
    o2, lse2 = fa.flash_attention_forward(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.fwd_launches == launches + 2
    # deterministic: a fixed order of tiles and sums
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    with torch.no_grad():
        plain = fa.flash_attention_reference(q, k, v, causal=causal)
        exact = fa.flash_attention_reference(q.float(), k.float(), v.float(),
                                             causal=causal)
    assert torch.isfinite(o).all()
    e_kernel = (o.float() - exact).abs().max().item()
    e_plain = (plain.float() - exact).abs().max().item()
    assert e_kernel <= BF16_ERR_RATIO * e_plain + BF16_ERR_FLOOR, (
        f"o: kernel {e_kernel:.3e}, plain bf16 {e_plain:.3e} against float32")
    torch.testing.assert_close(lse, _lse_reference(q, k, causal),
                               atol=LSE_ATOL, rtol=LSE_RTOL)


@pytest.mark.parametrize("shape", [(8, 16, 1024, 1024, 64),
                                   (1, 8, 200, 333, 128)],
                         ids=["train", "rect-tail-d128"])
def test_bf16_backward_after_forward_on_the_same_tensors_on_cuda(shape):
    """The forward and the backward map the same q, k and v: the backward
    must get maps of its own box (both use one box and swizzle)."""
    _cuda_or_skip()
    b, h, s_q, s_k, d = shape
    gen = torch.Generator(device="cuda").manual_seed(s_q + 3 * s_k)
    q, do = (torch.randn((b, h, s_q, d), generator=gen, device="cuda")
             .bfloat16() for _ in range(2))
    k, v = (torch.randn((b, h, s_k, d), generator=gen, device="cuda")
            .bfloat16() for _ in range(2))
    o, lse = fa.flash_attention_forward(q, k, v, causal=True)
    got = fa.flash_attention_backward(q, k, v, o, lse, do, causal=True)
    plain = _outputs(fa.flash_attention_reference, q, k, v, do, True)
    exact = _outputs(fa.flash_attention_reference,
                     *(t.float() for t in (q, k, v, do)), True)
    torch.cuda.synchronize()
    for name, g, p, e in zip(("o", "dq", "dk", "dv"), (o, *got), plain,
                             exact):
        e_kernel = (g.float() - e).abs().max().item()
        e_plain = (p.float() - e).abs().max().item()
        assert e_kernel <= BF16_ERR_RATIO * e_plain + BF16_ERR_FLOOR, (
            f"{name}: kernel {e_kernel:.3e}, plain bf16 {e_plain:.3e}")


def _train_sizes():
    from paddle_tpu_torch.text import GPTForCausalLM, gpt_config

    model = GPTForCausalLM(gpt_config("gpt3-350m", max_seq_len=1024),
                           device="meta")
    return [p.numel() for p in model.parameters()]


def test_multi_tensor_adam_equals_plain_on_cuda():
    """One step over the training path's 292 tensors and odd sizes, the
    gradients float32 and bfloat16 in turn, decay on every other tensor:
    bit for bit, in the plan's launches."""
    _cuda_or_skip()
    gen = torch.Generator(device="cuda").manual_seed(11)
    sizes = _train_sizes() + [1, 3, 5, 1023, 4097, 16385, 1_000_003]
    groups, plain = [], []
    for i, n in enumerate(sizes):
        g_dtype = torch.bfloat16 if i % 2 else torch.float32
        p = torch.randn(n, generator=gen, device="cuda")
        g = torch.randn(n, generator=gen, device="cuda").to(g_dtype)
        m = torch.randn(n, generator=gen, device="cuda")
        v = torch.rand(n, generator=gen, device="cuda")
        decay = 1 - 1e-6 if i % 3 else 1.0
        out = torch.empty(n, dtype=torch.bfloat16, device="cuda")
        groups.append((p, g, m, v, decay, out if i % 4 else None))
        plain.append((p.clone(), g, m.clone(), v.clone(), decay,
                      torch.empty_like(out) if i % 4 else None))
    hyper = dict(beta1=0.9, beta2=0.999, eps=1e-8)
    plan = fo.adam_launch_plan(sizes, [t[1].dtype for t in groups],
                               fo.kernel_param_bytes())
    launches, tensors = fo.launches, fo.tensors
    fo.fused_adam_update_many(groups, 1e-4, 0.1, 0.001, **hyper)
    torch.cuda.synchronize()
    assert fo.launches == launches + len(plan)
    assert fo.tensors == tensors + len(sizes)
    for p, g, m, v, decay, out in plain:
        fo.fused_adam_update_reference(p, g, m, v, 1e-4, 0.1, 0.001,
                                       decay=decay, p_out=out, **hyper)
    for i, (got, want) in enumerate(zip(groups, plain)):
        for name, a, w in zip(("p", "m", "v"), (got[0], got[2], got[3]),
                              (want[0], want[2], want[3])):
            assert torch.equal(a, w), f"tensor {i} ({a.numel()}) {name}"
        if got[5] is not None:
            assert torch.equal(got[5], want[5]), f"tensor {i} p_bf16"
