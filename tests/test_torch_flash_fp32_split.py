"""The float32 flash kernels' 3xTF32 arithmetic, emulated in numpy.

The float32 flash programs (``csrc/flash_attention.cu``) run every
product on the tensor cores as three TF32 products: each operand element
x is split into ``big`` (x rounded to 10 mantissa bits, to nearest, ties
away from zero: the value of ``cvt.rna.tf32.f32``) and ``small = x - big``
(exact in float32), which the tensor core reads truncated to 10 mantissa
bits; ``a b = a_small b_big + a_big b_small + a_big b_big``. Here that
arithmetic is emulated on the float32 bits and the attention forward and
backward are built from it step by step as the plain version computes
them (``sdpa_reference`` under autograd): scores, the -1e30 causal fill
(bottom-right), softmax, ``o = p v``, and ``dp = do v^T``,
``ds = p (dp - rowsum(do o))`` (no gradient through a masked score),
``dv = p^T do``, ``dk = scale ds^T q``, ``dq = scale ds k``. The TF32
products are exact and are summed in float64 here, so the emulation
isolates the split's error from the order of the sums.

Held against the JAX package's attention on the CPU (its composite
``sdpa``, which serves its flash dispatch on the CPU, and ``_splash`` in
interpret mode, as ``tests/test_kernels.py`` runs it) within
chip_smoke.py's ``FLASH_TOL_FP32`` (atol 1e-4, rtol 1e-4), and against the
same steps in float64. One TF32 product (``big`` alone) is reported at the
same inputs and leaves that tolerance in every output of every case: the
reason the split is there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from paddle_tpu.kernels.attention import sdpa as jax_sdpa
from paddle_tpu.kernels.flash_attention import _splash

ATOL, RTOL = 1e-4, 1e-4  # chip_smoke.py FLASH_TOL_FP32
CASES = [  # (b, h, s_q, s_k, d, causal)
    (1, 2, 80, 80, 64, True),
    (1, 2, 48, 72, 128, False),
    (2, 1, 70, 70, 64, True),      # a tail past one 64-row tile
    (1, 2, 40, 24, 128, True),     # rows 0-15 see no key
    (1, 2, 33, 90, 64, True),      # the splash offset
]
IDS = ["causal-d64", "full-d128", "tail", "rows-see-no-key-d128",
       "causal-offset"]


def _tf32_nearest(x):
    """x rounded to TF32 on its float32 bits: half an ulp of the 10-bit
    mantissa added to the magnitude, the low 13 bits cleared."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _tf32_truncated(x):
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def _split(x):
    big = _tf32_nearest(x)
    return big, _tf32_truncated((x - big).astype(np.float32))


def _mm(a, b, parts):
    """a @ b (float32 operands) as the kernel forms it: ``parts`` 3 is
    3xTF32, 1 is one TF32 product; the exact products summed in float64
    and rounded once to float32."""
    (ab, asm), (bb, bsm) = _split(a), _split(b)
    f = np.float64
    out = ab.astype(f) @ bb.astype(f)
    if parts == 3:
        out += asm.astype(f) @ bb.astype(f) + ab.astype(f) @ bsm.astype(f)
    return out.astype(np.float32)


def _visible(s_q, s_k, causal):
    if not causal:
        return np.ones((s_q, s_k), bool)
    return np.tril(np.ones((s_q, s_k), bool), s_k - s_q)


def _attention(q, k, v, do, causal, mm):
    """o, dq, dk, dv in the inputs' dtype with products ``mm``, the plain
    version's steps."""
    dt = q.dtype.type
    scale = dt(1.0 / np.sqrt(q.shape[-1]))
    keep = _visible(q.shape[2], k.shape[2], causal)
    kt = np.swapaxes(k, -1, -2)
    s = np.where(keep, mm(q, kt) * scale, dt(-1e30))
    e = np.exp(s - s.max(-1, keepdims=True))
    p = (e / e.sum(-1, keepdims=True)).astype(dt)
    o = mm(p, v)
    dp = mm(do, np.swapaxes(v, -1, -2))
    delta = (do * o).sum(-1, keepdims=True, dtype=dt)
    ds = np.where(keep, p * (dp - delta), dt(0)).astype(dt)
    dv = mm(np.swapaxes(p, -1, -2), do)
    dk = mm(np.swapaxes(ds, -1, -2), q) * scale
    dq = mm(ds, k) * scale
    return [o, dq, dk, dv]


def _exact(q, k, v, do, causal):
    return _attention(*(a.astype(np.float64) for a in (q, k, v, do)),
                      causal, lambda a, b: a @ b)


def _jax(fn, q, k, v, do):
    out, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (q, k, v)))
    return [np.asarray(out)] + [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _inputs(case):
    b, h, s_q, s_k, d, _ = case
    rng = np.random.default_rng(s_q * 1000 + s_k + d)
    q, do = (rng.standard_normal((b, h, s_q, d), np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((b, h, s_k, d), np.float32)
            for _ in range(2))
    return q, k, v, do


def _outside(got, want):
    """The largest |got - want| over the tolerance's allowance (> 1:
    outside FLASH_TOL_FP32)."""
    return float((np.abs(got.astype(np.float64) - want)
                  / (ATOL + RTOL * np.abs(want))).max())


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_3xtf32_attention_within_fp32_tolerance(case):
    q, k, v, do = _inputs(case)
    causal = case[-1]
    got = _attention(q, k, v, do, causal, lambda a, b: _mm(a, b, 3))
    exact = _exact(q, k, v, do, causal)
    ref = _jax(lambda *x: jax_sdpa(*x, is_causal=causal), q, k, v, do)
    for name, g, e, r in zip(("o", "dq", "dk", "dv"), got, exact, ref):
        assert np.isfinite(g).all(), name
        assert _outside(g, e) <= 1.0, f"{name} against float64"
        np.testing.assert_allclose(g, r, atol=ATOL, rtol=RTOL,
                                   err_msg=f"{name} against the JAX sdpa")


def test_3xtf32_attention_matches_jax_splash():
    """The causal square case against the JAX package's splash kernel in
    interpret mode, forward and gradients."""
    q, k, v, do = _inputs((1, 2, 128, 128, 64, True))
    got = _attention(q, k, v, do, True, lambda a, b: _mm(a, b, 3))
    ref = _jax(lambda *x: _splash(*x, 1.0 / np.sqrt(64), interpret=True),
               q, k, v, do)
    for name, g, r in zip(("o", "dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(g, r, atol=ATOL, rtol=RTOL,
                                   err_msg=f"{name} against _splash")


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_one_tf32_product_leaves_the_tolerance(case, capsys):
    """One TF32 product keeps about three decimal digits: at the same
    inputs it leaves FLASH_TOL_FP32, which the split keeps."""
    q, k, v, do = _inputs(case)
    causal = case[-1]
    exact = _exact(q, k, v, do, causal)
    one = _attention(q, k, v, do, causal, lambda a, b: _mm(a, b, 1))
    three = _attention(q, k, v, do, causal, lambda a, b: _mm(a, b, 3))
    report = {name: (_outside(g1, e), _outside(g3, e))
              for name, g1, g3, e in zip(("o", "dq", "dk", "dv"), one,
                                         three, exact)}
    with capsys.disabled():
        print(f"\n  {case}: |err| / (atol + rtol |x|), one TF32 vs 3xTF32: "
              + ", ".join(f"{n} {a:.2f} vs {b:.4f}"
                          for n, (a, b) in report.items()))
    assert all(b <= 1.0 for _, b in report.values()), report
    assert all(a > 1.0 for a, _ in report.values()), report
