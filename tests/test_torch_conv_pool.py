"""The port's convolutions and pools against the JAX package's, on the
CPU: every conv, transposed conv, pool, adaptive pool and unpool of
``nn.functional`` over each padding form (an int, ``n`` ints, ``2n``
ints, pairs, ``"SAME"`` at stride 1 and 2, ``"VALID"``), strides,
dilations and groups, ``NCHW`` and ``NHWC``, ``ceil_mode``, both
``exclusive`` values, ``return_mask`` and adaptive sizes that do not
divide. The same seeded numpy inputs go through both; the outputs and
the gradients of ``sum(output * cotangent)`` with respect to every float
input must agree within rtol 1e-4 / atol 1e-5 (a float32 sum in a
different order; the transposed convolutions' gradients hold larger
values, so their atol is 1e-4). Integer outputs (the pooling masks)
must be equal.

Max-pool inputs are permutations of distinct values: where a window
holds equal values (a tie), JAX and torch route the gradient to
different members, and no test holds that. The unpool cases pool with
the stride equal to the kernel: overlapping windows can name one
position twice, and which duplicate's gradient survives the scatter is
each library's own. Where the reference's
behaviour is not Paddle's, the test pins the reference's:
``adaptive_max_pool2d`` ignores ``return_mask``; a transposed
convolution with ``groups > 1``, or string padding at stride > 1, raises
there; ``output_size`` is ignored there (the port reads it as the
output padding it implies)."""
import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu_torch import _device
from paddle_tpu_torch.analysis.layercheck import to_numpy

TOL = (1e-4, 1e-5)
TOL_T = (1e-4, 1e-4)
CASES = {}


def case(name, fn, *makers, grad=(0,), tol=TOL):
    """``fn(F, *tensors)``: F a package's ``nn.functional``."""
    CASES[name] = (fn, makers, grad, tol)


def f(*shape):
    return lambda rng: rng.standard_normal(shape).astype(np.float32)


def distinct(*shape):
    def make(rng):
        n = int(np.prod(shape))
        return (rng.permutation(n).reshape(shape) / n - 0.5).astype(
            np.float32)
    return make


X2 = f(2, 4, 9, 8)
W2 = f(6, 2, 3, 3)          # groups 2
B6 = f(6)
for _pad in (0, 1, [1, 2], [1, 0, 2, 1], [[1, 2], [0, 1]], "SAME", "VALID",
             "same"):
    for _s in (1, 2):
        case(f"conv2d_pad{_pad}_s{_s}".replace(" ", ""),
             lambda F, x, w, b, p=_pad, s=_s: F.conv2d(x, w, b, s, p, 1, 2),
             X2, W2, B6, grad=(0, 1, 2))
case("conv2d_dilation_stride_nobias",
     lambda F, x, w: F.conv2d(x, w, None, [2, 1], [2, 1], [2, 3]),
     f(2, 3, 11, 10), f(4, 3, 3, 2), grad=(0, 1))
case("conv2d_nhwc_same_s2",
     lambda F, x, w, b: F.conv2d(x, w, b, 2, "SAME", 1, 2, "NHWC"),
     f(2, 9, 8, 4), W2, B6, grad=(0, 1, 2))
case("conv2d_nhwc_pairs",
     lambda F, x, w, b: F.conv2d(x, w, b, 1, [1, 2, 0, 1], 2, 1, "NHWC"),
     f(2, 7, 8, 2), f(3, 2, 3, 3), f(3), grad=(0, 1, 2))
case("conv2d_negative_pad",
     lambda F, x, w: F.conv2d(x, w, None, 1, [[-1, 2], [0, -1]]),
     f(1, 2, 7, 6), f(3, 2, 2, 2), grad=(0, 1))
case("conv1d", lambda F, x, w, b: F.conv1d(x, w, b, 2, [1, 2], 1, 2),
     f(2, 4, 11), f(6, 2, 3), B6, grad=(0, 1, 2))
case("conv1d_same_dilated", lambda F, x, w: F.conv1d(x, w, None, 2, "SAME",
                                                     2), f(2, 3, 10),
     f(4, 3, 3), grad=(0, 1))
case("conv3d", lambda F, x, w, b: F.conv3d(x, w, b, [1, 2, 1], 1, 1, 2),
     f(1, 4, 5, 6, 4), f(4, 2, 3, 2, 3), f(4), grad=(0, 1, 2))
case("conv3d_same", lambda F, x, w: F.conv3d(x, w, None, 2, "SAME",
                                             [1, 1, 2]),
     f(1, 2, 5, 6, 7), f(3, 2, 2, 3, 2), grad=(0, 1))
XT = f(2, 4, 5, 4)
WT = f(4, 3, 3, 3)
for _pad in (0, 1, [1, 2], [[1, 0], [2, 1]]):
    for _s, _op in ((1, 0), (2, 0), (2, 1), (3, 2)):
        case(f"conv2d_transpose_pad{_pad}_s{_s}_op{_op}".replace(" ", ""),
             lambda F, x, w, b, p=_pad, s=_s, op=_op: F.conv2d_transpose(
                 x, w, b, s, p, op), XT, WT, f(3), grad=(0, 1, 2),
             tol=TOL_T)
for _pad in ("SAME", "VALID"):
    case(f"conv2d_transpose_{_pad}_s1",
         lambda F, x, w, p=_pad: F.conv2d_transpose(x, w, None, 1, p,
                                                    dilation=2),
         XT, WT, grad=(0, 1), tol=TOL_T)
case("conv2d_transpose_dilation",
     lambda F, x, w: F.conv2d_transpose(x, w, None, 2, 1, 1, dilation=2),
     XT, WT, grad=(0, 1), tol=TOL_T)
case("conv1d_transpose", lambda F, x, w, b: F.conv1d_transpose(
    x, w, b, 3, [1, 2], 1), f(2, 3, 6), f(3, 2, 4), f(2), grad=(0, 1, 2),
     tol=TOL_T)
case("conv3d_transpose", lambda F, x, w: F.conv3d_transpose(
    x, w, None, 2, [1, 0, 1], [1, 0, 1], 1, [1, 2, 1]),
     f(1, 2, 3, 3, 2), f(2, 3, 2, 3, 2), grad=(0, 1), tol=TOL_T)

XP = distinct(2, 3, 9, 8)
for _k, _s, _p, _cm in ((2, None, 0, False), (3, 2, 1, False),
                        (3, 2, 1, True), (3, 2, 0, True), (2, 1, "SAME", False),
                        (3, 2, "SAME", True), (3, 3, "VALID", True),
                        ([3, 2], [2, 1], [1, 0], False)):
    _tag = f"k{_k}_s{_s}_p{_p}_cm{int(_cm)}".replace(" ", "")
    case(f"max_pool2d_{_tag}", lambda F, x, k=_k, s=_s, p=_p, cm=_cm:
         F.max_pool2d(x, k, s, p, cm), XP)
    for _ex in (True, False):
        case(f"avg_pool2d_{_tag}_ex{int(_ex)}",
             lambda F, x, k=_k, s=_s, p=_p, cm=_cm, ex=_ex:
             F.avg_pool2d(x, k, s, p, cm, ex), XP)
case("max_pool2d_nhwc", lambda F, x: F.max_pool2d(
    x, 3, 2, 1, True, data_format="NHWC"), distinct(2, 9, 8, 3))
case("avg_pool2d_nhwc", lambda F, x: F.avg_pool2d(
    x, 3, 2, 1, True, False, data_format="NHWC"), f(2, 9, 8, 3))
case("max_pool2d_mask", lambda F, x: F.max_pool2d(x, 3, 2, 1,
                                                  return_mask=True), XP)
case("max_pool2d_mask_same", lambda F, x: F.max_pool2d(
    x, 2, 2, "SAME", return_mask=True), distinct(2, 3, 7, 8))
case("max_pool1d", lambda F, x: F.max_pool1d(x, 3, 2, 1, False, True),
     distinct(2, 3, 10))
case("max_pool1d_mask", lambda F, x: F.max_pool1d(x, 2, None, 0, True),
     distinct(2, 3, 9))
case("avg_pool1d", lambda F, x: F.avg_pool1d(x, 3, 2, 1, True, True),
     f(2, 3, 10))
case("avg_pool1d_inclusive", lambda F, x: F.avg_pool1d(x, 3, 2, 1, False),
     f(2, 3, 10))
X3 = distinct(1, 2, 5, 6, 7)
case("max_pool3d", lambda F, x: F.max_pool3d(x, 2, 2, 1), X3)
case("max_pool3d_ceil", lambda F, x: F.max_pool3d(x, 3, 2, 1, True), X3)
case("max_pool3d_mask", lambda F, x: F.max_pool3d(x, 2, 2, 0,
                                                  return_mask=True), X3)
case("avg_pool3d", lambda F, x: F.avg_pool3d(x, 3, 2, 1, True, True), X3)
case("avg_pool3d_inclusive_same", lambda F, x: F.avg_pool3d(
    x, 2, 1, "SAME", exclusive=False), X3)
for _o in (3, [3, 4], [None, 3], [4, 2], [9, 8], 1):
    _tag = str(_o).replace(" ", "")
    case(f"adaptive_avg_pool2d_{_tag}",
         lambda F, x, o=_o: F.adaptive_avg_pool2d(x, o), XP)
    case(f"adaptive_max_pool2d_{_tag}",
         lambda F, x, o=_o: F.adaptive_max_pool2d(x, o), XP)
case("adaptive_avg_pool2d_nhwc", lambda F, x: F.adaptive_avg_pool2d(
    x, [2, 3], "NHWC"), f(2, 9, 8, 3))
case("adaptive_max_pool2d_mask_ignored", lambda F, x: F.adaptive_max_pool2d(
    x, [4, 3], return_mask=True), XP)
case("adaptive_avg_pool1d", lambda F, x: F.adaptive_avg_pool1d(x, 4),
     f(2, 3, 10))
case("adaptive_avg_pool1d_divides", lambda F, x: F.adaptive_avg_pool1d(
    x, [4]), f(2, 3, 8))
case("adaptive_max_pool1d", lambda F, x: F.adaptive_max_pool1d(x, 4),
     distinct(2, 3, 10))
case("adaptive_max_pool1d_mask", lambda F, x: F.adaptive_max_pool1d(
    x, 3, True), distinct(2, 3, 10))
case("adaptive_avg_pool3d", lambda F, x: F.adaptive_avg_pool3d(
    x, [2, None, 4]), X3)
case("adaptive_max_pool3d", lambda F, x: F.adaptive_max_pool3d(x, [2, 3,
                                                                   4]), X3)
case("adaptive_max_pool3d_mask", lambda F, x: F.adaptive_max_pool3d(
    x, [3, 2, 4], True), X3)


def _pooled(nd, shape, k, s=None, p=0):
    """A max pool's values and its int32 indices as two input arrays."""
    def vals(rng):
        x = J.to_tensor(distinct(*shape)(rng))
        fn = getattr(J.nn.functional, f"max_pool{nd}d")
        out, idx = fn(x, k, s, p, return_mask=True)
        vals.idx = np.asarray(idx.numpy())
        return np.asarray(out.numpy())
    return vals, lambda rng: vals.idx


_v, _i = _pooled(2, (2, 3, 9, 8), 2, 2)
case("max_unpool2d", lambda F, x, i: F.max_unpool2d(x, i, 2, 2), _v, _i)
case("max_unpool2d_output_size", lambda F, x, i: F.max_unpool2d(
    x, i, 2, 2, output_size=[2, 3, 9, 8]), _v, _i)
_v1, _i1 = _pooled(1, (2, 3, 9), 2, 2, 1)
case("max_unpool1d", lambda F, x, i: F.max_unpool1d(x, i, 2, 2, 1), _v1, _i1)
_v3, _i3 = _pooled(3, (1, 2, 4, 6, 5), 2)
case("max_unpool3d", lambda F, x, i: F.max_unpool3d(
    x, i, 2, output_size=[4, 6, 5]), _v3, _i3)


@pytest.fixture(autouse=True)
def _cpu():
    prev = _device._CURRENT
    T.set_device("cpu")
    yield
    _device._CURRENT = prev


def _run(P, name):
    fn, makers, grad, _ = CASES[name]
    rng = np.random.default_rng(0)
    arrays = [m(rng) for m in makers]
    ts = [P.to_tensor(a, stop_gradient=i not in grad)
          for i, a in enumerate(arrays)]
    out = fn(P.nn.functional, *ts)
    outs = list(out) if isinstance(out, (tuple, list)) else [out]
    crng = np.random.default_rng(1)
    loss = None
    for o in outs:
        if not np.issubdtype(to_numpy(o).dtype, np.floating):
            continue
        c = P.to_tensor(crng.standard_normal(tuple(o.shape)).astype(
            np.float32))
        term = P.sum(o * c)
        loss = term if loss is None else loss + term
    loss.backward()
    return ([to_numpy(o) for o in outs],
            [to_numpy(ts[i].grad) for i in grad])


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_reference(name):
    rtol, atol = CASES[name][3]
    want, want_g = _run(J, name)
    got, got_g = _run(T, name)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape, (g.shape, w.shape)
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)
        else:
            assert g.dtype == w.dtype == np.int32
            np.testing.assert_array_equal(g, w)
    for i, (g, w) in enumerate(zip(got_g, want_g)):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                   err_msg=f"grad {i}")


def test_every_conv_and_pool_function_has_a_case():
    names = {n for n in T.nn.functional.__all__
             if n.startswith(("conv", "max_pool", "avg_pool", "adaptive_",
                              "max_unpool"))}
    assert len(names) == 21
    covered = {n for n in names if any(c == n or c.startswith(n + "_")
                                       for c in CASES)}
    assert names - covered == set()


def test_transpose_groups_raise_in_the_reference_and_compose_in_the_port():
    """The reference's transposed convolution swaps the weight's first
    two axes whole, which ``lax`` refuses for ``groups > 1``; the port's
    grouped transpose equals each group's own transpose, concatenated."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 4, 5, 5)).astype(np.float32)
    w = rng.standard_normal((4, 3, 3, 3)).astype(np.float32)
    with pytest.raises(ValueError):
        J.nn.functional.conv2d_transpose(J.to_tensor(x), J.to_tensor(w),
                                         stride=2, padding=1, groups=2)
    F = T.nn.functional
    got = F.conv2d_transpose(T.to_tensor(x), T.to_tensor(w), stride=2,
                             padding=1, groups=2)
    parts = [to_numpy(J.nn.functional.conv2d_transpose(
        J.to_tensor(x[:, 2 * g:2 * g + 2]), J.to_tensor(w[2 * g:2 * g + 2]),
        stride=2, padding=1)) for g in range(2)]
    np.testing.assert_allclose(to_numpy(got), np.concatenate(parts, 1),
                               rtol=1e-4, atol=1e-5)


def test_transpose_string_padding_at_stride_two_raises_in_both():
    x = np.zeros((1, 2, 4, 4), np.float32)
    w = np.zeros((2, 3, 3, 3), np.float32)
    for P in (J, T):
        with pytest.raises(ValueError):
            P.nn.functional.conv2d_transpose(P.to_tensor(x), P.to_tensor(w),
                                             stride=2, padding="SAME")
        with pytest.raises(NotImplementedError):
            P.nn.functional.conv2d_transpose(P.to_tensor(x), P.to_tensor(w),
                                             padding="SAME",
                                             output_padding=1)


def test_output_size_is_the_output_padding_it_implies():
    """The reference ignores ``output_size``; the port's ``output_size``
    of the plain size plus one equals the reference's ``output_padding=1``
    (and an unreachable size raises)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 4, 5, 4)).astype(np.float32)
    w = rng.standard_normal((4, 3, 3, 3)).astype(np.float32)
    ref = J.nn.functional.conv2d_transpose
    plain = ref(J.to_tensor(x), J.to_tensor(w), stride=2, padding=1,
                output_size=[10, 8])
    assert list(plain.shape) == [2, 3, 9, 7]  # ignored by the reference
    want = ref(J.to_tensor(x), J.to_tensor(w), stride=2, padding=1,
               output_padding=1)
    got = T.nn.functional.conv2d_transpose(T.to_tensor(x), T.to_tensor(w),
                                           stride=2, padding=1,
                                           output_size=[10, 8])
    np.testing.assert_allclose(to_numpy(got), to_numpy(want), rtol=1e-4,
                               atol=1e-5)
    with pytest.raises(ValueError):
        T.nn.functional.conv2d_transpose(T.to_tensor(x), T.to_tensor(w),
                                         stride=2, padding=1,
                                         output_size=[12, 8])


def test_return_mask_with_ceil_mode_or_channels_last_raises_in_both():
    x = np.zeros((1, 2, 5, 5), np.float32)
    for P in (J, T):
        with pytest.raises(NotImplementedError):
            P.nn.functional.max_pool2d(P.to_tensor(x), 2, ceil_mode=True,
                                       return_mask=True)
        with pytest.raises(NotImplementedError):
            P.nn.functional.max_pool2d(P.to_tensor(x), 2, return_mask=True,
                                       data_format="NHWC")


@pytest.mark.parametrize("nd", [1, 3])
def test_channels_last_conv_is_the_channels_first_one_moved(nd):
    """``"NLC"`` / ``"NDHWC"`` (the reference reads every 1-D and 3-D
    input channels first, whatever ``data_format`` says): the port's
    channels-last result is its channels-first one with the channel axis
    moved, and the channels-first one matches the reference above."""
    rng = np.random.default_rng(4)
    x = torch.as_tensor(rng.standard_normal((2, 3) + (6,) * nd).astype(
        np.float32))
    w = torch.as_tensor(rng.standard_normal((4, 3) + (3,) * nd).astype(
        np.float32))
    F = T.nn.functional
    fn, last = (F.conv1d, "NLC") if nd == 1 else (F.conv3d, "NDHWC")
    first = fn(x, w, None, 2, "SAME")
    moved = fn(torch.movedim(x, 1, -1), w, None, 2, "SAME",
               data_format=last)
    torch.testing.assert_close(torch.movedim(moved, -1, 1), first)


def test_float32_conv_on_the_cpu_needs_no_flag():
    from paddle_tpu_torch.nn.functional import _ieee_fp32

    import contextlib

    assert isinstance(_ieee_fp32(torch.zeros(1)), contextlib.nullcontext)
