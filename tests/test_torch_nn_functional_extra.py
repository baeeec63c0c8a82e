"""The rest of item 12b-2's ``nn.functional`` against the JAX package's,
on the CPU: ``fold``, ``affine_grid``, ``grid_sample``,
``temporal_shift``, ``ctc_loss``, ``hsigmoid_loss``,
``margin_cross_entropy``, ``class_center_sample``, ``sparse_attention``
and ``gather_tree``. The same seeded numpy inputs go through both; the
outputs and the gradients of ``sum(output * cotangent)`` with respect to
the float inputs marked ``grad`` must agree within rtol 1e-4 / atol 1e-5
(sums in a different order), integer outputs exactly.

Pinned to the reference: ``grid_sample`` samples bilinearly with zero
padding whatever ``mode`` and ``padding_mode`` say (every pair is a
case); ``affine_grid`` comes out float64 there (its x64 mode), float32
in the port, equal within float32 rounding; ``class_center_sample``
draws the reference's negatives bit for bit after the same ``seed``
(its ``randint`` through the port's threefry).
"""
import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu_torch import _device
from paddle_tpu_torch.analysis.layercheck import to_numpy

TOL = (1e-4, 1e-5)
CASES = {}


def case(name, fn, *makers, grad=(0,), tol=TOL, seed=None):
    """``fn(F, *tensors)``: F a package's ``nn.functional``, called after
    ``seed(seed)`` when one is given."""
    CASES[name] = (fn, makers, grad, tol, seed)


def f(*shape, scale=1.0):
    return lambda rng: (rng.standard_normal(shape) * scale).astype(
        np.float32)


def ints(lo, hi, *shape):
    return lambda rng: rng.integers(lo, hi, shape).astype(np.int64)


def const(a):
    return lambda rng: np.asarray(a)


case("fold", lambda F, x: F.fold(x, [5, 6], 3, 2, 1), f(2, 18, 9))
case("fold_dilated", lambda F, x: F.fold(x, [7, 6], [2, 3], 1, [1, 0],
                                         [2, 1]), f(1, 12, 28))
case("affine_grid", lambda F, t: F.affine_grid(t, [2, 3, 4, 5]),
     f(2, 2, 3))
case("affine_grid_centres", lambda F, t: F.affine_grid(
    t, [2, 3, 5, 4], align_corners=False), f(2, 2, 3))
for _mode in ("bilinear", "nearest"):
    for _pm in ("zeros", "border", "reflection"):
        for _ac in (True, False):
            case(f"grid_sample_{_mode}_{_pm}_ac{int(_ac)}",
                 lambda F, x, g, m=_mode, p=_pm, a=_ac: F.grid_sample(
                     x, g, m, p, a), f(2, 3, 5, 6), f(2, 4, 3, 2, scale=0.7),
                 grad=(0, 1))
case("temporal_shift", lambda F, x: F.temporal_shift(x, 3, 0.25),
     f(6, 8, 2, 3))
case("temporal_shift_wide", lambda F, x: F.temporal_shift(x, 2, 0.4),
     f(4, 5, 3, 2))
_LP = f(7, 3, 5, scale=2.0)
_LAB = ints(1, 5, 3, 3)
_IN = const(np.array([7, 5, 6], np.int64))
_LL = const(np.array([3, 2, 1], np.int64))
for _red in ("mean", "sum", "none"):
    for _nbt in (False, True):
        case(f"ctc_loss_{_red}_nbt{int(_nbt)}",
             lambda F, lp, lab, il, ll, r=_red, n=_nbt: F.ctc_loss(
                 lp, lab, il, ll, 0, r, n), _LP, _LAB, _IN, _LL)
case("ctc_loss_blank_last_repeats", lambda F, lp, lab, il, ll: F.ctc_loss(
    lp, lab, il, ll, blank=4), f(6, 2, 5), const(np.array(
        [[1, 1, 2], [3, 3, 3]], np.int64)), const(np.array([6, 6])),
     const(np.array([3, 2])))
case("hsigmoid_loss", lambda F, x, y, w, b: F.hsigmoid_loss(x, y, 7, w, b),
     f(5, 6), ints(0, 7, 5), f(6, 6), f(6), grad=(0, 2, 3))
case("hsigmoid_loss_nobias_pow2", lambda F, x, y, w: F.hsigmoid_loss(
    x, y, 8, w), f(4, 3), ints(0, 8, 4), f(7, 3), grad=(0, 2))
_COS = lambda rng: rng.uniform(-0.9, 0.9, (6, 5)).astype(np.float32)  # noqa
for _red in ("mean", "sum", "none"):
    case(f"margin_cross_entropy_{_red}",
         lambda F, c, y, r=_red: F.margin_cross_entropy(
             c, y, 1.0, 0.5, 0.1, 8.0, reduction=r), _COS, ints(0, 5, 6))
case("margin_cross_entropy_softmax", lambda F, c, y: F.margin_cross_entropy(
    c, y, 0.9, 0.3, 0.0, 16.0, return_softmax=True), _COS, ints(0, 5, 6))


def _csr(b, h, s, rng):
    """Per-(batch, head) CSR patterns: every row keeps its diagonal and a
    seeded random subset, so each head's pattern differs."""
    offs, cols = [], []
    for _ in range(b * h):
        rows = [sorted({i} | set(rng.choice(s, rng.integers(0, s), False)))
                for i in range(s)]
        offs.append(np.cumsum([0] + [len(r) for r in rows]))
        cols.append(np.concatenate(rows))
    width = max(len(c) for c in cols)
    # pad each head's columns to one width: entries past the last offset
    # are dropped
    cols = [np.pad(c, (0, width - len(c))) for c in cols]
    return (np.stack(offs).reshape(b, h, s + 1).astype(np.int64),
            np.stack(cols).reshape(b, h, width).astype(np.int64))


def _pattern(part):
    return lambda rng: _csr(2, 3, 6, np.random.default_rng(5))[part]


case("sparse_attention", lambda F, q, k, v, o, c: F.sparse_attention(
    q, k, v, o, c), f(2, 3, 6, 4), f(2, 3, 6, 4), f(2, 3, 6, 4),
     _pattern(0), _pattern(1), grad=(0, 1, 2))
case("gather_tree", lambda F, i, p: F.gather_tree(i, p),
     ints(0, 9, 5, 2, 3), ints(0, 3, 5, 2, 3), grad=())
case("class_center_sample", lambda F, y: F.class_center_sample(y, 30, 10),
     ints(0, 30, 9), grad=(), seed=3)


@pytest.fixture(autouse=True)
def _cpu():
    prev = _device._CURRENT
    T.set_device("cpu")
    yield
    _device._CURRENT = prev


def _run(P, name):
    fn, makers, grad, _, seed = CASES[name]
    rng = np.random.default_rng(0)
    arrays = [m(rng) for m in makers]
    ts = [P.to_tensor(a, stop_gradient=i not in grad)
          for i, a in enumerate(arrays)]
    if seed is not None:
        P.seed(seed)
    out = fn(P.nn.functional, *ts)
    outs = list(out) if isinstance(out, (tuple, list)) else [out]
    if grad:
        crng = np.random.default_rng(1)
        loss = None
        for o in outs:
            c = P.to_tensor(crng.standard_normal(tuple(o.shape)).astype(
                np.float32))
            term = P.sum(o.astype("float32") * c)
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
            np.testing.assert_allclose(g, w.astype(g.dtype), rtol=rtol,
                                       atol=atol)
        else:
            np.testing.assert_array_equal(g, w)
    for i, (g, w) in enumerate(zip(got_g, want_g)):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                   err_msg=f"grad {i}")


def test_affine_grid_dtype_is_thetas():
    t = np.zeros((1, 2, 3), np.float32)
    assert to_numpy(J.nn.functional.affine_grid(
        J.to_tensor(t), [1, 1, 2, 2])).dtype == np.float64
    assert to_numpy(T.nn.functional.affine_grid(
        T.to_tensor(t), [1, 1, 2, 2])).dtype == np.float32


@pytest.mark.parametrize("seed", [0, 7])
def test_class_center_sample_draws_the_references_bits(seed):
    """After the same ``seed``, the same negatives twice in a row (the
    second call draws the generator's next key), remapped labels equal."""
    label = np.array([1, 5, 5, 9, 30, 1], np.int64)
    got, want = [], []
    for P, out in ((J, want), (T, got)):
        P.seed(seed)
        for _ in range(2):
            remapped, sampled = P.nn.functional.class_center_sample(
                P.to_tensor(label), 40, 12)
            out.append((to_numpy(remapped), to_numpy(sampled)))
    for (gr, gs), (wr, ws) in zip(got, want):
        np.testing.assert_array_equal(gs, ws)
        np.testing.assert_array_equal(gr, wr)
    assert not np.array_equal(got[0][1], got[1][1])
    assert set(label) <= set(got[0][1].tolist())


def test_class_center_sample_keeps_every_positive_when_it_has_enough():
    label = np.arange(8, dtype=np.int64)
    for P in (J, T):
        P.seed(1)
        remapped, sampled = P.nn.functional.class_center_sample(
            P.to_tensor(label), 10, 5)
        np.testing.assert_array_equal(to_numpy(sampled), label)
        np.testing.assert_array_equal(to_numpy(remapped), label)


def test_custom_trees_raise_in_both():
    x = np.zeros((2, 3), np.float32)
    for P in (J, T):
        with pytest.raises(NotImplementedError):
            P.nn.functional.hsigmoid_loss(
                P.to_tensor(x), P.to_tensor(np.zeros(2, np.int64)), 4,
                P.to_tensor(np.zeros((3, 3), np.float32)),
                path_table=P.to_tensor(np.zeros((2, 2), np.int64)))
