"""``vision.ops`` and the ``vision`` namespace of the port against the JAX
package's, on the CPU.

The same seeded numpy inputs go through both packages. Index outputs
(``nms``, ``multiclass_nms``'s rows, ``distribute_fpn_proposals``,
``bipartite_match``) must be equal, ties included; values agree within
rtol = atol = 1e-6 in float32 and 1e-12 in float64, and so do the
gradients of ``sum(output * cotangent)`` of ``roi_align``, ``roi_pool``
(the reference records none: its gradient comes from ``jax.grad`` through
the reference's own function) and ``deform_conv2d``, but for a float32
gradient that sums hundreds of terms in another order (a box's
coordinates, a weight), held to 1e-5. Where the reference
rounds a float64 call through float32 (``deform_conv2d``'s product,
``psroi_pool``'s output), the port stays float64, the approved departure
of ROADMAP Queue 3: it is held to float32's tolerance against the
reference as it is, and to 1e-12 against the reference's arithmetic in
float64 (the product without its float32 rounding; ``psroi_pool``'s host
loop, kept here as the plain version, with a float64 output).
``yolo_loss`` is held to the reference's value, and its gradient (which
the reference's loss does not take) to central differences in float64.
"""
import io
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu.vision.ops as JO
import paddle_tpu_torch as T
import paddle_tpu_torch.vision.ops as TO
from paddle_tpu_torch import _device

TOL = {np.float32: dict(rtol=1e-6, atol=1e-6),
       np.float64: dict(rtol=1e-12, atol=1e-12)}
DTYPES = (np.float32, np.float64)
#: a float32 gradient that sums many terms in another order
GRAD32 = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _cpu():
    prev = _device._CURRENT
    T.set_device("cpu")
    yield
    _device._CURRENT = prev


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().numpy()
    return np.asarray(t.numpy() if hasattr(t, "numpy") else t)


def _boxes(rng, n, size=50.0, least=2.0, most=20.0):
    xy = rng.uniform(0, size, (n, 2))
    return np.concatenate([xy, xy + rng.uniform(least, most, (n, 2))], 1)


def _close(got, want, dt, **kw):
    np.testing.assert_allclose(_np(got), _np(want), **{**TOL[dt], **kw})


def _greedy(iou, thr):
    """The reference's sweep as a plain loop: keep i unless a kept j < i
    overlaps it above ``thr``."""
    keep = []
    for i in range(iou.shape[0]):
        keep.append(not any(keep[j] and iou[j, i] > thr for j in range(i)))
    return np.asarray(keep)


# ------------------------------------------------------------------ nms
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("thr", [0.0, 0.3, 0.7])
def test_nms_indices_equal_the_reference_with_ties(dt, thr):
    rng = np.random.default_rng(1)
    b = _boxes(rng, 300).astype(dt)
    s = rng.random(300).astype(dt)
    s[40:80] = s[3]          # a block of equal scores
    b[100:110] = b[5]        # identical boxes
    got = TO.nms(T.to_tensor(b), thr, T.to_tensor(s))
    want = JO.nms(J.to_tensor(b), thr, J.to_tensor(s))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("dt", DTYPES)
def test_nms_categories_top_k_and_default_scores(dt):
    rng = np.random.default_rng(2)
    b = _boxes(rng, 120, size=30).astype(dt)
    s = np.round(rng.random(120), 1).astype(dt)   # many ties
    cat = rng.integers(0, 4, 120)
    got = TO.nms(T.to_tensor(b), 0.4, T.to_tensor(s), T.to_tensor(cat),
                 [0, 1, 2, 3], top_k=25)
    want = JO.nms(J.to_tensor(b), 0.4, J.to_tensor(s), J.to_tensor(cat),
                  [0, 1, 2, 3], top_k=25)
    np.testing.assert_array_equal(_np(got), _np(want))
    np.testing.assert_array_equal(_np(TO.nms(T.to_tensor(b), 0.2)),
                                  _np(JO.nms(J.to_tensor(b), 0.2)))
    one = b[:1]
    np.testing.assert_array_equal(_np(TO.nms(T.to_tensor(one))), [0])


def test_sweep_is_the_greedy_loop_on_long_chains():
    """A chain where box i overlaps box i + 1 only: the greedy answer
    alternates, and the fixed point takes about a pass a link."""
    rng = np.random.default_rng(3)
    for n, density in ((1, 0.5), (2, 1.0), (9, 0.0), (40, 0.1), (64, 0.6)):
        iou = rng.random((n, n)) * (rng.random((n, n)) < density)
        want = _greedy(iou, 0.5)
        by = TO._overlaps(torch.from_numpy(iou.T), 0.5).tril_(-1)
        np.testing.assert_array_equal(TO._sweep(by).numpy(), want)
    n = 33
    chain = np.zeros((n, n))
    chain[np.arange(n - 1), np.arange(1, n)] = 1.0
    before = TO.sweep_passes
    keep = TO._sweep(TO._overlaps(torch.from_numpy(chain.T), 0.5))
    np.testing.assert_array_equal(keep.numpy(), _greedy(chain, 0.5))
    assert keep.numpy().tolist() == [i % 2 == 0 for i in range(n)]
    passes = TO.sweep_passes - before
    assert n - 1 <= passes <= n + TO.SWEEP_PASSES_PER_READ


@pytest.mark.parametrize("dt,normalized,background,nms_top_k,keep_top_k", [
    (np.float32, True, 0, 40, 30), (np.float64, True, 0, 40, 30),
    (np.float32, False, -1, -1, -1), (np.float64, True, 2, 10, 200)])
def test_multiclass_nms_rows_equal_the_reference(dt, normalized, background,
                                                 nms_top_k, keep_top_k):
    rng = np.random.default_rng(4)
    b = _boxes(rng, 60, size=40).astype(dt)
    sc = np.round(rng.random((5, 60)), 2).astype(dt)
    args = (0.25, nms_top_k, keep_top_k, 0.45, normalized, 1.0, background)
    got = TO.multiclass_nms(T.to_tensor(b), T.to_tensor(sc), *args)
    want = JO.multiclass_nms(J.to_tensor(b), J.to_tensor(sc), *args)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_array_equal(_np(got), _np(want))


# -------------------------------------------------------------- roi ops
def _roi_inputs(rng, dt, n=2, c=3, h=12, w=14, r=6):
    x = rng.standard_normal((n, c, h, w)).astype(dt)
    bx = _boxes(rng, r, size=14, least=0.5, most=9).astype(dt)
    bx[-1] = [3.0, 2.0, 3.0005, 2.0002]   # a nearly empty box
    return x, bx, np.array([4, r - 4])


def _cotangent(shape, dtype, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _fwd_bwd(P, fn, arrays, grad, seed=9, eager=False):
    """``fn(P, *tensors)`` and the gradients of ``sum(out * cotangent)``
    with respect to the inputs ``grad`` names. Unless ``eager``, the
    reference's side runs as one ``jax.jit`` of its function and
    ``jax.vjp``: its eager ops would each compile on first use, seconds a
    case. XLA fuses the jitted program, which moves float32 results by a
    few 1e-6 (float64 ones by ~1e-15), so a float32 check at 1e-6 runs
    the reference eagerly, as its users do."""
    if P is J and not eager:
        def f(*vals):
            return fn(J, *[J.Tensor(v) for v in vals])._value

        shape = jax.eval_shape(f, *arrays)
        cot = _cotangent(shape.shape, shape.dtype, seed)

        def run(*vals):
            def part(*g):
                full = list(vals)
                for i, v in zip(grad, g):
                    full[i] = v
                return f(*full)
            out, vjp = jax.vjp(part, *[vals[i] for i in grad])
            return out, vjp(cot)
        out, grads = jax.jit(run)(*arrays)
        return np.asarray(out), [np.asarray(g) for g in grads]
    ts = [P.to_tensor(a, stop_gradient=i not in grad)
          for i, a in enumerate(arrays)]
    out = fn(P, *ts)
    P.sum(out * P.to_tensor(_cotangent(tuple(out.shape), arrays[0].dtype,
                                       seed))).backward()
    return out, [ts[i].grad for i in grad]


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("aligned,ratio,size,scale,num_on_device", [
    (True, -1, 7, 1.0, False), (False, 3, (3, 2), 0.7, True),
    (True, 1, (2, 5), 0.5, False)])
def test_roi_align_and_its_gradients(dt, aligned, ratio, size, scale,
                                     num_on_device):
    x, bx, num = _roi_inputs(np.random.default_rng(5), dt)

    def fn(P, x, b):
        n = P.to_tensor(num) if num_on_device and P is T else num
        ops = TO if P is T else JO
        return ops.roi_align(x, b, n, size, scale, ratio, aligned)

    got, got_g = _fwd_bwd(T, fn, [x, bx], (0, 1))
    want, want_g = _fwd_bwd(J, fn, [x, bx], (0, 1),
                            eager=dt is np.float32)
    assert got.dtype == {np.float32: torch.float32,
                         np.float64: torch.float64}[dt]
    _close(got, want, dt)
    _close(got_g[0], want_g[0], dt)
    _close(got_g[1], want_g[1], dt, **(GRAD32 if dt is np.float32 else {}))


def test_roi_align_layer_and_boxes_num_check():
    x, bx, num = _roi_inputs(np.random.default_rng(6), np.float32)
    layer = T.vision.ops.RoIAlign(3, 0.5)
    _close(layer(T.to_tensor(x), T.to_tensor(bx), num),
           J.vision.ops.RoIAlign(3, 0.5)(J.to_tensor(x), J.to_tensor(bx),
                                         num), np.float32)
    with pytest.raises(ValueError, match="boxes_num"):
        TO.roi_align(T.to_tensor(x), T.to_tensor(bx), [1, 1], 3)


def _reference_roi_pool_grad(x, bx, num, size, scale, cot):
    """The reference records no gradient for ``roi_pool``; this is
    ``jax.grad`` through its own function, jitted (its eager ops would
    each compile on first use)."""
    def loss(xv):
        out = JO.roi_pool(J.Tensor(xv), J.to_tensor(bx), num, size, scale)
        return jnp.sum(out._value * cot)
    return np.asarray(jax.jit(jax.grad(loss))(jnp.asarray(x)))


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("size,scale", [(3, 0.5), ((2, 4), 1.0)])
def test_roi_pool_and_its_gradient(dt, size, scale):
    rng = np.random.default_rng(7)
    x, bx, num = _roi_inputs(rng, dt)
    x = (rng.permutation(x.size).reshape(x.shape) / x.size).astype(dt)
    xt = T.to_tensor(x, stop_gradient=False)
    got = TO.roi_pool(xt, T.to_tensor(bx), num, size, scale)
    want = JO.roi_pool(J.to_tensor(x), J.to_tensor(bx), num, size, scale)
    np.testing.assert_array_equal(_np(got), _np(want))
    cot = rng.standard_normal(tuple(got.shape)).astype(dt)
    (got * T.to_tensor(cot)).sum().backward()
    _close(xt.grad, _reference_roi_pool_grad(x, bx, num, size, scale, cot),
           dt, **(GRAD32 if dt is np.float32 else {}))
    layer = T.vision.ops.RoIPool(size, scale)
    np.testing.assert_array_equal(
        _np(layer(T.to_tensor(x), T.to_tensor(bx), num)), _np(want))


def _psroi_loop(x, rois, oc, scale, ph, pw, counts):
    """``paddle_tpu/fluid/layers.py:2365-2407``'s loop with a float64
    output: the plain version of the port's summed-area tables."""
    n, c, h, w = x.shape
    out = np.zeros((rois.shape[0], oc, ph, pw), np.float64)
    img_of = np.repeat(np.arange(len(counts)), counts)
    for ri, roi in enumerate(rois):
        x1, y1, x2, y2 = [v * scale for v in roi]
        rh = max(y2 - y1, 0.1) / ph
        rw = max(x2 - x1, 0.1) / pw
        for i in range(ph):
            for j in range(pw):
                ys = int(np.floor(y1 + i * rh))
                ye = max(int(np.ceil(y1 + (i + 1) * rh)), ys + 1)
                xs = int(np.floor(x1 + j * rw))
                xe = max(int(np.ceil(x1 + (j + 1) * rw)), xs + 1)
                ys, ye = np.clip([ys, ye], 0, h)
                xs, xe = np.clip([xs, xe], 0, w)
                if ye <= ys or xe <= xs:
                    continue
                for o in range(oc):
                    ch = o * ph * pw + i * pw + j
                    out[ri, o, i, j] = x[img_of[ri], ch, ys:ye, xs:xe].mean()
    return out


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("size,scale", [(3, 0.6), ((2, 3), 1.3)])
def test_psroi_pool(dt, size, scale):
    rng = np.random.default_rng(8)
    ph, pw = (size, size) if isinstance(size, int) else size
    x = rng.standard_normal((2, 2 * ph * pw, 10, 11)).astype(dt)
    bx = _boxes(rng, 7, size=12, least=0.02, most=8).astype(dt)
    bx[0] = [-4.0, -3.0, 2.0, 1.5]      # partly outside the map
    bx[1] = [20.0, 20.0, 30.0, 25.0]    # wholly outside: zeros
    num = np.array([3, 4])
    got = TO.psroi_pool(T.to_tensor(x), T.to_tensor(bx), num, size, scale)
    want = JO.psroi_pool(J.to_tensor(x), J.to_tensor(bx), J.to_tensor(num),
                         size, scale)
    assert got.dtype == {np.float32: torch.float32,
                         np.float64: torch.float64}[dt]
    _close(got, want, np.float32)        # the reference's output is float32
    if dt is np.float64:
        _close(got, _psroi_loop(x, bx, 2, scale, ph, pw, num), dt)
    layer = T.vision.ops.PSRoIPool(size, scale)
    _close(layer(T.to_tensor(x), T.to_tensor(bx), num), got, dt)
    alone = TO.psroi_pool(T.to_tensor(x[:1]), T.to_tensor(bx), None, size,
                          scale)
    _close(alone, JO.psroi_pool(J.to_tensor(x[:1]), J.to_tensor(bx), None,
                                size, scale), np.float32)
    with pytest.raises(ValueError):
        TO.psroi_pool(T.to_tensor(x[:, :5]), T.to_tensor(bx), num, size)


# ------------------------------------------------------------ yolo, coder
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("clip,scale_x_y", [(True, 1.0), (False, 1.05)])
def test_yolo_box(dt, clip, scale_x_y):
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, 3 * 9, 5, 6)).astype(dt)
    img = np.array([[320, 416], [300, 200]], np.int32)
    args = ([10, 13, 16, 30, 33, 23], 4, 0.4, 32, clip, scale_x_y)
    got = TO.yolo_box(T.to_tensor(x), T.to_tensor(img), *args)
    want = JO.yolo_box(J.to_tensor(x), J.to_tensor(img), *args)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        _close(g, w, dt)


def _yolo_inputs(rng, dt, n=2, boxes=7, h=5, w=6, classes=4):
    x = rng.standard_normal((n, 3 * (5 + classes), h, w)).astype(dt)
    gt = np.concatenate([rng.uniform(0, 1, (n, boxes, 2)),
                         rng.uniform(0.05, 0.7, (n, boxes, 2))], -1).astype(dt)
    gt[0, 2, 2] = 0.0                    # skipped (w <= 0)
    gt[1, 3] = gt[1, 1]                  # same cell and anchor: the last wins
    gt[1, 3, 2:] *= 1.01
    gt[0, 4, :2] = [0.9999, 0.0]         # the edge cells
    # a centre below -1 / size: the cell index wraps, the target does not
    gt[1, 4, :2] = [-1.5 / w, -2.5 / h]
    lab = rng.integers(0, classes, (n, boxes))
    lab[1, 3] = (lab[1, 1] + 1) % classes   # two labels on one cell
    return x, gt, lab


YOLO_ARGS = ([10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119], [3, 4, 5],
             4, 0.7, 16)


@pytest.mark.parametrize("dt", DTYPES)
def test_yolo_loss_equals_the_reference(dt):
    x, gt, lab = _yolo_inputs(np.random.default_rng(11), dt)
    got = TO.yolo_loss(T.to_tensor(x), T.to_tensor(gt), T.to_tensor(lab),
                       *YOLO_ARGS)
    want = JO.yolo_loss(J.to_tensor(x), J.to_tensor(gt), J.to_tensor(lab),
                        *YOLO_ARGS)
    assert got.shape == torch.Size([])
    # the reference forms its loss in float32 whatever x's dtype
    np.testing.assert_allclose(float(got), float(_np(want)), rtol=1e-6)


def test_yolo_loss_gradient_against_central_differences():
    """Pinned difference: the reference rebuilds its prediction from host
    arrays, so its loss takes no gradient to ``x``; the port's does, and
    it matches central differences in float64."""
    x, gt, lab = _yolo_inputs(np.random.default_rng(12), np.float64,
                              boxes=5, h=3, w=4, classes=2)
    args = (YOLO_ARGS[0], [0, 1, 2], 2, 0.7, 32)
    xt = T.to_tensor(x, stop_gradient=False)
    TO.yolo_loss(xt, T.to_tensor(gt), T.to_tensor(lab), *args).backward()
    grad = _np(xt.grad)
    rng = np.random.default_rng(13)
    eps = 1e-6
    for flat in rng.choice(x.size, 40, replace=False):
        idx = np.unravel_index(flat, x.shape)
        vals = []
        for sign in (1, -1):
            xp = x.copy()
            xp[idx] += sign * eps
            vals.append(float(TO.yolo_loss(T.to_tensor(xp), T.to_tensor(gt),
                                           T.to_tensor(lab), *args)))
        np.testing.assert_allclose(grad[idx], (vals[0] - vals[1]) / (2 * eps),
                                   rtol=1e-6, atol=1e-7)
    xj = J.to_tensor(x, stop_gradient=False)
    loss = JO.yolo_loss(xj, J.to_tensor(gt), J.to_tensor(lab), *args)
    with pytest.raises(RuntimeError):
        loss.backward()


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("code", ["encode_center_size", "decode_center_size"])
@pytest.mark.parametrize("normalized,with_var", [(True, True), (False, False)])
def test_box_coder(dt, code, normalized, with_var):
    rng = np.random.default_rng(14)
    pb = _boxes(rng, 7, size=5, least=0.5, most=3).astype(dt)
    tb = _boxes(rng, 7, size=5, least=0.5, most=3).astype(dt)
    if code == "decode_center_size":
        tb = rng.standard_normal((7, 4)).astype(dt) * 0.3
    var = rng.uniform(0.1, 0.3, (7, 4)).astype(dt) if with_var else None
    got = TO.box_coder(T.to_tensor(pb), None if var is None
                       else T.to_tensor(var), T.to_tensor(tb), code,
                       normalized)
    want = JO.box_coder(J.to_tensor(pb), None if var is None
                        else J.to_tensor(var), J.to_tensor(tb), code,
                        normalized)
    _close(got, want, dt)


# ---------------------------------------------------------- deform conv
class _Float64Product:
    """``jnp`` for the reference's module, its ``einsum`` without the
    ``preferred_element_type=float32`` that rounds a float64 product."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def einsum(*args, preferred_element_type=None, **kw):
        return jnp.einsum(*args, **kw)


DCN_CASES = {  # (x, offset channels, weight, groups, dg, mask, s, p, d)
    "v1": ((2, 4, 7, 6), 18, (6, 4, 3, 3), 1, 1, False, 1, 1, 1),
    "v2_groups_dilated": ((2, 4, 8, 7), 18, (6, 2, 3, 3), 2, 1, True, 1, 2,
                          2),
    "dg2_stride": ((1, 4, 8, 9), 2 * 2 * 6, (4, 4, 2, 3), 1, 2, False,
                   (2, 1), (1, 0), 1),
}


def _dcn(P, case, arrays, grad):
    xs, oc, ws, g, dg, use_mask, s, p, d = DCN_CASES[case]
    ops = TO if P is T else JO

    def fn(P_, x, off, w, b, *m):
        return ops.deform_conv2d(x, off, w, b, s, p, d, dg, g,
                                 m[0] if m else None)
    out, grads = _fwd_bwd(P, fn, arrays, grad)
    return [out, *grads]


def _dcn_arrays(case, dt):
    xs, oc, ws, g, dg, use_mask, s, p, d = DCN_CASES[case]
    rng = np.random.default_rng(15)
    x = rng.standard_normal(xs).astype(dt)
    p2, d2 = (p, p) if isinstance(p, int) else p, (d, d) if isinstance(
        d, int) else d
    s2 = (s, s) if isinstance(s, int) else s
    oh = (xs[2] + 2 * p2[0] - d2[0] * (ws[2] - 1) - 1) // s2[0] + 1
    ow = (xs[3] + 2 * p2[1] - d2[1] * (ws[3] - 1) - 1) // s2[1] + 1
    off = (rng.standard_normal((xs[0], oc, oh, ow)) * 1.7).astype(dt)
    arrays = [x, off, rng.standard_normal(ws).astype(dt),
              rng.standard_normal(ws[0]).astype(dt)]
    if use_mask:
        arrays.append(rng.random((xs[0], ws[2] * ws[3], oh, ow)).astype(dt))
    return arrays


@pytest.mark.parametrize("case", sorted(DCN_CASES))
def test_deform_conv2d_float32(case):
    arrays = _dcn_arrays(case, np.float32)
    grad = tuple(range(len(arrays)))
    for g, w in zip(_dcn(T, case, arrays, grad), _dcn(J, case, arrays, grad)):
        _close(g, w, np.float32, **GRAD32)


@pytest.mark.parametrize("case", sorted(DCN_CASES))
def test_deform_conv2d_float64_and_its_gradients(case, monkeypatch):
    arrays = _dcn_arrays(case, np.float64)
    grad = tuple(range(len(arrays)))
    got = _dcn(T, case, arrays, grad)
    if case == "v1":  # the reference as it is: its float32 product
        for g, w in zip(got, _dcn(J, case, arrays, grad)):
            _close(g, w, np.float32, **GRAD32)
    monkeypatch.setattr(JO, "jnp", _Float64Product())
    for g, w in zip(got, _dcn(J, case, arrays, grad)):
        assert g.dtype == torch.float64
        _close(g, w, np.float64)


def test_deform_conv2d_layer_carries_the_reference_weights():
    J.seed(0)
    ref = J.vision.ops.DeformConv2D(4, 6, 3, padding=2, dilation=2, groups=2)
    T.seed(0)
    port = T.vision.ops.DeformConv2D(4, 6, 3, padding=2, dilation=2,
                                     groups=2)
    missing, unexpected = port.set_state_dict(
        {k: v.numpy() for k, v in ref.state_dict().items()})
    assert missing == [] and unexpected == []
    arrays = _dcn_arrays("v2_groups_dilated", np.float32)
    x, off, _, _, m = arrays
    got = port(T.to_tensor(x), T.to_tensor(off), T.to_tensor(m))
    # the reference layer's forward as one jitted program
    want = jax.jit(lambda *a: ref(*map(J.Tensor, a))._value)(x, off, m)
    _close(got, want, np.float32, **GRAD32)
    nobias = T.vision.ops.DeformConv2D(2, 3, (3, 2), bias_attr=False)
    assert nobias.bias is None and tuple(nobias.weight.shape) == (3, 2, 3, 2)


# ------------------------------------------------------ legacy detection
@pytest.mark.parametrize("pixel_offset", [False, True])
def test_distribute_fpn_proposals(pixel_offset):
    rng = np.random.default_rng(16)
    rois = _boxes(rng, 200, size=800, least=4, most=700).astype(np.float32)
    rois[:3] = [[0, 0, 224, 224], [10, 10, 10, 10], [0, 0, 112, 112]]
    got = TO.distribute_fpn_proposals(T.to_tensor(rois), 2, 5, 4, 224,
                                      pixel_offset)
    want = JO.distribute_fpn_proposals(J.to_tensor(rois), 2, 5, 4, 224,
                                       pixel_offset)
    for g, w in zip(got[0] + got[1] + [got[2]],
                    want[0] + want[1] + [want[2]]):
        assert g.dtype in (torch.float32, torch.int64)
        np.testing.assert_array_equal(_np(g), _np(w))


def test_generate_proposals_raises_as_the_reference():
    with pytest.raises(NotImplementedError) as port:
        TO.generate_proposals(None)
    with pytest.raises(NotImplementedError) as ref:
        JO.generate_proposals(None)
    assert str(port.value) == str(ref.value)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("normalized", [True, False])
def test_iou_similarity(dt, normalized):
    rng = np.random.default_rng(17)
    a = _boxes(rng, 9).astype(dt)
    b = _boxes(rng, 5).astype(dt)
    _close(TO.iou_similarity(T.to_tensor(a), T.to_tensor(b), normalized),
           JO.iou_similarity(J.to_tensor(a), J.to_tensor(b), normalized), dt)


def test_box_clip():
    rng = np.random.default_rng(18)
    boxes = rng.uniform(-20, 300, (2, 5, 4)).astype(np.float32)
    info = np.array([[200, 250, 1.0], [300, 100, 2.0]], np.float32)
    _close(TO.box_clip(T.to_tensor(boxes), T.to_tensor(info)),
           JO.box_clip(J.to_tensor(boxes), J.to_tensor(info)), np.float32)
    flat = boxes[0]
    _close(TO.box_clip(T.to_tensor(flat), T.to_tensor(info[:1])),
           JO.box_clip(J.to_tensor(flat), J.to_tensor(info[:1])), np.float32)
    with pytest.raises(ValueError):
        TO.box_clip(T.to_tensor(flat), T.to_tensor(info))
    with pytest.raises(ValueError):
        JO.box_clip(J.to_tensor(flat), J.to_tensor(info))


@pytest.mark.parametrize("kw", [
    dict(),
    dict(max_sizes=[20.0, 30.0], aspect_ratios=(2.0, 3.0), flip=True,
         clip=True, min_max_aspect_ratios_order=True),
    dict(max_sizes=[20.0, 30.0], aspect_ratios=(2.0,), steps=(8.0, 6.0),
         offset=0.25)], ids=["plain", "flip_clip_order", "steps"])
def test_prior_box(kw):
    feat = np.zeros((1, 2, 5, 7), np.float32)
    image = np.zeros((1, 3, 40, 56), np.float32)
    got = TO.prior_box(T.to_tensor(feat), T.to_tensor(image), [10.0, 15.0],
                       **kw)
    want = JO.prior_box(J.to_tensor(feat), J.to_tensor(image), [10.0, 15.0],
                        **kw)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape) and g.dtype == torch.float32
        np.testing.assert_array_equal(_np(g), _np(w))


def test_anchor_generator():
    feat = np.zeros((1, 2, 5, 7), np.float32)
    args = ([32, 64, 128], [0.5, 1.0, 2.0], [0.1, 0.1, 0.2, 0.2], [16, 12],
            0.4)
    for g, w in zip(TO.anchor_generator(T.to_tensor(feat), *args),
                    JO.anchor_generator(J.to_tensor(feat), *args)):
        np.testing.assert_array_equal(_np(g), _np(w))


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("match_type", [None, "per_prediction"])
@pytest.mark.parametrize("shape", [(6, 15), (9, 4)])
def test_bipartite_match(dt, match_type, shape):
    rng = np.random.default_rng(19)
    d = np.round(rng.random(shape), 1).astype(dt)   # ties
    got = TO.bipartite_match(T.to_tensor(d), match_type, 0.5)
    want = JO.bipartite_match(J.to_tensor(d), match_type, 0.5)
    np.testing.assert_array_equal(_np(got[0]), _np(want[0]))
    assert got[0].dtype == torch.int32
    # the reference's distances are float64 (its x64 zeros); the port's
    # keep the input's dtype
    np.testing.assert_array_equal(_np(got[1]), _np(want[1]).astype(dt))


# -------------------------------------------------------- files, images
def _jpeg_bytes():
    from PIL import Image

    rgb = np.random.default_rng(20).integers(0, 255, (9, 11, 3), np.uint8)
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, format="JPEG")
    return buf.getvalue()


@pytest.mark.parametrize("mode", ["unchanged", "gray"])
def test_read_file_and_decode_jpeg(tmp_path, mode):
    path = tmp_path / "img.jpg"
    path.write_bytes(_jpeg_bytes())
    got, want = TO.read_file(str(path)), JO.read_file(str(path))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(_np(got), _np(want))
    img = TO.decode_jpeg(got, mode)
    np.testing.assert_array_equal(_np(img), _np(JO.decode_jpeg(want, mode)))
    assert tuple(img.shape) == ((1, 9, 11) if mode == "gray" else (3, 9, 11))


def test_decode_jpeg_and_image_load_raise_without_pil(tmp_path,
                                                       monkeypatch):
    path = tmp_path / "img.jpg"
    path.write_bytes(_jpeg_bytes())
    data = TO.read_file(str(path))
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(NotImplementedError, match="needs PIL"):
        TO.decode_jpeg(data)
    with pytest.raises(NotImplementedError, match="needs PIL"):
        JO.decode_jpeg(JO.read_file(str(path)))
    with pytest.raises(ImportError):
        T.vision.image_load(str(path))
    with pytest.raises(ImportError):
        J.vision.image_load(str(path))


def test_image_backend_and_image_load(tmp_path):
    path = tmp_path / "img.jpg"
    path.write_bytes(_jpeg_bytes())
    before = T.vision.get_image_backend()
    assert before == J.vision.get_image_backend() == "pil"
    try:
        T.vision.set_image_backend("tensor")
        J.vision.set_image_backend("tensor")
        got, want = T.vision.image_load(str(path)), J.vision.image_load(
            str(path))
        np.testing.assert_array_equal(_np(got), _np(want))
        for P in (T, J):
            with pytest.raises(ValueError):
                P.vision.set_image_backend("opencv")
            with pytest.raises(NotImplementedError):
                P.vision.image_load(str(path), "cv2")
        pil = T.vision.image_load(str(path), "pil")
        np.testing.assert_array_equal(
            np.asarray(pil), np.asarray(J.vision.image_load(str(path),
                                                            "pil")))
    finally:
        T.vision.set_image_backend(before)
        J.vision.set_image_backend(before)
