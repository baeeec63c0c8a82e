"""``paddle_tpu_torch.amp`` against the JAX package's ``amp``.

- Every white- and black-listed op, an unlisted one and a custom-listed
  ``"add"`` (function and ``+``), under O1 and O2: the port's output dtype
  is the reference's, and its values agree within bfloat16 rounding
  (rtol 2e-2, atol 2e-2 of the largest value; the float32 cases within
  1e-5). One divergence is pinned: ``softmax_with_cross_entropy`` under
  O2 (the reference's trailing reshape re-casts its loss to bf16).
- A 2-layer, hidden-64 ERNIE classifier under ``auto_cast`` O1 bf16: the
  logits and the loss within the bf16 tolerance of the reference's, on
  the same weights and ids, and the same dtypes out.
- ``decorate`` at O2 (parameters cast, ``_casted_dtype``,
  ``_multi_precision``) as the reference's.
- ``GradScaler``: over a seeded sequence of finite and non-finite steps
  the port's skips and ``_scale`` equal the reference's after every
  step; the found-inf flag stays on the device until ``step`` reads it.
- float16 attention computes through the composite, as the reference's
  does (the kernels take float32 and bfloat16), within float16 rounding
  of the reference's output.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu_torch import _device

F32 = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _cpu():
    prev = _device._CURRENT
    T.set_device("cpu")
    yield
    _device._CURRENT = prev


def _dtype(t) -> str:
    d = t.dtype
    return str(d).replace("torch.", "") if isinstance(d, torch.dtype) \
        else str(d)


def _np(t):
    return np.asarray(t.numpy(), dtype=np.float64)


def _arrays(seed, *shapes):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


#: op name -> (shapes, call(P, *tensors)), each P the package module
OPS = {
    "matmul": ([(4, 8), (8, 3)], lambda P, a, b: P.matmul(a, b)),
    "linear": ([(2, 4, 8), (8, 3), (3,)],
               lambda P, x, w, b: P.nn.functional.linear(x, w, b)),
    "conv1d": ([(2, 3, 9), (4, 3, 3)],
               lambda P, x, w: P.nn.functional.conv1d(x, w)),
    "conv2d": ([(2, 3, 6, 6), (4, 3, 3, 3)],
               lambda P, x, w: P.nn.functional.conv2d(x, w)),
    "conv3d": ([(1, 2, 4, 4, 4), (3, 2, 2, 2, 2)],
               lambda P, x, w: P.nn.functional.conv3d(x, w)),
    "bmm": ([(2, 3, 4), (2, 4, 5)], lambda P, a, b: P.bmm(a, b)),
    "mm": ([(3, 4), (4, 5)], lambda P, a, b: P.mm(a, b)),
    "einsum": ([(3, 4), (4, 5)], lambda P, a, b: P.einsum("ij,jk->ik", a, b)),
    "scaled_dot_product_attention": (
        [(1, 2, 8, 16)] * 3,
        lambda P, q, k, v: P.nn.functional.scaled_dot_product_attention(
            q, k, v)),
    "reduce_sum": ([(4, 6)], lambda P, x: P.sum(x, axis=1)),
    "norm": ([(4, 6)], lambda P, x: P.linalg.norm(x)),
    "layer_norm": ([(4, 8), (8,), (8,)],
                   lambda P, x, w, b: P.nn.functional.layer_norm(x, 8, w, b)),
    "log_softmax": ([(4, 6)], lambda P, x: P.nn.functional.log_softmax(x)),
    "mse_loss": ([(4, 6), (4, 6)],
                 lambda P, a, b: P.nn.functional.mse_loss(a, b)),
    "cross_entropy": ([(4, 6)], lambda P, x: P.nn.functional.cross_entropy(
        x, P.to_tensor(np.array([0, 2, 5, 1], np.int64)))),
    "softmax_with_cross_entropy": (
        [(4, 6)], lambda P, x: P.nn.functional.softmax_with_cross_entropy(
            x, P.to_tensor(np.array([[0], [2], [5], [1]], np.int64)))),
    "batch_norm": ([(4, 3, 5)], lambda P, x: P.nn.functional.batch_norm(
        x, P.to_tensor(np.zeros(3, np.float32)),
        P.to_tensor(np.ones(3, np.float32)), training=True)),
    "tanh (unlisted)": ([(4, 6)], lambda P, x: P.tanh(x)),
    "add (custom white)": ([(4, 6), (4, 6)], lambda P, a, b: P.add(a, b)),
    "+ (custom white)": ([(4, 6), (4, 6)], lambda P, a, b: a + b),
    "@ (white matmul)": ([(4, 8), (8, 3)], lambda P, a, b: a @ b),
}


def _run(P, name, level, arrays, low_inputs):
    shapes, call = OPS[name]
    ts = [P.to_tensor(a) for a in arrays]
    if low_inputs:
        ts = [t.astype("bfloat16") for t in ts]
    custom = ["add"] if "custom" in name else None
    with P.amp.auto_cast(level=level, dtype="bfloat16",
                         custom_white_list=custom):
        out = call(P, *ts)
    return out


@pytest.mark.parametrize("level", ["O1", "O2"])
@pytest.mark.parametrize("low_inputs", [False, True],
                         ids=["float32_in", "bf16_in"])
@pytest.mark.parametrize("name", sorted(OPS))
def test_op_dtype_and_value_under_auto_cast(name, level, low_inputs):
    shapes, _ = OPS[name]
    arrays = _arrays(len(name), *shapes)
    want = _run(J, name, level, arrays, low_inputs)
    got = _run(T, name, level, arrays, low_inputs)
    if name == "softmax_with_cross_entropy" and level == "O2":
        # pinned: the reference composes this op of dispatched ops, and
        # under O2 its trailing reshape casts the float32 loss back to
        # bf16; the port's is one op, black-listed, float32 out
        assert (_dtype(got), _dtype(want)) == ("float32", "bfloat16")
        want = want.astype("float32")
    assert _dtype(got) == _dtype(want), (name, level)
    w, g = _np(want), _np(got)
    if _dtype(want) == "float32" and not low_inputs and level == "O1" \
            and name.split()[0] not in J.amp.WHITE_OPS:
        np.testing.assert_allclose(g, w, **F32)
    else:
        scale = max(float(np.abs(w).max()), 1.0)
        np.testing.assert_allclose(g, w, rtol=2e-2, atol=2e-2 * scale)


def test_lists_and_state_are_the_references():
    assert T.amp.WHITE_OPS == J.amp.WHITE_OPS
    assert T.amp.BLACK_OPS == J.amp.BLACK_OPS
    assert T.amp.amp_guard is T.amp.auto_cast and T.amp.amp_state() is None
    with T.amp.auto_cast(level="O2", dtype="float16"):
        st = T.amp.amp_state()
        assert st["level"] == "O2" and st["dtype"] == "float16"
        with T.amp.auto_cast(enable=False):
            assert T.amp.amp_state() is None
        assert T.amp.amp_state() is st
    assert T.amp.amp_state() is None
    # the amp-aware Tensor operators are gone outside every scope
    assert "__add__" not in T.Tensor.__dict__


ERNIE = dict(vocab_size=97, hidden_size=64, num_layers=2, num_heads=4,
             intermediate_size=128, max_position_embeddings=32,
             hidden_dropout=0.0, attn_dropout=0.0)


def test_ernie_classifier_logits_and_loss_under_o1():
    models = {}
    for P in (J, T):
        P.seed(3)
        models[P] = P.text.ErnieForSequenceClassification(
            P.text.ErnieConfig(**ERNIE), num_classes=15)
    models[T].set_state_dict({k: np.asarray(v.numpy()) for k, v in
                              models[J].state_dict().items()})
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 97, (4, 16)).astype(np.int64)
    labels = rng.randint(0, 15, (4,)).astype(np.int64)
    outs = {}
    for P in (J, T):
        m = models[P]
        m.eval()
        x, y = P.to_tensor(ids), P.to_tensor(labels)
        with P.amp.auto_cast(level="O1", dtype="bfloat16"):
            logits = m(x)
            loss = P.nn.functional.cross_entropy(logits, y)  # black
        outs[P] = (logits, loss)
    (jl, jloss), (tl, tloss) = outs[J], outs[T]
    assert _dtype(tl) == _dtype(jl) == "bfloat16"
    assert _dtype(tloss) == _dtype(jloss) == "float32"
    scale = float(np.abs(_np(jl)).max())
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=2e-2,
                               atol=2e-2 * scale)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=2e-2)


def test_decorate_o2():
    for P in (J, T):
        P.seed(0)
        net = P.nn.Linear(4, 4)
        opt = P.optimizer.Adam(parameters=net.parameters())
        assert getattr(net, "_casted_dtype", None) is None
        net, opt = P.amp.decorate(net, opt, level="O2", dtype="bfloat16")
        assert _dtype(net.weight) == "bfloat16"
        assert net._casted_dtype == "bfloat16" and opt._multi_precision
    net = T.nn.Linear(4, 4)
    assert T.amp.decorate(net, level="O1") is net
    assert _dtype(net.weight) == "float32"


def _scaler_run(P, flags):
    P.seed(1)
    net = P.nn.Linear(3, 2)
    opt = P.optimizer.SGD(0.1, parameters=net.parameters())
    scaler = P.amp.GradScaler(init_loss_scaling=1024.0, incr_every_n_steps=3,
                              decr_every_n_nan_or_inf=2)
    rng = np.random.RandomState(5)
    trace = []
    for bad in flags:
        g = rng.standard_normal((3, 2)).astype(np.float32) * scaler._scale
        if bad:
            g[rng.randint(3), rng.randint(2)] = np.inf if bad == 1 else np.nan
        net.weight.grad = P.to_tensor(g)
        net.bias.grad = P.to_tensor(np.ones(2, np.float32) * scaler._scale)
        before = np.asarray(net.weight.numpy()).copy()
        scaler.step(opt)
        after = np.asarray(net.weight.numpy())
        trace.append((bool(np.array_equal(before, after)), scaler._scale,
                      scaler.state_dict()["incr_count"],
                      scaler.state_dict()["decr_count"]))
        opt.clear_grad()
    return trace


def test_grad_scaler_skips_and_scale_follow_the_reference():
    flags = np.random.RandomState(11).choice([0, 0, 0, 1, 2], size=24)
    flags[5:8] = 0  # a run of good steps grows the scale
    flags[9:11] = 1  # two bad steps in a row halve it
    want, got = _scaler_run(J, flags), _scaler_run(T, flags)
    assert got == want
    assert any(t[0] for t in got) and any(not t[0] for t in got)


def test_grad_scaler_flag_stays_on_the_device_until_step():
    net = T.nn.Linear(2, 1)
    opt = T.optimizer.SGD(0.1, parameters=net.parameters())
    scaler = T.amp.GradScaler(init_loss_scaling=4.0,
                              decr_every_n_nan_or_inf=1)
    net.weight.grad = T.to_tensor(np.asarray([[np.inf], [1.0]], np.float32))
    net.bias.grad = T.to_tensor(np.asarray([1.0], np.float32))
    scaler.unscale_(opt)
    assert isinstance(scaler._found_inf, torch.Tensor)
    assert bool(scaler._found_inf)
    np.testing.assert_allclose(net.bias.grad.numpy(), [0.25])
    scaler.update()
    assert scaler._scale == 2.0 and scaler._found_inf is False
    sd = scaler.state_dict()
    fresh = T.amp.GradScaler()
    fresh.load_state_dict(sd)
    assert fresh._scale == 2.0


def test_float16_attention_raises():
    """Float16 attention no longer raises: it takes the composite, and
    agrees with the reference's within float16 rounding (rtol / atol
    2e-3)."""
    q = np.random.RandomState(4).standard_normal((1, 2, 8, 16)) \
        .astype(np.float32)
    outs = {}
    for P in (J, T):
        x = P.to_tensor(q)
        with P.amp.auto_cast(dtype="float16"):
            outs[P] = P.nn.functional.scaled_dot_product_attention(x, x, x)
    assert _dtype(outs[T]) == _dtype(outs[J]) == "float16"
    np.testing.assert_allclose(_np(outs[T]), _np(outs[J]), rtol=2e-3,
                               atol=2e-3)
