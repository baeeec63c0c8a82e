"""``vision.models`` of the port against the JAX package's, on the CPU:
ResNet and LeNet.

- ``seed(0)`` then ``resnet18()`` / ``LeNet()`` draw the reference's
  initial weights, entry for entry (the Kaiming and Xavier draws within
  float32 rounding of their scaling: rtol 1e-5, atol 2e-5, the layers
  test's), and the reference's ``state_dict()`` loads with
  ``set_state_dict``, nothing missing or unexpected.
- ResNet-50's bottleneck blocks at base width 4 draw the reference's
  weights too; ``resnet50()``'s 267 state entries (161 parameters, two
  buffers for each of 53 BatchNorms) have the reference's names and
  shapes, and 25,557,032 parameters; every factory (resnet18-152,
  ResNeXt, wide) builds the reference's parameter shapes (both under
  ``LazyGuard``, which draws nothing).
- resnet18 at 32 x 32, batch 2, carried weights: the logits in eval
  mode in float32 (rtol 1e-4 / atol 1e-5 of a float32 sum's order); then
  in training mode in float64 the logits, the loss, every gradient, two
  Momentum steps and the BatchNorm buffers, each within 1e-7 of its own
  largest value.
  Training-mode BatchNorm at layer4's 1 x 1 maps normalises 2 values a
  channel, which turns float32's summation-order differences into ~1e-3
  of the logits (both packages); float64 keeps the comparison tight.
- LeNet at batch 4, 1 x 28 x 28, float32: logits, loss and gradients.

The reference's float32 eval forward runs as one ``jax.jit`` of its
``functional_call`` (``test_torch_vision_zoo.reference_eval``), not op by
op: its eager mode compiles every op at every shape. The float64 training
test keeps the eager reference: under ``jax.jit`` the reference's own
second-step gradient of ``layer4.0.downsample.0.weight`` moves by 1.2e-7
of its largest value (XLA's fused reductions; BatchNorm over 2 values a
channel amplifies them), past the test's 1e-7 limit.
"""
import copy

import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu_torch import _device
from paddle_tpu_torch.analysis.layercheck import to_numpy
from test_torch_vision_zoo import reference_eval

INIT_TOL = dict(rtol=1e-5, atol=2e-5)
F32 = dict(rtol=1e-4, atol=1e-5)
F64_REL = 1e-7   # of each array's own largest value
FACTORIES = ("resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
             "resnext50_32x4d", "resnext50_64x4d", "resnext101_32x4d",
             "resnext101_64x4d", "resnext152_32x4d", "resnext152_64x4d",
             "wide_resnet50_2", "wide_resnet101_2")


@pytest.fixture(autouse=True)
def _cpu():
    prev = _device._CURRENT
    T.set_device("cpu")
    yield
    _device._CURRENT = prev


def _state(layer) -> dict:
    return {k: to_numpy(v) for k, v in layer.state_dict().items()}


def _build(P, name, **kw):
    P.seed(0)
    return getattr(P.vision.models, name)(**kw)


@pytest.fixture(scope="module")
def ref18():
    """The reference's ``seed(0)`` resnet18 (10 classes), built once: its
    initialisers compile a program each, which takes the most time."""
    return _build(J, "resnet18", num_classes=10)


def _close64(got, want, what):
    """Within F64_REL of the array's own largest value."""
    scale = max(float(np.abs(want).max()), 1e-300)
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= F64_REL * scale, (what, err, scale)


@pytest.mark.parametrize("name", ["resnet18", "LeNet"])
def test_seed_draws_the_references_weights(name, request):
    kw = {"num_classes": 10} if name == "resnet18" else {}
    jm = request.getfixturevalue("ref18") if name == "resnet18" else \
        _build(J, name)
    tm = _build(T, name, **kw)
    want, got = _state(jm), _state(tm)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **INIT_TOL)
    missing, unexpected = tm.set_state_dict(want)
    assert missing == [] and unexpected == []
    if name == "LeNet":
        assert sum(p.numel() for p in tm.parameters()) == 61610


def test_bottleneck_resnet_draws_the_references_weights():
    """ResNet-50's blocks (``BottleneckBlock``, the downsample branch drawn
    before its block) at base width 4: the same draw order as
    ``resnet50()`` with 3,466,922 parameters, not 25,557,032."""
    J.seed(0)
    jm = J.vision.models.ResNet(J.vision.models.resnet.BottleneckBlock, 50,
                                width=4, num_classes=10)
    T.seed(0)
    tm = T.vision.models.ResNet(T.vision.models.resnet.BottleneckBlock, 50,
                                width=4, num_classes=10)
    want, got = _state(jm), _state(tm)
    assert sorted(got) == sorted(want) and len(got) == 267
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **INIT_TOL)


def test_resnet50_state_names_shapes_and_size():
    with J.LazyGuard():
        jm = J.vision.models.resnet50()
    with T.LazyGuard():
        tm = T.vision.models.resnet50()
    want = {k: tuple(v.shape) for k, v in jm.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert got == want and len(got) == 267
    params = tm.parameters()
    assert len(params) == 161
    assert sum(p.numel() for p in params) == 25_557_032
    assert sum(1 for k in got if k.endswith(("._mean", "._variance"))) \
        == 2 * 53


@pytest.mark.parametrize("name", FACTORIES)
def test_factory_builds_the_references_shapes(name):
    with J.LazyGuard():
        jm = getattr(J.vision.models, name)(pretrained=False)
    with T.LazyGuard():
        tm = getattr(T.vision.models, name)(pretrained=True)  # ignored
    assert {k: tuple(v.shape) for k, v in tm.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in jm.state_dict().items()}


def _carried(jm, name, dtype=None, **kw):
    """A copy of the reference's model and the port's with its weights."""
    jm = copy.deepcopy(jm)
    tm = getattr(T.vision.models, name)(**kw)
    tm.set_state_dict(_state(jm))
    if dtype is not None:
        jm.to(dtype=dtype)
        tm.to(dtype=dtype)
    return jm, tm


def _split(jm):
    """The reference model's parameters and buffers as numpy dicts."""
    params = {n: np.asarray(to_numpy(p)) for n, p in jm.named_parameters()}
    buffers = {n: np.asarray(to_numpy(b)) for n, b in jm.named_buffers()}
    return params, buffers


def test_resnet18_eval_logits_float32(ref18):
    jm, tm = _carried(ref18, "resnet18", num_classes=10)
    jm.eval()
    tm.eval()
    x = np.random.default_rng(0).standard_normal((2, 3, 32, 32)).astype(
        np.float32)
    want = reference_eval(jm, *_split(jm), x)[0]
    np.testing.assert_allclose(to_numpy(tm(T.to_tensor(x))),
                               to_numpy(want), **F32)


def test_resnet18_trains_like_the_reference_float64(ref18):
    jm, tm = _carried(ref18, "resnet18", "float64", num_classes=10)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 2, 3, 32, 32))
    y = np.array([[3, 7], [1, 4]])
    opts = [P.optimizer.Momentum(learning_rate=0.01, momentum=0.9,
                                 parameters=m.parameters())
            for P, m in ((J, jm), (T, tm))]
    for step in range(2):
        outs = []
        for P, m, opt in ((J, jm, opts[0]), (T, tm, opts[1])):
            logits = m(P.to_tensor(x[step]))
            loss = P.nn.functional.cross_entropy(logits,
                                                 P.to_tensor(y[step]))
            loss.backward()
            outs.append((to_numpy(logits), to_numpy(loss),
                         {n: to_numpy(p.grad)
                          for n, p in m.named_parameters()}))
            opt.step()
            opt.clear_grad()
        (wl, wloss, wg), (gl, gloss, gg) = outs
        _close64(gl, wl, f"logits {step}")
        _close64(gloss, wloss, f"loss {step}")
        assert sorted(gg) == sorted(wg) and len(gg) == 62
        for n in wg:
            _close64(gg[n], wg[n], f"{n} grad {step}")
    want, got = _state(jm), _state(tm)
    for k in want:  # parameters after two steps and the running statistics
        _close64(got[k], want[k], k)


def test_lenet_matches_the_reference():
    jm, tm = _carried(_build(J, "LeNet"), "LeNet")
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 1, 28, 28)).astype(np.float32)
    y = rng.integers(0, 10, (4,))
    grads = []
    for P, m in ((J, jm), (T, tm)):
        logits = m(P.to_tensor(x))
        loss = P.nn.functional.cross_entropy(logits, P.to_tensor(y))
        loss.backward()
        grads.append((to_numpy(logits), to_numpy(loss),
                      {n: to_numpy(p.grad) for n, p in m.named_parameters()}))
    (wl, wloss, wg), (gl, gloss, gg) = grads
    np.testing.assert_allclose(gl, wl, **F32)
    np.testing.assert_allclose(gloss, wloss, **F32)
    for n in wg:
        np.testing.assert_allclose(gg[n], wg[n], err_msg=n, **F32)


def test_vision_namespace():
    assert T.vision.LeNet is T.vision.models.LeNet
    assert set(T.vision.models.__all__) >= {"ResNet", "resnet50", "LeNet"}
