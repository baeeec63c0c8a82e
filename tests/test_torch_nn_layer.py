"""``nn.Layer``'s surface against the JAX package's ``Layer``: parameter
order and structured names, ``state_dict`` keys with buffers (a
non-persistable one left out), ``full_name`` counters, forward hooks and
their removal, ``train`` / ``eval``, ``to(dtype="bfloat16")``,
``functional_call`` (buffers returned, the caller's untouched),
``ParamAttr`` (name, initializer, ``learning_rate``, ``trainable=False``,
regularizer), ``LazyGuard``, ``create_parameter``,
``set_global_initializer``; and that a ``Parameter`` keeps its type and
attributes through ``Module._apply``, ``copy.deepcopy`` and
``torch.func.functional_call``.

Values are compared float32 elementwise within rtol 1e-5 / atol 1e-6
(products within rtol 1e-4 / atol 1e-5); initial weights of normal
draws within rtol 1e-5 / atol 2e-5 (``erfinv``'s float32 rounding)."""
import copy
import re

import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu_torch import _device
from paddle_tpu_torch.analysis.layercheck import to_numpy

ELEM = dict(rtol=1e-5, atol=1e-6)
PROD = dict(rtol=1e-4, atol=1e-5)
INIT = dict(rtol=1e-5, atol=2e-5)


@pytest.fixture(autouse=True)
def _cpu():
    prev = _device._CURRENT
    T.set_device("cpu")
    yield
    _device._CURRENT = prev
    T.nn.initializer.set_global_initializer(None, None)
    J.nn.initializer.set_global_initializer(None, None)


def _net(P):
    """A small model of either package: a Linear, a Sequential of a
    Linear and a BatchNorm1D, a persistable and a non-persistable
    buffer."""

    class Net(P.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = P.nn.Linear(4, 6)
            self.body = P.nn.Sequential(P.nn.Linear(6, 5),
                                        P.nn.BatchNorm1D(5))
            self.register_buffer("steps", P.to_tensor(
                np.zeros((2,), np.float32)))
            self.register_buffer("scratch", P.to_tensor(
                np.ones((3,), np.float32)), persistable=False)

        def forward(self, x):
            return self.body(P.nn.functional.relu(self.fc(x)))

    return Net()


def _pair():
    J.seed(0)
    jn = _net(J)
    T.seed(0)
    tn = _net(T)
    return jn, tn


def test_parameter_order_names_and_state_dict_keys():
    jn, tn = _pair()
    assert [n for n, _ in tn.named_parameters()] == \
        [n for n, _ in jn.named_parameters()]
    assert isinstance(tn.parameters(), list)
    assert all(isinstance(p, T.nn.Parameter) and
               isinstance(p, torch.nn.Parameter) for p in tn.parameters())
    assert sorted(tn.state_dict()) == sorted(jn.state_dict())
    assert "scratch" not in tn.state_dict() and "steps" in tn.state_dict()
    assert "body.1._mean" in tn.state_dict()
    assert [n for n, _ in tn.named_buffers()] == \
        [n for n, _ in jn.named_buffers()]
    for k, v in jn.state_dict().items():
        np.testing.assert_allclose(to_numpy(tn.state_dict()[k]),
                                   to_numpy(v), err_msg=k, **INIT)
    # the reference's structured names load back with nothing left over
    missing, unexpected = tn.set_state_dict(
        {k: to_numpy(v) for k, v in jn.state_dict().items()})
    assert missing == [] and unexpected == []
    missing, unexpected = tn.set_state_dict({"fc.weight": np.zeros((4, 6)),
                                             "nope": np.zeros(1)})
    assert unexpected == ["nope"] and "fc.bias" in missing
    assert [n for n, _ in tn.named_sublayers()] == \
        [n for n, _ in jn.named_sublayers()]
    assert len(tn.sublayers()) == len(jn.sublayers())
    order = []
    tn.apply(lambda layer: order.append(type(layer).__name__))
    jorder = []
    jn.apply(lambda layer: jorder.append(type(layer).__name__))
    assert order == jorder


def test_full_name_counts_per_prefix_like_the_reference():
    pat = re.compile(r"^linear_(\d+)$")
    for P in (J, T):
        a, b = P.nn.Linear(2, 2), P.nn.Linear(2, 2)
        ia = int(pat.match(a.full_name()).group(1))
        assert b.full_name() == f"linear_{ia + 1}"
        assert P.nn.Layer(name_scope="block").full_name().startswith(
            "block_")
    p = T.nn.Linear(2, 2).weight
    assert re.match(r"^param_\d+$", p.name)


def test_hooks_change_inputs_and_outputs_until_removed():
    jn, tn = _pair()
    tn.set_state_dict({k: to_numpy(v) for k, v in jn.state_dict().items()})
    x = np.random.default_rng(1).standard_normal((3, 4)).astype(np.float32)
    outs = {}
    for P, net in (("J", jn), ("T", tn)):
        pkg = J if P == "J" else T
        pre = net.register_forward_pre_hook(
            lambda layer, inputs: (inputs[0] * 2,))
        post = net.register_forward_post_hook(
            lambda layer, inputs, out: out + 1)
        hooked = to_numpy(net(pkg.to_tensor(x)))
        pre.remove()
        post.remove()
        plain = to_numpy(net(pkg.to_tensor(x)))
        outs[P] = (hooked, plain)
    np.testing.assert_allclose(outs["T"][0], outs["J"][0], **PROD)
    np.testing.assert_allclose(outs["T"][1], outs["J"][1], **PROD)
    assert not np.allclose(outs["T"][0], outs["T"][1])


def test_train_eval_reach_every_sublayer():
    _, tn = _pair()
    tn.eval()
    assert not any(layer.training for layer in tn.sublayers(True))
    tn.train()
    assert all(layer.training for layer in tn.sublayers(True))
    drop = T.nn.Dropout(0.5).eval()
    x = T.to_tensor(np.ones((4, 4), np.float32))
    assert torch.equal(drop(x), x)


def test_to_bfloat16_casts_parameters_and_float_buffers_in_place():
    _, tn = _pair()
    before = {n: p for n, p in tn.named_parameters()}
    names = {n: p.name for n, p in before.items()}
    assert tn.to(dtype="bfloat16") is tn
    for n, p in tn.named_parameters():
        assert p.dtype == torch.bfloat16 and isinstance(p, T.nn.Parameter)
        assert p is before[n] and p.name == names[n]
    assert tn.body[1]._mean.dtype == torch.bfloat16
    tn.astype("float32")
    assert tn.fc.weight.dtype == torch.float32
    # torch's own conversions keep the subclass and its attributes too
    tn.double()
    assert isinstance(tn.fc.weight, T.nn.Parameter)
    assert tn.fc.weight.name == names["fc.weight"]


def test_deepcopy_keeps_type_values_and_names():
    _, tn = _pair()
    twin = copy.deepcopy(tn)
    for (n, a), (_, b) in zip(tn.named_parameters(),
                              twin.named_parameters()):
        assert isinstance(b, T.nn.Parameter) and a is not b
        assert torch.equal(a, b) and a.name == b.name
        assert b.optimize_attr == a.optimize_attr


def test_functional_call_substitutes_and_returns_buffers():
    jn, tn = _pair()
    tn.set_state_dict({k: to_numpy(v) for k, v in jn.state_dict().items()})
    rng = np.random.default_rng(2)
    x = rng.standard_normal((5, 4)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    jp = {"fc.weight": J.to_tensor(w)}
    tw = T.to_tensor(w, stop_gradient=False)
    jb = {"body.1._mean": J.to_tensor(np.full((5,), 0.5, np.float32))}
    tb = {"body.1._mean": T.to_tensor(np.full((5,), 0.5, np.float32))}
    jout, jbuf = jn.functional_call(jp, jb, J.to_tensor(x))
    tout, tbuf = tn.functional_call({"fc.weight": tw}, tb, T.to_tensor(x))
    np.testing.assert_allclose(to_numpy(tout), to_numpy(jout), **PROD)
    np.testing.assert_allclose(to_numpy(tbuf["body.1._mean"]),
                               to_numpy(jbuf["body.1._mean"]), **ELEM)
    # the caller's buffer and the layer's own weight are untouched
    np.testing.assert_array_equal(tb["body.1._mean"].numpy(), 0.5)
    assert not np.allclose(tn.fc.weight.detach().numpy(), w)
    tout.sum().backward()
    assert tw.grad is not None and tn.fc.weight.grad is None
    # through torch.func directly as well
    out = torch.func.functional_call(tn, {"fc.weight": tw.detach()},
                                     (T.to_tensor(x),))
    assert tuple(out.shape) == (5, 5)
    assert isinstance(tn.fc.weight, T.nn.Parameter)


def test_param_attr_name_initializer_rate_and_trainable():
    attr = T.ParamAttr(name="w_custom",
                       initializer=T.nn.initializer.Constant(0.25),
                       learning_rate=0.5, trainable=False,
                       regularizer=T.regularizer.L2Decay(0.1))
    layer = T.nn.Linear(3, 2, weight_attr=attr)
    w = layer.weight
    assert w.name == "w_custom" and w.stop_gradient and not w.trainable
    np.testing.assert_array_equal(w.numpy(), 0.25)
    assert w.optimize_attr == {"learning_rate": 0.5}
    assert w.regularizer.coeff == 0.1
    assert T.nn.Linear(3, 2, bias_attr=False).bias is None
    opt = T.optimizer.SGD(parameters=layer.parameters())
    assert [n for n, _ in opt._params] == [layer.bias.name]
    jattr = J.ParamAttr(name="w_custom",
                        initializer=J.nn.initializer.Constant(0.25),
                        learning_rate=0.5, trainable=False)
    jw = J.nn.Linear(3, 2, weight_attr=jattr).weight
    assert jw.stop_gradient and jw.optimize_attr == w.optimize_attr


def test_lazy_guard_defers_the_draws_in_the_reference_order():
    J.seed(3)
    with J.LazyGuard():
        jn = _net(J)
    J.seed(3)
    jn.lazy_materialize()
    T.seed(3)
    with T.LazyGuard():
        tn = _net(T)
    assert all(p.is_meta for p in tn.parameters())
    T.seed(3)
    assert tn.lazy_materialize() == len(tn.parameters())
    assert not any(p.is_meta for p in tn.parameters())
    for k, v in jn.state_dict().items():
        np.testing.assert_allclose(to_numpy(tn.state_dict()[k]),
                                   to_numpy(v), err_msg=k, **INIT)


def test_create_parameter_add_parameter_and_global_initializer():
    p = T.create_parameter([2, 3], "float32",
                           default_initializer=T.nn.initializer.Constant(
                               1.5))
    assert isinstance(p, T.nn.Parameter) and not p.stop_gradient
    np.testing.assert_array_equal(p.numpy(), 1.5)
    layer = T.nn.Layer()
    q = layer.add_parameter("extra", T.to_tensor(np.ones(2, np.float32),
                                                 stop_gradient=False))
    assert isinstance(q, T.nn.Parameter) and layer.extra is q
    assert [n for n, _ in layer.named_parameters()] == ["extra"]
    # the global initializer beats a layer's default, a ParamAttr beats it
    for P in (J, T):
        P.nn.initializer.set_global_initializer(
            P.nn.initializer.Constant(0.5), P.nn.initializer.Constant(-1.0))
    tl, jl = T.nn.Linear(2, 2), J.nn.Linear(2, 2)
    for a, b in ((tl.weight, jl.weight), (tl.bias, jl.bias)):
        np.testing.assert_array_equal(to_numpy(a), to_numpy(b))
    own = T.nn.Linear(2, 2, weight_attr=T.nn.initializer.Constant(2.0))
    np.testing.assert_array_equal(own.weight.numpy(), 2.0)


def test_clear_gradients_and_parameter_attributes():
    _, tn = _pair()
    out = tn(T.to_tensor(np.ones((3, 4), np.float32)))
    out.sum().backward()
    assert tn.fc.weight.grad is not None
    tn.clear_gradients()
    assert all(p.grad is None for p in tn.parameters())
    w = tn.fc.weight
    assert w.numpy().shape == (4, 6) and w.trainable and not w.stop_gradient
    w.stop_gradient = True
    assert not w.requires_grad
    assert "Parameter" in repr(w) and w.name in repr(w)
