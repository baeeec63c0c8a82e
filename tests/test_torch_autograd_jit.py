"""``paddle_tpu_torch.autograd`` and ``paddle_tpu_torch.jit`` against the
JAX package's.

- ``PyLayer`` with non-tensor arguments, a frozen tensor argument and two
  outputs: outputs and input gradients equal the reference's (float32,
  within 1e-5); ``saved_tensor`` returns what was saved; with no input
  that takes a gradient the forward's outputs come back as they are.
- ``to_static`` on a layer, on a function and on BatchNorm in training
  mode (its running statistics updated; the reference's traced running
  variance is the biased one, pinned): outputs within 1e-5 of the
  reference's ``forward_traced``; a layer with dropout in training mode
  draws the reference's bits for the same ``paddle.seed`` (the outputs
  equal, the dropped positions identical); the output takes no
  gradient, as the reference's.
- ``jit.save`` / ``jit.load`` on the CPU: without ``input_spec`` the
  ``.pdparams`` dict comes back; with it a ``TranslatedLayer`` whose
  program runs the LayerNorm and flash forwards as custom ops (their
  plain versions here) and gives the eager logits within 1e-6; the
  reference's own StableHLO artifact raises, its ``.pdparams`` loads.
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu_torch import _device
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.kernels import fused_layernorm as fl

F32 = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _cpu():
    prev = _device._CURRENT
    T.set_device("cpu")
    yield
    _device._CURRENT = prev


def _scaled_pair(P):
    class ScaledPair(P.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x, scale, y, tag="t"):
            ctx.save_for_backward(x, y)
            ctx.scale = scale
            return x * scale + y, x * y

        @staticmethod
        def backward(ctx, g1, g2):
            x, y = ctx.saved_tensor()
            # one gradient per input tensor that takes one: x only
            return g1 * ctx.scale + g2 * y

    return ScaledPair


def test_pylayer_non_tensor_args_and_two_outputs():
    rng = np.random.RandomState(0)
    xs, ys = rng.standard_normal((2, 3, 4)).astype(np.float32)
    got = {}
    for P in (J, T):
        x = P.to_tensor(xs, stop_gradient=False)
        y = P.to_tensor(ys)  # frozen: no gradient slot
        a, b = _scaled_pair(P).apply(x, 3.0, y, tag="pair")
        assert not a.stop_gradient and not b.stop_gradient
        (a.sum() + (b * 2.0).sum()).backward()
        got[P] = (a.numpy(), b.numpy(), x.grad.numpy())
    for g, w in zip(got[T], got[J]):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), **F32)
    with T.no_grad():
        x = T.to_tensor(xs, stop_gradient=False)
        a, b = _scaled_pair(T).apply(x, 2.0, T.to_tensor(ys))
    assert a.stop_gradient and isinstance(a, T.Tensor)


def test_autograd_backward_and_reexports():
    assert T.autograd.no_grad is T.no_grad and T.autograd.grad is T.grad
    outs = {}
    for P in (J, T):
        x = P.to_tensor(np.array([1.0, 2.0], np.float32), stop_gradient=False)
        P.autograd.backward([(x * x).sum(), (x * 3.0).sum()])
        outs[P] = x.grad.numpy()
    np.testing.assert_allclose(outs[T], outs[J])


def _mlp(P):
    P.seed(4)
    return P.nn.Sequential(P.nn.Linear(4, 8), P.nn.ReLU(), P.nn.Linear(8, 2))


def _load_ref(port, ref):
    port.set_state_dict({k: np.asarray(v.numpy()) for k, v in
                         ref.state_dict().items()})


def test_to_static_layer_function_and_no_gradient():
    x = np.random.RandomState(1).standard_normal((3, 4)).astype(np.float32)
    nets = {P: _mlp(P) for P in (J, T)}
    _load_ref(nets[T], nets[J])
    outs = {}
    for P, net in nets.items():
        traced = P.jit.to_static(net)
        assert traced is net
        xt = P.to_tensor(x)
        out = net.forward_traced(xt)
        assert out.stop_gradient  # the reference's no_grad trace
        out2 = net.forward_traced(xt)  # the signature's cached runner
        outs[P] = (out.numpy(), out2.numpy())
    for g, w in zip(outs[T], outs[J]):
        np.testing.assert_allclose(g, w, **F32)
    assert len(nets[T].forward_traced._cache) == 1
    w = nets[T][0].weight
    assert nets[T].forward_traced(T.to_tensor(x)).grad_fn is None
    assert w.requires_grad

    def f(a, b):
        return a * 2.0 + b

    fns = {P: P.jit.to_static(f) for P in (J, T)}
    ys = x[::-1].copy()
    np.testing.assert_allclose(fns[T](T.to_tensor(x), T.to_tensor(ys)).numpy(),
                               fns[J](J.to_tensor(x), J.to_tensor(ys)).numpy(),
                               **F32)


def test_to_static_batchnorm_updates_its_buffers():
    x = np.random.RandomState(2).standard_normal((16, 4, 8)).astype(
        np.float32)
    stats = {}
    for P in (J, T):
        bn = P.nn.BatchNorm1D(4)
        net = P.jit.to_static(P.nn.Sequential(bn))
        out = net.forward_traced(P.to_tensor(x))
        stats[P] = [out.numpy(), bn._mean.numpy(), bn._variance.numpy()]
    assert not np.allclose(stats[T][1], 0.0)
    # pinned: under its jit trace the reference keeps the BIASED batch
    # variance as the running one (eagerly, like the port, the unbiased):
    # running = 0.9 * 1 + 0.1 * var, so rescale its share by n / (n - 1)
    n = 16 * 8
    stats[J][2] = 0.9 + (stats[J][2] - 0.9) * n / (n - 1)
    for g, w in zip(stats[T], stats[J]):
        np.testing.assert_allclose(g, w, **F32)


def test_to_static_dropout_draws_the_references_bits():
    x = np.random.RandomState(3).standard_normal((4, 64)).astype(np.float32)
    outs = {}
    for P in (J, T):
        P.seed(9)
        net = P.nn.Sequential(P.nn.Linear(64, 64), P.nn.Dropout(0.5))
        net.train()
        if P is T:
            _load_ref(net, ref_net)
        else:
            ref_net = net
        P.jit.to_static(net)
        xt = P.to_tensor(x)
        P.seed(21)
        outs[P] = [net.forward_traced(xt).numpy() for _ in range(2)]
    for g, w in zip(outs[T], outs[J]):
        np.testing.assert_array_equal(g == 0.0, w == 0.0)
        np.testing.assert_allclose(g, w, **F32)
    assert not np.array_equal(outs[T][0] == 0.0, outs[T][1] == 0.0)


ERNIE = dict(vocab_size=97, hidden_size=64, num_layers=2, num_heads=4,
             intermediate_size=128, max_position_embeddings=32)


def test_jit_save_load_round_trip(tmp_path):
    T.seed(5)
    m = T.text.ErnieForSequenceClassification(T.text.ErnieConfig(**ERNIE),
                                              num_classes=15)
    rng = np.random.RandomState(4)
    ids = T.to_tensor(rng.randint(0, 97, (4, 16)).astype(np.int64))
    tt = T.to_tensor(np.zeros((4, 16), np.int64))
    m.eval()
    with torch.no_grad():
        eager = m(ids, tt).numpy()
    m.train()
    path = str(tmp_path / "ernie")
    T.jit.save(m, path)
    assert not os.path.exists(path + ".pdmodel")
    sd = T.jit.load(path)
    assert sd["class"] == "ErnieForSequenceClassification"
    assert set(sd["state_dict"]) == set(m.state_dict())
    spec = [T.jit.InputSpec([4, 16], "int64"), T.jit.InputSpec([4, 16],
                                                                "int64")]
    T.jit.save(m, path, input_spec=spec)
    assert m.training  # restored after the eval export
    loaded = T.jit.load(path)
    assert isinstance(loaded, T.jit.TranslatedLayer)
    fa.reference_calls = fl.reference_calls = 0
    out = loaded(ids, tt)
    assert (fa.reference_calls, fl.reference_calls) == (2, 5)  # 2 L, 2 L + 1
    np.testing.assert_allclose(out.numpy(), eager, rtol=1e-6, atol=1e-6)
    with pytest.raises(RuntimeError, match="inference-only"):
        loaded.train()
    T.jit.save(m, path)  # no spec: the stale program goes
    assert not os.path.exists(path + ".pdmodel")


def test_reference_artifact_raises(tmp_path):
    J.seed(0)
    net = J.nn.Linear(4, 2)
    path = str(tmp_path / "ref")
    J.jit.save(net, path, input_spec=[J.jit.InputSpec([2, 4], "float32")])
    with pytest.raises(RuntimeError, match="JAX package"):
        T.jit.load(path)
    sd = T.load(path + ".pdparams")
    np.testing.assert_allclose(np.asarray(sd["state_dict"]["weight"]),
                               net.weight.numpy())
    with open(path + ".pdmodel", "wb") as f:
        f.write(b"\x0a\x05proto")  # a ProgramDesc protobuf's first bytes
    with pytest.raises(NotImplementedError, match="12f"):
        T.jit.load(path)


def test_program_translator_switch():
    calls = []

    def f(a):
        calls.append(1)
        return a + 1.0

    g = T.jit.to_static(f, convert_control_flow=False)
    x = T.to_tensor(np.zeros(2, np.float32), stop_gradient=False)
    T.jit.ProgramTranslator.get_instance().enable(False)
    try:
        assert not g(x).stop_gradient  # run as it is, recording
    finally:
        T.jit.ProgramTranslator.get_instance().enable(True)
    assert g(x).stop_gradient and len(calls) == 2
