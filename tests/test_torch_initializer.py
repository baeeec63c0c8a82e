"""The port's initializers (``nn.initializer``) against the JAX package's:
after the same ``seed``, each draws from the key schedule in the
reference's order, so the values are the reference's — bit for bit for
the uniform ones (``Uniform``, ``XavierUniform``, ``KaimingUniform``: the
same threefry bits, the same float32 arithmetic), within float32
rounding of ``erfinv`` (torch's, not XLA's) for the normal ones:
rtol 1e-5, atol 2e-5 for unit draws (the error grows in the tails,
where erfinv is steep), scaled by the standard deviation where one
applies. ``Orthogonal`` goes through a QR of a normal draw (LAPACK's,
not XLA's): rtol 1e-4, atol 1e-5. The deterministic ones (``Constant``,
``Assign``, ``Dirac``, ``Bilinear``) are equal."""
import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu_torch import _device

NORMAL = dict(rtol=1e-5, atol=2e-5)
QR = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def _cpu():
    prev = _device._CURRENT
    T.set_device("cpu")
    yield
    _device._CURRENT = prev


def _draw(P, make, shapes, seed=5):
    """The arrays ``make(P.nn.initializer)`` draws for each shape in turn
    after ``P.seed(seed)``."""
    P.seed(seed)
    init = make(P.nn.initializer)
    return [np.asarray(init(s, "float32")) if P is J else
            init(s, "float32").numpy() for s in shapes]


SHAPES = [(64, 48), (3, 5, 2, 2), (7,)]

EXACT = {
    "Uniform": lambda I: I.Uniform(-0.3, 0.7),
    "XavierUniform": lambda I: I.XavierUniform(),
    "XavierUniform-gain": lambda I: I.XavierUniform(fan_in=10, gain=2.0),
    "KaimingUniform": lambda I: I.KaimingUniform(),
    "KaimingUniform-leaky": lambda I: I.KaimingUniform(
        negative_slope=0.1, nonlinearity="leaky_relu"),
    "Constant": lambda I: I.Constant(0.75),
}

NORMALS = {
    "Normal": (lambda I: I.Normal(0.5, 2.0), 2.0),
    "TruncatedNormal": (lambda I: I.TruncatedNormal(0.1, 0.02), 0.02),
    "XavierNormal": (lambda I: I.XavierNormal(), 1.0),
    "XavierNormal-fans": (lambda I: I.XavierNormal(fan_in=3, fan_out=5),
                          1.0),
    "KaimingNormal": (lambda I: I.KaimingNormal(), 1.0),
    "KaimingNormal-tanh": (lambda I: I.KaimingNormal(fan_in=8,
                                                     nonlinearity="tanh"),
                           1.0),
}


@pytest.mark.parametrize("name", sorted(EXACT))
def test_uniform_and_constant_draws_are_the_references_bits(name):
    for want, got in zip(_draw(J, EXACT[name], SHAPES),
                         _draw(T, EXACT[name], SHAPES)):
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", sorted(NORMALS))
def test_normal_draws_within_float32_rounding(name):
    make, std = NORMALS[name]
    for want, got in zip(_draw(J, make, SHAPES), _draw(T, make, SHAPES)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=NORMAL["rtol"],
                                   atol=NORMAL["atol"] * std)


def test_truncated_normal_stays_inside_two_deviations():
    got = _draw(T, lambda I: I.TruncatedNormal(0.0, 1.0), [(200, 50)])[0]
    assert np.all(np.abs(got) < 2.0)


def test_orthogonal_through_qr():
    shapes = [(6, 4), (4, 6), (2, 3, 5)]
    make = lambda I: I.Orthogonal(gain=1.5)  # noqa: E731
    for s, want, got in zip(shapes, _draw(J, make, shapes),
                            _draw(T, make, shapes)):
        np.testing.assert_allclose(got, want, err_msg=str(s), **QR)
    q = _draw(T, lambda I: I.Orthogonal(), [(6, 4)])[0]
    np.testing.assert_allclose(q.T @ q, np.eye(4), atol=1e-5)


@pytest.mark.parametrize("name,make,shape", [
    ("Assign", lambda I: I.Assign(np.arange(6, dtype=np.float32)), (2, 3)),
    ("Dirac", lambda I: I.Dirac(), (4, 2, 3, 3)),
    ("Dirac-groups", lambda I: I.Dirac(groups=2), (4, 2, 3)),
    ("Bilinear", lambda I: I.Bilinear(), (2, 2, 4, 5)),
])
def test_deterministic_initializers_are_equal(name, make, shape):
    want, = _draw(J, make, [shape])
    got, = _draw(T, make, [shape])
    np.testing.assert_array_equal(got, want)


def test_draws_follow_the_key_schedule_across_layers():
    """A model's parameters take keys one after another: the second
    layer's weights equal the reference's second draw."""
    for P in (J, T):
        P.seed(9)
    jl = [J.nn.Linear(5, 4), J.nn.Embedding(7, 3), J.nn.Linear(4, 2)]
    tl = [T.nn.Linear(5, 4), T.nn.Embedding(7, 3), T.nn.Linear(4, 2)]
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(b.weight.numpy(),
                                   np.asarray(a.weight.numpy()), **NORMAL)
    # one more draw after them agrees too: no key was skipped or added
    u = T.nn.initializer.Uniform()((3,), "float32").numpy()
    v = np.asarray(J.nn.initializer.Uniform()((3,), "float32"))
    np.testing.assert_array_equal(u, v)


def test_calculate_gain_and_global_initializer():
    for nl, p in (("tanh", None), ("relu", None), ("leaky_relu", 0.2),
                  ("selu", None), ("linear", None)):
        assert T.nn.initializer.calculate_gain(nl, p) == \
            J.nn.initializer.calculate_gain(nl, p)
    with pytest.raises(TypeError):
        T.nn.initializer.set_global_initializer("not an initializer")
    assert sorted(T.nn.initializer.__all__) == \
        sorted(J.nn.initializer.__all__)


def test_low_precision_is_drawn_in_float32_and_cast():
    T.seed(1)
    w = T.nn.initializer.Normal()((4, 4), "bfloat16")
    T.seed(1)
    f = T.nn.initializer.Normal()((4, 4), "float32")
    assert str(w.dtype) == "torch.bfloat16"
    np.testing.assert_array_equal(w.float().numpy(),
                                  f.bfloat16().float().numpy())
