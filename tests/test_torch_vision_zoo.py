"""The ten vision families of item 12c-1 (AlexNet, VGG, SqueezeNet,
MobileNetV1, V2 and V3, ShuffleNetV2, GoogLeNet, InceptionV3, DenseNet)
in the port against the JAX package.

- Every factory and class builds the reference's ``state_dict()`` names
  and shapes (under ``LazyGuard``, which draws nothing).
- ``seed(s)`` construction: ``shufflenet_v2_x0_25`` with the real draws,
  every parameter within float32 rounding of the reference's; and one
  factory of each family (this file: SqueezeNet; the others in the
  family's file) with each package's draws replaced by a value
  that encodes the draw's key (:func:`keyed_draws`): the same parameter
  then takes the same key, distribution and scale in both, and its
  ``state_dict()`` loads into the port with ``set_state_dict``. Drawing
  the real values of AlexNet's 61 million or VGG's 138 million
  parameters with the port's threefry on this CPU takes tens of seconds
  and gigabytes; the draws themselves are held against ``jax.random``
  in ``tests/test_torch_initializer.py``.
- The numerics (:func:`check_family`): the reference's forward and
  backward are ``jax.jit`` of its ``functional_call`` (its op-by-op
  eager mode compiles each layer's shapes one at a time, minutes for a
  DenseNet), on the same random float64 weights as the port's, at
  ``num_classes=10``: the eval-mode logits, then in training mode the
  logits, the loss, every parameter's gradient and every BatchNorm
  buffer (the running variance unbiased, as the reference's eager step
  keeps it: :func:`unbiased_running_variance`), each within 1e-10 of its
  own largest value (a gradient that
  is 0 but for rounding, of a bias before a BatchNorm, within 1e-10 of
  the model's largest gradient). The input sizes
  are the reference tests' or smaller where the model allows, large
  enough that the last BatchNorm normalises over 8 values or more
  (over 2, its backward cancels to rounding). Torch's side runs on one
  thread (:func:`one_thread`: with the suite's workers sharing the
  cores, a float64 grouped convolution's per-group OpenMP regions were
  the slowest part of the run). This file holds
  SqueezeNet; each other family has a file of its own
  (``test_torch_vision_zoo_*.py``, built on the helpers here), so that no
  file holds one worker for long.
"""
import contextlib
import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu.nn.initializer as JI
import paddle_tpu_torch as T
import paddle_tpu_torch.nn.initializer as TI
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu_torch import _device
from paddle_tpu_torch.analysis.layercheck import to_numpy

INIT_TOL = dict(rtol=1e-5, atol=2e-5)
F64_REL = 1e-10   # of each array's own largest value
#: a gradient below this share of the model's largest is rounding of an
#: exact 0
ZERO_GRAD = 1e-8

#: every factory and class of the ten families, with its constructor's
#: arguments
BUILDS = {
    "alexnet": {}, "AlexNet": {},
    "vgg11": {}, "vgg13": {}, "vgg16": {}, "vgg19": {},
    "vgg11-bn": {"batch_norm": True},
    "squeezenet1_0": {}, "squeezenet1_1": {}, "SqueezeNet": {},
    "mobilenet_v1": {}, "MobileNetV1": {"scale": 0.5},
    "mobilenet_v2": {}, "MobileNetV2": {"scale": 0.75},
    "mobilenet_v3_large": {}, "mobilenet_v3_small": {},
    "MobileNetV3Large": {"scale": 0.5}, "MobileNetV3Small": {},
    "shufflenet_v2_x0_25": {}, "shufflenet_v2_x0_33": {},
    "shufflenet_v2_x0_5": {}, "shufflenet_v2_x1_0": {},
    "shufflenet_v2_x1_5": {}, "shufflenet_v2_x2_0": {},
    "shufflenet_v2_swish": {}, "ShuffleNetV2": {"scale": "x0_5"},
    "googlenet": {}, "GoogLeNet": {"with_pool": False},
    "inception_v3": {}, "InceptionV3": {},
    "densenet121": {}, "densenet161": {}, "densenet169": {},
    "densenet201": {}, "densenet264": {}, "DenseNet": {"layers": 169},
}


@pytest.fixture(autouse=True)
def _cpu():
    prev = _device._CURRENT
    T.set_device("cpu")
    yield
    _device._CURRENT = prev


def _factory(P, name):
    return getattr(P.vision.models, name.split("-")[0])


def _state(layer) -> dict:
    return {k: to_numpy(v) for k, v in layer.state_dict().items()}


def _key_value(words) -> float:
    """A value in [0.5, 1.5) that names a key's two words."""
    k0, k1 = (int(w) & 0xFFFFFFFF for w in words)
    return 0.5 + ((k0 * 1_000_003 + k1) % 65_521) / 65_521


def _jax_words(key):
    if jnp.issubdtype(getattr(key, "dtype", None), jax.dtypes.prng_key):
        key = jax.random.key_data(key)
    return np.asarray(key).reshape(-1)


class _KeyedRandom:
    """``jax.random`` for the reference's initializers, each draw a
    constant naming its key."""

    @staticmethod
    def normal(key, shape, dtype=jnp.float32):
        return jnp.full(shape, _key_value(_jax_words(key)), dtype)

    @staticmethod
    def uniform(key, shape, dtype=jnp.float32, minval=0.0, maxval=1.0):
        u = _key_value(_jax_words(key)) - 0.5
        return jnp.full(shape, minval + (maxval - minval) * u, dtype)


class _KeyedJax:
    random = _KeyedRandom


@contextlib.contextmanager
def keyed_draws():
    """Inside the block, every random initializer of both packages draws
    a constant that names its key (the uniform ones ``low + (high - low)
    * u``, the normal ones ``z``, each then scaled by its initializer), so
    that building a model costs no random numbers."""
    def normal(key, shape, dtype):
        return torch.full(shape, _key_value(key), dtype=dtype,
                          device=_device.resolve_device(None))

    def uniform(key, shape, dtype, lo, hi):
        u = _key_value(key) - 0.5
        return torch.full(shape, lo + (hi - lo) * u, dtype=dtype,
                          device=_device.resolve_device(None))

    saved = JI.jax, TI._normal, TI._uniform
    JI.jax, TI._normal, TI._uniform = _KeyedJax, normal, uniform
    try:
        yield
    finally:
        JI.jax, TI._normal, TI._uniform = saved


def build_pair(name, seed=0, **kw):
    """The reference's model and the port's, each built after
    ``seed(seed)`` under :func:`keyed_draws`."""
    kw = {**BUILDS.get(name, {}), **kw}
    with keyed_draws():
        J.seed(seed)
        jm = _factory(J, name)(**kw)
        T.seed(seed)
        tm = _factory(T, name)(**kw)
    return jm, tm


def assert_same_state(jm, tm):
    want, got = _state(jm), _state(tm)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **INIT_TOL)
    missing, unexpected = tm.set_state_dict(want)
    assert missing == [] and unexpected == []


def random_weights(jm, seed, dtype=np.float64) -> dict:
    """Weights for every parameter of ``jm``, by name: weights of rank 2
    or more scaled by ``sqrt(2 / fan_in)`` (a Linear's weight is ``[in,
    out]``), BatchNorm scales near 1, biases near 0."""
    rng = np.random.default_rng(seed)
    out = {}
    for n, p in jm.named_parameters():
        shape = tuple(p.shape)
        z = rng.standard_normal(shape, dtype=dtype)
        if len(shape) >= 2:
            fan_in = shape[0] if len(shape) == 2 else int(np.prod(shape[1:]))
            w = z * np.sqrt(2.0 / fan_in)
        elif n.endswith("bias"):
            w = 0.1 * z
        else:
            w = 1.0 + 0.1 * z
        out[n] = w.astype(dtype)
    return out


def _outs(out) -> list:
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _close64(got, want, what, floor=1e-300):
    """Within F64_REL of ``want``'s largest value, or of ``floor`` where
    that is larger."""
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), floor)
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= F64_REL * scale, (what, err, scale)


def reference_eval(jm, weights, buffers, x) -> list:
    """The reference's outputs on ``x`` with ``weights`` and ``buffers``
    substituted: ``jax.jit`` of its ``functional_call``."""
    fn = jax.jit(lambda p, b, x: jm.functional_call(p, b, JTensor(x))[0])
    return _outs(fn({k: jnp.asarray(v) for k, v in weights.items()},
                    {k: jnp.asarray(v) for k, v in buffers.items()},
                    jnp.asarray(x)))


def _openmp():
    """The OpenMP runtime torch loaded (its CPU ops' threads)."""
    with open("/proc/self/maps") as maps:
        path = next(line.split()[-1] for line in maps
                    if "gomp" in line.split()[-1])
    return ctypes.CDLL(path)


@contextlib.contextmanager
def one_thread():
    """Torch's CPU ops on one OpenMP thread inside the block. A float64
    grouped convolution on the CPU runs one small convolution a group,
    each an OpenMP region; with the suite's workers sharing the cores,
    the regions' threads wait on each other far longer than they
    compute. The OpenMP setting is restored as it was (not through
    ``torch.set_num_threads``, which also pins the BLAS library's
    threads and so moves later float64 sums of other tests)."""
    omp = _openmp()
    threads = omp.omp_get_max_threads()
    omp.omp_set_num_threads(1)
    try:
        yield
    finally:
        omp.omp_set_num_threads(threads)


def check_family(name, size, batch=2, seed=0, num_classes=10, train=True,
                 **kw):
    with one_thread():
        return _check_family(name, size, batch, seed, num_classes, train,
                             **kw)


def _check_family(name, size, batch, seed, num_classes, train, **kw):
    """The port's ``name(num_classes=num_classes, **kw)`` against the reference's on
    the same random float64 weights and input ``[batch, 3, size, size]``:
    the eval-mode outputs, then the training-mode outputs, the loss (a
    fixed random weighting of every output), every parameter's gradient
    and the BatchNorm buffers after the step, each within F64_REL of its
    own largest value (with ``train`` False, the eval-mode outputs only).
    Dropout draws the same keys on both sides (each package is seeded
    just before its training forward)."""
    jm, tm = build_pair(name, num_classes=num_classes, **kw)
    jm.to(dtype="float64")
    tm.to(dtype="float64")
    weights = random_weights(jm, seed)
    jbuf = {k: np.asarray(to_numpy(v), np.float64)
            for k, v in jm.named_buffers()}
    missing, unexpected = tm.set_state_dict({**weights, **jbuf})
    assert missing == [] and unexpected == []
    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal((batch, 3, size, size))
    pv = {k: jnp.asarray(v) for k, v in weights.items()}
    bv = {k: jnp.asarray(v) for k, v in jbuf.items()}

    jm.eval()
    want_eval = reference_eval(jm, weights, jbuf, x)
    tm.eval()
    with torch.no_grad():
        got_eval = _outs(tm(T.to_tensor(x)))
    assert len(got_eval) == len(want_eval)
    for i, (g, w) in enumerate(zip(got_eval, want_eval)):
        _close64(to_numpy(g), to_numpy(w), f"eval out{i}")
    if not train:
        return tm
    rs = [rng.standard_normal(tuple(o.shape)) for o in got_eval]

    def loss_fn(p, b, x):
        out, nb = jm.functional_call(p, b, JTensor(x))
        outs = [o._value for o in _outs(out)]
        loss = sum(jnp.sum(o * jnp.asarray(r)) for o, r in zip(outs, rs))
        return loss, (outs, nb)

    jm.train()
    J.seed(seed + 2)
    (jloss, (jouts, jnb)), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(pv, bv, jnp.asarray(x))
    tm.train()
    counts = {}
    hooks = [layer.register_forward_pre_hook(
        lambda layer, inputs, name=name: counts.__setitem__(
            name, inputs[0].numel() // inputs[0].shape[1]))
        for name, layer in tm.named_sublayers()
        if isinstance(layer, T.nn.layers_norm._BatchNormBase)]
    T.seed(seed + 2)
    touts = _outs(tm(T.to_tensor(x)))
    for h in hooks:
        h.remove()
    tloss = sum(torch.sum(o * torch.as_tensor(r)) for o, r in zip(touts, rs))
    tloss.backward()
    for i, (g, w) in enumerate(zip(touts, jouts)):
        _close64(to_numpy(g), np.asarray(w), f"train out{i}")
    _close64(to_numpy(tloss), np.asarray(jloss), "loss")
    tparams = dict(tm.named_parameters())
    assert sorted(tparams) == sorted(jgrads)
    # a parameter whose exact gradient is 0 (a bias before a BatchNorm in
    # training mode) holds rounding only: it is held against the model's
    # largest gradient instead
    top = max(float(np.abs(np.asarray(g)).max()) for g in jgrads.values())
    for n, g in jgrads.items():
        g = np.asarray(g)
        rounding = float(np.abs(g).max()) < ZERO_GRAD * top
        _close64(to_numpy(tparams[n].grad), g, f"{n} grad",
                 floor=top if rounding else 1e-300)
    tbuf = {k: to_numpy(v) for k, v in tm.named_buffers()}
    assert sorted(tbuf) == sorted(jnb)
    for k, v in jnb.items():
        want = np.asarray(v)
        if k.endswith("._variance"):
            want = unbiased_running_variance(
                jbuf[k], want, counts[k[:-len("._variance")]],
                tm.get_submodule(k[:-len("._variance")])._momentum)
        _close64(tbuf[k], want, k)
    return tm


def unbiased_running_variance(before, traced, n, momentum):
    """The running variance the reference's eager step keeps (the batch
    variance times ``n / (n - 1)``), from the one its traced step keeps
    (the batch variance itself: under ``jax.jit`` its ``batch_norm``
    cannot read ``n``, ``paddle_tpu/nn/functional.py:521-524``). The port
    follows the eager step."""
    batch = (traced - momentum * before) / (1 - momentum)
    return momentum * before + (1 - momentum) * batch * n / (n - 1)


# ------------------------------------------------------------------ tests
@pytest.mark.parametrize("name", sorted(BUILDS))
def test_factory_builds_the_references_names_and_shapes(name):
    with J.LazyGuard():
        jm = _factory(J, name)(**BUILDS[name])
    with T.LazyGuard():
        tm = _factory(T, name)(pretrained=True, **BUILDS[name]) \
            if name[0].islower() else _factory(T, name)(**BUILDS[name])
    assert {k: tuple(v.shape) for k, v in tm.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in jm.state_dict().items()}


def test_seed_draws_the_references_weights():
    J.seed(0)
    jm = J.vision.models.shufflenet_v2_x0_25(num_classes=10)
    T.seed(0)
    tm = T.vision.models.shufflenet_v2_x0_25(num_classes=10)
    assert_same_state(jm, tm)


def test_seed_gives_each_parameter_the_references_key():
    jm, tm = build_pair("squeezenet1_0")
    assert_same_state(jm, tm)


def test_keyed_draws_name_the_key():
    """The replaced draws differ between keys, so a parameter that took
    another key would show."""
    with keyed_draws():
        for P in (J, T):
            P.seed(0)
        a, b = (T.nn.Linear(3, 2) for _ in range(2))
        ja = J.nn.Linear(3, 2)
    assert not np.array_equal(to_numpy(a.weight), to_numpy(b.weight))
    np.testing.assert_allclose(to_numpy(a.weight), to_numpy(ja.weight),
                               **INIT_TOL)


@pytest.mark.parametrize("name", ["squeezenet1_0", "squeezenet1_1"])
def test_squeezenet_matches_the_reference_float64(name):
    check_family(name, 64)


def test_vision_namespace_exports_every_family():
    names = {n for n in dir(J.vision.models) if n[0] != "_"}
    assert {n for n in names if not hasattr(T.vision.models, n)} == set()
    assert set(T.vision.models.__all__) <= names
