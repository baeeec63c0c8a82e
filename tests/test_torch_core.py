"""The port's dygraph core (``paddle_tpu_torch.core``: dtypes, places,
the ``Tensor`` subclass and its methods, grad mode, errors, allocator
statistics, the random-key names; ``framework.grad``) against the JAX
package's ``paddle_tpu.core``, on the CPU.

Values are compared exactly (they are copies or integer results) or, for
float32 arithmetic, within ``rtol 1e-6``; dtypes by canonical name.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu.core import errors as jerrors
from paddle_tpu_torch import _device
from paddle_tpu_torch.core import errors as terrors
from paddle_tpu_torch.core import memory as tmemory
from paddle_tpu_torch.core.dtype import convert_dtype


@pytest.fixture(autouse=True)
def _cpu():
    prev = _device._CURRENT
    T.set_device("cpu")
    yield
    _device._CURRENT = prev


def _x(seed=0, shape=(3, 4)):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


# ------------------------------------------------------------------ dtype
@pytest.mark.parametrize("spec", ["float32", "float", "double", "half",
                                  "int", "long", "bfloat16", "bool",
                                  "uint8", "int8", "int16", "complex64",
                                  np.float64, np.int32, np.dtype("bool")],
                         ids=str)
def test_convert_dtype_matches_reference(spec):
    assert T.core.convert_dtype(spec) == J.core.convert_dtype(spec)


def test_torch_dtypes_convert_and_compare():
    for name in ("float32", "float64", "int64", "bool", "bfloat16",
                 "complex128"):
        td = getattr(T, name)
        assert isinstance(td, torch.dtype)
        assert convert_dtype(td) == name
    x = T.to_tensor([1.0, 2.0])
    assert x.dtype == T.float32 and T.dtype is torch.dtype


def test_unknown_dtype_raises_like_reference():
    for conv in (T.core.convert_dtype, J.core.convert_dtype):
        with pytest.raises(ValueError):
            conv("float8")


def test_default_dtype_drives_python_floats():
    prev_t, prev_j = T.get_default_dtype(), J.get_default_dtype()
    try:
        for P in (T, J):
            P.set_default_dtype("float64")
        assert convert_dtype(T.to_tensor(1.5).dtype) == \
            J.to_tensor(1.5).dtype == "float64"
        for P in (T, J):
            with pytest.raises(TypeError):
                P.set_default_dtype("int32")
    finally:
        T.set_default_dtype(prev_t)
        J.set_default_dtype(prev_j)
    assert T.get_default_dtype() == "float32"


@pytest.mark.parametrize("data,dtype", [
    (1.5, None), (3, None), (True, None), ([1, 2, 3], None),
    ([[1.0, 2.5]], None), (np.ones(3), None), (np.ones(3, np.int32), None),
    ([1, 2], "float32"), (2.0, "float16"), ([0.5], "bfloat16"),
], ids=lambda v: repr(v)[:20])
def test_to_tensor_dtype_rules(data, dtype):
    t, j = T.to_tensor(data, dtype=dtype), J.to_tensor(data, dtype=dtype)
    assert convert_dtype(t.dtype) == j.dtype
    assert list(t.shape) == j.shape
    np.testing.assert_array_equal(t.numpy(), np.asarray(j.numpy(),
                                                        np.float64)
                                  if dtype == "bfloat16" else j.numpy())


def test_to_tensor_copies_a_tensor_and_sets_stop_gradient():
    src = torch.ones(3)
    t = T.to_tensor(src, stop_gradient=False)
    assert isinstance(t, T.Tensor) and not t.stop_gradient and t.is_leaf
    src.add_(1)
    assert float(t.sum()) == 3.0  # a copy
    assert T.to_tensor([1, 2], stop_gradient=False).stop_gradient  # ints


# ------------------------------------------------------------------ place
def test_places_and_set_device():
    assert T.CPUPlace() == T.CPUPlace() and T.CUDAPlace(0) != T.CUDAPlace(1)
    assert T.CUDAPlace(1).get_device_id() == 1
    assert T.set_device("cpu") == T.CPUPlace()
    assert T.get_device() == J.get_device() == "cpu" or \
        T.get_device() == "cpu"
    assert T.to_tensor([1.0]).place == T.CPUPlace()
    assert T.device_count() == torch.cuda.device_count()
    assert T.set_device("gpu:1") == T.CUDAPlace(1)
    assert T.get_device() == "gpu:1"
    with pytest.raises(ValueError):
        T.set_device("tpu")  # the port has no TPU place


def test_chosen_card_absent_raises():
    """The default is the card, and a card that is chosen (or defaulted)
    but absent raises; the CPU is only ever the caller's choice."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: nothing raises")
    _device._CURRENT = None
    assert T.get_device() == "gpu:0"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.resolve_device(None)
    with pytest.raises(RuntimeError):
        T.to_tensor([1.0])
    T.set_device("gpu")
    with pytest.raises(RuntimeError):
        T.zeros([2])
    T.set_device("cpu")
    assert T.resolve_device(None) == torch.device("cpu")


def test_compiled_with():
    assert T.is_compiled_with_cuda() is True  # the reference says False
    assert not T.is_compiled_with_xpu() and not T.is_compiled_with_npu()
    assert not T.is_compiled_with_ipu()


# ----------------------------------------------------------- Tensor methods
def _pair(seed=0, grad=False):
    x = _x(seed)
    return (T.to_tensor(x, stop_gradient=not grad),
            J.to_tensor(x, stop_gradient=not grad))


METHODS = {  # name -> f(tensor, package)
    "numpy": lambda t, P: t.numpy(),
    "item": lambda t, P: t[1, 2].item(),
    "tolist": lambda t, P: t.tolist(),
    "astype": lambda t, P: t.astype("int32").numpy(),
    "cast": lambda t, P: t.cast("float64").numpy(),
    "detach": lambda t, P: t.detach().numpy(),
    "clone": lambda t, P: t.clone().numpy(),
    "stop_gradient": lambda t, P: t.stop_gradient,
    "detach_stop_gradient": lambda t, P: t.detach().stop_gradient,
    "ndim": lambda t, P: t.ndim,
    "dim": lambda t, P: t.dim(),
    "value": lambda t, P: t.value().numpy(),
    "md5sum": lambda t, P: t._md5sum(),
    "float": lambda t, P: float(t[0, 0]),
    "abs_method": lambda t, P: t.abs().numpy(),
    "logsumexp_method": lambda t, P: t.logsumexp(axis=1).numpy(),
    "matmul_method": lambda t, P: t.matmul(t.t()).numpy(),
    "gather_nd_method": lambda t, P: t.gather_nd(
        P.to_tensor(np.array([[0, 1]]))).numpy(),
    "put_along_axis_method": lambda t, P: t.put_along_axis(
        P.to_tensor(np.array([[1], [0], [2]])), 9.0, 1).numpy(),
}


@pytest.mark.parametrize("name", sorted(METHODS))
def test_tensor_method_matches_reference(name):
    t, j = _pair()
    got, want = METHODS[name](t, T), METHODS[name](j, J)
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-6)
    else:
        assert got == want


def test_numpy_of_a_tensor_that_takes_a_gradient():
    t, j = _pair(grad=True)
    y, jy = (t * 2).sum(), J.sum(j * 2)
    assert isinstance(y, T.Tensor) and not y.stop_gradient
    np.testing.assert_allclose(y.numpy(), jy.numpy(), rtol=1e-6)
    assert float(y.numpy()) == pytest.approx(float(jy.numpy()), rel=1e-6)
    bf = T.to_tensor([1.5], dtype="bfloat16")
    assert bf.numpy().dtype == np.float32  # numpy has no bfloat16


def test_backward_clear_grad_and_set_value():
    t, j = _pair(grad=True)
    (t * t).sum().backward()
    J.sum(j * j).backward()
    np.testing.assert_allclose(t.grad.numpy(), j.grad.numpy(), rtol=1e-6)
    np.testing.assert_allclose(t.gradient(), j.gradient(), rtol=1e-6)
    t.clear_grad()
    j.clear_grad()
    assert t.grad is None and j.grad is None
    new = _x(5)
    t.set_value(new)
    j.set_value(new)
    np.testing.assert_array_equal(t.numpy(), j.numpy())
    with pytest.raises(ValueError):
        t.set_value(np.zeros((2, 2), np.float32))
    assert not t.stop_gradient  # set_value keeps the leaf's flag


def test_stop_gradient_toggles_on_a_leaf():
    t = T.to_tensor(_x())
    assert t.stop_gradient
    t.stop_gradient = False
    assert t.requires_grad and t.is_leaf
    y = t * 2
    with pytest.raises(RuntimeError, match="detach"):
        y.stop_gradient = True


def test_register_hook_scales_gradient():
    t, j = _pair(grad=True)
    t.register_hook(lambda g: g * 3)
    j.register_hook(lambda g: g * 3)
    (t * t).sum().backward()
    J.sum(j * j).backward()
    np.testing.assert_allclose(t.grad.numpy(), j.grad.numpy(), rtol=1e-6)


def test_subclass_survives_torch_ops_and_methods_stay_on_it():
    t = T.to_tensor(_x())
    for out in (t + 1, torch.matmul(t, t.t()), t.reshape(-1), t[0],
                torch.nn.functional.linear(t, t), t.detach(), t.clone()):
        assert isinstance(out, T.Tensor)
    assert hasattr(T.Tensor, "astype") and hasattr(T.Tensor, "gather_nd")
    assert not hasattr(torch.Tensor, "astype")  # torch.Tensor untouched
    assert not hasattr(torch.Tensor, "gather_nd")
    assert isinstance(t.shape, torch.Size)  # torch's (the reference: list)
    np.testing.assert_array_equal(T.shape(t).numpy(),
                                  J.shape(J.to_tensor(_x())).numpy())


# ------------------------------------------------------------ grad mode
def test_no_grad_and_enable_grad():
    for P in (T, J):
        x = P.to_tensor(_x(), stop_gradient=False)
        with P.no_grad():
            assert not P.is_grad_enabled()
            assert (x * 2).stop_gradient
            with P.enable_grad():
                assert P.is_grad_enabled()
                assert not (x * 2).stop_gradient
        assert P.is_grad_enabled()

    @T.no_grad()
    def f(x):
        return x * 2

    assert f(T.to_tensor(_x(), stop_gradient=False)).stop_gradient
    with T.set_grad_enabled(False):
        assert not T.is_grad_enabled()
    assert T.is_grad_enabled()


def test_grad_matches_reference():
    xs = _x()
    t = T.to_tensor(xs, stop_gradient=False)
    j = J.to_tensor(xs, stop_gradient=False)
    u_t = T.to_tensor(_x(1), stop_gradient=False)
    u_j = J.to_tensor(_x(1), stop_gradient=False)
    gt = T.grad(T.sum(t * t * t), [t, u_t])
    gj = J.grad(J.sum(j * j * j), [j, u_j])
    np.testing.assert_allclose(gt[0].numpy(), gj[0].numpy(), rtol=1e-6)
    np.testing.assert_array_equal(gt[1].numpy(), gj[1].numpy())  # zeros
    assert t.grad is None  # .grad untouched
    gt = T.grad(T.sum(t * 2), [t, u_t], allow_unused=True)
    gj = J.grad(J.sum(j * 2), [j, u_j], allow_unused=True)
    assert gt[1] is None and gj[1] is None
    np.testing.assert_allclose(gt[0].numpy(), gj[0].numpy())
    assert T.in_dynamic_mode() and J.in_dynamic_mode()


# --------------------------------------------------------- errors, memory
@pytest.mark.parametrize("name", jerrors.__all__)
def test_errors_match_reference(name):
    jobj, tobj = getattr(jerrors, name), getattr(terrors, name)
    if isinstance(jobj, type):
        assert [b.__name__ for b in tobj.__mro__] == \
            [b.__name__ for b in jobj.__mro__]
        if issubclass(jobj, jerrors.PaddleError):
            assert str(tobj("bad", k=1)) == str(jobj("bad", k=1))
    else:
        args = {"enforce": (False, "m"), "enforce_eq": (1, 2),
                "enforce_gt": (1, 2), "enforce_not_none": (None,)}[name]
        with pytest.raises(jerrors.PaddleError) as je:
            jobj(*args, k=3)
        with pytest.raises(terrors.PaddleError) as te:
            tobj(*args, k=3)
        assert type(te.value).__name__ == type(je.value).__name__
        assert str(te.value) == str(je.value)


def test_memory_stats_on_the_cpu_are_empty():
    assert tmemory.memory_stats("cpu") == {}
    assert tmemory.memory_allocated("cpu") == 0
    assert tmemory.device_memory_limit("cpu") == 0
    with pytest.raises(ValueError):
        tmemory.set_memory_fraction(1.5)
    tmemory.empty_cache()


def test_rng_root_names_draw_the_reference_keys():
    """``Generator``, ``default_generator``, ``next_rng_key`` and
    ``get_rng_tracker`` are the root's and core's; after ``seed`` the keys
    equal the reference's key data."""
    import jax

    T.seed(3)
    J.seed(3)
    tk = T.core.next_rng_key()
    jk = J.core.next_rng_key()
    assert tuple(tk) == tuple(int(w) for w in jax.random.key_data(jk))
    assert T.core.default_generator() is T.core.rng.default_generator()
    assert isinstance(T.Generator(5), T.core.Generator)
    assert T.core.get_rng_tracker() is T.core.rng.get_rng_tracker()
    state = T.get_cuda_rng_state()
    a = T.core.next_rng_key()
    T.set_cuda_rng_state(state)
    assert T.core.next_rng_key() == a
