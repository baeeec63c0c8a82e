"""``paddle_tpu_torch.jit.dy2static`` against the JAX package's: every
case of ``tests/test_dy2static.py`` through both packages' conversion,
each result equal (the values are exact small floats) or both raising
the same error.

The reference traces its tensor-bound cases under ``jax.jit``, where a
tensor predicate is symbolic (both branches, ``where``, ``lax.while_loop``);
the port runs them eagerly, reading a tensor predicate once a test. The
cases that the reference's test runs under ``jax.jit`` run so here too on
the reference's side, and eagerly on the port's.
"""
import importlib.util
import os
import sys
import tempfile

import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu.jit.dy2static import convert_control_flow as j_convert
from paddle_tpu_torch import _device
from paddle_tpu_torch.jit.dy2static import convert_control_flow as t_convert

CONVERT = {J: j_convert, T: t_convert}


@pytest.fixture(autouse=True)
def _cpu():
    prev = _device._CURRENT
    T.set_device("cpu")
    yield
    _device._CURRENT = prev


def _t(P, values, dtype=np.float32):
    return P.to_tensor(np.asarray(values, dtype))


def _val(x):
    """A result as plain Python: floats, nested lists."""
    if isinstance(x, (list, tuple)):
        return [_val(v) for v in x]
    if hasattr(x, "numpy"):
        return np.asarray(x.numpy(), np.float64).tolist()
    if isinstance(x, np.ndarray):
        return x.astype(np.float64).tolist()
    return x


def _jitted(P, g, *static):
    """The reference test's ``jax.jit`` of ``g(Tensor(arr), *static)``;
    the port calls ``g`` eagerly."""
    if P is T:
        return lambda arr: g(T.to_tensor(arr), *static)
    import jax

    from paddle_tpu.core import tape
    from paddle_tpu.core.tensor import Tensor

    @jax.jit
    def traced(arr):
        with tape.no_grad():
            return g(Tensor(arr), *static)._value

    return lambda arr: J.to_tensor(np.asarray(traced(arr)))


# ---------------------------------------------------------------- the cases
def case_tensor_if_both_signs(P, convert):
    def f(x):
        if x.sum() > 0:
            y = x * 2.0
        else:
            y = x - 1.0
        return y

    g = convert(f)
    return [g(_t(P, [1.0, 2.0])), g(_t(P, [-3.0, 1.0]))]


def case_tensor_if_under_jit_tracing(P, convert):
    def f(x):
        if x.sum() > 0:
            y = x * 2.0
        else:
            y = x - 1.0
        return y

    run = _jitted(P, convert(f))
    return [run(np.array([1.0, 2.0], np.float32)),
            run(np.array([-3.0, 1.0], np.float32))]


def case_python_if_untouched(P, convert):
    def f(x, flag):
        if flag:
            return x + 1.0
        return x - 1.0

    g = convert(f)
    x = _t(P, np.zeros(2))
    return [g(x, True), g(x, False)]


def case_var_assigned_one_branch_raises(P, convert):
    def f(x):
        if x.sum() > 0:
            y = x * 2.0
        else:
            z = x  # noqa: F841 — y missing on this branch
        return y  # noqa: F821

    return convert(f)(_t(P, np.ones(2)))


def case_tensor_while_loop(P, convert):
    def f(x):
        s = x * 0.0 + 1.0
        n = x * 0.0
        while (s < 100.0).all():
            s = s * 2.0
            n = n + 1.0
        return s, n

    def h(x, k):
        while k > 0:
            x = x + 1.0
            k -= 1
        return x

    return [convert(f)(_t(P, 1.0)), convert(h)(_t(P, 0.0), 3)]


def case_for_range_conversion_python_and_tensor_bounds(P, convert):
    def g(x, n):
        acc = x * 0.0
        for i in range(n):
            acc = acc + 1.0
        return acc

    def h(x, n):
        s = x * 0.0
        for i in range(1, n):
            s = s + i
        return s

    def k(x):
        s = x * 0.0
        for i in range(3, 0, -1):
            s = s + i
        return s

    cg = convert(g)
    zero = _t(P, 0.0)
    if P is T:
        bound = [cg(zero, T.to_tensor(np.int32(5))),
                 cg(zero, T.to_tensor(np.int32(2)))]
    else:
        import jax

        from paddle_tpu.core import tape
        from paddle_tpu.core.tensor import Tensor

        @jax.jit
        def traced(n_arr):
            with tape.no_grad():
                return cg(Tensor(np.zeros((), np.float32)),
                          Tensor(n_arr))._value

        bound = [np.asarray(traced(np.int32(5))),
                 np.asarray(traced(np.int32(2)))]
    return [cg(zero, 4), *bound, convert(h)(zero, 4), convert(k)(zero)]


def case_for_range_python_edge_semantics(P, convert):
    def f(x, i):
        for i in range(5, 5):
            x = x + 1.0
        return x, i

    calls = []

    def side(v):
        calls.append(v)
        return v

    def g(x, n):
        s = x * 0.0
        for i in range(side(1), n):
            s = s + i
        return s

    out, i = convert(f)(_t(P, 0.0), 99)
    return [out, i, convert(g)(_t(P, 0.0), 4), calls]


def case_closure_and_globals_survive(P, convert):
    scale = 3.0

    def outer():
        offset = 10.0

        def f(x):
            if x.sum() > 0:
                y = x * scale + offset
            else:
                y = x * scale - offset
            return y

        return f

    g = convert(outer())
    return [g(_t(P, np.ones(2))), g(_t(P, -np.ones(2)))]


def case_while_with_body_temp_variable(P, convert):
    def f(x):
        s = x * 0.0
        while (s < 5.0).all():
            t = x * 1.0  # body-local temp, no pre-loop init
            s = s + t
        return s

    return convert(f)(_t(P, 1.0))


def case_while_body_temp_unbound_after(P, convert):
    def h(x):
        s = x * 0.0
        while (s < 3.0).all():
            t = x * 1.0
            s = s + t
        return t  # read after the loop: must fail loudly

    return convert(h)(_t(P, 1.0))


def case_nested_tensor_ifs_convert(P, convert):
    def f(x):
        if x.sum() > 0.0:
            if x.max() > 10.0:
                y = x * 100.0
            else:
                y = x * 2.0
        else:
            y = x - 1.0
        return y

    run = _jitted(P, convert(f))
    return [run(np.array([v], np.float32)) for v in (20.0, 2.0, -2.0)]


def case_python_untaken_branch_var_stays_unbound(P, convert):
    def f(x, flag):
        if flag:
            y = x * 2.0
        else:
            z = x  # noqa: F841
        return y  # noqa: F821

    g = convert(f)
    out = g(_t(P, np.ones(2)), True)
    try:
        g(_t(P, np.ones(2)), False)
    except (NameError, UnboundLocalError) as e:
        return [out, type(e).__name__ in ("NameError", "UnboundLocalError")]
    return [out, False]


def case_to_static_layer_with_convert_flag(P, convert):
    class Gate(P.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = P.nn.Linear(2, 2)

        def forward(self, x):
            h = self.fc(x)
            if h.sum() > 0:
                out = h * 2.0
            else:
                out = h * -1.0
            return out

    P.seed(0)
    layer = Gate()
    layer.fc.weight.set_value(np.array([[0.5, -1.0], [0.25, 2.0]],
                                       np.float32))
    P.jit.to_static(layer, convert_control_flow=True)
    x = _t(P, np.ones((1, 2)))
    return [layer.forward_traced(x), layer.forward_traced(-x)]


def case_to_static_with_convert_flag(P, convert):
    @P.jit.to_static(convert_control_flow=True)
    def f(x):
        if x.sum() > 0:
            y = x * 2.0
        else:
            y = x * -1.0
        return y

    return [f(_t(P, [2.0])), f(_t(P, [-2.0]))]


def case_return_inside_branch_left_as_python_if(P, convert):
    def f(x, flag):
        if flag:
            return x * 2.0
        return x

    def h(x):
        if x.sum() > 0:
            return x * 2.0
        return x

    x = _t(P, [3.0])
    g = convert(f)
    return [g(x, True), g(x, False), convert(h)(x)]


_BC_CODE = """
import {pkg} as paddle


def f_break(x):
    s = paddle.zeros([], 'float32')
    for i in range(5):
        if s > 2.5:
            break
        s = s + paddle.sum(x)
    return s


def f_continue(x):
    s = paddle.zeros([], 'float32')
    for i in range(4):
        if paddle.sum(x) * float(i) == 3.0:
            continue
        s = s + 1.0
    return s


def f_while_break(x):
    s = paddle.zeros([], 'float32')
    n = paddle.zeros([], 'int32')
    while n < 100:
        s = s + paddle.sum(x)
        n = n + 1
        if s > 7.0:
            break
    return s, n


def f_python_break(x):
    s = 0.0
    for i in range(10):
        if i == 3:
            break
        s = s + 1.0
    return paddle.to_tensor(__import__('numpy').float32(s)) + paddle.sum(x) * 0


def f_with_break(x):
    s = paddle.zeros([], 'float32')
    for i in range(5):
        with paddle.no_grad():
            if s > 2.5:
                break
        s = s + paddle.sum(x)
    return s
"""


@pytest.fixture(scope="module")
def bc_modules():
    """The break/continue functions compiled from real files (the
    conversion reads their source), one module a package."""
    mods, paths = {}, []
    for P, pkg in ((J, "paddle_tpu"), (T, "paddle_tpu_torch")):
        f = tempfile.NamedTemporaryFile("w", suffix=".py", delete=False)
        f.write(_BC_CODE.format(pkg=pkg))
        f.close()
        paths.append(f.name)
        name = f"d2s_bc_{pkg}"
        spec = importlib.util.spec_from_file_location(name, f.name)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
        mods[P] = mod
    yield mods
    for p in paths:
        os.unlink(p)


def _bc_case(fn_name):
    def case(P, convert, mods):
        return P.jit.to_static(getattr(mods[P], fn_name))(
            _t(P, np.ones(3)))

    return case


CASES = {name[5:]: fn for name, fn in dict(globals()).items()
         if name.startswith("case_")}
BC_CASES = {name: _bc_case(name) for name in (
    "f_break", "f_continue", "f_while_break", "f_python_break",
    "f_with_break")}


def _outcome(run):
    try:
        return ("ok", _val(run()))
    except (NameError, UnboundLocalError) as e:
        return ("raises", "NameError" if isinstance(e, NameError)
                and "only one branch" in str(e) else "unbound")


@pytest.mark.parametrize("name", sorted(CASES))
def test_case_through_both_packages(name):
    want = _outcome(lambda: CASES[name](J, CONVERT[J]))
    got = _outcome(lambda: CASES[name](T, CONVERT[T]))
    assert got == want


@pytest.mark.parametrize("name", sorted(BC_CASES))
def test_break_continue_case_through_both_packages(name, bc_modules):
    want = _outcome(lambda: BC_CASES[name](J, CONVERT[J], bc_modules))
    got = _outcome(lambda: BC_CASES[name](T, CONVERT[T], bc_modules))
    assert got == want


def test_cases_cover_the_reference_file():
    src = open(os.path.join(os.path.dirname(__file__),
                            "test_dy2static.py")).read()
    ref_tests = {line.split("(")[0][len("def test_"):]
                 for line in src.splitlines()
                 if line.startswith("def test_")}
    mine = set(CASES) | {n[2:] for n in BC_CASES}
    aliases = {"while_with_body_temp_variable":
               "while_body_temp_unbound_after",
               "tensor_break_in_for_range": "break",
               "tensor_continue_in_for_range": "continue",
               "tensor_break_in_while": "while_break",
               "python_break_semantics_preserved": "python_break",
               "tensor_break_inside_with_block": "with_break"}
    for t in ref_tests:
        assert t in mine or aliases.get(t) in mine, t


def test_tensor_predicate_runs_one_branch():
    seen = []

    def f(x):
        if x.sum() > 0:
            seen.append("t")
            y = x * 2.0
        else:
            seen.append("f")
            y = x - 1.0
        return y

    t_convert(f)(_t(T, [1.0]))
    assert seen == ["t"]  # the reference's symbolic path runs both
