"""The port's tensor functions (``paddle_tpu_torch.tensor_ops``: creation,
math, manipulation, logic, search, random, linalg, ``einsum``) against
the JAX package's, one case per function.

Each case makes its inputs with numpy from a seed, passes the same
arrays (as each package's ``to_tensor``) through the JAX function and
the port's counterpart, and holds every output equal in dtype and shape,
and in value: exactly for integer and bool outputs, within ``rtol 1e-5``
and ``atol 1e-6`` for float32 (summation order and the libraries'
elementary functions; a case that needs more states it beside the case,
with the reason). Where the reference differentiates the function, the
inputs take a gradient and the gradients of ``sum(output)`` (float
outputs) are held to the same tolerance. Random functions are compared
after ``seed(7)`` in both packages: bit for bit where the port's docstring
says so, else within the stated tolerance. Decompositions with a sign or
order freedom (``svd``, ``eig``, ``eigh``) compare what is unique: the
reconstruction, the sorted values.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu_torch.core.dtype import convert_dtype

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _cpu():
    """The port on the CPU for each case, then the default place again."""
    from paddle_tpu_torch import _device

    prev = _device._CURRENT
    T.set_device("cpu")
    yield
    _device._CURRENT = prev


def F(*shape, seed=0):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


def Pos(*shape, seed=0):
    return np.random.RandomState(seed).uniform(0.5, 2.0, shape).astype(
        np.float32)


def Unit(*shape, seed=0):
    return np.random.RandomState(seed).uniform(0.1, 0.9, shape).astype(
        np.float32)


def I(*shape, lo=0, hi=5, seed=0):  # noqa: E743 — a short name in tables
    return np.random.RandomState(seed).randint(lo, hi, shape).astype(
        np.int64)


def B(*shape, seed=0):
    return np.random.RandomState(seed).rand(*shape) > 0.5


def SPD(n, seed=0):
    a = F(n, n, seed=seed)
    return (a @ a.T + n * np.eye(n)).astype(np.float32)


#: name -> (call(P, *tensors), inputs, options). ``inputs``: numpy
#: arrays, each passed as ``P.to_tensor``; options: grad (the gradient
#: of sum(output) w.r.t. the float inputs), tol (rtol, atol), random
#: (seed both packages first), check (a custom comparison of outputs)
CASES = {}


def case(name, call, *inputs, grad=False, tol=None, check=None,
         random=False, ref_raises=None, expect=None):
    """``ref_raises``: the reference's function is broken and raises this
    (its actual behaviour, pinned); the port is then held to ``expect``,
    a numpy function of the inputs."""
    CASES[name] = (call, inputs, dict(grad=grad, tol=tol, check=check,
                                      random=random, ref_raises=ref_raises,
                                      expect=expect))


x34, y34, p34, u34 = F(3, 4), F(3, 4, seed=1), Pos(3, 4), Unit(3, 4)
x234 = F(2, 3, 4)
i34 = I(3, 4, lo=1, hi=9)

# ------------------------------------------------------------- creation
case("to_tensor", lambda P: P.to_tensor([[1.5, 2.0], [3.0, 4.0]]))
case("zeros", lambda P: P.zeros([2, 3]))
case("ones", lambda P: P.ones([2, 3], dtype="int32"))
case("full", lambda P: P.full([2, 3], 7))
case("zeros_like", lambda P, x: P.zeros_like(x), x34)
case("ones_like", lambda P, x: P.ones_like(x, dtype="float64"), x34)
case("full_like", lambda P, x: P.full_like(x, 2.5), x34)
case("empty", lambda P: P.empty([2, 2]))
case("empty_like", lambda P, x: P.empty_like(x), i34)
case("arange", lambda P: P.arange(2, 11, 3))
case("linspace", lambda P: P.linspace(0, 1, 7))
case("eye", lambda P: P.eye(3, 4))
case("tril", lambda P, x: P.tril(x, 1), x34, grad=True)
case("triu", lambda P, x: P.triu(x, -1), x34, grad=True)
case("diag", lambda P, x: P.diag(x, padding_value=0.5), F(4), grad=True)
case("diagflat", lambda P, x: P.diagflat(x, 1), F(2, 2), grad=True)
case("meshgrid", lambda P, a, b: P.meshgrid(a, b), F(3), F(2, seed=1),
     grad=True)
case("assign", lambda P, x: P.assign(x), x34, grad=True)
case("clone", lambda P, x: P.clone(x), x34, grad=True)
case("numel", lambda P, x: P.numel(x), x234)
case("one_hot", lambda P, x: P.one_hot(x, 6), I(5))
# jnp.logspace computes base ** linspace in float32; torch in float64
# then rounds: one float32 ulp at 1e3
case("logspace", lambda P: P.logspace(0, 3, 5), tol=(2e-6, 1e-6))
case("tril_indices", lambda P: P.tril_indices(4, 5, 1))
case("triu_indices", lambda P: P.triu_indices(4, 3, -1))
case("complex", lambda P, a, b: P.complex(a, b), x34, y34)

# ----------------------------------------------------------------- math
for _n in ("add", "subtract", "multiply", "divide", "maximum", "minimum",
           "fmax", "fmin", "atan2"):
    case(_n, lambda P, x, y, _n=_n: getattr(P, _n)(x, y), x34, y34,
         grad=True)
case("floor_divide", lambda P, x, y: P.floor_divide(x, y), x34, p34)
case("remainder", lambda P, x, y: P.remainder(x, y), x34, p34, grad=True)
case("mod", lambda P, x: P.mod(x, 1.5), x34)
case("floor_mod", lambda P, x, y: P.floor_mod(x, y), i34, I(3, 4, lo=1,
                                                            hi=4, seed=2))
case("pow", lambda P, x: P.pow(x, 3), x34, grad=True)
case("matmul", lambda P, x, y: P.matmul(x, y, transpose_y=True), x34, y34,
     grad=True)
_UNARY = {  # name -> input (the function's domain)
    "sqrt": p34, "rsqrt": p34, "exp": x34, "expm1": x34, "log": p34,
    "log2": p34, "log10": p34, "log1p": p34, "abs": x34, "neg": x34,
    "sign": x34, "sin": x34, "cos": x34, "tan": u34, "sinh": x34,
    "cosh": x34, "tanh": x34, "asin": u34, "acos": u34, "atan": x34,
    "floor": x34, "ceil": x34, "round": x34, "trunc": x34, "square": x34,
    "reciprocal": p34, "erf": x34, "frac": x34, "rad2deg": x34,
    "deg2rad": x34, "logit": u34, "stanh": x34, "acosh": p34 + 1,
    "asinh": x34, "atanh": u34, "digamma": p34, "lgamma": p34,
    "erfinv": u34, "isnan": x34, "isinf": x34, "isfinite": x34,
    "angle": x34, "real": x34, "imag": x34, "conj": x34}
_NO_GRAD = {"isnan", "isinf", "isfinite", "sign", "floor", "ceil", "round",
            "trunc", "angle", "imag"}
for _n, _x in _UNARY.items():
    case(_n, lambda P, x, _n=_n: getattr(P, _n)(x), _x,
         grad=_n not in _NO_GRAD)
case("clip", lambda P, x: P.clip(x, -0.5, 0.7), x34, grad=True)
for _n in ("sum", "mean", "max", "min", "amax", "amin", "logsumexp",
           "nansum", "nanmean"):
    case(_n, lambda P, x, _n=_n: getattr(P, _n)(x, axis=[0, 2],
                                                keepdim=True),
         x234, grad=True)
case("sum_all", lambda P, x: P.sum(x), i34)
case("prod", lambda P, x: P.prod(x, axis=1), p34, grad=True)
case("cumsum", lambda P, x: P.cumsum(x, axis=1), x34, grad=True)
case("cumprod", lambda P, x: P.cumprod(x, dim=0), x34, grad=True)
case("std", lambda P, x: P.std(x, axis=1), x34, grad=True)
case("var", lambda P, x: P.var(x, axis=0, unbiased=False), x34, grad=True)
case("add_n", lambda P, a, b: P.add_n([a, b]), x34, y34, grad=True)
case("all", lambda P, x: P.all(x, axis=1), B(3, 4))
case("any", lambda P, x: P.any(x), B(3, 4))
case("count_nonzero", lambda P, x: P.count_nonzero(x, axis=1), I(3, 4))
case("scale", lambda P, x: P.scale(x, 2.0, 0.5, bias_after_scale=False),
     x34, grad=True)
case("increment", lambda P, x: P.increment(x, 2.0), x34)
case("dot", lambda P, x, y: P.dot(x, y), x34, y34, grad=True)
case("outer", lambda P, x, y: P.outer(x, y), F(3), F(4, seed=1), grad=True)
case("inner", lambda P, x, y: P.inner(x, y), x34, y34, grad=True)
case("multiplex", lambda P, a, b, i: P.multiplex([a, b], i), x34, y34,
     np.array([1, 0, 1], np.int32))
case("lerp", lambda P, x, y: P.lerp(x, y, 0.3), x34, y34, grad=True)
case("diff", lambda P, x: P.diff(x, axis=1), x34, grad=True)
case("multiply_", lambda P, x, y: P.multiply_(x, y), x34, y34)
case("add_", lambda P, x, y: P.add_(x, y), x34, y34)
case("subtract_", lambda P, x, y: P.subtract_(x, y), x34, y34)
case("clip_", lambda P, x: P.clip_(x, -0.2, 0.2), x34)
case("scale_", lambda P, x: P.scale_(x, 3.0, 1.0), x34)
case("tanh_", lambda P, x: P.tanh_(x), x34)
for _n, _x in (("exp_", x34), ("ceil_", x34), ("floor_", x34),
               ("round_", x34), ("sqrt_", p34), ("rsqrt_", p34),
               ("reciprocal_", p34), ("erfinv_", u34)):
    case(_n, lambda P, x, _n=_n: getattr(P, _n)(x), _x)
case("lerp_", lambda P, x, y: P.lerp_(x, y, 0.25), x34, y34)
case("gcd", lambda P, a, b: P.gcd(a, b), I(6, lo=1, hi=40),
     I(6, lo=1, hi=40, seed=3))
case("lcm", lambda P, a, b: P.lcm(a, b), I(6, lo=1, hi=12),
     I(6, lo=1, hi=12, seed=3))
case("heaviside", lambda P, a, b: P.heaviside(a, b), x34, y34)
case("kron", lambda P, a, b: P.kron(a, b), F(2, 2), F(2, 3, seed=1),
     grad=True)
case("trace", lambda P, x: P.trace(x, offset=1), x34, grad=True)
case("addmm", lambda P, i, x, y: P.addmm(i, x, y, beta=0.5, alpha=2.0),
     F(3, 3), x34, F(4, 3, seed=1), grad=True)
case("quantile", lambda P, x: P.quantile(x, 0.3, axis=1), x34, grad=True)
case("nanquantile", lambda P, x: P.nanquantile(x, 0.6, axis=0), x34)
case("renorm", lambda P, x: P.renorm(x, 2.0, 0, 1.0), x34, grad=True)
case("rank", lambda P, x: P.rank(x), x234)
case("is_complex", lambda P, x: P.is_complex(x), x34)
case("is_floating_point", lambda P, x: P.is_floating_point(x), x34)
case("is_integer", lambda P, x: P.is_integer(x), i34)
case("bincount", lambda P, x: P.bincount(x, minlength=7), I(10))

# --------------------------------------------------------- manipulation
case("reshape", lambda P, x: P.reshape(x, [0, 2, 6]), x234, grad=True)
case("reshape_", lambda P, x: P.reshape_(x, [4, 3]), x34)
case("transpose", lambda P, x: P.transpose(x, [2, 0, 1]), x234, grad=True)
case("concat", lambda P, a, b: P.concat([a, b], axis=1), x34, y34,
     grad=True)
case("split", lambda P, x: P.split(x, [1, -1], axis=-1), x34, grad=True)
case("stack", lambda P, a, b: P.stack([a, b], axis=1), x34, y34, grad=True)
case("unstack", lambda P, x: P.unstack(x, axis=1), x34, grad=True)
case("squeeze", lambda P, x: P.squeeze(x, axis=[0, 1]), F(1, 3, 1, 2),
     grad=True)
case("unsqueeze", lambda P, x: P.unsqueeze(x, [0, -1]), x34, grad=True)
case("flatten", lambda P, x: P.flatten(x, 1, 2), x234, grad=True)
case("expand", lambda P, x: P.expand(x, [2, -1, 4]), F(1, 3, 4),
     grad=True)
case("expand_as", lambda P, x, y: P.expand_as(x, y), F(1, 4), x34,
     grad=True)
case("tile", lambda P, x: P.tile(x, [2, 1]), x34, grad=True)
case("broadcast_to", lambda P, x: P.broadcast_to(x, [2, 3, 4]), x34,
     grad=True)
case("gather", lambda P, x, i: P.gather(x, i, axis=1), x34,
     np.array([3, 0, 3], np.int64), grad=True)
case("gather_nd", lambda P, x, i: P.gather_nd(x, i), x234,
     np.array([[0, 1], [1, 2]], np.int64), grad=True)
case("scatter", lambda P, x, i, u: P.scatter(x, i, u), x34,
     np.array([2, 0], np.int64), F(2, 4, seed=3))
case("scatter_accumulate", lambda P, x, i, u: P.scatter(
    x, i, u, overwrite=False), x34, np.array([2, 2], np.int64),
    F(2, 4, seed=3))
case("scatter_nd_add", lambda P, x, i, u: P.scatter_nd_add(x, i, u), x34,
     np.array([[1, 2], [1, 2], [0, 0]], np.int64), F(3, seed=4), grad=True)
case("slice", lambda P, x: P.slice(x, [0, 2], [1, 1], [3, 3]), x234,
     grad=True)
case("index_select", lambda P, x, i: P.index_select(x, i, axis=0), x34,
     np.array([2, 1], np.int64), grad=True)
case("masked_select", lambda P, x, m: P.masked_select(x, m), x34, B(3, 4))
case("where", lambda P, c, x, y: P.where(c, x, y), B(3, 4), x34, y34,
     grad=True)
case("where_nonzero", lambda P, c: P.where(c), B(3, 4))
case("roll", lambda P, x: P.roll(x, 2, axis=1), x34, grad=True)
case("flip", lambda P, x: P.flip(x, [0, 1]), x34, grad=True)
case("chunk", lambda P, x: P.chunk(x, 2, axis=1), x34, grad=True)
case("unbind", lambda P, x: P.unbind(x, 0), x34, grad=True)
case("cast", lambda P, x: P.cast(x, "int32"), x34 * 3)
case("t", lambda P, x: P.t(x), x34, grad=True)
case("moveaxis", lambda P, x: P.moveaxis(x, 0, 2), x234, grad=True)
case("tensordot", lambda P, x, y: P.tensordot(x, y, 1), x34, F(4, 2),
     grad=True)
case("repeat_interleave", lambda P, x: P.repeat_interleave(x, 2, axis=1),
     x34, grad=True)
case("take_along_axis", lambda P, x, i: P.take_along_axis(x, i, 1), x34,
     I(3, 2, hi=4), grad=True)
case("put_along_axis", lambda P, x, i, v: P.put_along_axis(x, i, v, 1),
     x34, I(3, 1, hi=4), F(3, 1, seed=5))
case("put_along_axis_", lambda P, x, i, v: P.put_along_axis_(
    x, i, v, 1, reduce="add"), x34, I(3, 1, hi=4), F(3, 1, seed=5))
case("flatten_", lambda P, x: P.flatten_(x), x234)
case("rot90", lambda P, x: P.rot90(x, 1, [0, 1]), x34, grad=True)
case("as_complex", lambda P, x: P.as_complex(x), F(3, 2))
case("as_real", lambda P, a, b: P.as_real(P.complex(a, b)), x34, y34)
case("tolist", lambda P, x: P.tolist(x), i34)
case("strided_slice", lambda P, x: P.strided_slice(x, [1], [0], [4], [2]),
     x34, grad=True)
case("unique", lambda P, x: P.unique(x, return_index=True,
                                     return_counts=True), I(10))
case("broadcast_shape", lambda P: P.broadcast_shape([3, 1, 4], [2, 1]))
case("squeeze_", lambda P, x: P.squeeze_(x, 0), F(1, 3))
case("unsqueeze_", lambda P, x: P.unsqueeze_(x, 1), x34)
case("broadcast_tensors", lambda P, a, b: P.broadcast_tensors([a, b]),
     F(3, 1), F(1, 4), grad=True)
case("diagonal", lambda P, x: P.diagonal(x, 1), x34, grad=True)
case("reverse", lambda P, x: P.reverse(x, 1), x34, grad=True)
case("crop", lambda P, x: P.crop(x, [2, 2], [1, 1]), x34,
     ref_raises=TypeError, expect=lambda x: x[1:3, 1:3])
case("scatter_nd", lambda P, i, u: P.scatter_nd(i, u, [3, 4]),
     np.array([[1, 1], [2, 3], [1, 1]], np.int64), F(3, seed=2), grad=True)
case("shard_index", lambda P, x: P.shard_index(x, 20, 2, 1), I(3, 4, hi=20))
case("unique_consecutive", lambda P, x: P.unique_consecutive(
    x, return_inverse=True, return_counts=True),
    np.array([1, 1, 2, 2, 2, 3, 1, 1], np.int64))
case("scatter_", lambda P, x, i, u: P.scatter_(x, i, u), x34,
     np.array([1], np.int64), F(1, 4, seed=3))

# ---------------------------------------------------------------- logic
for _n in ("equal", "not_equal", "greater_than", "greater_equal",
           "less_than", "less_equal"):
    case(_n, lambda P, x, y, _n=_n: getattr(P, _n)(x, y), i34,
         I(3, 4, lo=1, hi=9, seed=1))
for _n in ("logical_and", "logical_or", "logical_xor"):
    case(_n, lambda P, x, y, _n=_n: getattr(P, _n)(x, y), B(3, 4),
         B(3, 4, seed=1))
for _n in ("bitwise_and", "bitwise_or", "bitwise_xor"):
    case(_n, lambda P, x, y, _n=_n: getattr(P, _n)(x, y), i34,
         I(3, 4, hi=9, seed=1))
case("logical_not", lambda P, x: P.logical_not(x), B(3, 4))
case("bitwise_not", lambda P, x: P.bitwise_not(x), i34)
case("allclose", lambda P, x, y: P.allclose(x, y, atol=3.0), x34, y34)
case("isclose", lambda P, x, y: P.isclose(x, y, atol=0.5), x34, y34)
case("equal_all", lambda P, x: P.equal_all(x, x), i34)
case("is_empty", lambda P, x: P.is_empty(x), np.zeros((0, 3), np.float32))
case("is_tensor", lambda P, x: P.is_tensor(x), x34)

# --------------------------------------------------------------- search
case("argmax", lambda P, x: P.argmax(x, axis=1, keepdim=True), x34)
case("argmin", lambda P, x: P.argmin(x), x34)
case("argsort", lambda P, x: P.argsort(x, axis=1, descending=True), x34)
case("sort", lambda P, x: P.sort(x, axis=0), x34, grad=True)
case("topk", lambda P, x: P.topk(x, 2, axis=1), x34, grad=True)
case("nonzero", lambda P, x: P.nonzero(x), B(3, 4))
case("kthvalue", lambda P, x: P.kthvalue(x, 2, axis=1), x34, grad=True)
case("mode", lambda P, x: P.mode(x, axis=1),
     np.array([[1, 2, 2, 3, 3], [4, 4, 1, 1, 0]], np.int64))
case("index_sample", lambda P, x, i: P.index_sample(x, i), x34,
     I(3, 2, hi=4), grad=True)
case("searchsorted", lambda P, s, v: P.searchsorted(s, v, right=True),
     np.array([1.0, 2.0, 2.0, 5.0], np.float32),
     np.array([0.5, 2.0, 6.0], np.float32))
case("median", lambda P, x: P.median(x, axis=1), x34, grad=True)

# --------------------------------------------------------------- random
case("rand", lambda P: P.rand([3, 5]), random=True)
case("randn", lambda P: P.randn([3, 5]), random=True, tol=(1e-5, 1e-6))
case("standard_normal", lambda P: P.standard_normal([4]), random=True,
     tol=(1e-5, 1e-6))
case("randint", lambda P: P.randint(-3, 17, [4, 5]), random=True)
case("randint_like", lambda P, x: P.randint_like(x, 0, 1000), i34,
     random=True)
case("uniform", lambda P: P.uniform([2, 3], min=-2.0, max=3.0),
     random=True)
case("uniform_seeded", lambda P: P.uniform([2, 3], seed=11), random=True)
case("normal", lambda P: P.normal(1.0, 2.0, [3, 3]), random=True,
     tol=(1e-12, 1e-12))
case("bernoulli", lambda P, x: P.bernoulli(x), u34, random=True)
case("multinomial", lambda P, x: P.multinomial(x, 3), F(2, 6) ** 2,
     random=True)
case("randperm", lambda P: P.randperm(11), random=True)
case("uniform_", lambda P, x: P.uniform_(x, 0.0, 2.0), x34, random=True)
case("normal_", lambda P, x: P.normal_(x, 1.0, 0.5), x34, random=True,
     tol=(1e-5, 1e-6))
case("exponential_", lambda P, x: P.exponential_(x, 2.0), x34, random=True,
     tol=(1e-5, 1e-6))


def _poisson_check(jout, tout):
    """Not bit-equal (see the port's docstring): the same shape and
    dtype, non-negative whole numbers."""
    j, t = jout[0], tout[0]
    assert j[0].shape == t[0].shape and j[1] == t[1]
    assert np.all(t[0] >= 0) and np.all(t[0] == np.round(t[0]))


case("poisson", lambda P, x: P.poisson(x), p34 * 3, random=True,
     check=_poisson_check)

# --------------------------------------------------------------- linalg
a33, spd = F(3, 3, seed=3) + 3 * np.eye(3, dtype=np.float32), SPD(3)
case("norm", lambda P, x: P.linalg.norm(x), x34, grad=True)
case("norm_p1_axis", lambda P, x: P.linalg.norm(x, p=1, axis=1,
                                                keepdim=True), x34,
     grad=True)
case("norm_matrix", lambda P, x: P.linalg.norm(x, p="fro", axis=[1, 2]),
     x234, grad=True)
case("bmm", lambda P, x, y: P.bmm(x, y), x234, F(2, 4, 2), grad=True)
case("mm", lambda P, x, y: P.mm(x, y), x34, F(4, 2), grad=True)
case("histogram", lambda P, x: P.histogram(x, bins=5, min=-2, max=2), x34)
case("mv", lambda P, x, v: P.mv(x, v), x34, F(4, seed=2), grad=True)
case("matrix_power", lambda P, x: P.linalg.matrix_power(x, 3), a33,
     grad=True, tol=(1e-5, 1e-5))
case("cholesky", lambda P, x: P.linalg.cholesky(x), spd, grad=True)
case("pinv", lambda P, x: P.linalg.pinv(x), x34, grad=True,
     tol=(1e-4, 1e-5))
case("solve", lambda P, a, b: P.linalg.solve(a, b), a33, F(3, 2), grad=True,
     tol=(1e-5, 1e-5))
case("triangular_solve", lambda P, a, b: P.linalg.triangular_solve(
    a, b, upper=False, transpose=True), np.tril(a33), F(3, 2), grad=True,
    tol=(1e-5, 1e-5))
case("qr", lambda P, x: P.linalg.qr(F(4, 3)), x34, tol=(1e-5, 1e-5))
case("matrix_rank", lambda P, x: P.linalg.matrix_rank(x), x34)
case("det", lambda P, x: P.linalg.det(x), a33, grad=True, tol=(1e-5, 1e-5))
case("slogdet", lambda P, x: P.linalg.slogdet(x), a33, grad=True)
case("inv", lambda P, x: P.linalg.inv(x), a33, grad=True, tol=(1e-5, 1e-5))
case("inverse", lambda P, x: P.inverse(x), a33, tol=(1e-5, 1e-5))
case("cross", lambda P, x, y: P.linalg.cross(x, y), F(3, 4), y34,
     grad=True)
case("dist", lambda P, x, y: P.dist(x, y, p=3), x34, y34, grad=True)
case("cond", lambda P, x: P.linalg.cond(x), a33, tol=(1e-5, 1e-5))
case("eigvalsh", lambda P, x: P.linalg.eigvalsh(x), spd, grad=True,
     tol=(1e-5, 1e-5))
case("lu", lambda P, x: P.linalg.lu(x), a33, tol=(1e-5, 1e-6))
case("lstsq", lambda P, a, b: P.linalg.lstsq(a, b), F(5, 3), F(5, 2),
     tol=(1e-4, 1e-5))
case("cholesky_solve", lambda P, b, c: P.linalg.cholesky_solve(b, c),
     F(3, 2), np.linalg.cholesky(spd).astype(np.float32), grad=True,
     tol=(1e-5, 1e-5))
case("cov", lambda P, x: P.linalg.cov(x), x34, grad=True)
case("corrcoef", lambda P, x: P.linalg.corrcoef(x), x34, grad=True,
     tol=(1e-5, 1e-5))
case("multi_dot", lambda P, a, b, c: P.linalg.multi_dot([a, b, c]), x34,
     F(4, 2), F(2, 5), grad=True)
case("lu_unpack", lambda P, x: P.linalg.lu_unpack(*P.linalg.lu(x)), a33,
     tol=(1e-5, 1e-6))
case("einsum", lambda P, x, y: P.einsum("ij,kj->ik", x, y), x34, y34,
     grad=True)


def _recon_svd(P, x):
    u, s, vh = P.linalg.svd(x)
    return P.matmul(u * P.unsqueeze(s, 0), vh), s


def _recon_eigh(P, x):
    w, v = P.linalg.eigh(x)
    return P.matmul(v * P.unsqueeze(w, 0), P.t(v)), w


case("svd", _recon_svd, x34, tol=(1e-5, 1e-5))
case("eigh", _recon_eigh, spd, tol=(1e-5, 1e-5))


def _sorted_eigvals(jout, tout):
    """Eigenvalues as a set: each package may order them its own way."""
    (j, jdt), (t, tdt) = jout[0], tout[0]
    assert jdt == tdt
    key = lambda v: (round(float(v.real), 4), round(float(v.imag), 4))  # noqa: E731
    np.testing.assert_allclose(np.array(sorted(j.ravel(), key=key)),
                               np.array(sorted(t.ravel(), key=key)),
                               rtol=1e-5, atol=1e-5)


case("eig", lambda P, x: P.linalg.eig(x)[0], a33, check=_sorted_eigvals)
case("eigvals", lambda P, x: P.linalg.eigvals(x), a33,
     check=_sorted_eigvals)


# ------------------------------------------------------------- harness
def _flat(out, side):
    """Outputs as a list of ``(ndarray, dtype name)`` (Python values as
    themselves, dtype None)."""
    if isinstance(out, (list, tuple)):
        return [v for o in out for v in _flat(o, side)]
    if out is None:
        return [(None, None)]
    if side == "jax" and hasattr(out, "_value"):
        return [(np.asarray(out.numpy()), out.dtype)]
    if isinstance(out, torch.Tensor):
        t = out.detach().cpu()
        return [(t.numpy(), convert_dtype(t.dtype))]
    return [(out, None)]


def _inputs(P, arrays, grad):
    ts = []
    for a in arrays:
        t = P.to_tensor(a)
        if grad and np.issubdtype(a.dtype, np.floating):
            t.stop_gradient = False
        ts.append(t)
    return ts


def _run(P, side, call, arrays, opts):
    if opts["random"]:
        P.seed(7)
    ts = _inputs(P, arrays, opts["grad"])
    out = call(P, *ts)
    grads = []
    if opts["grad"]:
        floats = [o for o in (out if isinstance(out, (list, tuple))
                              else [out])
                  if o is not None and convert_dtype(
                      o.dtype if side == "port" else str(o.dtype))
                  .startswith("float")]
        loss = floats[0].sum() if side == "port" else P.sum(floats[0])
        for o in floats[1:]:
            loss = loss + (o.sum() if side == "port" else P.sum(o))
        if side == "jax" and loss.stop_gradient:
            return _flat(out, side), None  # the reference records no graph
        loss.backward()
        for t, a in zip(ts, arrays):
            if np.issubdtype(a.dtype, np.floating):
                g = t.grad
                grads.append(None if g is None else np.asarray(
                    g.numpy() if side == "jax" else g.detach().numpy()))
    return _flat(out, side), grads


def _same(j, t, tol):
    (jv, jdt), (tv, tdt) = j, t
    assert jdt == tdt, (jdt, tdt)
    if jdt is None:
        assert jv == tv if not isinstance(jv, np.ndarray) else \
            np.array_equal(jv, tv)
        return
    assert jv.shape == tv.shape, (jv.shape, tv.shape)
    if jdt.startswith(("float", "complex")):
        rtol, atol = tol or (RTOL, ATOL)
        np.testing.assert_allclose(tv, jv, rtol=rtol, atol=atol)
    else:
        np.testing.assert_array_equal(tv, jv)


@pytest.mark.parametrize("name", sorted(CASES))
def test_tensor_function_matches_reference(name):
    call, arrays, opts = CASES[name]
    if opts["ref_raises"] is not None:
        # the reference's crop names its module's own ``slice`` function
        # where it means the builtin (tensor_ops/manipulation.py:391)
        with pytest.raises(opts["ref_raises"]):
            _run(J, "jax", call, arrays, opts)
        (tv, _), = _run(T, "port", call, arrays, opts)[0]
        np.testing.assert_array_equal(tv, opts["expect"](*arrays))
        return
    jout, jgrads = _run(J, "jax", call, arrays, opts)
    tout, tgrads = _run(T, "port", call, arrays, opts)
    if opts["check"] is not None:
        opts["check"](jout, tout)
        return
    assert len(jout) == len(tout)
    for j, t in zip(jout, tout):
        _same(j, t, opts["tol"])
    if jgrads is None:
        return
    assert len(jgrads) == len(tgrads)
    for jg, tg in zip(jgrads, tgrads):
        if jg is None or tg is None:
            # no gradient on one side means none reached this input
            assert (jg is None or not np.any(jg)) and \
                (tg is None or not np.any(tg))
            continue
        rtol, atol = opts["tol"] or (RTOL, ATOL)
        np.testing.assert_allclose(tg, jg, rtol=rtol, atol=atol)


def test_every_ported_function_has_a_case():
    """Each name of the port's seven ``__all__`` lists (and ``einsum``)
    is exercised by a case of the same name (or a named variant)."""
    from paddle_tpu_torch.tensor_ops import (creation, linalg, logic,
                                             manipulation, math, random,
                                             search)

    names = {"einsum"}
    for mod in (creation, math, manipulation, logic, search, random,
                linalg):
        names |= set(mod.__all__)
    covered = {n for n in names
               if n in CASES or any(c.startswith(n + "_") for c in CASES)}
    assert names - covered == set()
