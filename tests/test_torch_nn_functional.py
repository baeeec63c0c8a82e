"""Every function of the port's ``nn.functional`` against the JAX
package's, parametrised: the same seeded numpy inputs through both, the
outputs and (for the float inputs marked ``grad``) the gradients of
``sum(output * cotangent)`` compared. Tolerances: elementwise float32
within rtol 1e-5 / atol 1e-6; reductions, norms, losses and resampling
within rtol 1e-4 / atol 1e-5. Random functions are called after the same
``seed`` on both sides and draw the same keys."""
import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu_torch import _device
from paddle_tpu_torch.analysis.layercheck import to_numpy

ELEM = (1e-5, 1e-6)
RED = (1e-4, 1e-5)
CASES = {}


def case(name, fn, *makers, grad=(), tol=ELEM, seed=None, compare=None):
    """``fn(F, P, *tensors)``: F the package's ``nn.functional``, P its
    root. ``grad``: input positions that take a gradient."""
    CASES[name] = (fn, makers, grad, tol, seed, compare)


def f(*shape, scale=1.0, shift=0.0):
    return lambda rng: (rng.standard_normal(shape) * scale + shift).astype(
        np.float32)


def ints(lo, hi, *shape, first=None):
    def make(rng):
        a = rng.integers(lo, hi, shape).astype(np.int64)
        if first is not None:
            a.flat[0] = first
        return a
    return make


def probs(*shape):
    def make(rng):
        z = rng.standard_normal(shape)
        e = np.exp(z - z.max(-1, keepdims=True))
        return (e / e.sum(-1, keepdims=True)).astype(np.float32)
    return make


def unit(*shape):
    return lambda rng: rng.uniform(0.05, 0.95, shape).astype(np.float32)


def signs(*shape):
    return lambda rng: np.where(rng.random(shape) < 0.5, -1.0,
                                1.0).astype(np.float32)


X = f(3, 8, scale=2.0)
IMG = f(2, 3, 4, 5)

# ------------------------------------------------------------ activations
for _n in ("relu", "relu6", "gelu", "sigmoid", "logsigmoid", "log_sigmoid",
           "tanh", "silu", "swish", "hardswish", "hardsigmoid", "mish",
           "softsign", "tanhshrink", "selu", "thresholded_relu"):
    case(_n, lambda F, P, x, _n=_n: getattr(F, _n)(x), X, grad=(0,))
case("gelu_approximate", lambda F, P, x: F.gelu(x, approximate=True), X,
     grad=(0,))
case("relu6_wide", lambda F, P, x: F.relu6(x), f(3, 8, scale=6.0),
     grad=(0,))
case("leaky_relu", lambda F, P, x: F.leaky_relu(x, 0.2), X, grad=(0,))
case("elu", lambda F, P, x: F.elu(x, 0.7), X, grad=(0,))
case("celu", lambda F, P, x: F.celu(x, 1.3), X, grad=(0,))
case("hardtanh", lambda F, P, x: F.hardtanh(x, -0.5, 1.5), X, grad=(0,))
case("softplus", lambda F, P, x: F.softplus(x, 2, 3), X, grad=(0,))
case("softshrink", lambda F, P, x: F.softshrink(x, 0.3), X, grad=(0,))
case("hardshrink", lambda F, P, x: F.hardshrink(x, 0.4), X, grad=(0,))
case("softmax", lambda F, P, x: F.softmax(x, axis=0), X, grad=(0,),
     tol=RED)
case("softmax_dtype", lambda F, P, x: F.softmax(x, dtype="float32"), X,
     tol=RED)
case("log_softmax", lambda F, P, x: F.log_softmax(x), X, grad=(0,),
     tol=RED)
case("temperature_scaled_softmax",
     lambda F, P, x: F.temperature_scaled_softmax(x, 0.5), X, grad=(0,),
     tol=RED)
case("prelu", lambda F, P, x, w: F.prelu(x, w), f(2, 4, 3, 3),
     lambda rng: np.array([0.1, 0.2, 0.3, 0.4], np.float32), grad=(0, 1))
case("prelu_scalar", lambda F, P, x, w: F.prelu(x, w), X,
     lambda rng: np.array([0.25], np.float32), grad=(0, 1))
case("rrelu", lambda F, P, x: F.rrelu(x), X, grad=(0,), seed=4)
case("rrelu_eval", lambda F, P, x: F.rrelu(x, training=False), X,
     grad=(0,))
case("glu", lambda F, P, x: F.glu(x, axis=1), X, grad=(0,))
case("maxout", lambda F, P, x: F.maxout(x, 2), f(2, 4, 3, 3), grad=(0,))
case("gumbel_softmax", lambda F, P, x: F.gumbel_softmax(x, 0.7), X,
     grad=(0,), seed=6, tol=RED)
case("gumbel_softmax_hard",
     lambda F, P, x: F.gumbel_softmax(x, 0.7, hard=True), X, grad=(0,),
     seed=6, tol=RED)
for _n in ("relu_", "tanh_"):
    case(_n, lambda F, P, x, _n=_n: getattr(F, _n)(x * 1.0), X, grad=(0,))
case("elu_", lambda F, P, x: F.elu_(x * 1.0, 0.5), X, grad=(0,))
case("softmax_", lambda F, P, x: F.softmax_(x * 1.0), X, grad=(0,),
     tol=RED)

# ------------------------------------------------------------ common
case("linear", lambda F, P, x, w, b: F.linear(x, w, b), f(2, 3, 8),
     f(8, 5), f(5), grad=(0, 1, 2), tol=RED)
case("linear_nobias", lambda F, P, x, w: F.linear(x, w), f(4, 8), f(8, 5),
     grad=(0, 1), tol=RED)
case("bilinear", lambda F, P, a, b, w, c: F.bilinear(a, b, w, c), f(5, 3),
     f(5, 4), f(2, 3, 4), f(2), grad=(0, 1, 2, 3), tol=RED)
case("embedding", lambda F, P, i, w: F.embedding(i, w, padding_idx=-2),
     ints(0, 9, 3, 4, first=7), f(9, 5), grad=(1,))
case("dropout", lambda F, P, x: F.dropout(x, 0.3), f(6, 7), grad=(0,),
     seed=2)
case("dropout_axis", lambda F, P, x: F.dropout(x, 0.5, axis=[0]),
     f(6, 7), grad=(0,), seed=2)
case("dropout_downscale",
     lambda F, P, x: F.dropout(x, 0.3, mode="downscale_in_infer"),
     f(6, 7), grad=(0,), seed=2)
case("dropout_eval", lambda F, P, x: F.dropout(x, 0.3, training=False),
     f(6, 7), grad=(0,))
case("dropout2d", lambda F, P, x: F.dropout2d(x, 0.5), f(2, 4, 3, 3),
     grad=(0,), seed=3)
case("dropout3d", lambda F, P, x: F.dropout3d(x, 0.5), f(2, 4, 2, 3, 3),
     grad=(0,), seed=3)
case("alpha_dropout", lambda F, P, x: F.alpha_dropout(x, 0.2), f(6, 7),
     grad=(0,), seed=5)

# ------------------------------------------------------------ norms
case("batch_norm", lambda F, P, x, m, v, w, b: F.batch_norm(
    x, m, v, w, b, training=True), f(4, 3, 2, 2, shift=1.0),
    lambda r: np.zeros(3, np.float32), lambda r: np.ones(3, np.float32),
    f(3, shift=1.0), f(3), grad=(0, 3, 4), tol=RED)
case("batch_norm_eval", lambda F, P, x, m, v: F.batch_norm(x, m, v),
     f(4, 3), f(3), unit(3), grad=(0,), tol=RED)
case("batch_norm_nhwc", lambda F, P, x, m, v: F.batch_norm(
    x, m, v, training=True, data_format="NHWC"), f(2, 3, 3, 4),
    lambda r: np.zeros(4, np.float32), lambda r: np.ones(4, np.float32),
    grad=(0,), tol=RED)
case("layer_norm", lambda F, P, x, w, b: F.layer_norm(x, 8, w, b),
     f(3, 5, 8, scale=2.0), f(8), f(8), grad=(0, 1, 2), tol=RED)
case("layer_norm_composite", lambda F, P, x: F.layer_norm(x, [5, 8]),
     f(3, 5, 8), grad=(0,), tol=RED)
case("group_norm", lambda F, P, x, w, b: F.group_norm(x, 2, 1e-5, w, b),
     f(2, 4, 3, 3), f(4), f(4), grad=(0, 1, 2), tol=RED)
case("instance_norm", lambda F, P, x, w, b: F.instance_norm(
    x, weight=w, bias=b), f(2, 3, 4, 5), f(3), f(3), grad=(0, 1, 2),
    tol=RED)
case("local_response_norm", lambda F, P, x: F.local_response_norm(x, 3),
     f(2, 5, 3, 3), grad=(0,), tol=RED)
case("normalize", lambda F, P, x: F.normalize(x, axis=1), f(3, 6),
     grad=(0,), tol=RED)
case("normalize_p1", lambda F, P, x: F.normalize(x, p=1, axis=0),
     f(3, 6), grad=(0,), tol=RED)

# ------------------------------------------------------------ losses
LOG = f(6, 5)
case("cross_entropy", lambda F, P, x, y: F.cross_entropy(x, y), LOG,
     ints(0, 5, 6, first=-100), grad=(0,), tol=RED)
case("cross_entropy_weight", lambda F, P, x, y, w: F.cross_entropy(
    x, y, weight=w), LOG, ints(0, 5, 6), unit(5), grad=(0,), tol=RED)
case("cross_entropy_soft", lambda F, P, x, y: F.cross_entropy(
    x, y, soft_label=True), LOG, probs(6, 5), grad=(0,), tol=RED)
case("cross_entropy_axis", lambda F, P, x, y: F.cross_entropy(
    x, y, axis=1, reduction="sum"), f(2, 5, 3), ints(0, 5, 2, 3),
    grad=(0,), tol=RED)
case("cross_entropy_probs", lambda F, P, x, y: F.cross_entropy(
    x, y, use_softmax=False, reduction="none"), probs(6, 5),
    ints(0, 5, 6, 1), grad=(0,), tol=RED)
case("cross_entropy_smooth", lambda F, P, x, y: F.cross_entropy(
    x, y, label_smoothing=0.2), LOG, ints(0, 5, 6), grad=(0,), tol=RED)
case("softmax_with_cross_entropy",
     lambda F, P, x, y: F.softmax_with_cross_entropy(x, y), LOG,
     ints(0, 5, 6, 1), grad=(0,), tol=RED)
case("linear_cross_entropy", lambda F, P, h, w, y: F.linear_cross_entropy(
    h, w, y, transpose_y=True, chunk_size=4, ignore_index=-1),
    f(2, 5, 8), f(11, 8), ints(0, 11, 2, 5, first=-1), grad=(0, 1),
    tol=RED)
case("mse_loss", lambda F, P, a, b: F.mse_loss(a, b), f(4, 5), f(4, 5),
     grad=(0, 1), tol=RED)
case("square_error_cost", lambda F, P, a, b: F.square_error_cost(a, b),
     f(4, 5), f(4, 5), grad=(0, 1))
case("l1_loss", lambda F, P, a, b: F.l1_loss(a, b, "sum"), f(4, 5),
     f(4, 5), grad=(0,), tol=RED)
case("nll_loss", lambda F, P, x, y: F.nll_loss(x, y),
     lambda r: np.log(probs(6, 5)(r)), ints(0, 5, 6), grad=(0,), tol=RED)
case("nll_loss_weight", lambda F, P, x, y, w: F.nll_loss(x, y, w),
     lambda r: np.log(probs(6, 5)(r)), ints(0, 5, 6), unit(5), grad=(0,),
     tol=RED)
case("binary_cross_entropy", lambda F, P, p, y, w: F.binary_cross_entropy(
    p, y, w), unit(4, 5), unit(4, 5), unit(4, 5), grad=(0,), tol=RED)
case("binary_cross_entropy_with_logits",
     lambda F, P, z, y, w, pw: F.binary_cross_entropy_with_logits(
         z, y, w, "sum", pw), f(4, 5), unit(4, 5), unit(4, 5), unit(5),
     grad=(0,), tol=RED)
case("smooth_l1_loss", lambda F, P, a, b: F.smooth_l1_loss(
    a, b, "none", 0.6), f(4, 5), f(4, 5), grad=(0,), tol=RED)
case("kl_div", lambda F, P, x, y: F.kl_div(x, y, "batchmean"),
     lambda r: np.log(probs(4, 5)(r)), probs(4, 5), grad=(0,), tol=RED)
case("kl_div_sum", lambda F, P, x, y: F.kl_div(x, y, "sum"),
     lambda r: np.log(probs(4, 5)(r)), probs(4, 5), grad=(0,), tol=RED)
case("margin_ranking_loss", lambda F, P, a, b, y: F.margin_ranking_loss(
    a, b, y, 0.1), f(8), f(8), signs(8), grad=(0, 1), tol=RED)
case("hinge_embedding_loss", lambda F, P, a, y: F.hinge_embedding_loss(
    a, y, 0.5), f(8), signs(8), grad=(0,), tol=RED)
case("log_loss", lambda F, P, p, y: F.log_loss(p, y), unit(4, 1),
     unit(4, 1), grad=(0,))
case("dice_loss", lambda F, P, p, y: F.dice_loss(p, y), probs(3, 4, 5),
     ints(0, 5, 3, 4, 1), grad=(0,), tol=RED)
case("npair_loss", lambda F, P, a, p, y: F.npair_loss(a, p, y), f(4, 6),
     f(4, 6), ints(0, 3, 4), grad=(0, 1), tol=RED)
case("sigmoid_focal_loss", lambda F, P, z, y: F.sigmoid_focal_loss(z, y),
     f(4, 5), unit(4, 5), grad=(0,), tol=RED)
case("sigmoid_focal_loss_norm", lambda F, P, z, y, n: F.sigmoid_focal_loss(
    z, y, n, reduction="mean"), f(4, 5), unit(4, 5),
    lambda r: np.array([3.0], np.float32), grad=(0,), tol=RED)

# ------------------------------------------------------------ the rest
case("cosine_similarity", lambda F, P, a, b: F.cosine_similarity(a, b),
     f(4, 6), f(4, 6), grad=(0, 1), tol=RED)
case("label_smooth", lambda F, P, y: F.label_smooth(y, epsilon=0.2),
     probs(4, 5), grad=(0,))
case("one_hot", lambda F, P, x: F.one_hot(x, 6), ints(0, 6, 5))
case("sequence_mask", lambda F, P, x: F.sequence_mask(x, 6),
     ints(0, 6, 4))
case("sequence_mask_auto", lambda F, P, x: F.sequence_mask(x),
     ints(1, 6, 4))
case("pad", lambda F, P, x: F.pad(x, [1, 2, 0, 1], value=0.3), IMG,
     grad=(0,))
case("pad_all_dims", lambda F, P, x: F.pad(x, [0, 0, 1, 0, 2, 1]),
     f(2, 3, 4), grad=(0,))
for _m in ("reflect", "replicate", "circular"):
    case(f"pad_{_m}", lambda F, P, x, _m=_m: F.pad(x, [2, 1, 1, 2],
                                                   mode=_m), IMG, grad=(0,))
case("zeropad2d", lambda F, P, x: F.zeropad2d(x, [1, 0, 2, 1]), IMG,
     grad=(0,))
case("zeropad2d_nhwc", lambda F, P, x: F.zeropad2d(x, [1, 2, 0, 1],
                                                   data_format="NHWC"),
     IMG, grad=(0,))
_INTERP = {
    "nearest": dict(scale_factor=2),
    "nearest_down": dict(size=[3, 2]),
    "nearest_corners": dict(size=[7, 9], align_corners=True),
    "bilinear": dict(size=[7, 9], mode="bilinear"),
    "bilinear_down": dict(size=[3, 2], mode="bilinear"),
    "bilinear_corners": dict(size=[7, 9], mode="bilinear",
                             align_corners=True),
    "bilinear_mode1": dict(size=[7, 9], mode="bilinear", align_mode=1),
    "bicubic": dict(size=[6, 8], mode="bicubic"),
    "area": dict(size=[2, 3], mode="area"),
    "area_uneven": dict(size=[3, 4], mode="area"),
    "nhwc": dict(size=[7, 3], mode="bilinear", data_format="NHWC"),
}
for _k, _kw in _INTERP.items():
    case(f"interpolate_{_k}", lambda F, P, x, _kw=_kw: F.interpolate(
        x, **_kw), IMG, grad=(0,), tol=RED)
case("interpolate_linear", lambda F, P, x: F.interpolate(
    x, size=9, mode="linear", data_format="NCW"), f(2, 3, 5), grad=(0,),
    tol=RED)
case("interpolate_trilinear", lambda F, P, x: F.interpolate(
    x, size=[3, 5, 4], mode="trilinear", data_format="NCDHW"),
    f(1, 2, 2, 3, 3), grad=(0,), tol=RED)
case("upsample", lambda F, P, x: F.upsample(x, scale_factor=[2, 1]), IMG,
     grad=(0,))
case("pixel_shuffle", lambda F, P, x: F.pixel_shuffle(x, 2),
     f(2, 8, 3, 3), grad=(0,))
case("pixel_unshuffle", lambda F, P, x: F.pixel_unshuffle(x, 2),
     f(2, 3, 4, 6), grad=(0,))
case("pixel_unshuffle_nhwc", lambda F, P, x: F.pixel_unshuffle(
    x, 2, "NHWC"), f(2, 4, 6, 3), grad=(0,))
case("channel_shuffle", lambda F, P, x: F.channel_shuffle(x, 2),
     f(2, 4, 3, 3), grad=(0,))
case("channel_shuffle_nhwc", lambda F, P, x: F.channel_shuffle(
    x, 3, "NHWC"), f(2, 3, 3, 6), grad=(0,))
case("unfold", lambda F, P, x: F.unfold(x, [2, 3], 2, 1, 1),
     f(2, 3, 6, 7), grad=(0,))
case("diag_embed", lambda F, P, x: F.diag_embed(x, 1), f(2, 3), grad=(0,))
case("diag_embed_dims", lambda F, P, x: F.diag_embed(x, -1, 0, 2),
     f(2, 3), grad=(0,))
case("scaled_dot_product_attention",
     lambda F, P, q, k, v: F.scaled_dot_product_attention(q, k, v),
     f(2, 2, 5, 8), f(2, 2, 6, 8), f(2, 2, 6, 8), grad=(0, 1, 2), tol=RED)
case("scaled_dot_product_attention_causal",
     lambda F, P, q, k, v: F.scaled_dot_product_attention(
         q, k, v, is_causal=True), f(2, 2, 5, 8), f(2, 2, 5, 8),
     f(2, 2, 5, 8), grad=(0, 1, 2), tol=RED)
case("scaled_dot_product_attention_mask",
     lambda F, P, q, k, v, m: F.scaled_dot_product_attention(
         q, k, v, attn_mask=m), f(2, 2, 5, 8), f(2, 2, 6, 8),
     f(2, 2, 6, 8), lambda r: (r.random((2, 1, 5, 6)) > 0.3), grad=(0, 1, 2),
     tol=RED)
case("scaled_dot_product_attention_dropout",
     lambda F, P, q, k, v: F.scaled_dot_product_attention(
         q, k, v, dropout_p=0.3), f(2, 2, 5, 8), f(2, 2, 5, 8),
     f(2, 2, 5, 8), grad=(0, 1, 2), seed=8, tol=RED)


@pytest.fixture(autouse=True)
def _cpu():
    prev = _device._CURRENT
    T.set_device("cpu")
    yield
    _device._CURRENT = prev


def _run(P, name):
    fn, makers, grad, _, seed, _ = CASES[name]
    rng = np.random.default_rng(0)
    arrays = [m(rng) for m in makers]
    ts = [P.to_tensor(a, stop_gradient=i not in grad)
          for i, a in enumerate(arrays)]
    if seed is not None:
        P.seed(seed)
    out = fn(P.nn.functional, P, *ts)
    outs = list(out) if isinstance(out, (tuple, list)) else [out]
    grads = []
    if grad:
        crng = np.random.default_rng(1)
        loss = None
        for o in outs:
            c = P.to_tensor(crng.standard_normal(tuple(o.shape)).astype(
                np.float32))
            term = P.sum(o.astype("float32") * c)
            loss = term if loss is None else loss + term
        loss.backward()
        grads = [to_numpy(ts[i].grad) for i in grad]
    return [to_numpy(o) for o in outs], grads


@pytest.mark.parametrize("name", sorted(CASES))
def test_function_matches_reference(name):
    tol = CASES[name][3]
    want, want_g = _run(J, name)
    got, got_g = _run(T, name)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape, (g.shape, w.shape)
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w.astype(g.dtype), rtol=tol[0],
                                       atol=tol[1])
        else:
            np.testing.assert_array_equal(g, w)
    for i, (g, w) in enumerate(zip(got_g, want_g)):
        np.testing.assert_allclose(g, w, rtol=tol[0], atol=tol[1],
                                   err_msg=f"grad {i}")


def test_every_ported_function_has_a_case():
    """Here, or (the convolutions, the pools and the rest of item 12b-2's
    functions) in ``test_torch_conv_pool.py`` and
    ``test_torch_nn_functional_extra.py``."""
    from test_torch_conv_pool import CASES as CONV_POOL
    from test_torch_nn_functional_extra import CASES as EXTRA

    names = set(T.nn.functional.__all__)
    cases = set(CASES) | set(CONV_POOL) | set(EXTRA)
    covered = {n for n in names
               if n in cases or any(c.startswith(n + "_") for c in cases)}
    assert names - covered == set()


def test_batch_norm_updates_running_statistics_like_the_reference():
    x = np.random.default_rng(4).standard_normal((5, 3)).astype(np.float32)
    stats = {}
    for P in (J, T):
        m = P.to_tensor(np.zeros(3, np.float32))
        v = P.to_tensor(np.ones(3, np.float32))
        for _ in range(3):
            P.nn.functional.batch_norm(P.to_tensor(x), m, v, training=True,
                                       momentum=0.8)
        stats[P] = (to_numpy(m), to_numpy(v))
    for a, b in zip(stats[T], stats[J]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
