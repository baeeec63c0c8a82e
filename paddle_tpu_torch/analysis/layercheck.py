"""One small case for every layer class of ``nn``: how to build it, its
inputs, how to call it and the tolerance it is held to — the table
``tests/test_torch_nn_layers.py`` runs against the JAX package's layers on
the CPU and ``chip_smoke.py`` runs on the card against a CPU copy (phase
11 the cases before the convolutions, phase 12 the convolution, pooling,
recurrent and ``layers_extra`` cases: ``SLICE_12B2``). A case builds from a package root handed in (the port, or any
package with Paddle's ``nn`` surface), so one table serves both.

:func:`run_case` drives a built layer: it calls it ``calls`` times on the
case's inputs (made tensors that take a gradient, except the ``nograd``
ones), reseeding before each call when the case draws random numbers,
backpropagates ``sum(output * cotangent)`` over every output (a seeded
cotangent of each output's shape) and returns the outputs, the inputs'
and parameters' gradients and the buffers as numpy arrays.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np

__all__ = ["LayerCase", "LAYER_CASES", "LAYER_CASES_12B2", "SLICE_12B2",
           "TOLERANCES", "run_case", "to_numpy"]

#: (rtol, atol) by kind: elementwise float32 functions; anything that
#: sums (products, norms, losses); attention, held to the float32 flash
#: kernel's limit against its plain version
TOLERANCES = {"elementwise": (1e-5, 1e-6), "reduction": (1e-4, 1e-5),
              "attention": (1e-4, 1e-4)}


@dataclass
class LayerCase:
    """``build(P)`` -> the layer (``P`` a package root); ``inputs(rng)`` ->
    numpy arrays; ``call(layer, tensors)`` -> output(s) (default: the
    layer on the tensors in order); ``nograd``: positions of inputs that
    take no gradient (labels, masks; integer arrays never do)."""
    name: str
    build: Callable
    inputs: Callable
    kind: str = "elementwise"
    call: Callable | None = None
    nograd: tuple = ()
    calls: int = 1
    train: bool = True
    random: bool = False
    tags: dict = field(default_factory=dict)


def _f(*shape, scale=1.0, shift=0.0):
    return lambda rng: rng.standard_normal(shape).astype(np.float32) \
        * np.float32(scale) + np.float32(shift)


def _inputs(*makers):
    return lambda rng: tuple(m(rng) for m in makers)


def _ints(lo, hi, *shape, force=None):
    def make(rng):
        a = rng.integers(lo, hi, shape).astype(np.int64)
        if force is not None:
            a.flat[0] = force
        return a
    return make


def _probs(*shape):
    def make(rng):
        z = rng.standard_normal(shape)
        e = np.exp(z - z.max(-1, keepdims=True))
        return (e / e.sum(-1, keepdims=True)).astype(np.float32)
    return make


def _log_probs(*shape):
    return lambda rng: np.log(_probs(*shape)(rng)).astype(np.float32)


def _unit(*shape):
    return lambda rng: rng.uniform(0.05, 0.95, shape).astype(np.float32)


def _signs(*shape):
    return lambda rng: np.where(rng.random(shape) < 0.5, -1.0,
                                1.0).astype(np.float32)


def _mask(b, s):
    """Additive ``[b, 1, 1, s]``: row ``i`` hides its last ``i + 1``
    keys."""
    def make(rng):
        m = np.zeros((b, 1, 1, s), np.float32)
        for i in range(b):
            m[i, ..., s - 1 - i:] = -1e9
        return m
    return make


def _distinct(*shape):
    """A seeded permutation of distinct values: no two elements of a
    pooling window are equal, so a max has one winner and its gradient
    one destination in both packages (a tie routes it by each library's
    own rule)."""
    def make(rng):
        n = int(np.prod(shape))
        return (rng.permutation(n).reshape(shape).astype(np.float32)
                / np.float32(n) - np.float32(0.5))
    return make


def _unpool_indices(n, c, in_sp, out_sp):
    """Distinct flat positions within each channel's ``out_sp`` plane, one
    per pooled value of ``in_sp``."""
    def make(rng):
        size, count = int(np.prod(out_sp)), int(np.prod(in_sp))
        idx = np.stack([rng.permutation(size)[:count]
                        for _ in range(n * c)])
        return idx.reshape((n, c) + tuple(in_sp)).astype(np.int64)
    return make


def _lengths(b, t):
    return lambda rng: rng.integers(1, t + 1, (b,)).astype(np.int64)


def _nest(out):
    """Nested tuples of outputs (an RNN's ``(y, (h, c))``) as one flat
    tuple."""
    if isinstance(out, (tuple, list)):
        return tuple(v for o in out for v in _nest(o))
    return (out,)


def _cell_base(P):
    """A cell on ``RNNCellBase``: its states from ``get_initial_states``
    (a pair of shapes, a fill value)."""
    class Cell(P.nn.RNNCellBase):
        def __init__(self):
            super().__init__()
            self.lin = P.nn.Linear(3, 4)

        @property
        def state_shape(self):
            return [(4,), (4,)]

        def forward(self, x, states=None):
            if states is None:
                states = self.get_initial_states(x, init_value=0.5)
            h, c = states
            h = P.nn.functional.tanh(self.lin(x) + h * c)
            return h, (h, c + h)

    return Cell()


def _cache_call(layer, t):
    out, cache = layer(t[0], cache=layer.gen_cache(t[0]))
    return out, cache.k, cache.v


def _transformer_call(layer, t):
    mask = type(layer).generate_square_subsequent_mask(t[1].shape[1])
    return layer(t[0], t[1], tgt_mask=mask)


#: the reference's RNN wrapper rebuilds its masked outputs and states
#: from raw arrays, so under ``sequence_length`` nothing it returns takes
#: a gradient; the port's masked outputs do
_MASKED_DETACHED = ("the reference's RNN wrapper masks its outputs and "
                    "states outside the tape under sequence_length")

E, H, FF = 128, 2, 64  # attention widths: head_dim 64, the flash kernel's


def _act(name, *args, x=None, **kw):
    return LayerCase(name, lambda P: getattr(P.nn, name)(*args, **kw),
                     _inputs(x or _f(3, 8, scale=2.0)))


LAYER_CASES = [
    # ------------------------------------------------------------ common
    LayerCase("Linear", lambda P: P.nn.Linear(8, 6), _inputs(_f(3, 8)),
              "reduction"),
    LayerCase("Linear-nobias", lambda P: P.nn.Linear(8, 6, bias_attr=False),
              _inputs(_f(2, 3, 8)), "reduction"),
    LayerCase("Embedding", lambda P: P.nn.Embedding(11, 6, padding_idx=2),
              _inputs(_ints(0, 11, 3, 5, force=2))),
    LayerCase("Identity", lambda P: P.nn.Identity(), _inputs(_f(3, 4))),
    LayerCase("Flatten", lambda P: P.nn.Flatten(), _inputs(_f(2, 3, 4, 5))),
    LayerCase("Bilinear", lambda P: P.nn.Bilinear(4, 5, 3),
              _inputs(_f(6, 4), _f(6, 5)), "reduction"),
    LayerCase("CosineSimilarity", lambda P: P.nn.CosineSimilarity(axis=1),
              _inputs(_f(4, 6), _f(4, 6)), "reduction"),
    LayerCase("Pad1D", lambda P: P.nn.Pad1D([1, 2], mode="reflect"),
              _inputs(_f(2, 3, 6))),
    LayerCase("Pad2D", lambda P: P.nn.Pad2D([1, 0, 2, 1], value=0.5),
              _inputs(_f(2, 3, 5, 6))),
    LayerCase("Pad2D-replicate", lambda P: P.nn.Pad2D(2, mode="replicate"),
              _inputs(_f(2, 3, 4, 5))),
    LayerCase("Pad3D", lambda P: P.nn.Pad3D(1, mode="circular"),
              _inputs(_f(1, 2, 3, 4, 5))),
    LayerCase("PixelShuffle", lambda P: P.nn.PixelShuffle(2),
              _inputs(_f(2, 8, 3, 3))),
    LayerCase("Unfold", lambda P: P.nn.Unfold([2, 3], paddings=1),
              _inputs(_f(2, 3, 5, 6))),
    LayerCase("Upsample", lambda P: P.nn.Upsample(scale_factor=2),
              _inputs(_f(2, 3, 4, 5))),
    LayerCase("Upsample-bilinear",
              lambda P: P.nn.Upsample(size=[7, 9], mode="bilinear"),
              _inputs(_f(2, 3, 4, 5)), "reduction"),
    LayerCase("Upsample-bilinear-down",
              lambda P: P.nn.Upsample(size=[3, 2], mode="bilinear"),
              _inputs(_f(2, 3, 7, 5)), "reduction"),
    LayerCase("Upsample-bicubic",
              lambda P: P.nn.Upsample(size=[6, 8], mode="bicubic"),
              _inputs(_f(1, 2, 4, 5)), "reduction"),
    LayerCase("Upsample-linear-corners",
              lambda P: P.nn.Upsample(size=9, mode="linear",
                                      align_corners=True, data_format="NCW"),
              _inputs(_f(2, 3, 5)), "reduction"),
    LayerCase("Upsample-area", lambda P: P.nn.Upsample(size=[2, 3],
                                                       mode="area"),
              _inputs(_f(2, 3, 4, 6)), "reduction"),
    LayerCase("UpsamplingBilinear2D",
              lambda P: P.nn.UpsamplingBilinear2D(size=[7, 9]),
              _inputs(_f(2, 3, 4, 5)), "reduction"),
    LayerCase("UpsamplingNearest2D",
              lambda P: P.nn.UpsamplingNearest2D(scale_factor=2),
              _inputs(_f(2, 3, 4, 5))),
    LayerCase("AlphaDropout", lambda P: P.nn.AlphaDropout(0.3),
              _inputs(_f(4, 6)), random=True),
    LayerCase("Dropout", lambda P: P.nn.Dropout(0.4), _inputs(_f(4, 6)),
              random=True),
    LayerCase("Dropout-axis", lambda P: P.nn.Dropout(0.5, axis=1),
              _inputs(_f(4, 6)), random=True),
    LayerCase("Dropout-eval", lambda P: P.nn.Dropout(0.4), _inputs(_f(4, 6)),
              train=False),
    LayerCase("Dropout2D", lambda P: P.nn.Dropout2D(0.5),
              _inputs(_f(2, 4, 3, 3)), random=True),
    LayerCase("Dropout3D", lambda P: P.nn.Dropout3D(0.5),
              _inputs(_f(2, 4, 2, 3, 3)), random=True),
    # ------------------------------------------------------------ activations
    _act("ReLU"), _act("ReLU6", x=_f(3, 8, scale=5.0)), _act("GELU"),
    _act("Sigmoid"), _act("LogSigmoid"), _act("Tanh"),
    _act("LeakyReLU", 0.2), _act("ELU", 0.7), _act("CELU", 1.3),
    _act("SELU"), _act("Silu"), _act("Swish"), _act("Hardswish"),
    _act("Hardsigmoid"), _act("Hardtanh", -0.5, 1.5), _act("Mish"),
    _act("Softplus", 2, 3), _act("Softsign"), _act("Tanhshrink"),
    _act("Softshrink", 0.3), _act("Hardshrink", 0.4),
    LayerCase("Softmax", lambda P: P.nn.Softmax(), _inputs(_f(3, 8)),
              "reduction"),
    LayerCase("LogSoftmax", lambda P: P.nn.LogSoftmax(axis=0),
              _inputs(_f(3, 8)), "reduction"),
    LayerCase("Maxout", lambda P: P.nn.Maxout(2),
              _inputs(_f(2, 4, 3, 3))),
    LayerCase("GLU", lambda P: P.nn.GLU(), _inputs(_f(3, 8))),
    LayerCase("PReLU", lambda P: P.nn.PReLU(), _inputs(_f(3, 8))),
    LayerCase("PReLU-channels", lambda P: P.nn.PReLU(4, init=0.1),
              _inputs(_f(2, 4, 3, 3))),
    # ------------------------------------------------------------ norms
    LayerCase("LayerNorm", lambda P: P.nn.LayerNorm(8),
              _inputs(_f(3, 5, 8, scale=2.0, shift=0.5)), "reduction"),
    LayerCase("LayerNorm-noaffine",
              lambda P: P.nn.LayerNorm(8, weight_attr=False,
                                       bias_attr=False),
              _inputs(_f(3, 8, scale=2.0)), "reduction"),
    LayerCase("LayerNorm-2d", lambda P: P.nn.LayerNorm([5, 8]),
              _inputs(_f(3, 5, 8)), "reduction"),
    LayerCase("BatchNorm", lambda P: P.nn.BatchNorm(4, act="relu"),
              _inputs(_f(6, 4, 3, 3, scale=2.0, shift=1.0)), "reduction",
              calls=3),
    LayerCase("BatchNorm1D", lambda P: P.nn.BatchNorm1D(4),
              _inputs(_f(8, 4, shift=1.0)), "reduction", calls=3),
    LayerCase("BatchNorm2D", lambda P: P.nn.BatchNorm2D(4),
              _inputs(_f(4, 4, 3, 3, scale=3.0)), "reduction", calls=3),
    LayerCase("BatchNorm2D-eval", lambda P: P.nn.BatchNorm2D(4),
              _inputs(_f(4, 4, 3, 3)), "reduction", train=False),
    LayerCase("BatchNorm3D", lambda P: P.nn.BatchNorm3D(3),
              _inputs(_f(2, 3, 2, 3, 3)), "reduction", calls=3),
    LayerCase("SyncBatchNorm", lambda P: P.nn.SyncBatchNorm(4),
              _inputs(_f(4, 4, 3, 3)), "reduction", calls=3),
    LayerCase("GroupNorm", lambda P: P.nn.GroupNorm(2, 4),
              _inputs(_f(2, 4, 3, 3)), "reduction"),
    LayerCase("InstanceNorm1D", lambda P: P.nn.InstanceNorm1D(4),
              _inputs(_f(2, 4, 7)), "reduction"),
    LayerCase("InstanceNorm2D", lambda P: P.nn.InstanceNorm2D(4),
              _inputs(_f(2, 4, 3, 5)), "reduction"),
    LayerCase("InstanceNorm3D", lambda P: P.nn.InstanceNorm3D(3),
              _inputs(_f(2, 3, 2, 3, 3)), "reduction"),
    LayerCase("LocalResponseNorm", lambda P: P.nn.LocalResponseNorm(3),
              _inputs(_f(2, 5, 3, 3)), "reduction"),
    LayerCase("SpectralNorm",
              lambda P: P.nn.SpectralNorm([6, 4], power_iters=2),
              _inputs(_f(6, 4)), "reduction",
              tags={"reference_detached": "the reference's forward "
                    "rebuilds its output from the raw array, so no "
                    "gradient reaches the weight; the port's does"}),
    # ------------------------------------------------------------ losses
    LayerCase("CrossEntropyLoss", lambda P: P.nn.CrossEntropyLoss(),
              _inputs(_f(6, 5), _ints(0, 5, 6, force=-100)), "reduction"),
    LayerCase("CrossEntropyLoss-weighted", lambda P: P.nn.CrossEntropyLoss(
        weight=P.to_tensor(np.linspace(0.5, 1.5, 5).astype(np.float32))),
        _inputs(_f(6, 5), _ints(0, 5, 6)), "reduction"),
    LayerCase("CrossEntropyLoss-soft",
              lambda P: P.nn.CrossEntropyLoss(soft_label=True,
                                              reduction="sum"),
              _inputs(_f(6, 5), _probs(6, 5)), "reduction", nograd=(1,)),
    LayerCase("CrossEntropyLoss-smooth",
              lambda P: P.nn.CrossEntropyLoss(label_smoothing=0.1,
                                              reduction="none"),
              _inputs(_f(6, 5), _ints(0, 5, 6)), "reduction"),
    LayerCase("MSELoss", lambda P: P.nn.MSELoss(),
              _inputs(_f(4, 5), _f(4, 5)), "reduction", nograd=(1,)),
    LayerCase("L1Loss", lambda P: P.nn.L1Loss(reduction="sum"),
              _inputs(_f(4, 5), _f(4, 5)), "reduction", nograd=(1,)),
    LayerCase("NLLLoss", lambda P: P.nn.NLLLoss(),
              _inputs(_log_probs(6, 5), _ints(0, 5, 6)), "reduction"),
    LayerCase("BCELoss", lambda P: P.nn.BCELoss(),
              _inputs(_unit(4, 5), _unit(4, 5)), "reduction", nograd=(1,)),
    LayerCase("BCEWithLogitsLoss", lambda P: P.nn.BCEWithLogitsLoss(
        pos_weight=P.to_tensor(np.linspace(0.5, 2.0, 5).astype(
            np.float32))), _inputs(_f(4, 5), _unit(4, 5)), "reduction",
        nograd=(1,)),
    LayerCase("SmoothL1Loss", lambda P: P.nn.SmoothL1Loss(delta=0.7),
              _inputs(_f(4, 5), _f(4, 5)), "reduction", nograd=(1,)),
    LayerCase("KLDivLoss", lambda P: P.nn.KLDivLoss(reduction="batchmean"),
              _inputs(_log_probs(4, 5), _probs(4, 5)), "reduction",
              nograd=(1,)),
    LayerCase("MarginRankingLoss", lambda P: P.nn.MarginRankingLoss(0.2),
              _inputs(_f(6), _f(6), _signs(6)), "reduction", nograd=(2,)),
    LayerCase("HingeEmbeddingLoss", lambda P: P.nn.HingeEmbeddingLoss(),
              _inputs(_f(6), _signs(6)), "reduction", nograd=(1,)),
    # ------------------------------------------------------------ attention
    LayerCase("MultiHeadAttention", lambda P: P.nn.MultiHeadAttention(E, H),
              _inputs(_f(2, 8, E)), "attention"),
    LayerCase("MultiHeadAttention-mask",
              lambda P: P.nn.MultiHeadAttention(E, H),
              _inputs(_f(2, 8, E), _f(2, 8, E), _mask(2, 8)), "attention",
              call=lambda layer, t: layer(t[0], t[1], t[1], attn_mask=t[2]),
              nograd=(2,)),
    LayerCase("MultiHeadAttention-cache",
              lambda P: P.nn.MultiHeadAttention(E, H), _inputs(_f(2, 8, E)),
              "attention", call=_cache_call),
    LayerCase("TransformerEncoderLayer",
              lambda P: P.nn.TransformerEncoderLayer(E, H, FF, dropout=0.0),
              _inputs(_f(2, 8, E)), "attention"),
    LayerCase("TransformerEncoderLayer-prenorm",
              lambda P: P.nn.TransformerEncoderLayer(
                  E, H, FF, dropout=0.0, activation="gelu",
                  normalize_before=True), _inputs(_f(2, 8, E)), "attention"),
    LayerCase("TransformerEncoder", lambda P: P.nn.TransformerEncoder(
        P.nn.TransformerEncoderLayer(E, H, FF, dropout=0.0), 2),
        _inputs(_f(2, 8, E)), "attention"),
    LayerCase("TransformerDecoderLayer",
              lambda P: P.nn.TransformerDecoderLayer(E, H, FF, dropout=0.0),
              _inputs(_f(2, 6, E), _f(2, 8, E)), "attention"),
    LayerCase("TransformerDecoder", lambda P: P.nn.TransformerDecoder(
        P.nn.TransformerDecoderLayer(E, H, FF, dropout=0.0), 2),
        _inputs(_f(2, 6, E), _f(2, 8, E)), "attention"),
    LayerCase("Transformer", lambda P: P.nn.Transformer(
        E, H, 1, 1, FF, dropout=0.0), _inputs(_f(2, 8, E), _f(2, 6, E)),
        "attention", call=_transformer_call),
    LayerCase("Sequential", lambda P: P.nn.Sequential(
        P.nn.Linear(8, 6), P.nn.ReLU(), P.nn.Linear(6, 3)),
        _inputs(_f(4, 8)), "reduction"),
]

#: the convolution, pooling, recurrent and ``layers_extra`` layers
LAYER_CASES_12B2 = [
    # ------------------------------------------------------------ conv
    LayerCase("Conv1D", lambda P: P.nn.Conv1D(3, 4, 3, stride=2, padding=1),
              _inputs(_f(2, 3, 9)), "reduction"),
    LayerCase("Conv2D", lambda P: P.nn.Conv2D(4, 6, 3, padding=1, groups=2),
              _inputs(_f(2, 4, 6, 5)), "reduction"),
    LayerCase("Conv2D-same-stride", lambda P: P.nn.Conv2D(
        3, 4, [3, 2], stride=2, padding="SAME", dilation=[1, 2],
        bias_attr=False), _inputs(_f(2, 3, 7, 8)), "reduction"),
    LayerCase("Conv2D-nhwc", lambda P: P.nn.Conv2D(
        3, 4, 3, padding=[1, 0, 2, 1], data_format="NHWC"),
        _inputs(_f(2, 6, 5, 3)), "reduction"),
    LayerCase("Conv3D", lambda P: P.nn.Conv3D(2, 3, 2, stride=[1, 2, 1],
                                             padding=1),
              _inputs(_f(1, 2, 4, 5, 3)), "reduction"),
    LayerCase("Conv2DTranspose", lambda P: P.nn.Conv2DTranspose(
        4, 3, 3, stride=2, padding=1, output_padding=1),
        _inputs(_f(2, 4, 4, 5)), "reduction"),
    LayerCase("Conv1DTranspose", lambda P: P.nn.Conv1DTranspose(
        3, 2, 4, stride=3, padding=[1, 2]), _inputs(_f(2, 3, 5)),
        "reduction"),
    LayerCase("Conv3DTranspose", lambda P: P.nn.Conv3DTranspose(
        2, 3, 2, stride=2, dilation=[1, 2, 1]),
        _inputs(_f(1, 2, 3, 3, 2)), "reduction"),
    # ------------------------------------------------------------ pooling
    LayerCase("MaxPool1D", lambda P: P.nn.MaxPool1D(3, 2, 1,
                                                   ceil_mode=True),
              _inputs(_distinct(2, 3, 8))),
    LayerCase("MaxPool2D", lambda P: P.nn.MaxPool2D(3, 2, 1),
              _inputs(_distinct(2, 3, 7, 6))),
    LayerCase("MaxPool2D-ceil-nhwc", lambda P: P.nn.MaxPool2D(
        2, ceil_mode=True, data_format="NHWC"),
        _inputs(_distinct(2, 5, 7, 3))),
    LayerCase("MaxPool3D", lambda P: P.nn.MaxPool3D(2, 2, 0),
              _inputs(_distinct(1, 2, 4, 5, 4))),
    LayerCase("MaxPool3D-mask", lambda P: P.nn.MaxPool3D(2, 1,
                                                        return_mask=True),
              _inputs(_distinct(1, 2, 3, 4, 3))),
    LayerCase("AvgPool1D", lambda P: P.nn.AvgPool1D(3, 2, 1),
              _inputs(_f(2, 3, 8)), "reduction"),
    LayerCase("AvgPool2D", lambda P: P.nn.AvgPool2D(3, 2, 1, ceil_mode=True),
              _inputs(_f(2, 3, 7, 6)), "reduction"),
    LayerCase("AvgPool2D-inclusive", lambda P: P.nn.AvgPool2D(
        2, 1, "SAME", exclusive=False), _inputs(_f(2, 3, 5, 4)),
        "reduction"),
    LayerCase("AvgPool3D", lambda P: P.nn.AvgPool3D(2, 2, 1),
              _inputs(_f(1, 2, 4, 5, 3)), "reduction"),
    LayerCase("AdaptiveAvgPool1D", lambda P: P.nn.AdaptiveAvgPool1D(3),
              _inputs(_f(2, 3, 7)), "reduction"),
    LayerCase("AdaptiveAvgPool2D", lambda P: P.nn.AdaptiveAvgPool2D([3, 2]),
              _inputs(_f(2, 3, 7, 6)), "reduction"),
    LayerCase("AdaptiveAvgPool2D-one", lambda P: P.nn.AdaptiveAvgPool2D(1),
              _inputs(_f(2, 3, 4, 4)), "reduction"),
    LayerCase("AdaptiveAvgPool3D", lambda P: P.nn.AdaptiveAvgPool3D(
        [2, None, 3]), _inputs(_f(1, 2, 5, 3, 4)), "reduction"),
    LayerCase("AdaptiveMaxPool1D", lambda P: P.nn.AdaptiveMaxPool1D(
        3, return_mask=True), _inputs(_distinct(2, 3, 7))),
    LayerCase("AdaptiveMaxPool2D", lambda P: P.nn.AdaptiveMaxPool2D([3, 4]),
              _inputs(_distinct(2, 3, 7, 6))),
    LayerCase("AdaptiveMaxPool3D", lambda P: P.nn.AdaptiveMaxPool3D(
        2, return_mask=True), _inputs(_distinct(1, 2, 5, 3, 4))),
    LayerCase("MaxUnPool1D", lambda P: P.nn.MaxUnPool1D(2),
              _inputs(_f(2, 3, 4), _unpool_indices(2, 3, (4,), (8,)))),
    LayerCase("MaxUnPool2D", lambda P: P.nn.MaxUnPool2D(2, output_size=[
        5, 7]), _inputs(_f(2, 2, 2, 3), _unpool_indices(2, 2, (2, 3),
                                                         (5, 7)))),
    LayerCase("MaxUnPool3D", lambda P: P.nn.MaxUnPool3D(2, 2),
              _inputs(_f(1, 2, 2, 2, 1),
                      _unpool_indices(1, 2, (2, 2, 1), (4, 4, 2)))),
    # ------------------------------------------------------------ vision
    LayerCase("ChannelShuffle", lambda P: P.nn.ChannelShuffle(3),
              _inputs(_f(2, 6, 3, 2))),
    LayerCase("PixelUnshuffle", lambda P: P.nn.PixelUnshuffle(2),
              _inputs(_f(2, 3, 4, 6))),
    LayerCase("ZeroPad2D", lambda P: P.nn.ZeroPad2D([1, 0, 2, 1]),
              _inputs(_f(2, 3, 4, 5))),
    LayerCase("Fold", lambda P: P.nn.Fold([5, 6], 3, strides=2, paddings=1),
              _inputs(_f(2, 18, 9)), "reduction"),
    LayerCase("Softmax2D", lambda P: P.nn.Softmax2D(),
              _inputs(_f(2, 4, 3, 3)), "reduction"),
    LayerCase("ThresholdedReLU", lambda P: P.nn.ThresholdedReLU(0.5),
              _inputs(_f(3, 8))),
    LayerCase("PairwiseDistance", lambda P: P.nn.PairwiseDistance(3.0),
              _inputs(_f(4, 6), _f(4, 6)), "reduction"),
    # ------------------------------------------------------------ losses
    LayerCase("CTCLoss", lambda P: P.nn.CTCLoss(blank=0),
              _inputs(_f(6, 3, 5), _ints(1, 5, 3, 3), _lengths(3, 6),
                      _lengths(3, 3)), "reduction"),
    LayerCase("CTCLoss-sum-by-times", lambda P: P.nn.CTCLoss(
        blank=4, reduction="sum"), _inputs(
        _f(5, 2, 5), _ints(0, 4, 2, 2), _lengths(2, 5), _lengths(2, 2)),
        "reduction", call=lambda layer, t: layer(*t, norm_by_times=True)),
    LayerCase("HSigmoidLoss", lambda P: P.nn.HSigmoidLoss(6, 7),
              _inputs(_f(5, 6), _ints(0, 7, 5)), "reduction"),
    # ------------------------------------------------------------ recurrent
    LayerCase("SimpleRNN", lambda P: P.nn.SimpleRNN(3, 4, num_layers=2),
              _inputs(_f(2, 5, 3)), "reduction", call=lambda layer, t:
              _nest(layer(t[0]))),
    LayerCase("GRU", lambda P: P.nn.GRU(3, 4, direction="bidirect",
                                       time_major=True),
              _inputs(_f(5, 2, 3), _f(2, 2, 4)), "reduction",
              call=lambda layer, t: _nest(layer(t[0], t[1]))),
    LayerCase("LSTM", lambda P: P.nn.LSTM(3, 4, num_layers=2,
                                         direction="bidirectional"),
              _inputs(_f(2, 4, 3), _f(4, 2, 4), _f(4, 2, 4), _lengths(2, 4)),
              "reduction", call=lambda layer, t: _nest(layer(
                  t[0], (t[1], t[2]), sequence_length=t[3]))),
    LayerCase("SimpleRNNCell", lambda P: P.nn.SimpleRNNCell(
        3, 4, activation="relu"), _inputs(_f(2, 3), _f(2, 4)), "reduction",
        call=lambda layer, t: _nest(layer(t[0], t[1]))),
    LayerCase("GRUCell", lambda P: P.nn.GRUCell(3, 4),
              _inputs(_f(2, 3)), "reduction",
              call=lambda layer, t: _nest(layer(t[0]))),
    LayerCase("LSTMCell", lambda P: P.nn.LSTMCell(3, 4),
              _inputs(_f(2, 3), _f(2, 4), _f(2, 4)), "reduction",
              call=lambda layer, t: _nest(layer(t[0], (t[1], t[2])))),
    LayerCase("RNNCellBase-states", _cell_base, _inputs(_f(2, 3)),
              "reduction", call=lambda layer, t: _nest(layer(t[0]))),
    LayerCase("RNN", lambda P: P.nn.RNN(P.nn.SimpleRNNCell(3, 4)),
              _inputs(_f(2, 5, 3), _lengths(2, 5)), "reduction",
              call=lambda layer, t: _nest(layer(t[0],
                                                sequence_length=t[1])),
              tags={"reference_detached": _MASKED_DETACHED}),
    LayerCase("RNN-reverse-lstm", lambda P: P.nn.RNN(
        P.nn.LSTMCell(3, 4), is_reverse=True, time_major=True),
        _inputs(_f(5, 2, 3), _f(2, 4), _f(2, 4)), "reduction",
        call=lambda layer, t: _nest(layer(t[0], (t[1], t[2])))),
    LayerCase("BiRNN", lambda P: P.nn.BiRNN(P.nn.SimpleRNNCell(3, 4),
                                           P.nn.SimpleRNNCell(3, 4)),
              _inputs(_f(2, 5, 3), _lengths(2, 5)), "reduction",
              call=lambda layer, t: _nest(layer(t[0],
                                                sequence_length=t[1])),
              tags={"reference_detached": _MASKED_DETACHED}),
    LayerCase("BiRNN-unmasked", lambda P: P.nn.BiRNN(
        P.nn.GRUCell(3, 4), P.nn.GRUCell(3, 4), time_major=True),
        _inputs(_f(5, 2, 3)), "reduction",
        call=lambda layer, t: _nest(layer(t[0]))),
]
LAYER_CASES += LAYER_CASES_12B2
#: their names (phase 12 of ``chip_smoke.py`` runs them on the card)
SLICE_12B2 = frozenset(c.name for c in LAYER_CASES_12B2)


def to_numpy(x) -> np.ndarray:
    """A tensor of either package (or an array) as a float32 or integer
    ndarray."""
    try:
        import torch

        if isinstance(x, torch.Tensor):
            x = x.detach().cpu()
            return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    except ImportError:  # pragma: no cover
        pass
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x)


def _flat(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def run_case(P, layer, case: LayerCase, arrays, place=None,
             seed: int = 7) -> dict:
    """Drive ``layer`` (built from the package root ``P``) on ``arrays``
    placed on ``place``: ``{"outputs": [...], "input_grads": {i: g},
    "param_grads": {name: g}, "buffers": {name: b}}``, numpy."""
    kw = {} if place is None else {"place": place}
    ts = []
    for i, a in enumerate(arrays):
        takes = np.issubdtype(a.dtype, np.floating) and i not in case.nograd
        ts.append(P.to_tensor(a, stop_gradient=not takes, **kw))
    layer.train() if case.train else layer.eval()
    call = case.call or (lambda lyr, t: lyr(*t))
    for _ in range(case.calls):
        if case.random:
            P.seed(seed)
        outs = _flat(call(layer, ts))
    rng = np.random.default_rng(seed)
    loss = None
    for o in outs:
        shape = tuple(o.shape)
        cot = P.to_tensor(rng.standard_normal(shape).astype(np.float32),
                          **kw)
        term = P.sum(o * cot)
        loss = term if loss is None else loss + term
    grads = {}
    if not loss.stop_gradient:
        loss.backward()
        grads = {i: to_numpy(t.grad) for i, t in enumerate(ts)
                 if not t.stop_gradient and t.grad is not None}
    return {"outputs": [to_numpy(o) for o in outs], "input_grads": grads,
            "param_grads": {n: to_numpy(p.grad)
                            for n, p in layer.named_parameters()
                            if p.grad is not None},
            "detached": bool(loss.stop_gradient),
            "buffers": {n: to_numpy(b) for n, b in layer.named_buffers()}}
