"""``nn.functional`` — the port of ``paddle_tpu/nn/functional.py``:
activations, ``linear`` and ``embedding``, dropout, the norms, the
losses and the shape functions the layers of ``nn`` call, each with the
reference's signature and defaults and computed in the reference's order
of operations, with conv, pooling, unpooling, ``fold``,
``grid_sample``, ``affine_grid``, ``temporal_shift``, ``ctc_loss``,
``hsigmoid_loss``, ``margin_cross_entropy``, ``class_center_sample``,
``sparse_attention`` and ``gather_tree``.

Plain functions on ``torch.Tensor``\\ s, differentiable by autograd. Four
reach the port's Hopper kernels on CUDA tensors (their plain versions on
CPU tensors): ``layer_norm`` (the LayerNorm kernels),
``scaled_dot_product_attention`` with no mask (flash attention),
``dropout`` and its broadcast forms (the dropout kernel);
``linear_cross_entropy`` is the fused, chunked LM head. Convolution is
``torch.convolution`` (cuDNN on the card; the reference's is XLA's, not
a Pallas kernel), a float32 one without TF32 under a local cuDNN flag,
and pooling is ATen's pooling operators, each after the reference's
padding rules. The rest are torch's element-wise and reduction
operators: the port takes nothing from ``torch.nn.functional`` but
``linear``, ``gelu`` and ``embedding``.

Random functions (``dropout``, ``alpha_dropout``, ``rrelu``,
``gumbel_softmax``) take the next key of the key schedule
(``core.rng.next_rng_key``) and draw as the reference does, with the
port's threefry.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch.nn import functional as TF

from .. import random as prng
from ..amp import amp_state, maybe_cast_inputs
from ..core.rng import next_rng_key
from ..kernels import attention
from ..kernels import dropout as _dropout
from ..kernels.fused_layernorm import fused_layer_norm

__all__ = [
    "relu", "relu6", "gelu", "sigmoid", "tanh", "softmax", "log_softmax",
    "leaky_relu", "elu", "selu", "silu", "swish", "hardswish", "hardsigmoid",
    "hardtanh", "mish", "softplus", "softsign", "tanhshrink", "softshrink",
    "hardshrink", "prelu", "glu", "maxout",
    "linear", "conv1d", "conv2d", "conv3d", "conv2d_transpose",
    "max_pool1d", "max_pool2d", "avg_pool1d", "avg_pool2d",
    "adaptive_avg_pool1d", "adaptive_avg_pool2d", "adaptive_max_pool2d",
    "batch_norm", "layer_norm", "group_norm", "instance_norm",
    "local_response_norm",
    "embedding", "dropout", "dropout2d", "dropout3d", "alpha_dropout",
    "cross_entropy", "softmax_with_cross_entropy", "linear_cross_entropy",
    "mse_loss", "l1_loss",
    "nll_loss", "binary_cross_entropy", "binary_cross_entropy_with_logits",
    "smooth_l1_loss", "kl_div", "margin_ranking_loss", "hinge_embedding_loss",
    "cosine_similarity", "normalize", "label_smooth", "one_hot", "pad",
    "interpolate", "upsample", "pixel_shuffle", "unfold", "grid_sample",
    "scaled_dot_product_attention", "sequence_mask",
    "temperature_scaled_softmax", "rrelu", "celu", "logsigmoid",
    "gumbel_softmax", "square_error_cost",
    # beyond the reference's __all__, defined in its module
    "adaptive_avg_pool3d", "adaptive_max_pool1d", "adaptive_max_pool3d",
    "affine_grid", "avg_pool3d", "bilinear", "channel_shuffle",
    "class_center_sample", "conv1d_transpose", "conv3d_transpose",
    "ctc_loss", "diag_embed", "dice_loss", "elu_", "fold", "gather_tree",
    "hsigmoid_loss", "log_loss", "log_sigmoid", "margin_cross_entropy",
    "max_pool3d", "max_unpool1d", "max_unpool2d", "max_unpool3d",
    "npair_loss", "pixel_unshuffle", "relu_", "sigmoid_focal_loss",
    "softmax_", "sparse_attention", "tanh_", "temporal_shift",
    "thresholded_relu", "zeropad2d",
]


def _zero(x):
    return torch.zeros((), dtype=x.dtype, device=x.device)


def _softplus(x):
    """``log(1 + exp(x))`` as the reference's ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, _zero(x))


def _inplace(x, fn):
    """``x`` overwritten with ``fn(x)``, the gradient flowing through the
    new value as the reference's in-place forms graft it."""
    return x.copy_(fn(x.clone()))


# ------------------------------------------------------------------ activations
def relu(x, name=None):
    return torch.relu(x)


def relu6(x, name=None):
    return torch.clamp(x, 0.0, 6.0)


def gelu(x, approximate=False, name=None):
    """Exact (``erf``) by default; ``approximate=True`` is the tanh form."""
    return TF.gelu(x, approximate="tanh" if approximate else "none")


def sigmoid(x, name=None):
    return torch.sigmoid(x)


def logsigmoid(x, name=None):
    return -_softplus(-x)


log_sigmoid = logsigmoid


def tanh(x, name=None):
    return torch.tanh(x)


def softmax(x, axis=-1, dtype=None, name=None):
    from ..core.dtype import to_torch_dtype

    if dtype is not None:
        x = x.to(to_torch_dtype(dtype))
    return torch.softmax(x, dim=axis)


def temperature_scaled_softmax(x, temperature=1.0, axis=-1, name=None):
    return torch.softmax(x / temperature, dim=axis)


def log_softmax(x, axis=-1, dtype=None, name=None):
    from ..core.dtype import to_torch_dtype

    if amp_state() is not None:
        (x,) = maybe_cast_inputs("log_softmax", [x])
    if dtype is not None:
        x = x.to(to_torch_dtype(dtype))
    return torch.log_softmax(x, dim=axis)


def leaky_relu(x, negative_slope=0.01, name=None):
    return torch.where(x >= 0, x, negative_slope * x)


def elu(x, alpha=1.0, name=None):
    safe = torch.where(x > 0, _zero(x), x)
    return torch.where(x > 0, x, alpha * torch.expm1(safe))


def celu(x, alpha=1.0, name=None):
    return torch.clamp(x, min=0.0) + alpha * torch.expm1(
        torch.clamp(x, max=0.0) / alpha)


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


def silu(x, name=None):
    return x * torch.sigmoid(x)


def swish(x, name=None):
    return silu(x)


def hardswish(x, name=None):
    return x * torch.clamp(x + 3, 0, 6) / 6


def hardsigmoid(x, slope=1 / 6, offset=0.5, name=None):
    return torch.clamp(x * slope + offset, 0, 1)


def hardtanh(x, min=-1.0, max=1.0, name=None):  # noqa: A002
    return torch.clamp(x, min, max)


def mish(x, name=None):
    return x * torch.tanh(_softplus(x))


def softplus(x, beta=1, threshold=20, name=None):
    return torch.where(x * beta > threshold, x, _softplus(x * beta) / beta)


def softsign(x, name=None):
    return x / (torch.abs(x) + 1)


def tanhshrink(x, name=None):
    return x - torch.tanh(x)


def softshrink(x, threshold=0.5, name=None):
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, _zero(x)))


def hardshrink(x, threshold=0.5, name=None):
    return torch.where(torch.abs(x) > threshold, x, _zero(x))


def thresholded_relu(x, threshold=1.0, name=None):
    return torch.where(x > threshold, x, _zero(x))


def prelu(x, weight, data_format="NCHW", name=None):
    if weight.numel() == 1:
        return torch.where(x > 0, x, weight.reshape(()) * x)
    shape = [1] * x.dim()
    shape[1 if data_format == "NCHW" else x.dim() - 1] = weight.numel()
    return torch.where(x > 0, x, weight.reshape(shape) * x)


def rrelu(x, lower=0.125, upper=0.333, training=True, name=None):
    """In training the negative slope is one draw, uniform in ``[lower,
    upper)`` (float64, as the reference draws it; the product is in x's
    dtype); otherwise their mean."""
    if training:
        key = torch.tensor(next_rng_key(), dtype=torch.int64)
        # a scalar draw is element 0 of a one-element draw
        a = float(prng.uniform(key, (1,), lower, upper,
                               dtype=torch.float64)[0])
    else:
        a = (lower + upper) / 2
    return torch.where(x >= 0, x, a * x)


def glu(x, axis=-1, name=None):
    a, b = torch.chunk(x, 2, dim=axis)
    return a * torch.sigmoid(b)


def maxout(x, groups, axis=1, name=None):
    shape = list(x.shape)
    axis = axis % x.dim()
    c = shape[axis]
    new = shape[:axis] + [groups, c // groups] + shape[axis + 1:]
    return torch.amax(x.reshape(new), dim=axis)


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    """``softmax((x + g) / temperature)`` with float64 Gumbel noise ``g``
    (the reference's default float), cast back to x's dtype; ``hard``
    returns the one-hot of the argmax with the soft gradient
    (straight-through)."""
    key = torch.tensor(next_rng_key(), dtype=torch.int64, device=x.device)
    u = prng.uniform(key, tuple(x.shape), float(torch.finfo(
        torch.float64).tiny), 1.0, dtype=torch.float64)
    g = -torch.log(-torch.log(u))
    y = torch.softmax((x + g) / temperature, dim=axis)
    if hard:
        idx = torch.argmax(y, dim=axis, keepdim=True)
        y_hard = torch.zeros_like(y).scatter_(axis, idx, 1.0)
        y = (y_hard - y).detach() + y
    return y.to(x.dtype)


def relu_(x, name=None):
    return _inplace(x, relu)


def elu_(x, alpha=1.0, name=None):
    return _inplace(x, lambda a: elu(a, alpha))


def tanh_(x, name=None):
    return _inplace(x, tanh)


def softmax_(x, axis=-1, dtype=None, name=None):
    return _inplace(x, lambda a: softmax(a, axis, dtype))


# ------------------------------------------------------------------ linear
def linear(x, weight, bias=None, name=None):
    """``x @ weight + bias`` with the reference's ``[in, out]`` weight."""
    if amp_state() is not None:
        x, weight, bias = maybe_cast_inputs("linear", [x, weight, bias])
    if bias is None:
        return torch.matmul(x, weight)
    lead = x.shape[:-1]
    out = torch.addmm(bias, x.reshape(-1, x.shape[-1]), weight)
    return out.reshape(*lead, weight.shape[-1])


def bilinear(x1, x2, weight, bias=None, name=None):
    """``out[n, o] = x1[n] · weight[o] · x2[n]`` (plus ``bias``)."""
    out = torch.einsum("ni,oij,nj->no", x1, weight, x2)
    return out if bias is None else out + bias


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of ``weight`` at the indices ``x``; rows at ``padding_idx`` (a
    negative one counts from the end) are zero and pass no gradient, as
    the reference masks them. ``sparse`` is the reference's flag for a
    row-sparse gradient; the port's gradient is dense."""
    out = TF.embedding(x, weight)
    if padding_idx is None:
        return out
    padding_idx = int(padding_idx)
    if padding_idx < 0:
        padding_idx += int(weight.shape[0])
    return torch.where((x == padding_idx)[..., None], _zero(out), out)


# ------------------------------------------------------------------ norms
def _stats_axes(x, ch_axis):
    return tuple(i for i in range(x.dim()) if i != ch_axis % x.dim())


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-05,
               data_format="NCHW", use_global_stats=None, name=None):
    """Batch statistics in training (unless ``use_global_stats``), else
    the running ones. In training the running statistics are updated in
    place with the reference's rule: ``running = momentum * running +
    (1 - momentum) * batch``, the variance unbiased. Under ``amp`` the
    running statistics keep their dtype (they are updated in place)."""
    if amp_state() is not None:
        x, weight, bias = maybe_cast_inputs("batch_norm", [x, weight, bias])
    ch_axis = 1 if data_format.startswith("NC") else -1
    axes = _stats_axes(x, ch_axis)
    use_batch = training and not use_global_stats
    shape = [1] * x.dim()
    shape[ch_axis % x.dim()] = -1
    if use_batch:
        mean = x.mean(axes)
        var = x.var(axes, unbiased=False)
    else:
        mean, var = running_mean.detach(), running_var.detach()
    out = (x - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape)
                                                  + epsilon)
    if weight is not None:
        out = out * weight.reshape(shape) + bias.reshape(shape)
    if use_batch and isinstance(running_mean, torch.Tensor):
        with torch.no_grad():
            bm, bv = mean.detach(), var.detach()
            n = float(np.prod([x.shape[i] for i in axes]))
            unbiased = bv if n <= 1 else bv * n / (n - 1)
            running_mean.copy_(running_mean * momentum
                               + bm * (1 - momentum))
            running_var.copy_(running_var * momentum
                              + unbiased * (1 - momentum))
    return out


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-05,
               name=None):
    """LayerNorm of ``x`` over its trailing ``normalized_shape``.

    With one normalised dimension and both a ``weight`` and a ``bias`` of
    that width (one dtype), this is :func:`fused_layer_norm`: on CUDA
    tensors the Hopper kernels, on CPU tensors their plain versions. Any
    other form, and a float64 or float16 ``x`` (the kernels take float32
    and bfloat16; float16 kernels are ROADMAP Queue 2 open work 10), is the
    reference's composite on either device — ``(x - mean) * rsqrt(var +
    epsilon)`` over float32 statistics, times the weight and plus the bias
    where given, cast to x's dtype — as the reference takes XLA there. A
    float64 ``x`` keeps float64 statistics (the reference rounds them
    through float32), so that a float64 model agrees with itself across
    devices to float64 rounding."""
    if amp_state() is not None:
        x, weight, bias = maybe_cast_inputs("layer_norm", [x, weight, bias])
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    nd = len(tuple(normalized_shape))
    d = x.shape[-1]
    if nd == 1 and weight is not None and bias is not None \
            and tuple(weight.shape) == tuple(bias.shape) == (d,) \
            and weight.dtype == bias.dtype \
            and x.dtype not in (torch.float64, torch.float16):
        return fused_layer_norm(x, weight, bias, epsilon)
    dims = tuple(range(x.dim() - nd, x.dim()))
    xf = x if x.dtype == torch.float64 else x.float()
    mean = xf.mean(dims, keepdim=True)
    var = xf.var(dims, unbiased=False, keepdim=True)
    out = (x - mean) * torch.rsqrt(var + epsilon)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out.to(x.dtype)


def group_norm(x, num_groups, epsilon=1e-05, weight=None, bias=None,
               data_format="NCHW", name=None):
    n, c = x.shape[0], x.shape[1]
    rest = tuple(x.shape[2:])
    g = x.reshape(n, num_groups, c // num_groups, *rest)
    axes = tuple(range(2, g.dim()))
    mean = g.mean(axes, keepdim=True)
    var = g.var(axes, unbiased=False, keepdim=True)
    out = ((g - mean) * torch.rsqrt(var + epsilon)).reshape(x.shape)
    if weight is not None:
        shape = [1, c] + [1] * len(rest)
        out = out * weight.reshape(shape) + bias.reshape(shape)
    return out


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-05,
                  data_format="NCHW", name=None):
    """Statistics over each sample's spatial dimensions (the reference
    uses the input's statistics always and keeps no running ones)."""
    axes = tuple(range(2, x.dim()))
    mean = x.mean(axes, keepdim=True)
    var = x.var(axes, unbiased=False, keepdim=True)
    out = (x - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        shape = [1, x.shape[1]] + [1] * (x.dim() - 2)
        out = out * weight.reshape(shape) + bias.reshape(shape)
    return out


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    sq = x * x
    half = size // 2
    pads = [0, 0] * (x.dim() - 2) + [half, size - 1 - half]
    sq_p = torch.constant_pad_nd(sq, pads, 0.0)
    acc = sum(sq_p[:, i:i + x.shape[1]] for i in range(size))
    return x / torch.pow(k + alpha * acc / size, beta)


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    nrm = torch.linalg.vector_norm(x, ord=p, dim=axis, keepdim=True)
    return x / torch.clamp(nrm, min=epsilon)


# ------------------------------------------------------------------ dropout
def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    """The reference's ``dropout``: in training with ``p > 0``, draw the
    next key (``core.rng.next_rng_key``) and keep each element of ``x``
    (each element of the broadcast mask of ``axis``: 1 along every
    dimension not in it) with probability ``1 - p``. ``upscale_in_train``
    divides kept values by ``1 - p``; ``downscale_in_infer`` keeps them as
    they are and, like the reference, returns ``x`` unscaled outside
    training. Otherwise ``x`` is returned and no key is drawn.

    On CUDA tensors the dropout kernel (forward, and on the gradient in
    the backward, each regenerating the mask from the key); on CPU
    tensors its plain version."""
    if not training or p == 0:
        return x
    return _dropout.dropout(x, next_rng_key(), p, mode, axis)


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    """Whole channels dropped: the mask broadcast over H and W."""
    axis = [0, 1] if data_format == "NCHW" else [0, 3]
    return dropout(x, p, axis=axis, training=training)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    axis = [0, 1] if data_format == "NCDHW" else [0, 4]
    return dropout(x, p, axis=axis, training=training)


def alpha_dropout(x, p=0.5, training=True, name=None):
    """SELU-preserving dropout: dropped values become ``-alpha * scale``
    and the result is rescaled to keep the mean and variance."""
    if not training or p == 0:
        return x
    key = torch.tensor(next_rng_key(), dtype=torch.int64, device=x.device)
    alpha = 1.6732632423543772
    scale = 1.0507009873554805
    alpha_p = -alpha * scale
    keep = prng.bernoulli(key, 1.0 - p, tuple(x.shape))
    q = 1.0 - p
    a_coef = (q + alpha_p**2 * q * p) ** -0.5
    b_coef = -a_coef * alpha_p * p
    return a_coef * torch.where(keep, x, torch.full(
        (), alpha_p, dtype=x.dtype, device=x.device)) + b_coef


# ------------------------------------------------------------------ losses
def _reduce(v, reduction):
    if reduction == "mean":
        return v.mean()
    if reduction == "sum":
        return v.sum()
    return v


def cross_entropy(input, label, weight=None, ignore_index=-100,  # noqa: A002
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """Softmax cross-entropy along ``axis`` (``use_softmax=False``: the
    input is probabilities). Hard labels skip ``ignore_index`` and, with
    ``weight``, are weighted by their class; ``"mean"`` divides by the
    valid count (the valid weights' sum). ``soft_label``: ``-sum(label *
    log_softmax)``. ``label_smoothing`` mixes the one-hot target with the
    uniform one."""
    if amp_state() is not None:
        input, weight = maybe_cast_inputs("cross_entropy",  # noqa: A001
                                          [input, weight])
    axis = axis % input.dim()
    lp = torch.log_softmax(input, dim=axis) if use_softmax else \
        torch.log(torch.clamp(input, min=1e-30))
    if soft_label:
        return _reduce(-(label * lp).sum(axis), reduction)
    lab = label.detach().long()
    if lab.dim() == lp.dim():
        lab = lab.squeeze(axis)
    valid = lab != ignore_index
    safe = torch.where(valid, lab, torch.zeros_like(lab))
    if label_smoothing > 0.0:
        n = lp.shape[axis]
        onehot = torch.movedim(
            torch.eye(n, dtype=lp.dtype, device=lp.device)[safe], -1, axis)
        smooth = onehot * (1 - label_smoothing) + label_smoothing / n
        loss = -(smooth * lp).sum(axis)
    else:
        loss = -lp.gather(axis, safe.unsqueeze(axis)).squeeze(axis)
    if weight is not None:
        wt = weight[safe]
        loss = loss * wt
    loss = torch.where(valid, loss, _zero(loss))
    if reduction == "mean":
        if weight is not None:
            denom = torch.clamp(torch.where(valid, wt, _zero(wt)).sum(),
                                min=1e-12)
        else:
            denom = torch.clamp(valid.sum(), min=1)
        return loss.sum() / denom
    return _reduce(loss, reduction)


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, axis=-1,
                               return_softmax=False, name=None):
    if amp_state() is not None:
        (logits,) = maybe_cast_inputs("softmax_with_cross_entropy", [logits])
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis)
    if loss.dim() < logits.dim():
        loss = loss.unsqueeze(axis)
    if return_softmax:
        return loss, softmax(logits, axis=axis)
    return loss


def mse_loss(input, label, reduction="mean", name=None):  # noqa: A002
    if amp_state() is not None:
        input, label = maybe_cast_inputs("mse_loss",  # noqa: A001
                                         [input, label])
    return _reduce((input - label) ** 2, reduction)


def square_error_cost(input, label):  # noqa: A002
    return (input - label) ** 2


def l1_loss(input, label, reduction="mean", name=None):  # noqa: A002
    return _reduce(torch.abs(input - label), reduction)


def nll_loss(input, label, weight=None, ignore_index=-100,  # noqa: A002
             reduction="mean", name=None):
    """``-input[n, label[n]]`` (log-probabilities ``[N, C]``), weighted by
    class with ``weight``; labels equal to ``ignore_index`` count 0 and
    leave the mean's denominator."""
    lab = label.detach().long()
    valid = lab != ignore_index
    safe = torch.where(valid, lab, torch.zeros_like(lab))
    loss = -input.gather(1, safe[:, None]).squeeze(1)
    wt = weight[safe] if weight is not None else None
    if wt is not None:
        loss = loss * wt
    loss = torch.where(valid, loss, _zero(loss))
    if reduction == "mean":
        denom = torch.where(valid, wt, _zero(wt)).sum() if wt is not None \
            else valid.sum()
        return loss.sum() / denom
    return _reduce(loss, reduction)


def binary_cross_entropy(input, label, weight=None,  # noqa: A002
                         reduction="mean", name=None):
    loss = -(label * torch.log(torch.clamp(input, min=1e-12))
             + (1 - label) * torch.log(torch.clamp(1 - input, min=1e-12)))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def _bce_logits(z, y):
    """``max(z, 0) - z * y + log(1 + exp(-|z|))``, the stable form."""
    return torch.clamp(z, min=0) - z * y + torch.log1p(torch.exp(
        -torch.abs(z)))


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    loss = _bce_logits(logit, label)
    if pos_weight is not None:
        loss = loss * ((pos_weight - 1) * label + 1)
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0,  # noqa: A002
                   name=None):
    d = torch.abs(input - label)
    loss = torch.where(d < delta, 0.5 * d * d, delta * (d - 0.5 * delta))
    return _reduce(loss, reduction)


def kl_div(input, label, reduction="mean", name=None):  # noqa: A002
    loss = label * (torch.log(torch.clamp(label, min=1e-12)) - input)
    if reduction == "batchmean":
        return loss.sum() / input.shape[0]
    return _reduce(loss, reduction)


def margin_ranking_loss(input, other, label, margin=0.0,  # noqa: A002
                        reduction="mean", name=None):
    return _reduce(torch.clamp(-label * (input - other) + margin, min=0.0),
                   reduction)


def hinge_embedding_loss(input, label, margin=1.0,  # noqa: A002
                         reduction="mean", name=None):
    loss = torch.where(label == 1, input,
                       torch.clamp(margin - input, min=0.0))
    return _reduce(loss, reduction)


def log_loss(input, label, epsilon=1e-4, name=None):  # noqa: A002
    """``-(y log(p + eps) + (1 - y) log(1 - p + eps))`` elementwise."""
    return -(label * torch.log(input + epsilon)
             + (1.0 - label) * torch.log(1.0 - input + epsilon))


def dice_loss(input, label, epsilon=1e-5, name=None):  # noqa: A002
    """``1 - dice`` for class probabilities ``[N, ..., C]`` and integer
    labels ``[N, ..., 1]``, averaged over the batch."""
    y1 = torch.eye(input.shape[-1], dtype=input.dtype,
                   device=input.device)[label.squeeze(-1).long()]
    red = tuple(range(1, input.dim()))
    inter = (input * y1).sum(red)
    union = input.sum(red) + y1.sum(red)
    return (1.0 - (2.0 * inter + epsilon) / (union + epsilon)).mean()


def npair_loss(anchor, positive, labels, l2_reg=0.002, name=None):
    """Softmax cross-entropy over the anchor-positive similarities with
    same-label soft targets, plus an L2 pull on the embeddings."""
    batch = anchor.shape[0]
    sim = anchor @ positive.T
    same = (labels.reshape(-1, 1) == labels.reshape(1, -1)).to(anchor.dtype)
    targets = same / same.sum(1, keepdim=True)
    ce = -(targets * torch.log_softmax(sim, dim=1)).sum(1).mean()
    l2 = (anchor * anchor).sum() / batch + (positive * positive).sum() / batch
    return ce + l2_reg * l2 * 0.25


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    p = torch.sigmoid(logit)
    ce = _bce_logits(logit, label)
    p_t = p * label + (1 - p) * (1 - label)
    a_t = alpha * label + (1 - alpha) * (1 - label)
    loss = a_t * ((1 - p_t) ** gamma) * ce
    if normalizer is not None:
        loss = loss / normalizer
    if reduction == "sum":
        return loss.sum()
    if reduction == "mean":
        return loss.mean()
    return loss


# ------------------------------------------------------------------ similarity
def cosine_similarity(x1, x2, axis=1, eps=1e-8, name=None):
    nrm = torch.linalg.vector_norm(x1, dim=axis) * torch.linalg.vector_norm(
        x2, dim=axis)
    return (x1 * x2).sum(axis) / torch.clamp(nrm, min=eps)


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    """``label * (1 - epsilon) + epsilon / n`` (``+ epsilon * prior_dist``
    when a prior is given)."""
    if prior_dist is not None:
        return label * (1 - epsilon) + epsilon * prior_dist
    return label * (1 - epsilon) + epsilon / label.shape[-1]


def one_hot(x, num_classes, name=None):
    """float32 ``[..., num_classes]``."""
    eye = torch.eye(int(num_classes), dtype=torch.float32, device=x.device)
    return eye[x.detach().long()]


def sequence_mask(lengths, maxlen=None, dtype="int64", name=None):
    from ..core.dtype import to_torch_dtype

    ml = int(lengths.max()) if maxlen is None else int(maxlen)
    rng = torch.arange(ml, device=lengths.device)
    return (rng[None, :] < lengths.detach()[:, None]).to(
        to_torch_dtype(dtype))


def diag_embed(input, offset=0, dim1=-2, dim2=-1, name=None):  # noqa: A002
    """``input``'s last dimension on the ``offset`` diagonal of new
    trailing ``[n + |offset|, n + |offset|]`` matrices, moved to ``(dim1,
    dim2)``."""
    n = input.shape[-1]
    size = n + abs(int(offset))
    i = torch.arange(n, device=input.device)
    r, c = i + max(-offset, 0), i + max(offset, 0)
    out = input.new_zeros(tuple(input.shape[:-1]) + (size, size))
    out[..., r, c] = input
    if (dim1, dim2) not in ((-2, -1), (out.dim() - 2, out.dim() - 1)):
        out = torch.movedim(out, (-2, -1), (dim1, dim2))
    return out


# ------------------------------------------------------------------ shape ops
_PAD_MODES = {"reflect": "reflect", "replicate": "edge", "circular": "wrap"}


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    """``pad`` holds ``(before, after)`` pairs: one per dimension in order
    when it has ``2 * ndim`` entries, else for the trailing dimensions
    starting from the last (Paddle's ``[left, right, top, bottom]``).
    Modes ``constant``, ``reflect``, ``replicate`` and ``circular``, as
    ``numpy.pad``'s ``constant``, ``reflect``, ``edge`` and ``wrap``."""
    p = [int(v) for v in (pad.tolist() if isinstance(pad, torch.Tensor)
                          else pad)]
    if len(p) == 2 * x.dim():
        cfg = [(p[2 * i], p[2 * i + 1]) for i in range(x.dim())]
    else:
        n = len(p) // 2
        pairs = [(p[2 * i], p[2 * i + 1]) for i in range(n)]
        cfg = [(0, 0)] * (x.dim() - n) + list(reversed(pairs))
    if mode == "constant":
        flat = [v for lo, hi in reversed(cfg) for v in (lo, hi)]
        return torch.constant_pad_nd(x, flat, value)
    np_mode = _PAD_MODES[mode]
    out = x
    for d, (lo, hi) in enumerate(cfg):
        if lo or hi:
            idx = np.pad(np.arange(x.shape[d]), (lo, hi), mode=np_mode)
            out = out.index_select(d, torch.as_tensor(idx, device=x.device))
    return out


def zeropad2d(x, padding, data_format="NCHW", name=None):
    p = [int(v) for v in padding] if isinstance(padding, (list, tuple)) \
        else [int(padding)] * 4  # [left, right, top, bottom]
    if data_format == "NCHW":
        return torch.constant_pad_nd(x, [p[0], p[1], p[2], p[3]], 0.0)
    return torch.constant_pad_nd(x, [0, 0, p[0], p[1], p[2], p[3]], 0.0)


def _resize_weights(n_in, n_out, kernel, antialias=True):
    """``[n_in, n_out]`` weights of ``jax.image.resize`` along one
    dimension (half-pixel centres; the kernel widened by the downscale
    factor when ``antialias``), in float64."""
    scale = n_out / n_in
    inv = 1.0 / scale
    kscale = max(inv, 1.0) if antialias else 1.0
    sample = (np.arange(n_out) + 0.5) * inv - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in)[:, None]) / kscale
    w = kernel(x)
    tot = w.sum(0, keepdims=True)
    w = np.where(np.abs(tot) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(tot != 0, tot, 1), 0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0)


def _triangle(x):
    return np.maximum(0, 1 - np.abs(x))


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def _linear_at(coords, n_in):
    """``[n_in, n_out]`` weights of linear interpolation at ``coords``
    (``map_coordinates`` of order 1: indices outside ``[0, n_in)`` add
    nothing)."""
    lo = np.floor(coords)
    frac = coords - lo
    w = np.zeros((n_in, len(coords)))
    for j, (i0, f) in enumerate(zip(lo.astype(int), frac)):
        for i, wt in ((i0, 1 - f), (i0 + 1, f)):
            if 0 <= i < n_in:
                w[i, j] += wt
    return w


def _adaptive_bins(n, out):
    """Bin ``i`` of ``out`` over ``n``: ``[floor(i n / out), ceil((i + 1) n
    / out))``, the reference's (and torch's)."""
    starts = [(i * n) // out for i in range(out)]
    ends = [-(-((i + 1) * n) // out) for i in range(out)]
    return starts, ends


def _adaptive_avg(n_in, n_out):
    """``[n_in, n_out]`` averaging weights of adaptive pooling over
    :func:`_adaptive_bins`."""
    w = np.zeros((n_in, n_out))
    for i, (s, e) in enumerate(zip(*_adaptive_bins(n_in, n_out))):
        w[s:e, i] = 1.0 / (e - s)
    return w


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    """The reference's resampling over 3-5-D inputs, channels first or
    last: ``nearest`` takes ``floor(i * in / out)`` (``align_corners``:
    the rounded corner-aligned positions); ``linear``, ``bilinear``,
    ``trilinear`` and ``bicubic`` are ``jax.image.resize``'s (half-pixel
    centres, antialiased when shrinking; Keys' cubic with ``a = -0.5``),
    and with ``align_corners`` or ``align_mode=1`` linear interpolation at
    ``i * (in - 1) / (out - 1)`` or ``i * in / out``; ``area`` is adaptive
    average pooling. Each resampled dimension is one product with a
    weight matrix built on the host."""
    if size is None and scale_factor is None:
        raise ValueError("interpolate: one of size or scale_factor must be "
                         "set")
    channels_last = data_format in ("NHWC", "NLC", "NWC", "NDHWC")
    a = torch.movedim(x, -1, 1) if channels_last else x
    sp = a.dim() - 2
    in_sp = tuple(a.shape[2:])
    if size is not None:
        osz = tuple(size) if isinstance(size, (list, tuple)) \
            else (int(size),) * sp
        if len(osz) != sp:
            raise ValueError(f"interpolate: size has {len(osz)} elements "
                             f"but the input has {sp} spatial dims")
        osz = tuple(int(s) for s in osz)
    else:
        sf = scale_factor if isinstance(scale_factor, (list, tuple)) \
            else (scale_factor,) * sp
        if len(sf) != sp:
            raise ValueError(f"interpolate: scale_factor has {len(sf)} "
                             f"elements but the input has {sp} spatial "
                             f"dims")
        osz = tuple(int(d * s) for d, s in zip(in_sp, sf))
    if mode == "bicubic" and align_corners:
        raise NotImplementedError(
            "bicubic with align_corners=True (the reference has no exact "
            "lowering either); use align_corners=False or bilinear")
    out = a
    for d, (n_in, n_out) in enumerate(zip(in_sp, osz)):
        if n_in == n_out:
            continue
        dim = 2 + d
        if mode == "nearest":
            idx = np.round(np.linspace(0.0, n_in - 1.0, n_out)) \
                if align_corners else np.floor(np.arange(n_out)
                                               * (n_in / n_out))
            out = out.index_select(dim, torch.as_tensor(
                idx.astype(np.int64), device=x.device))
            continue
        if mode == "area":
            w = _adaptive_avg(n_in, n_out)
        elif mode in ("linear", "bilinear", "trilinear") and (
                align_corners or align_mode == 1):
            coords = np.linspace(0.0, n_in - 1.0, n_out) if align_corners \
                else np.clip(np.arange(n_out) * (n_in / n_out), 0, n_in - 1)
            w = _linear_at(coords, n_in)
        else:
            kernel = {"bilinear": _triangle, "linear": _triangle,
                      "trilinear": _triangle, "bicubic": _keys_cubic}[mode]
            w = _resize_weights(n_in, n_out, kernel)
        wt = torch.as_tensor(w, dtype=out.dtype, device=x.device)
        out = torch.movedim(torch.tensordot(out, wt, dims=([dim], [0])), -1,
                            dim)
    return torch.movedim(out, 1, -1) if channels_last else out


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format="NCHW",
             name=None):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format)


def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    r = int(upscale_factor)
    if data_format != "NCHW":
        return torch.movedim(pixel_shuffle(torch.movedim(x, -1, 1), r), 1,
                             -1)
    n, c, h, w = x.shape
    a = x.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
    return a.reshape(n, c // (r * r), h * r, w * r)


def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    r = int(downscale_factor)
    if data_format == "NCHW":
        n, c, h, w = x.shape
        a = x.reshape(n, c, h // r, r, w // r, r).permute(0, 1, 3, 5, 2, 4)
        return a.reshape(n, c * r * r, h // r, w // r)
    n, h, w, c = x.shape
    a = x.reshape(n, h // r, r, w // r, r, c).permute(0, 1, 3, 5, 2, 4)
    return a.reshape(n, h // r, w // r, c * r * r)


def channel_shuffle(x, groups, data_format="NCHW", name=None):
    if data_format == "NCHW":
        n, c, h, w = x.shape
        return x.reshape(n, groups, c // groups, h, w).transpose(1, 2) \
            .reshape(n, c, h, w)
    n, h, w, c = x.shape
    return x.reshape(n, h, w, groups, c // groups).transpose(3, 4) \
        .reshape(n, h, w, c)


def _pair(v, n=2):
    """``v`` as ``n`` ints (a list or tuple as it is); None entries stay
    None (an adaptive pool keeps that dimension)."""
    if isinstance(v, (list, tuple)):
        return tuple(None if i is None else int(i) for i in v)
    if v is None:
        return (None,) * n
    return (int(v),) * n


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col: ``[N, C, H, W]`` -> ``[N, C * kh * kw, L]``."""
    k, s, p, d = (_pair(v) for v in (kernel_sizes, strides, paddings,
                                      dilations))
    n, c, h, w = x.shape
    a = torch.constant_pad_nd(x, [p[1], p[1], p[0], p[0]], 0.0)
    oh = (h + 2 * p[0] - d[0] * (k[0] - 1) - 1) // s[0] + 1
    ow = (w + 2 * p[1] - d[1] * (k[1] - 1) - 1) // s[1] + 1
    patches = [a[:, :, i * d[0]:i * d[0] + oh * s[0]:s[0],
                 j * d[1]:j * d[1] + ow * s[1]:s[1]]
               for i in range(k[0]) for j in range(k[1])]
    return torch.stack(patches, dim=2).reshape(n, c * k[0] * k[1], oh * ow)


# ------------------------------------------------------------------ conv
def _is_int(v) -> bool:
    return isinstance(v, (int, np.integer))


def _conv_padding(padding, n):
    """The reference's padding forms: ``"SAME"`` / ``"VALID"`` (any case)
    as the upper-case string, else ``n`` ``(lo, hi)`` pairs from an int,
    ``n`` ints, ``2n`` ints read as (lo, hi) pairs, or a list of pairs."""
    if isinstance(padding, str):
        return padding.upper()
    if _is_int(padding):
        return [(int(padding), int(padding))] * n
    padding = list(padding)
    if len(padding) == n and all(_is_int(p) for p in padding):
        return [(int(p), int(p)) for p in padding]
    if len(padding) == 2 * n:
        return [(int(padding[2 * i]), int(padding[2 * i + 1]))
                for i in range(n)]
    return [tuple(int(v) for v in p) for p in padding]


def _same_pads(sizes, kernel, stride, dilation):
    """``lax``'s ``"SAME"`` at any stride: ``out = ceil(n / s)``, ``total =
    max((out - 1) s + (k - 1) d + 1 - n, 0)``, the odd element on the high
    side. (PyTorch's ``padding="same"`` refuses stride > 1.)"""
    pads = []
    for n, k, s, d in zip(sizes, kernel, stride, dilation):
        out = -(-int(n) // s)
        total = max((out - 1) * s + (k - 1) * d + 1 - int(n), 0)
        pads.append((total // 2, total - total // 2))
    return pads


def _spatial_pads(padding, sizes, kernel, stride, dilation):
    """``padding`` as ``(lo, hi)`` pairs of the spatial dimensions."""
    nd = len(sizes)
    p = _conv_padding(padding, nd)
    if p == "SAME":
        return _same_pads(sizes, kernel, stride, dilation)
    if p == "VALID":
        return [(0, 0)] * nd
    if isinstance(p, str):
        raise ValueError(f"unknown padding {padding!r}: SAME, VALID or "
                         f"numbers")
    return p


def _pad_flat(pads):
    """``(lo, hi)`` pairs of the leading-to-trailing spatial dimensions as
    ``constant_pad_nd``'s list (last dimension first); negative entries
    crop."""
    return [v for lo, hi in reversed(pads) for v in (lo, hi)]


def _ieee_fp32(x):
    """For a float32 CUDA tensor, cuDNN without TF32 for the duration: the
    reference's float32 convolution is full float32
    (``preferred_element_type=float32``), and cuDNN would run it in TF32
    by default. A local flag, restored on exit; a no-op otherwise."""
    if not (x.is_cuda and x.dtype == torch.float32):
        return contextlib.nullcontext()
    return torch.backends.cudnn.flags(
        enabled=torch.backends.cudnn.enabled,
        benchmark=torch.backends.cudnn.benchmark,
        deterministic=torch.backends.cudnn.deterministic, allow_tf32=False)


class _Convolution(torch.autograd.Function):
    """``torch.convolution`` (cuDNN on the card) with no bias and no output
    padding, forward and backward under :func:`_ieee_fp32`: autograd runs
    the backward after the forward's scope has closed, so the flag is set
    again around ``convolution_backward``. bf16 accumulates in float32, as
    cuDNN does."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, dilation, transposed, groups):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, padding, dilation, transposed, groups)
        with _ieee_fp32(x):
            return torch.convolution(x, w, None, stride, padding, dilation,
                                     transposed, [0] * len(stride), groups)

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        stride, padding, dilation, transposed, groups = ctx.conf
        with _ieee_fp32(x):
            dx, dw, _ = torch.ops.aten.convolution_backward(
                grad.contiguous(), x, w, None, stride, padding, dilation,
                transposed, [0] * len(stride), groups,
                [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return dx, dw, None, None, None, None, None


def _channels_last(data_format) -> bool:
    return not str(data_format).startswith("NC")


def _add_bias(out, bias, nd):
    return out if bias is None else out + bias.reshape((1, -1) + (1,) * nd)


def _conv_nd(x, weight, bias, stride, padding, dilation, groups, nd,
             data_format):
    """Convolution of ``nd`` spatial dimensions, weight ``[out, in /
    groups, *k]`` in every layout. Uneven (or negative) padding is applied
    to the input first; the rest is cuDNN's symmetric padding."""
    stride, dilation = _pair(stride, nd), _pair(dilation, nd)
    last = _channels_last(data_format)
    a = torch.movedim(x, -1, 1) if last else x
    pads = _spatial_pads(padding, a.shape[2:], weight.shape[2:], stride,
                         dilation)
    sym = [max(min(lo, hi), 0) for lo, hi in pads]
    extra = [(lo - s, hi - s) for (lo, hi), s in zip(pads, sym)]
    if any(e != (0, 0) for e in extra):
        a = torch.constant_pad_nd(a, _pad_flat(extra), 0.0)
    out = _add_bias(_Convolution.apply(a, weight, list(stride), sym,
                                       list(dilation), False, int(groups)),
                    bias, nd)
    return torch.movedim(out, 1, -1) if last else out


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    """1-D convolution, weight ``[out, in / groups, k]``. ``padding``: an
    int, a list of 1 or 2 ints (lo, hi), pairs, ``"SAME"`` (``lax``'s
    rule at every stride) or ``"VALID"``. A float32 CUDA input runs without
    TF32 (:func:`_ieee_fp32`). ``"NLC"`` is channels last (the reference
    reads every 1-D input as ``"NCL"``)."""
    if amp_state() is not None:
        x, weight, bias = maybe_cast_inputs("conv1d", [x, weight, bias])
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 1,
                    data_format)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    """2-D convolution, weight ``[out, in / groups, kh, kw]`` in both
    layouts (``"NHWC"`` included, as the reference's OIHW -> HWIO).
    ``padding``: an int, 2 ints, 4 ints ``[top, bottom, left, right]``,
    pairs, ``"SAME"`` (``lax``'s rule at every stride) or ``"VALID"``.
    A float32 CUDA input runs in full float32, TF32 off under a local
    cuDNN flag (:func:`_ieee_fp32`); bf16 accumulates in float32."""
    if amp_state() is not None:
        x, weight, bias = maybe_cast_inputs("conv2d", [x, weight, bias])
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 2,
                    data_format)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    """3-D convolution, weight ``[out, in / groups, kd, kh, kw]``; the
    padding forms and the float32 rule of :func:`conv2d`. ``"NDHWC"`` is
    channels last (the reference reads every 3-D input as ``"NCDHW"``)."""
    if amp_state() is not None:
        x, weight, bias = maybe_cast_inputs("conv3d", [x, weight, bias])
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 3,
                    data_format)


def _conv_transpose_nd(x, weight, bias, stride, padding, output_padding,
                       dilation, groups, output_size, nd, data_format):
    """The reference's transposed convolution: the input dilated by the
    stride, padded ``(d (k - 1) - lo, d (k - 1) - hi + output_padding)``
    and convolved with the flipped kernel, weight ``[in, out / groups,
    *k]``. cuDNN's transposed convolution gives the fully padded output;
    the pads are then cropped (or zero-filled, where negative) from it
    before the bias. A string padding is taken at stride 1 only and with
    no ``output_padding``, as the reference's ``lax`` call allows.
    ``output_size`` sets ``output_padding`` to the difference from the
    size without it (the reference ignores ``output_size``)."""
    stride, dilation = _pair(stride, nd), _pair(dilation, nd)
    out_pad = list(_pair(output_padding, nd))
    last = _channels_last(data_format)
    a = torch.movedim(x, -1, 1) if last else x
    ks = tuple(int(k) for k in weight.shape[2:])
    full = [d * (k - 1) for d, k in zip(dilation, ks)]
    if isinstance(padding, str):
        if any(out_pad):
            raise NotImplementedError(
                "output_padding with string padding is not supported")
        if any(s != 1 for s in stride):
            raise ValueError("string padding is not implemented for a "
                             "transposed convolution with stride > 1")
        lax_pads = _spatial_pads(padding, a.shape[2:], ks, (1,) * nd,
                                 dilation)
        deltas = [(lo - f, hi - f) for (lo, hi), f in zip(lax_pads, full)]
    else:
        pads = _conv_padding(padding, nd)
        if output_size is not None:
            want = [int(v) for v in list(output_size)[-nd:]]
            base = [(n - 1) * s + 1 + f - lo - hi for n, s, f, (lo, hi)
                    in zip(a.shape[2:], stride, full, pads)]
            out_pad = [w - b for w, b in zip(want, base)]
            if any(not 0 <= p < max(s, d) for p, s, d
                   in zip(out_pad, stride, dilation)):
                raise ValueError(f"output_size {want} is not reachable "
                                 f"from {base} (output padding {out_pad})")
        deltas = [(-lo, -hi + op) for (lo, hi), op in zip(pads, out_pad)]
    out = _Convolution.apply(a, weight, list(stride), [0] * nd,
                             list(dilation), True, int(groups))
    if any(d != (0, 0) for d in deltas):
        out = torch.constant_pad_nd(out, _pad_flat(deltas), 0.0)
    out = _add_bias(out, bias, nd)
    return torch.movedim(out, 1, -1) if last else out


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1, output_size=None,
                     data_format="NCL", name=None):
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, dilation, groups, output_size,
                              1, data_format)


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     output_size=None, data_format="NCHW", name=None):
    """Transposed 2-D convolution, weight ``[in, out / groups, kh, kw]``
    (see :func:`_conv_transpose_nd`)."""
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, dilation, groups, output_size,
                              2, data_format)


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1, output_size=None,
                     data_format="NCDHW", name=None):
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, dilation, groups, output_size,
                              3, data_format)


# ------------------------------------------------------------------ pooling
def _window(kernel, stride, nd):
    k = _pair(kernel, nd)
    s = _pair(stride if stride is not None else kernel, nd)
    if len(k) != nd or len(s) != nd:
        raise ValueError(f"kernel {kernel} / stride {stride}: {nd} "
                         f"spatial dimensions")
    return k, s


def _pool_pads(padding, sizes, kernel, stride, ceil_mode):
    """The reference's pooling pads: ``"SAME"`` / ``"VALID"`` by ``lax``'s
    rule (``ceil_mode`` is then ignored), else an int or one int a
    dimension on both sides; ``ceil_mode`` adds to the high side only, so
    the last partial window is kept."""
    nd = len(sizes)
    if isinstance(padding, str):
        p = padding.upper()
        if p == "SAME":
            return _same_pads(sizes, kernel, stride, (1,) * nd)
        if p == "VALID":
            return [(0, 0)] * nd
        raise ValueError(f"unknown padding {padding!r}")
    p = _pair(padding, nd)
    if len(p) != nd:
        raise ValueError(f"padding {padding}: {nd} spatial dimensions")
    pads = [(v, v) for v in p]
    if ceil_mode:
        for i, n in enumerate(sizes):
            rem = (int(n) + 2 * p[i] - kernel[i]) % stride[i]
            if rem:
                pads[i] = (p[i], p[i] + stride[i] - rem)
    return pads


def _max_window(a, kernel, stride, pads):
    """Max over each window of channels-first ``a`` and the flat position
    of its maximum within the channel's (unpadded) spatial plane. Even
    pads within half the kernel are the library's own -inf padding;
    others pad with -inf first and map the positions back."""
    nd = len(kernel)
    op = getattr(torch.ops.aten, f"max_pool{nd}d_with_indices")
    if all(lo == hi and lo <= k // 2 for (lo, hi), k in zip(pads, kernel)):
        return op(a, list(kernel), list(stride), [lo for lo, _ in pads],
                  [1] * nd, False)
    ap = torch.constant_pad_nd(a, _pad_flat(pads), float("-inf"))
    out, idx = op(ap, list(kernel), list(stride), [0] * nd, [1] * nd, False)
    padded = ap.shape[2:]
    flat = torch.zeros_like(idx)
    rest = idx
    coords = []
    for n in reversed(padded):
        coords.append(rest % n)
        rest = rest // n
    for c, (lo, _), n in zip(reversed(coords), pads, a.shape[2:]):
        flat = flat * n + (c - lo)
    return out, flat


def _max_pool(x, kernel_size, stride, padding, ceil_mode, return_mask, nd,
              data_format):
    if return_mask and ceil_mode:
        raise NotImplementedError(
            "return_mask=True with ceil_mode=True is not supported yet")
    last = _channels_last(data_format)
    if return_mask and last:
        raise NotImplementedError(f"return_mask=True requires channels-first "
                                  f"layout, got {data_format}")
    k, s = _window(kernel_size, stride, nd)
    a = torch.movedim(x, -1, 1) if last else x
    out, idx = _max_window(a, k, s, _pool_pads(padding, a.shape[2:], k, s,
                                               ceil_mode))
    if return_mask:
        return out, idx.to(torch.int32)
    return torch.movedim(out, 1, -1) if last else out


def _avg_window(a, kernel, stride):
    nd = len(kernel)
    op = getattr(torch.ops.aten, f"avg_pool{nd}d")
    args = (list(kernel), list(stride), [0] * nd, False, True)
    return op(a, *args) if nd == 1 else op(a, *args, None)


def _avg_pool(x, kernel_size, stride, padding, ceil_mode, exclusive, nd,
              data_format):
    """The window's sum over the kernel size — with ``exclusive`` and any
    padding, over the count of real elements (the padding ``ceil_mode``
    adds not counted), as the reference's two ``reduce_window``\\ s."""
    last = _channels_last(data_format)
    k, s = _window(kernel_size, stride, nd)
    a = torch.movedim(x, -1, 1) if last else x
    pads = _pool_pads(padding, a.shape[2:], k, s, ceil_mode)
    padded = any(p != (0, 0) for p in pads)
    ap = torch.constant_pad_nd(a, _pad_flat(pads), 0.0) if padded else a
    out = _avg_window(ap, k, s)
    if padded and exclusive:
        ones = a.new_ones((1, 1) + tuple(a.shape[2:]))
        out = out / _avg_window(torch.constant_pad_nd(ones, _pad_flat(pads),
                                                      0.0), k, s)
    return torch.movedim(out, 1, -1) if last else out


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, name=None):
    return _max_pool(x, kernel_size, stride, padding, ceil_mode, return_mask,
                     1, "NCL")


def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCHW", name=None):
    """Max pooling; padded positions never win. ``return_mask`` adds the
    int32 flat position of each maximum within its channel's plane
    (channels first, no ``ceil_mode``, as in the reference)."""
    return _max_pool(x, kernel_size, stride, padding, ceil_mode, return_mask,
                     2, data_format)


def max_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCDHW", name=None):
    return _max_pool(x, kernel_size, stride, padding, ceil_mode, return_mask,
                     3, data_format)


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, name=None):
    return _avg_pool(x, kernel_size, stride, padding, ceil_mode, exclusive,
                     1, "NCL")


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    """Average pooling: ``exclusive`` divides by the real elements of a
    padded window, else by the kernel size. ``divisor_override`` is
    accepted and ignored, as in the reference."""
    return _avg_pool(x, kernel_size, stride, padding, ceil_mode, exclusive,
                     2, data_format)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    return _avg_pool(x, kernel_size, stride, padding, ceil_mode, exclusive,
                     3, data_format)


def _sizes_out(sizes, output_size):
    return [int(n) if o is None else int(o)
            for n, o in zip(sizes, output_size)]


def _by_matrices(a, outs):
    """Adaptive average pooling of every spatial dimension of
    channels-first ``a`` as one product each with its averaging matrix."""
    out = a
    for d, (n, o) in enumerate(zip(a.shape[2:], outs)):
        w = torch.as_tensor(_adaptive_avg(int(n), o), dtype=a.dtype,
                            device=a.device)
        out = torch.movedim(torch.tensordot(out, w, dims=([2 + d], [0])),
                            -1, 2 + d)
    return out


def _adaptive_max_bins(a, outs, return_mask=False):
    """Max over each adaptive bin of channels-first ``a`` (a loop over the
    bins) and, with ``return_mask``, the int32 flat position of each
    maximum within its channel's plane."""
    sizes = [int(n) for n in a.shape[2:]]
    bins = [_adaptive_bins(n, o) for n, o in zip(sizes, outs)]
    vals, idxs = [], []
    for cell in np.ndindex(*outs):
        sl = tuple(slice(bins[d][0][i], bins[d][1][i])
                   for d, i in enumerate(cell))
        blk = a[(slice(None), slice(None)) + sl]
        vals.append(torch.amax(blk, dim=tuple(range(2, a.dim()))))
        if return_mask:
            shape = blk.shape[2:]
            am = torch.argmax(blk.detach().reshape(blk.shape[:2] + (-1,)),
                              dim=2)
            flat = torch.zeros_like(am)
            for d in range(len(shape)):
                stride = int(np.prod(shape[d + 1:], dtype=np.int64))
                local = (am // stride) % shape[d]
                flat = flat * sizes[d] + local + bins[d][0][cell[d]]
            idxs.append(flat)
    out = torch.stack(vals, dim=-1).reshape(a.shape[:2] + tuple(outs))
    if not return_mask:
        return out
    idx = torch.stack(idxs, dim=-1).reshape(a.shape[:2] + tuple(outs))
    return out, idx.to(torch.int32)


def _divides(sizes, outs) -> bool:
    return all(int(n) % o == 0 for n, o in zip(sizes, outs))


def adaptive_avg_pool1d(x, output_size, name=None):
    o = [output_size if _is_int(output_size) else output_size[0]]
    n = int(x.shape[2])
    if n % o[0] == 0:
        return _avg_window(x, (n // o[0],), (n // o[0],))
    return _by_matrices(x, o)


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    """Adaptive average pooling: windows of ``n / out`` where the output
    divides the input, else a product with each dimension's averaging
    matrix (the reference's bins). None in ``output_size`` keeps that
    dimension."""
    last = _channels_last(data_format)
    a = torch.movedim(x, -1, 1) if last else x
    outs = _sizes_out(a.shape[2:], _pair(output_size))
    if _divides(a.shape[2:], outs):
        k = [int(n) // o for n, o in zip(a.shape[2:], outs)]
        out = _avg_window(a, k, k)
    else:
        out = _by_matrices(a, outs)
    return torch.movedim(out, 1, -1) if last else out


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    """By the averaging matrices at every size, as the reference."""
    return _by_matrices(x, _sizes_out(x.shape[2:], _pair(output_size, 3)))


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    o = output_size if _is_int(output_size) else output_size[0]
    return _adaptive_max_bins(x, [int(o)], return_mask)


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    """Adaptive max pooling (channels first). ``return_mask`` is accepted
    and ignored: the reference returns the pooled values only."""
    outs = _sizes_out(x.shape[2:], _pair(output_size))
    if _divides(x.shape[2:], outs):
        k = [int(n) // o for n, o in zip(x.shape[2:], outs)]
        return _max_window(x, k, k, [(0, 0)] * 2)[0]
    return _adaptive_max_bins(x, outs)


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    return _adaptive_max_bins(x, _sizes_out(x.shape[2:],
                                            _pair(output_size, 3)),
                              return_mask)


def _max_unpool_nd(x, indices, kernel_size, stride, padding, output_size,
                   nd):
    """Each pooled value written back at its flat position of a zero
    plane of ``output_size`` (default ``(n - 1) s - 2 p + k``); a
    position outside the plane is dropped."""
    k, s = _window(kernel_size, stride, nd)
    p = _pair(padding, nd)
    if output_size is not None:
        sizes = list(output_size)
        out_sp = tuple(int(v) for v in (sizes[-nd:] if len(sizes) > nd
                                        else sizes))
    else:
        out_sp = tuple((int(n) - 1) * s[i] - 2 * p[i] + k[i]
                       for i, n in enumerate(x.shape[2:]))
    n, c = x.shape[0], x.shape[1]
    size = int(np.prod(out_sp))
    idx = indices.reshape(n, c, -1).long()
    # a position outside the plane is dropped, as the reference's scatter
    # drops it: it lands in a spare slot that is cut away
    idx = torch.where((idx >= 0) & (idx < size), idx,
                      torch.full_like(idx, size))
    flat = x.new_zeros((n, c, size + 1)).scatter(2, idx,
                                                 x.reshape(n, c, -1))
    return flat[:, :, :size].reshape((n, c) + out_sp)


def max_unpool1d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCL", output_size=None, name=None):
    return _max_unpool_nd(x, indices, kernel_size, stride, padding,
                          output_size, 1)


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
    return _max_unpool_nd(x, indices, kernel_size, stride, padding,
                          output_size, 2)


def max_unpool3d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCDHW", output_size=None, name=None):
    return _max_unpool_nd(x, indices, kernel_size, stride, padding,
                          output_size, 3)


# ------------------------------------------------------------------ vision
def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    """col2im: ``[N, C * kh * kw, L]`` -> ``[N, C, H, W]``, overlapping
    patches summed, the padding cropped."""
    oh, ow = _pair(output_sizes)
    kh, kw = _pair(kernel_sizes)
    sh, sw = _pair(strides)
    ph, pw = _pair(paddings)
    dh, dw = _pair(dilations)
    n, ckk, _ = x.shape
    c = ckk // (kh * kw)
    nh = (oh + 2 * ph - (dh * (kh - 1) + 1)) // sh + 1
    nw = (ow + 2 * pw - (dw * (kw - 1) + 1)) // sw + 1
    a = x.reshape(n, c, kh, kw, nh, nw)
    out = x.new_zeros((n, c, oh + 2 * ph, ow + 2 * pw))
    for i in range(kh):
        for j in range(kw):
            rows = slice(i * dh, i * dh + sh * (nh - 1) + 1, sh)
            cols = slice(j * dw, j * dw + sw * (nw - 1) + 1, sw)
            out[:, :, rows, cols] = out[:, :, rows, cols] + a[:, :, i, j]
    return out[:, :, ph:ph + oh, pw:pw + ow]


def affine_grid(theta, out_shape, align_corners=True, name=None):
    """The sampling grid ``[N, H, W, 2]`` of affine matrices ``[N, 2, 3]``
    over ``[-1, 1]`` (pixel corners with ``align_corners``, else pixel
    centres), in ``theta``'s dtype (the reference's comes out float64
    under its x64 mode)."""
    n, _, h, w = [int(s) for s in out_shape]

    def coords(size):
        if align_corners:
            return np.linspace(-1.0, 1.0, size)
        step = 2.0 / size
        return np.linspace(-1.0 + step / 2, 1.0 - step / 2, size)

    gx, gy = np.meshgrid(coords(w), coords(h))
    base = np.stack([gx, gy, np.ones_like(gx)], axis=-1).reshape(-1, 3)
    base = torch.as_tensor(base, dtype=theta.dtype, device=theta.device)
    grid = torch.einsum("hk,nok->nho", base, theta)
    return grid.reshape(n, h, w, 2)


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    """Bilinear sampling of ``x [N, C, H, W]`` at ``grid [N, Ho, Wo, 2]``
    (x, y in ``[-1, 1]``), positions outside the input reading 0.
    ``mode`` and ``padding_mode`` are accepted and ignored: the
    reference samples bilinearly with zero padding whatever they say.
    ``align_corners`` defaults to True, as in Paddle."""
    n, c, h, w = x.shape
    gx, gy = grid[..., 0], grid[..., 1]
    if align_corners:
        gx, gy = (gx + 1) * (w - 1) / 2, (gy + 1) * (h - 1) / 2
    else:
        gx, gy = ((gx + 1) * w - 1) / 2, ((gy + 1) * h - 1) / 2
    x0 = torch.floor(gx).to(torch.int64)
    y0 = torch.floor(gy).to(torch.int64)
    x1, y1 = x0 + 1, y0 + 1
    rows = torch.arange(n, device=x.device)[:, None, None]

    def sample(yy, xx):
        valid = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        v = x[rows, :, yy.clamp(0, h - 1), xx.clamp(0, w - 1)]
        return torch.where(valid[..., None], v, _zero(v))

    wx, wy = gx - x0, gy - y0
    out = (sample(y0, x0) * ((1 - wx) * (1 - wy))[..., None]
           + sample(y0, x1) * (wx * (1 - wy))[..., None]
           + sample(y1, x0) * ((1 - wx) * wy)[..., None]
           + sample(y1, x1) * (wx * wy)[..., None])
    return out.permute(0, 3, 1, 2)


def temporal_shift(x, seg_num, shift_ratio=0.25, data_format="NCHW",
                   name=None):
    """TSM's shift along time of ``[N * T, C, H, W]``: the first
    ``C * shift_ratio`` channels move one segment back, the next as many
    one forward, zeros entering."""
    nt, c, h, w = x.shape
    a = x.reshape(nt // seg_num, seg_num, c, h, w)
    f = int(c * shift_ratio)
    back = torch.cat([a[:, 1:, :f], torch.zeros_like(a[:, :1, :f])], dim=1)
    fwd = torch.cat([torch.zeros_like(a[:, :1, f:2 * f]),
                     a[:, :-1, f:2 * f]], dim=1)
    return torch.cat([back, fwd, a[:, :, 2 * f:]], dim=2).reshape(nt, c, h,
                                                                  w)


# ------------------------------------------------------------------ fused heads
def _logits(h, w, transpose_y: bool):
    """float32 logits ``h @ w`` (``h @ wᵀ`` with ``transpose_y``).

    The reference asks the matrix unit for float32 accumulation of bf16
    inputs (``preferred_element_type=jnp.float32``). The port does the same
    on the card: a bfloat16 or float16 product on CUDA is one cuBLAS call
    with float32 accumulation and a float32 result (``torch.mm`` with
    ``out_dtype``); elsewhere, and for float32 inputs, the inputs are cast
    to float32 first — products of bf16 values are exact in float32, so
    the two differ only in summation order. Float64 inputs give float64
    logits (the reference's float32 request rounds them: a float64 model
    of the port stays float64 throughout, so that the card and the CPU
    agree to float64 rounding)."""
    wt = w.t() if transpose_y else w
    if h.dtype == wt.dtype == torch.float64:
        return torch.mm(h, wt)
    if h.device.type == "cuda" and h.dtype in (torch.bfloat16, torch.float16):
        return torch.mm(h, wt, out_dtype=torch.float32)
    return torch.mm(h.float(), wt.float())


def _split_bf16(x):
    """float32 ``x`` as two bfloat16 parts ``hi + lo``: ``hi`` is ``x``
    rounded, ``lo`` the rest rounded (16 significant bits in all)."""
    hi = x.to(torch.bfloat16)
    # one pass, no float32 temporary: hi widens and the difference rounds
    # inside the subtraction
    return hi, torch.sub(x, hi, out=torch.empty_like(hi))


def _ce_input_grads(grad, h, w, transpose_y: bool, need_dh: bool,
                    need_dw: bool):
    """``(dh, dw)`` from the float32 logit gradient ``grad [rows, vocab]``,
    each formed in float32 and rounded once to its input's dtype, as the
    reference's transposed float32-accumulating product does.

    On the card with bf16 inputs the float32 gradient is split into bf16
    ``hi + lo`` parts and each result is the float32 sum of two bf16
    tensor-core products (float32 accumulation): the products see 16 of
    the gradient's 24 significant bits. One TF32 product would see 11
    and cost less (PERF.md §6), but its bf16 results would stray
    further from the float32 product rounded once, the reference's.
    Elsewhere the products take the gradient's dtype: float32, float64
    for float64 inputs (see :func:`_logits`)."""
    dh = dw = None
    wt = w if transpose_y else w.t()          # [vocab, in]
    if h.device.type == "cuda" and h.dtype == w.dtype == torch.bfloat16:
        parts = _split_bf16(grad)
        if need_dh:
            dh = sum(torch.mm(g, wt, out_dtype=torch.float32)
                     for g in parts).to(h.dtype)
        if need_dw:
            dw = sum(torch.mm(g.t(), h, out_dtype=torch.float32)
                     for g in parts)
    else:
        if need_dh:
            dh = (grad @ wt.to(grad.dtype)).to(h.dtype)
        if need_dw:
            dw = grad.t() @ h.to(grad.dtype)
    if dw is not None:
        dw = (dw if transpose_y else dw.t()).to(w.dtype)
    return dh, dw


class _ChunkCrossEntropy(torch.autograd.Function):
    """One chunk of rows: ``(sum of (logsumexp - target logit) over valid
    rows, number of valid rows)``. The ``[chunk, vocab]`` logits are not
    saved: the backward recomputes them, so at most one such block is live
    at a time — what ``jax.checkpoint`` does around the reference's chunk
    (``torch.utils.checkpoint`` cannot serve here: the float32-output
    product has no autograd formula).

    The reference's logsumexp and its derivative, in its order of
    operations: the forward forms the row max ``m`` (0 where not finite)
    and ``S = sum(exp(logits - m))``, ``lse = log(S) + m``, and keeps
    ``m`` and ``S``; the backward forms ``exp(logits - m) * (g / S)`` from
    the recomputed logits with ``-g`` added at the target (``g`` the
    chunk's loss cotangent on valid rows, 0 elsewhere), all in float32;
    ``dh`` and ``dw`` are formed from that float32 gradient and rounded
    once (:func:`_ce_input_grads`)."""

    @staticmethod
    def forward(ctx, h, w, label, transpose_y, ignore_index):
        logits = _logits(h, w, transpose_y)
        m = logits.amax(dim=-1, keepdim=True)
        m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        total = torch.exp(logits - m).sum(dim=-1, keepdim=True)
        lse = (torch.log(total) + m)[:, 0]
        valid = label != ignore_index
        safe = torch.where(valid, label, torch.zeros_like(label)).long()
        tgt = logits.gather(1, safe[:, None])[:, 0]
        loss = torch.where(valid, lse - tgt, torch.zeros_like(lse)).sum()
        count = valid.sum(dtype=torch.float32)
        ctx.save_for_backward(h, w, label, m, total)
        ctx.transpose_y, ctx.ignore_index = transpose_y, ignore_index
        ctx.mark_non_differentiable(count)
        return loss, count

    @staticmethod
    def backward(ctx, g_loss, _g_count):
        h, w, label, m, total = ctx.saved_tensors
        # d(lse - tgt)/dlogits = softmax - onehot(label), on valid rows
        grad = _logits(h, w, ctx.transpose_y)
        grad.sub_(m).exp_()
        valid = label != ctx.ignore_index
        safe = torch.where(valid, label, torch.zeros_like(label)).long()
        g = torch.where(valid, g_loss, torch.zeros_like(g_loss))[:, None]
        grad.mul_(g / total)
        grad.scatter_add_(1, safe[:, None], -g)
        dh, dw = _ce_input_grads(grad, h, w, ctx.transpose_y,
                                 ctx.needs_input_grad[0],
                                 ctx.needs_input_grad[1])
        return dh, dw, None, None, None


def linear_cross_entropy(hidden, weight, label, transpose_y=False,
                         chunk_size=256, ignore_index=-100, name=None):
    """Fused LM-head projection + softmax cross-entropy, chunked over rows.

    ``hidden`` ``[..., in_features]``; ``weight`` ``[in_features, vocab]``
    or, with ``transpose_y``, ``[vocab, in_features]`` (the tied
    embedding, and the port's ``nn.Linear`` head); ``label`` integer
    targets with one per row of ``hidden``. Each chunk of ``chunk_size``
    rows forms its float32 logits, reduces them to logsumexp minus the
    target logit (ignored labels count 0) and drops them; the backward
    recomputes them. Returns the mean over valid rows (a float32 scalar;
    float64 for float64 inputs, see :func:`_logits`)."""
    h2 = hidden.reshape(-1, hidden.shape[-1])
    lab = label.reshape(-1)
    if lab.numel() != h2.shape[0]:
        raise ValueError(f"label has {lab.numel()} elements for "
                         f"{h2.shape[0]} rows of hidden")
    n = h2.shape[0]
    c = min(int(chunk_size), n)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    count = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for start in range(0, n, c):
        loss_c, count_c = _ChunkCrossEntropy.apply(
            h2[start:start + c], weight, lab[start:start + c],
            bool(transpose_y), int(ignore_index))
        total = total + loss_c
        count = count + count_c
    return total / torch.clamp(count, min=1.0)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None):
    """Attention over ``[b, h, s, d]`` through ``kernels.attention.sdpa``:
    with no mask a CUDA tensor runs the flash kernel, a CPU tensor its
    plain version; with a mask, the composite.

    ``dropout_p > 0`` in training applies :func:`dropout` to the attention
    output ``[b, h, s, d]``, as the reference does (its attention
    probabilities are not dropped). The reference's sequence-parallel
    branch (ring attention) is ROADMAP Queue 1 item 12; the port has no
    sequence-parallel scope yet."""
    if amp_state() is not None:
        query, key, value, attn_mask = maybe_cast_inputs(
            "scaled_dot_product_attention", [query, key, value, attn_mask])
    out = attention.sdpa(query, key, value, attn_mask, is_causal=is_causal)
    if dropout_p > 0.0 and training:
        out = dropout(out, dropout_p, training=training)
    return out


# ------------------------------------------------------------------ losses 2
def _heap_paths(num_classes):
    """Each class's path in the default complete binary tree (leaf ``c +
    num_classes`` of the implicit heap, root first): internal node ids
    (0-based) and branch codes (1 right, -1 an unused slot)."""
    depth = int(np.ceil(np.log2(max(num_classes, 2))))
    tables = np.zeros((num_classes, depth), np.int64)
    codes = np.full((num_classes, depth), -1, np.int64)
    for c in range(num_classes):
        node, path = c + num_classes, []
        while node > 1:
            path.append((node // 2, node % 2))
            node //= 2
        for d, (nid, code) in enumerate(reversed(path)):
            tables[c, d] = nid - 1
            codes[c, d] = code
    return tables, codes


def hsigmoid_loss(input, label, num_classes, weight, bias=None,  # noqa: A002
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """Hierarchical sigmoid over the default complete binary tree: the sum
    of the binary cross-entropies of the class's path, ``[B, 1]``. Custom
    trees (``path_table`` / ``path_code``) are not supported, as in the
    reference."""
    if path_table is not None or path_code is not None:
        raise NotImplementedError(
            "custom trees (path_table/path_code) are not supported yet")
    tables, codes = _heap_paths(int(num_classes))
    y = label.reshape(-1).long().cpu().numpy()
    nodes = torch.as_tensor(tables[y], device=input.device)
    code = torch.as_tensor(codes[y], device=input.device)
    logits = torch.einsum("bdf,bf->bd", weight[nodes], input)
    if bias is not None:
        logits = logits + bias.reshape(-1)[nodes]
    valid = code >= 0
    t = torch.where(valid, code, torch.zeros_like(code)).to(input.dtype)
    ce = torch.clamp(logits, min=0) - logits * t + torch.log1p(
        torch.exp(-torch.abs(logits)))
    return torch.where(valid, ce, _zero(ce)).sum(dim=1, keepdim=True)


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """CTC's negative log-likelihood. ``log_probs [T, B, C]`` are logits,
    normalised inside by ``log_softmax``; ``labels [B, L]`` padded past
    ``label_lengths``. The alpha recursion over the blank-interleaved label
    row runs a step of time at a time, every row masked in lockstep.
    ``norm_by_times`` divides each row's loss by its input length;
    ``"mean"`` divides by the label length, then averages the batch."""
    lp = torch.log_softmax(log_probs, dim=-1)
    T, B, _ = lp.shape
    lab = labels.long()
    in_len, lab_len = input_lengths.long(), label_lengths.long()
    L = lab.shape[1]
    S = 2 * L + 1
    neg = torch.full((), -1e30, dtype=lp.dtype, device=lp.device)
    ext = torch.full((B, S), int(blank), dtype=torch.int64,
                     device=lp.device)
    ext[:, 1::2] = lab
    s_idx = torch.arange(S, device=lp.device)
    valid = s_idx[None, :] < (2 * lab_len[:, None] + 1)
    ext_m2 = torch.cat([torch.full((B, 2), -1, dtype=torch.int64,
                                   device=lp.device), ext[:, :-2]], dim=1)
    can_skip = (ext != blank) & (ext != ext_m2)
    alpha = torch.where(s_idx[None, :] < 2, torch.gather(lp[0], 1, ext), neg)
    alpha = torch.where(valid, alpha, neg)
    alphas = [alpha]
    for t in range(1, T):
        a1 = torch.cat([neg.expand(B, 1), alpha[:, :-1]], dim=1)
        a2 = torch.cat([neg.expand(B, 2), alpha[:, :-2]], dim=1)
        a2 = torch.where(can_skip, a2, neg)
        merged = torch.logaddexp(torch.logaddexp(alpha, a1), a2)
        alpha = torch.where(valid, merged + torch.gather(lp[t], 1, ext), neg)
        alphas.append(alpha)
    alphas = torch.stack(alphas)
    rows = torch.arange(B, device=lp.device)
    final = alphas[torch.clamp(in_len - 1, 0, T - 1), rows]
    end1 = (2 * lab_len)[:, None]
    end2 = torch.clamp(2 * lab_len - 1, min=0)[:, None]
    ll = torch.logaddexp(
        torch.gather(final, 1, end1),
        torch.where((lab_len > 0)[:, None], torch.gather(final, 1, end2),
                    neg))[:, 0]
    loss = -ll
    if norm_by_times:
        loss = loss / torch.clamp(in_len.to(loss.dtype), min=1.0)
    if reduction == "mean":
        return torch.mean(loss / torch.clamp(lab_len.to(loss.dtype),
                                             min=1.0))
    if reduction == "sum":
        return loss.sum()
    return loss


def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5,
                         margin3=0.0, scale=64.0, group=None,
                         return_softmax=False, reduction="mean"):
    """ArcFace's margin softmax on cosines: the target's becomes ``cos(m1
    theta + m2) - m3``, every logit scaled by ``scale``; one process (the
    reference's single-shard form)."""
    theta = torch.arccos(torch.clamp(logits, -1.0, 1.0))
    tgt = torch.cos(margin1 * theta + margin2) - margin3
    classes = torch.arange(logits.shape[-1], device=logits.device)
    onehot = (label.reshape(logits.shape[:-1]).long()[..., None]
              == classes).to(logits.dtype)
    out = scale * torch.where(onehot > 0, tgt, logits)
    loss = torch.logsumexp(out, dim=-1) - (out * onehot).sum(-1)
    if reduction == "mean":
        loss = loss.mean()
    elif reduction == "sum":
        loss = loss.sum()
    if return_softmax:
        return loss, torch.softmax(out, dim=-1)
    return loss


def class_center_sample(label, num_classes, num_samples, group=None):
    """PartialFC's sampling of class centres: every positive class, then
    ``num_samples`` less as many negatives drawn without replacement by
    numpy's ``RandomState`` seeded from the process generator's next key
    (the reference's ``randint(key, (), 0, 2**31 - 1)``, the same bits).
    Returns the labels remapped into the sorted sample, and the sample."""
    from .._device import resolve_device
    from ..core.rng import default_generator
    from ..core.tensor import as_port
    from ..tensor_ops.random import _randint_words

    dev = label.device if isinstance(label, torch.Tensor) else \
        resolve_device(None)
    y = (label.detach().cpu().numpy() if isinstance(label, torch.Tensor)
         else np.asarray(label))
    pos = np.unique(y)
    rest = np.setdiff1d(np.arange(num_classes), pos)
    seed = int(_randint_words(default_generator().next_key(), (1,), 0,
                              2 ** 31 - 1, torch.int64)[0])
    rng = np.random.RandomState(seed)
    n_extra = max(int(num_samples) - pos.size, 0)
    extra = rng.choice(rest, size=min(n_extra, rest.size), replace=False) \
        if n_extra else np.empty((0,), pos.dtype)
    sampled = np.sort(np.concatenate([pos, extra]).astype(np.int64))
    remap = {c: i for i, c in enumerate(sampled.tolist())}
    y_remap = np.asarray([remap[v] for v in y.tolist()], np.int64)
    return (as_port(torch.as_tensor(y_remap, device=dev)),
            as_port(torch.as_tensor(sampled, device=dev)))


def sparse_attention(query, key, value, sparse_csr_offset,
                     sparse_csr_columns, key_padding_mask=None,
                     attn_mask=None, name=None):
    """Attention of ``[b, h, s, d]`` restricted to a CSR pattern, which may
    differ per (batch, head): dense scores masked outside the pattern,
    as the reference computes it (plain JAX there, no Pallas kernel).
    Entries past a row's last offset are dropped. ``key_padding_mask``
    and ``attn_mask`` are accepted and ignored, as in the reference."""
    b, h, s, d = query.shape
    logits = torch.einsum("bhqd,bhkd->bhqk", query, key) / torch.sqrt(
        torch.tensor(float(d), dtype=query.dtype, device=query.device))
    off = sparse_csr_offset.long()
    cols = sparse_csr_columns.long()
    nnz = torch.arange(cols.shape[-1], device=cols.device).expand(
        cols.shape).contiguous()
    rows = torch.searchsorted(off.contiguous(), nnz, right=True) - 1
    keep = (rows >= 0) & (rows < s)
    bi = torch.arange(b, device=cols.device)[:, None, None].expand(
        cols.shape)
    hi = torch.arange(h, device=cols.device)[None, :, None].expand(
        cols.shape)
    mask = torch.zeros((b, h, s, s), dtype=torch.bool, device=query.device)
    mask[bi[keep], hi[keep], rows[keep], cols[keep]] = True
    logits = torch.where(mask, logits, torch.full((), -1e30,
                                                  dtype=logits.dtype,
                                                  device=logits.device))
    probs = torch.where(mask, torch.softmax(logits, dim=-1), _zero(logits))
    return torch.einsum("bhqk,bhkd->bhqd", probs, value)


def gather_tree(ids, parents):
    """Beam search's backtracking (:func:`..decode.gather_tree`)."""
    from .decode import gather_tree as _gather_tree

    return _gather_tree(ids, parents)
