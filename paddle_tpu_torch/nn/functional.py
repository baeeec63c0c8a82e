"""``nn.functional`` — the port of ``paddle_tpu/nn/functional.py``:
activations, ``linear`` and ``embedding``, dropout, the norms, the
losses and the shape functions the layers of ``nn`` call, each with the
reference's signature and defaults and computed in the reference's order
of operations. Conv, pooling, unpooling, ``fold``, ``grid_sample``,
``affine_grid``, ``ctc_loss``, ``hsigmoid_loss``,
``margin_cross_entropy``, ``class_center_sample``, ``sparse_attention``,
``temporal_shift`` and ``gather_tree`` are ROADMAP Queue 1 item 12b-2.

Plain functions on ``torch.Tensor``\\ s, differentiable by autograd. Four
reach the port's Hopper kernels on CUDA tensors (their plain versions on
CPU tensors): ``layer_norm`` (the LayerNorm kernels),
``scaled_dot_product_attention`` with no mask (flash attention),
``dropout`` and its broadcast forms (the dropout kernel);
``linear_cross_entropy`` is the fused, chunked LM head. The rest are
torch's element-wise and reduction operators: the port takes nothing
from ``torch.nn.functional`` but ``linear``, ``gelu`` and ``embedding``.

Random functions (``dropout``, ``alpha_dropout``, ``rrelu``,
``gumbel_softmax``) take the next key of the key schedule
(``core.rng.next_rng_key``) and draw as the reference does, with the
port's threefry.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.nn import functional as TF

from .. import random as prng
from ..core.rng import next_rng_key
from ..kernels import attention
from ..kernels import dropout as _dropout
from ..kernels.fused_layernorm import fused_layer_norm

__all__ = [
    "relu", "relu6", "gelu", "sigmoid", "tanh", "softmax", "log_softmax",
    "leaky_relu", "elu", "selu", "silu", "swish", "hardswish", "hardsigmoid",
    "hardtanh", "mish", "softplus", "softsign", "tanhshrink", "softshrink",
    "hardshrink", "prelu", "glu", "maxout",
    "linear",
    "batch_norm", "layer_norm", "group_norm", "instance_norm",
    "local_response_norm",
    "embedding", "dropout", "dropout2d", "dropout3d", "alpha_dropout",
    "cross_entropy", "softmax_with_cross_entropy", "linear_cross_entropy",
    "mse_loss", "l1_loss",
    "nll_loss", "binary_cross_entropy", "binary_cross_entropy_with_logits",
    "smooth_l1_loss", "kl_div", "margin_ranking_loss", "hinge_embedding_loss",
    "cosine_similarity", "normalize", "label_smooth", "one_hot", "pad",
    "interpolate", "upsample", "pixel_shuffle", "unfold",
    "scaled_dot_product_attention", "sequence_mask",
    "temperature_scaled_softmax", "rrelu", "celu", "logsigmoid",
    "gumbel_softmax", "square_error_cost",
    # beyond the reference's __all__, defined in its module
    "bilinear", "channel_shuffle", "diag_embed", "dice_loss", "elu_",
    "log_loss", "log_sigmoid", "npair_loss", "pixel_unshuffle", "relu_",
    "sigmoid_focal_loss", "softmax_", "tanh_", "thresholded_relu",
    "zeropad2d",
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
    (1 - momentum) * batch``, the variance unbiased."""
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
    other form is the reference's composite on either device —
    ``(x - mean) * rsqrt(var + epsilon)`` over float32 statistics, times
    the weight and plus the bias where given, cast to x's dtype — as the
    reference takes XLA there."""
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    nd = len(tuple(normalized_shape))
    d = x.shape[-1]
    if nd == 1 and weight is not None and bias is not None \
            and tuple(weight.shape) == tuple(bias.shape) == (d,) \
            and weight.dtype == bias.dtype:
        return fused_layer_norm(x, weight, bias, epsilon)
    dims = tuple(range(x.dim() - nd, x.dim()))
    xf = x.float()
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
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis)
    if loss.dim() < logits.dim():
        loss = loss.unsqueeze(axis)
    if return_softmax:
        return loss, softmax(logits, axis=axis)
    return loss


def mse_loss(input, label, reduction="mean", name=None):  # noqa: A002
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


def _adaptive_avg(n_in, n_out):
    """``[n_in, n_out]`` averaging weights of adaptive pooling: bin ``i``
    covers ``[floor(i n_in / n_out), ceil((i + 1) n_in / n_out))``."""
    w = np.zeros((n_in, n_out))
    for i in range(n_out):
        s, e = (i * n_in) // n_out, -(-((i + 1) * n_in) // n_out)
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
    if isinstance(v, (list, tuple)):
        return tuple(int(i) for i in v)
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


# ------------------------------------------------------------------ fused heads
def _logits(h, w, transpose_y: bool):
    """float32 logits ``h @ w`` (``h @ wᵀ`` with ``transpose_y``).

    The reference asks the matrix unit for float32 accumulation of bf16
    inputs (``preferred_element_type=jnp.float32``). The port does the same
    on the card: a bfloat16 or float16 product on CUDA is one cuBLAS call
    with float32 accumulation and a float32 result (``torch.mm`` with
    ``out_dtype``); elsewhere, and for float32 inputs, the inputs are cast
    to float32 first — products of bf16 values are exact in float32, so
    the two differ only in summation order."""
    wt = w.t() if transpose_y else w
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
    Elsewhere the products are float32."""
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
            dh = (grad @ wt.float()).to(h.dtype)
        if need_dw:
            dw = grad.t() @ h.float()
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
    recomputes them. Returns the mean over valid rows (float32 scalar)."""
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
    out = attention.sdpa(query, key, value, attn_mask, is_causal=is_causal)
    if dropout_p > 0.0 and training:
        out = dropout(out, dropout_p, training=training)
    return out
