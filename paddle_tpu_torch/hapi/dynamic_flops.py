"""``paddle.flops`` — the port of ``paddle_tpu/hapi/dynamic_flops.py``:
per-layer FLOP accounting through forward hooks, with the reference's
count for each layer type. One forward on a zeros input (on the
network's device) records each leaf layer's input and output shapes.
Returns the total; ``print_detail`` prints a per-layer table. A static
``Program`` (``hapi.static_flops``) is ROADMAP Queue 1 item 12f.
"""
from __future__ import annotations

import numpy as np
import torch


def _numel(shape):
    n = 1
    for s in shape:
        n *= int(s)
    return n


def _count(layer, x_shape, y_shape):
    """Op count for one layer call, by type — the reference convention is
    MACs WITHOUT doubling for linear/conv (dynamic_flops.py count_linear:
    total_mul * num_elements; count_convNd: y.numel() * (in/groups * prod(k)),
    reference lines 123-150), and elementwise counts for norm/activation."""
    from .. import nn

    if isinstance(layer, nn.Linear):
        return _numel(x_shape[:-1]) * layer.weight.shape[0] * layer.weight.shape[1]
    if isinstance(layer, (nn.Conv2D, nn.Conv1D, nn.Conv3D)):
        w = layer.weight  # [out_c, in_c/groups, *k]
        macs_per_out = _numel(w.shape[1:])
        return _numel(y_shape) * macs_per_out
    if isinstance(layer, (nn.Conv2DTranspose, nn.Conv1DTranspose,
                          nn.Conv3DTranspose)):
        # transpose weights are [in, out/groups, *k]: each output element
        # sums over in_channels/groups * prod(k) taps
        w = layer.weight
        groups = getattr(layer, "_groups", 1)
        macs_per_out = (w.shape[0] // groups) * _numel(w.shape[2:])
        return _numel(y_shape) * macs_per_out
    if isinstance(layer, (nn.BatchNorm, nn.BatchNorm1D, nn.BatchNorm2D,
                          nn.BatchNorm3D, nn.LayerNorm, nn.GroupNorm,
                          nn.InstanceNorm1D, nn.InstanceNorm2D,
                          nn.InstanceNorm3D)):
        return 2 * _numel(y_shape)
    if isinstance(layer, (nn.ReLU, nn.ReLU6, nn.GELU, nn.Sigmoid, nn.Tanh,
                          nn.LeakyReLU, nn.Hardswish, nn.Hardsigmoid,
                          nn.Silu, nn.PReLU, nn.ELU, nn.Softmax)):
        return _numel(y_shape)
    if isinstance(layer, (nn.AvgPool1D, nn.AvgPool2D, nn.MaxPool1D,
                          nn.MaxPool2D, nn.AdaptiveAvgPool1D,
                          nn.AdaptiveAvgPool2D, nn.AdaptiveMaxPool2D)):
        return _numel(y_shape)
    if isinstance(layer, nn.Embedding):
        return 0
    return 0


def flops(net, input_size=None, custom_ops=None, print_detail=False):
    """Total forward FLOPs of `net` on `input_size` (list incl. batch dim).
    A static Program counts through hapi.static_flops (reference
    hapi/dynamic_flops.py flops() dispatches the same way)."""
    if not isinstance(net, torch.nn.Module):
        raise NotImplementedError(
            f"flops of a {type(net).__name__}: the port counts dygraph "
            f"layers; a static Program (hapi.static_flops) is ROADMAP "
            f"Queue 1 item 12f")

    from ..core.tensor import to_tensor

    rows = []
    total = [0]
    custom_ops = custom_ops or {}

    hooks = []

    def make_hook(layer):
        def hook(lyr, inputs, output):
            if lyr._modules:  # only count leaves
                return
            x_shape = list(inputs[0].shape) if inputs else []
            y = output[0] if isinstance(output, (tuple, list)) else output
            y_shape = list(y.shape) if isinstance(y, torch.Tensor) else []
            fn = custom_ops.get(type(lyr))
            n = int(fn(lyr, x_shape, y_shape)) if fn else _count(lyr, x_shape, y_shape)
            total[0] += n
            params = sum(int(np.prod(tuple(p.shape)))
                         for p in lyr.parameters(include_sublayers=False))
            rows.append((type(lyr).__name__, x_shape, y_shape, params, n))

        return hook

    for lyr in net.sublayers(include_self=True):
        hooks.append(lyr.register_forward_post_hook(make_hook(lyr)))

    was_training = net.training
    net.eval()
    try:
        device = next((p.device for p in net.parameters()), None)
        x = to_tensor(np.zeros(list(input_size), np.float32), place=device)
        net(x)
    finally:
        for h in hooks:
            h.remove()
        if was_training:
            net.train()

    if print_detail:
        print(f"{'Layer':<24}{'Input':<20}{'Output':<20}{'Params':>10}{'FLOPs':>14}")
        for name, xs, ys, p, n in rows:
            print(f"{name:<24}{str(xs):<20}{str(ys):<20}{p:>10}{n:>14}")
        print(f"Total FLOPs: {total[0]}")
    return total[0]
