"""MobileNetV3 — the port of ``paddle_tpu/vision/models/mobilenetv3.py``:
``MobileNetV3Large`` and ``MobileNetV3Small``: inverted residuals with
squeeze-excitation (Hardsigmoid) and Hardswish, at a width ``scale``.
Built from the port's ``nn`` layers in the reference's order, so that
``seed(s)`` draws the reference's initial weights and the reference's
``state_dict()`` loads with ``set_state_dict``. NCHW, as in the
reference. ``pretrained`` is accepted and ignored, as in the reference
(no weights are in the repo).
"""
from __future__ import annotations

from ... import nn, reshape


def _make_divisible(v, divisor=8, min_value=None):
    min_value = min_value or divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class SqueezeExcitation(nn.Layer):
    def __init__(self, c, squeeze_c):
        super().__init__()
        self.pool = nn.AdaptiveAvgPool2D((1, 1))
        self.fc1 = nn.Conv2D(c, squeeze_c, 1)
        self.relu = nn.ReLU()
        self.fc2 = nn.Conv2D(squeeze_c, c, 1)
        self.hsig = nn.Hardsigmoid()

    def forward(self, x):
        s = self.hsig(self.fc2(self.relu(self.fc1(self.pool(x)))))
        return x * s


class ConvBNAct(nn.Sequential):
    def __init__(self, in_c, out_c, k, stride=1, groups=1, act=nn.Hardswish):
        layers = [nn.Conv2D(in_c, out_c, k, stride, (k - 1) // 2, groups=groups,
                            bias_attr=False), nn.BatchNorm2D(out_c)]
        if act is not None:
            layers.append(act())
        super().__init__(*layers)


class InvertedResidual(nn.Layer):
    def __init__(self, in_c, exp_c, out_c, k, stride, use_se, act):
        super().__init__()
        self.use_res = stride == 1 and in_c == out_c
        act_l = nn.Hardswish if act == "hardswish" else nn.ReLU
        layers = []
        if exp_c != in_c:
            layers.append(ConvBNAct(in_c, exp_c, 1, act=act_l))
        layers.append(ConvBNAct(exp_c, exp_c, k, stride, groups=exp_c, act=act_l))
        if use_se:
            layers.append(SqueezeExcitation(exp_c, _make_divisible(exp_c // 4)))
        layers.append(ConvBNAct(exp_c, out_c, 1, act=None))
        self.block = nn.Sequential(*layers)

    def forward(self, x):
        out = self.block(x)
        return x + out if self.use_res else out


_LARGE = [
    # k, exp, out, se, act, stride
    (3, 16, 16, False, "relu", 1), (3, 64, 24, False, "relu", 2),
    (3, 72, 24, False, "relu", 1), (5, 72, 40, True, "relu", 2),
    (5, 120, 40, True, "relu", 1), (5, 120, 40, True, "relu", 1),
    (3, 240, 80, False, "hardswish", 2), (3, 200, 80, False, "hardswish", 1),
    (3, 184, 80, False, "hardswish", 1), (3, 184, 80, False, "hardswish", 1),
    (3, 480, 112, True, "hardswish", 1), (3, 672, 112, True, "hardswish", 1),
    (5, 672, 160, True, "hardswish", 2), (5, 960, 160, True, "hardswish", 1),
    (5, 960, 160, True, "hardswish", 1),
]
_SMALL = [
    (3, 16, 16, True, "relu", 2), (3, 72, 24, False, "relu", 2),
    (3, 88, 24, False, "relu", 1), (5, 96, 40, True, "hardswish", 2),
    (5, 240, 40, True, "hardswish", 1), (5, 240, 40, True, "hardswish", 1),
    (5, 120, 48, True, "hardswish", 1), (5, 144, 48, True, "hardswish", 1),
    (5, 288, 96, True, "hardswish", 2), (5, 576, 96, True, "hardswish", 1),
    (5, 576, 96, True, "hardswish", 1),
]


class MobileNetV3(nn.Layer):
    def __init__(self, cfg, last_c, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        in_c = _make_divisible(16 * scale)
        self.stem = ConvBNAct(3, in_c, 3, stride=2)
        blocks = []
        for k, exp, out, se, act, s in cfg:
            exp_c = _make_divisible(exp * scale)
            out_c = _make_divisible(out * scale)
            blocks.append(InvertedResidual(in_c, exp_c, out_c, k, s, se, act))
            in_c = out_c
        self.blocks = nn.Sequential(*blocks)
        exp_last = _make_divisible(cfg[-1][1] * scale)
        self.conv_last = ConvBNAct(in_c, exp_last, 1)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Linear(exp_last, last_c), nn.Hardswish(), nn.Dropout(0.2),
                nn.Linear(last_c, num_classes),
            )

    def forward(self, x):
        x = self.conv_last(self.blocks(self.stem(x)))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(reshape(x, [x.shape[0], -1]))
        return x


class MobileNetV3Large(MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__(_LARGE, 1280, scale, num_classes, with_pool)


class MobileNetV3Small(MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__(_SMALL, 1024, scale, num_classes, with_pool)


def mobilenet_v3_large(pretrained=False, scale=1.0, **kw):
    return MobileNetV3Large(scale=scale, **kw)


def mobilenet_v3_small(pretrained=False, scale=1.0, **kw):
    return MobileNetV3Small(scale=scale, **kw)
