"""MobileNetV2 — the port of ``paddle_tpu/vision/models/mobilenet.py``:
inverted residual blocks with linear bottlenecks and ReLU6, at a width
``scale``. Built from the port's ``nn`` layers in the reference's order,
so that ``seed(s)`` draws the reference's initial weights and the
reference's ``state_dict()`` loads with ``set_state_dict``. NCHW, as in
the reference. ``pretrained`` is accepted and ignored, as in the
reference (no weights are in the repo).
"""
from __future__ import annotations

from ... import nn


class ConvBNReLU(nn.Sequential):
    def __init__(self, in_planes, out_planes, kernel_size=3, stride=1, groups=1):
        padding = (kernel_size - 1) // 2
        super().__init__(
            nn.Conv2D(in_planes, out_planes, kernel_size, stride, padding, groups=groups,
                      bias_attr=False),
            nn.BatchNorm2D(out_planes),
            nn.ReLU6(),
        )


class InvertedResidual(nn.Layer):
    def __init__(self, inp, oup, stride, expand_ratio):
        super().__init__()
        self.stride = stride
        hidden_dim = int(round(inp * expand_ratio))
        self.use_res_connect = stride == 1 and inp == oup
        layers = []
        if expand_ratio != 1:
            layers.append(ConvBNReLU(inp, hidden_dim, kernel_size=1))
        layers.extend([
            ConvBNReLU(hidden_dim, hidden_dim, stride=stride, groups=hidden_dim),
            nn.Conv2D(hidden_dim, oup, 1, 1, 0, bias_attr=False),
            nn.BatchNorm2D(oup),
        ])
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        if self.use_res_connect:
            return x + self.conv(x)
        return self.conv(x)


class MobileNetV2(nn.Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        input_channel = int(32 * scale)
        last_channel = int(1280 * max(1.0, scale))
        cfg = [
            (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
            (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1),
        ]
        features = [ConvBNReLU(3, input_channel, stride=2)]
        for t, c, n, s in cfg:
            out_c = int(c * scale)
            for i in range(n):
                features.append(InvertedResidual(input_channel, out_c, s if i == 0 else 1, t))
                input_channel = out_c
        features.append(ConvBNReLU(input_channel, last_channel, kernel_size=1))
        self.features = nn.Sequential(*features)
        if with_pool:
            self.pool2d_avg = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Dropout(0.2), nn.Linear(last_channel, num_classes)
            )

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool2d_avg(x)
        if self.num_classes > 0:
            x = x.flatten(1)
            x = self.classifier(x)
        return x


def mobilenet_v2(pretrained=False, scale=1.0, **kwargs):
    return MobileNetV2(scale=scale, **kwargs)
