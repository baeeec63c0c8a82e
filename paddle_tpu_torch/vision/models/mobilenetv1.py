"""MobileNetV1 — the port of ``paddle_tpu/vision/models/mobilenetv1.py``:
depthwise-separable convolutions, each a depthwise and a pointwise
convolution with BatchNorm and ReLU, at a width ``scale``. Built from
the port's ``nn`` layers in the reference's order, so that ``seed(s)``
draws the reference's initial weights and the reference's
``state_dict()`` loads with ``set_state_dict``. NCHW, as in the
reference. ``pretrained`` is accepted and ignored, as in the reference
(no weights are in the repo).
"""
from __future__ import annotations

from ... import nn, reshape


class ConvBNLayer(nn.Layer):
    def __init__(self, in_c, out_c, k, stride=1, groups=1):
        super().__init__()
        self.conv = nn.Conv2D(in_c, out_c, k, stride, (k - 1) // 2, groups=groups,
                              bias_attr=False)
        self.bn = nn.BatchNorm2D(out_c)
        self.relu = nn.ReLU()

    def forward(self, x):
        return self.relu(self.bn(self.conv(x)))


class DepthwiseSeparable(nn.Layer):
    def __init__(self, in_c, out_c1, out_c2, stride, scale):
        super().__init__()
        self.dw = ConvBNLayer(int(in_c * scale), int(out_c1 * scale), 3, stride,
                              groups=int(in_c * scale))
        self.pw = ConvBNLayer(int(out_c1 * scale), int(out_c2 * scale), 1)

    def forward(self, x):
        return self.pw(self.dw(x))


class MobileNetV1(nn.Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__()
        self.scale = scale
        self.num_classes = num_classes
        self.with_pool = with_pool
        cfg = [
            # in, c1, c2, stride
            (32, 32, 64, 1), (64, 64, 128, 2), (128, 128, 128, 1),
            (128, 128, 256, 2), (256, 256, 256, 1), (256, 256, 512, 2),
            (512, 512, 512, 1), (512, 512, 512, 1), (512, 512, 512, 1),
            (512, 512, 512, 1), (512, 512, 512, 1), (512, 512, 1024, 2),
            (1024, 1024, 1024, 1),
        ]
        self.conv1 = ConvBNLayer(3, int(32 * scale), 3, stride=2)
        self.blocks = nn.Sequential(*[
            DepthwiseSeparable(i, c1, c2, s, scale) for i, c1, c2, s in cfg
        ])
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = nn.Linear(int(1024 * scale), num_classes)

    def forward(self, x):
        x = self.blocks(self.conv1(x))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(reshape(x, [x.shape[0], -1]))
        return x


def mobilenet_v1(pretrained=False, scale=1.0, **kwargs):
    return MobileNetV1(scale=scale, **kwargs)
