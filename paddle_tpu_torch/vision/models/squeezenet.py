"""SqueezeNet — the port of ``paddle_tpu/vision/models/squeezenet.py``:
versions 1.0 and 1.1 of the Fire-module network, its classifier a 1 x 1
convolution and an adaptive average pool. Built from the port's ``nn``
layers in the reference's order, so that ``seed(s)`` draws the
reference's initial weights and the reference's ``state_dict()`` loads
with ``set_state_dict``. NCHW, as in the reference. ``pretrained`` is
accepted and ignored, as in the reference (no weights are in the repo).
"""
from __future__ import annotations

from ... import concat, nn, reshape


class MakeFire(nn.Layer):
    def __init__(self, in_c, squeeze_c, e1_c, e3_c):
        super().__init__()
        self.squeeze = nn.Conv2D(in_c, squeeze_c, 1)
        self.relu = nn.ReLU()
        self.expand1 = nn.Conv2D(squeeze_c, e1_c, 1)
        self.expand3 = nn.Conv2D(squeeze_c, e3_c, 3, padding=1)

    def forward(self, x):
        x = self.relu(self.squeeze(x))
        return concat([self.relu(self.expand1(x)), self.relu(self.expand3(x))],
                      axis=1)


class SqueezeNet(nn.Layer):
    def __init__(self, version="1.0", num_classes=1000, with_pool=True):
        super().__init__()
        self.version = version
        self.num_classes = num_classes
        self.with_pool = with_pool
        relu = nn.ReLU()
        pool = nn.MaxPool2D(3, stride=2, ceil_mode=True)
        if version == "1.0":
            self.features = nn.Sequential(
                nn.Conv2D(3, 96, 7, stride=2), relu, pool,
                MakeFire(96, 16, 64, 64), MakeFire(128, 16, 64, 64),
                MakeFire(128, 32, 128, 128), pool,
                MakeFire(256, 32, 128, 128), MakeFire(256, 48, 192, 192),
                MakeFire(384, 48, 192, 192), MakeFire(384, 64, 256, 256), pool,
                MakeFire(512, 64, 256, 256),
            )
        else:
            self.features = nn.Sequential(
                nn.Conv2D(3, 64, 3, stride=2, padding=1), relu, pool,
                MakeFire(64, 16, 64, 64), MakeFire(128, 16, 64, 64), pool,
                MakeFire(128, 32, 128, 128), MakeFire(256, 32, 128, 128), pool,
                MakeFire(256, 48, 192, 192), MakeFire(384, 48, 192, 192),
                MakeFire(384, 64, 256, 256), MakeFire(512, 64, 256, 256),
            )
        self.classifier = nn.Sequential(
            nn.Dropout(0.5),
            nn.Conv2D(512, num_classes, 1),
            nn.ReLU(),
            nn.AdaptiveAvgPool2D((1, 1)),
        )

    def forward(self, x):
        x = self.features(x)
        x = self.classifier(x)
        return reshape(x, [x.shape[0], -1])


def squeezenet1_0(pretrained=False, **kwargs):
    return SqueezeNet("1.0", **kwargs)


def squeezenet1_1(pretrained=False, **kwargs):
    return SqueezeNet("1.1", **kwargs)
