"""VGG — the port of ``paddle_tpu/vision/models/vgg.py``: ``vgg11``,
``vgg13``, ``vgg16`` and ``vgg19`` (configurations A, B, D and E, each
with or without BatchNorm), a 7 x 7 adaptive average pool and the three-
layer classifier. Built from the port's ``nn`` layers in the reference's
order, so that ``seed(s)`` draws the reference's initial weights and the
reference's ``state_dict()`` loads with ``set_state_dict``. NCHW, as in
the reference. ``pretrained`` is accepted and ignored, as in the
reference (no weights are in the repo).
"""
from __future__ import annotations

from ... import nn

_CFGS = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512, 512,
          "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
          512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512, 512,
          "M", 512, 512, 512, 512, "M"],
}


def _make_layers(cfg, batch_norm=False):
    layers = []
    in_c = 3
    for v in cfg:
        if v == "M":
            layers.append(nn.MaxPool2D(2, 2))
        else:
            layers.append(nn.Conv2D(in_c, v, 3, padding=1))
            if batch_norm:
                layers.append(nn.BatchNorm2D(v))
            layers.append(nn.ReLU())
            in_c = v
    return nn.Sequential(*layers)


class VGG(nn.Layer):
    def __init__(self, features, num_classes=1000, with_pool=True):
        super().__init__()
        self.features = features
        self.num_classes = num_classes
        self.with_pool = with_pool
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((7, 7))
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Linear(512 * 7 * 7, 4096), nn.ReLU(), nn.Dropout(),
                nn.Linear(4096, 4096), nn.ReLU(), nn.Dropout(),
                nn.Linear(4096, num_classes),
            )

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = x.flatten(1)
            x = self.classifier(x)
        return x


def vgg16(pretrained=False, batch_norm=False, **kwargs):
    return VGG(_make_layers(_CFGS["D"], batch_norm), **kwargs)


def vgg19(pretrained=False, batch_norm=False, **kwargs):
    return VGG(_make_layers(_CFGS["E"], batch_norm), **kwargs)


def vgg11(pretrained=False, batch_norm=False, **kwargs):
    return VGG(_make_layers(_CFGS["A"], batch_norm), **kwargs)


def vgg13(pretrained=False, batch_norm=False, **kwargs):
    return VGG(_make_layers(_CFGS["B"], batch_norm), **kwargs)
