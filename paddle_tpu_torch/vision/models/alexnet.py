"""AlexNet — the port of ``paddle_tpu/vision/models/alexnet.py``: five
convolutions with ReLU and three max pools, then three linear layers
with dropout (for ``[N, 3, 224, 224]`` inputs). Built from the port's
``nn`` layers in the reference's order, so that ``seed(s)`` draws the
reference's initial weights and the reference's ``state_dict()`` loads
with ``set_state_dict``. NCHW, as in the reference. ``pretrained`` is
accepted and ignored, as in the reference (no weights are in the repo).
"""
from __future__ import annotations

from ... import nn


class AlexNet(nn.Layer):
    def __init__(self, num_classes=1000):
        super().__init__()
        self.features = nn.Sequential(
            nn.Conv2D(3, 64, 11, stride=4, padding=2), nn.ReLU(), nn.MaxPool2D(3, 2),
            nn.Conv2D(64, 192, 5, padding=2), nn.ReLU(), nn.MaxPool2D(3, 2),
            nn.Conv2D(192, 384, 3, padding=1), nn.ReLU(),
            nn.Conv2D(384, 256, 3, padding=1), nn.ReLU(),
            nn.Conv2D(256, 256, 3, padding=1), nn.ReLU(), nn.MaxPool2D(3, 2),
        )
        self.classifier = nn.Sequential(
            nn.Dropout(), nn.Linear(256 * 6 * 6, 4096), nn.ReLU(),
            nn.Dropout(), nn.Linear(4096, 4096), nn.ReLU(),
            nn.Linear(4096, num_classes),
        )

    def forward(self, x):
        x = self.features(x)
        x = x.flatten(1)
        return self.classifier(x)


def alexnet(pretrained=False, **kwargs):
    return AlexNet(**kwargs)
