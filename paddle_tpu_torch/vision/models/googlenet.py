"""GoogLeNet — the port of ``paddle_tpu/vision/models/googlenet.py``:
Inception v1's blocks of four branches; in training and in eval the
forward returns the main logits and the two auxiliary heads' (``(out,
aux1, aux2)``), as the reference's does. Built from the port's ``nn``
layers in the reference's order, so that ``seed(s)`` draws the
reference's initial weights and the reference's ``state_dict()`` loads
with ``set_state_dict``. NCHW, as in the reference. ``pretrained`` is
accepted and ignored, as in the reference (no weights are in the repo).
"""
from __future__ import annotations

from ... import concat, nn, reshape


class ConvLayer(nn.Layer):
    def __init__(self, in_c, out_c, k, stride=1, padding=None):
        super().__init__()
        padding = (k - 1) // 2 if padding is None else padding
        self.conv = nn.Conv2D(in_c, out_c, k, stride, padding, bias_attr=False)
        self.relu = nn.ReLU()

    def forward(self, x):
        return self.relu(self.conv(x))


class Inception(nn.Layer):
    def __init__(self, in_c, c1, c3r, c3, c5r, c5, proj):
        super().__init__()
        self.b1 = ConvLayer(in_c, c1, 1)
        self.b3r = ConvLayer(in_c, c3r, 1)
        self.b3 = ConvLayer(c3r, c3, 3)
        self.b5r = ConvLayer(in_c, c5r, 1)
        self.b5 = ConvLayer(c5r, c5, 5)
        self.pool = nn.MaxPool2D(3, stride=1, padding=1)
        self.proj = ConvLayer(in_c, proj, 1)

    def forward(self, x):
        return concat([self.b1(x), self.b3(self.b3r(x)), self.b5(self.b5r(x)),
                       self.proj(self.pool(x))], axis=1)


class GoogLeNet(nn.Layer):
    """Returns (out, aux1, aux2) like the reference when training."""

    def __init__(self, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.stem = nn.Sequential(
            ConvLayer(3, 64, 7, stride=2), nn.MaxPool2D(3, stride=2, ceil_mode=True),
            ConvLayer(64, 64, 1), ConvLayer(64, 192, 3),
            nn.MaxPool2D(3, stride=2, ceil_mode=True),
        )
        self.i3a = Inception(192, 64, 96, 128, 16, 32, 32)
        self.i3b = Inception(256, 128, 128, 192, 32, 96, 64)
        self.pool3 = nn.MaxPool2D(3, stride=2, ceil_mode=True)
        self.i4a = Inception(480, 192, 96, 208, 16, 48, 64)
        self.i4b = Inception(512, 160, 112, 224, 24, 64, 64)
        self.i4c = Inception(512, 128, 128, 256, 24, 64, 64)
        self.i4d = Inception(512, 112, 144, 288, 32, 64, 64)
        self.i4e = Inception(528, 256, 160, 320, 32, 128, 128)
        self.pool4 = nn.MaxPool2D(3, stride=2, ceil_mode=True)
        self.i5a = Inception(832, 256, 160, 320, 32, 128, 128)
        self.i5b = Inception(832, 384, 192, 384, 48, 128, 128)
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.dropout = nn.Dropout(0.2)
            self.fc = nn.Linear(1024, num_classes)
            # aux classifiers (reference out1/out2 heads)
            self.aux1 = nn.Sequential(nn.AdaptiveAvgPool2D((4, 4)))
            self.aux1_fc1 = nn.Linear(512 * 16, 1024)
            self.aux1_fc2 = nn.Linear(1024, num_classes)
            self.aux2 = nn.Sequential(nn.AdaptiveAvgPool2D((4, 4)))
            self.aux2_fc1 = nn.Linear(528 * 16, 1024)
            self.aux2_fc2 = nn.Linear(1024, num_classes)
        self.relu = nn.ReLU()

    def forward(self, x):
        x = self.stem(x)
        x = self.pool3(self.i3b(self.i3a(x)))
        x = self.i4a(x)
        aux1_in = x
        x = self.i4c(self.i4b(x))
        x = self.i4d(x)
        aux2_in = x
        x = self.pool4(self.i4e(x))
        x = self.i5b(self.i5a(x))
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            out = self.fc(self.dropout(reshape(x, [x.shape[0], -1])))
            a1 = self.aux1(aux1_in)
            a1 = self.aux1_fc2(self.relu(self.aux1_fc1(
                reshape(a1, [a1.shape[0], -1]))))
            a2 = self.aux2(aux2_in)
            a2 = self.aux2_fc2(self.relu(self.aux2_fc1(
                reshape(a2, [a2.shape[0], -1]))))
            return out, a1, a2
        return x


def googlenet(pretrained=False, **kwargs):
    return GoogLeNet(**kwargs)
