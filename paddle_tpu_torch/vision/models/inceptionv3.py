"""InceptionV3 — the port of ``paddle_tpu/vision/models/inceptionv3.py``:
the A-E Inception blocks with factorised 1 x 7 / 7 x 1 and 1 x 3 / 3 x 1
convolutions (for ``[N, 3, 299, 299]`` inputs). Built from the port's
``nn`` layers in the reference's order, so that ``seed(s)`` draws the
reference's initial weights and the reference's ``state_dict()`` loads
with ``set_state_dict``. NCHW, as in the reference. ``pretrained`` is
accepted and ignored, as in the reference (no weights are in the repo).
"""
from __future__ import annotations

from ... import concat, nn, reshape


class ConvBNLayer(nn.Layer):
    def __init__(self, in_c, out_c, k, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2D(in_c, out_c, k, stride, padding, bias_attr=False)
        self.bn = nn.BatchNorm2D(out_c)
        self.relu = nn.ReLU()

    def forward(self, x):
        return self.relu(self.bn(self.conv(x)))


class InceptionA(nn.Layer):
    def __init__(self, in_c, pool_features):
        super().__init__()
        self.b1 = ConvBNLayer(in_c, 64, 1)
        self.b5_1 = ConvBNLayer(in_c, 48, 1)
        self.b5_2 = ConvBNLayer(48, 64, 5, padding=2)
        self.b3_1 = ConvBNLayer(in_c, 64, 1)
        self.b3_2 = ConvBNLayer(64, 96, 3, padding=1)
        self.b3_3 = ConvBNLayer(96, 96, 3, padding=1)
        self.pool = nn.AvgPool2D(3, stride=1, padding=1)
        self.bp = ConvBNLayer(in_c, pool_features, 1)

    def forward(self, x):
        return concat([
            self.b1(x), self.b5_2(self.b5_1(x)),
            self.b3_3(self.b3_2(self.b3_1(x))), self.bp(self.pool(x)),
        ], axis=1)


class InceptionB(nn.Layer):  # reduction
    def __init__(self, in_c):
        super().__init__()
        self.b3 = ConvBNLayer(in_c, 384, 3, stride=2)
        self.b3d_1 = ConvBNLayer(in_c, 64, 1)
        self.b3d_2 = ConvBNLayer(64, 96, 3, padding=1)
        self.b3d_3 = ConvBNLayer(96, 96, 3, stride=2)
        self.pool = nn.MaxPool2D(3, stride=2)

    def forward(self, x):
        return concat([self.b3(x), self.b3d_3(self.b3d_2(self.b3d_1(x))),
                       self.pool(x)], axis=1)


class InceptionC(nn.Layer):
    def __init__(self, in_c, c7):
        super().__init__()
        self.b1 = ConvBNLayer(in_c, 192, 1)
        self.b7_1 = ConvBNLayer(in_c, c7, 1)
        self.b7_2 = ConvBNLayer(c7, c7, (1, 7), padding=(0, 3))
        self.b7_3 = ConvBNLayer(c7, 192, (7, 1), padding=(3, 0))
        self.b7d_1 = ConvBNLayer(in_c, c7, 1)
        self.b7d_2 = ConvBNLayer(c7, c7, (7, 1), padding=(3, 0))
        self.b7d_3 = ConvBNLayer(c7, c7, (1, 7), padding=(0, 3))
        self.b7d_4 = ConvBNLayer(c7, c7, (7, 1), padding=(3, 0))
        self.b7d_5 = ConvBNLayer(c7, 192, (1, 7), padding=(0, 3))
        self.pool = nn.AvgPool2D(3, stride=1, padding=1)
        self.bp = ConvBNLayer(in_c, 192, 1)

    def forward(self, x):
        return concat([
            self.b1(x), self.b7_3(self.b7_2(self.b7_1(x))),
            self.b7d_5(self.b7d_4(self.b7d_3(self.b7d_2(self.b7d_1(x))))),
            self.bp(self.pool(x)),
        ], axis=1)


class InceptionD(nn.Layer):  # reduction
    def __init__(self, in_c):
        super().__init__()
        self.b3_1 = ConvBNLayer(in_c, 192, 1)
        self.b3_2 = ConvBNLayer(192, 320, 3, stride=2)
        self.b7_1 = ConvBNLayer(in_c, 192, 1)
        self.b7_2 = ConvBNLayer(192, 192, (1, 7), padding=(0, 3))
        self.b7_3 = ConvBNLayer(192, 192, (7, 1), padding=(3, 0))
        self.b7_4 = ConvBNLayer(192, 192, 3, stride=2)
        self.pool = nn.MaxPool2D(3, stride=2)

    def forward(self, x):
        return concat([self.b3_2(self.b3_1(x)),
                       self.b7_4(self.b7_3(self.b7_2(self.b7_1(x)))),
                       self.pool(x)], axis=1)


class InceptionE(nn.Layer):
    def __init__(self, in_c):
        super().__init__()
        self.b1 = ConvBNLayer(in_c, 320, 1)
        self.b3_1 = ConvBNLayer(in_c, 384, 1)
        self.b3_2a = ConvBNLayer(384, 384, (1, 3), padding=(0, 1))
        self.b3_2b = ConvBNLayer(384, 384, (3, 1), padding=(1, 0))
        self.b3d_1 = ConvBNLayer(in_c, 448, 1)
        self.b3d_2 = ConvBNLayer(448, 384, 3, padding=1)
        self.b3d_3a = ConvBNLayer(384, 384, (1, 3), padding=(0, 1))
        self.b3d_3b = ConvBNLayer(384, 384, (3, 1), padding=(1, 0))
        self.pool = nn.AvgPool2D(3, stride=1, padding=1)
        self.bp = ConvBNLayer(in_c, 192, 1)

    def forward(self, x):
        b3 = self.b3_1(x)
        b3d = self.b3d_2(self.b3d_1(x))
        return concat([
            self.b1(x), self.b3_2a(b3), self.b3_2b(b3),
            self.b3d_3a(b3d), self.b3d_3b(b3d), self.bp(self.pool(x)),
        ], axis=1)


class InceptionV3(nn.Layer):
    def __init__(self, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.stem = nn.Sequential(
            ConvBNLayer(3, 32, 3, stride=2), ConvBNLayer(32, 32, 3),
            ConvBNLayer(32, 64, 3, padding=1), nn.MaxPool2D(3, stride=2),
            ConvBNLayer(64, 80, 1), ConvBNLayer(80, 192, 3),
            nn.MaxPool2D(3, stride=2),
        )
        self.blocks = nn.Sequential(
            InceptionA(192, 32), InceptionA(256, 64), InceptionA(288, 64),
            InceptionB(288),
            InceptionC(768, 128), InceptionC(768, 160), InceptionC(768, 160),
            InceptionC(768, 192),
            InceptionD(768),
            InceptionE(1280), InceptionE(2048),
        )
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.dropout = nn.Dropout(0.2)
            self.fc = nn.Linear(2048, num_classes)

    def forward(self, x):
        x = self.blocks(self.stem(x))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(self.dropout(reshape(x, [x.shape[0], -1])))
        return x


def inception_v3(pretrained=False, **kwargs):
    return InceptionV3(**kwargs)
