"""DenseNet — the port of ``paddle_tpu/vision/models/densenet.py``:
``densenet121``, ``161``, ``169``, ``201`` and ``264``: dense blocks
whose layers concatenate their input with their output, joined by
transitions (BatchNorm, ReLU, 1 x 1 convolution, 2 x 2 average pool).
Built from the port's ``nn`` layers in the reference's order, so that
``seed(s)`` draws the reference's initial weights and the reference's
``state_dict()`` loads with ``set_state_dict``. NCHW, as in the
reference. ``pretrained`` is accepted and ignored, as in the reference
(no weights are in the repo).
"""
from __future__ import annotations

from ... import concat, nn, reshape


class DenseLayer(nn.Layer):
    def __init__(self, in_c, growth_rate, bn_size, drop_rate):
        super().__init__()
        self.bn1 = nn.BatchNorm2D(in_c)
        self.relu = nn.ReLU()
        self.conv1 = nn.Conv2D(in_c, bn_size * growth_rate, 1, bias_attr=False)
        self.bn2 = nn.BatchNorm2D(bn_size * growth_rate)
        self.conv2 = nn.Conv2D(bn_size * growth_rate, growth_rate, 3, padding=1,
                               bias_attr=False)
        self.dropout = nn.Dropout(drop_rate) if drop_rate else None

    def forward(self, x):
        out = self.conv1(self.relu(self.bn1(x)))
        out = self.conv2(self.relu(self.bn2(out)))
        if self.dropout is not None:
            out = self.dropout(out)
        return concat([x, out], axis=1)


class DenseBlock(nn.Layer):
    def __init__(self, num_layers, in_c, bn_size, growth_rate, drop_rate):
        super().__init__()
        self.layers = nn.LayerList([
            DenseLayer(in_c + i * growth_rate, growth_rate, bn_size, drop_rate)
            for i in range(num_layers)
        ])

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x


class Transition(nn.Layer):
    def __init__(self, in_c, out_c):
        super().__init__()
        self.bn = nn.BatchNorm2D(in_c)
        self.relu = nn.ReLU()
        self.conv = nn.Conv2D(in_c, out_c, 1, bias_attr=False)
        self.pool = nn.AvgPool2D(2, stride=2)

    def forward(self, x):
        return self.pool(self.conv(self.relu(self.bn(x))))


_CFG = {121: (6, 12, 24, 16), 161: (6, 12, 36, 24), 169: (6, 12, 32, 32),
        201: (6, 12, 48, 32), 264: (6, 12, 64, 48)}


class DenseNet(nn.Layer):
    def __init__(self, layers=121, growth_rate=32, bn_size=4, dropout=0.0,
                 num_classes=1000, with_pool=True):
        super().__init__()
        if layers == 161:
            growth_rate, init_c = 48, 96
        else:
            init_c = 64
        block_cfg = _CFG[layers]
        self.with_pool = with_pool
        self.num_classes = num_classes
        self.stem = nn.Sequential(
            nn.Conv2D(3, init_c, 7, stride=2, padding=3, bias_attr=False),
            nn.BatchNorm2D(init_c), nn.ReLU(), nn.MaxPool2D(3, stride=2, padding=1),
        )
        blocks, c = [], init_c
        for i, n in enumerate(block_cfg):
            blocks.append(DenseBlock(n, c, bn_size, growth_rate, dropout))
            c += n * growth_rate
            if i != len(block_cfg) - 1:
                blocks.append(Transition(c, c // 2))
                c //= 2
        self.blocks = nn.Sequential(*blocks)
        self.bn_final = nn.BatchNorm2D(c)
        self.relu = nn.ReLU()
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.classifier = nn.Linear(c, num_classes)

    def forward(self, x):
        x = self.relu(self.bn_final(self.blocks(self.stem(x))))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(reshape(x, [x.shape[0], -1]))
        return x


def densenet121(pretrained=False, **kw):
    return DenseNet(121, **kw)


def densenet161(pretrained=False, **kw):
    return DenseNet(161, **kw)


def densenet169(pretrained=False, **kw):
    return DenseNet(169, **kw)


def densenet201(pretrained=False, **kw):
    return DenseNet(201, **kw)


def densenet264(pretrained=False, **kw):
    return DenseNet(264, **kw)
