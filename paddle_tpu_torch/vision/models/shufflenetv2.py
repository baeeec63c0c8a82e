"""ShuffleNetV2 — the port of ``paddle_tpu/vision/models/shufflenetv2.py``:
every width factory (``x0_25`` to ``x2_0``) and ``shufflenet_v2_swish``;
a block splits the channels or takes two branches, concatenates and
shuffles them (``reshape``, ``transpose``, ``reshape``). Built from the
port's ``nn`` layers in the reference's order, so that ``seed(s)`` draws
the reference's initial weights and the reference's ``state_dict()``
loads with ``set_state_dict``. NCHW, as in the reference. ``pretrained``
is accepted and ignored, as in the reference (no weights are in the
repo).
"""
from __future__ import annotations

from ... import concat, nn, reshape, transpose


def channel_shuffle(x, groups):
    n, c, h, w = x.shape
    x = reshape(x, [n, groups, c // groups, h, w])
    x = transpose(x, [0, 2, 1, 3, 4])
    return reshape(x, [n, c, h, w])


def _conv_bn(in_c, out_c, k, stride=1, groups=1, act="relu"):
    layers = [
        nn.Conv2D(in_c, out_c, k, stride, (k - 1) // 2, groups=groups,
                  bias_attr=False),
        nn.BatchNorm2D(out_c),
    ]
    if act == "relu":
        layers.append(nn.ReLU())
    elif act == "swish":
        layers.append(nn.Swish())
    return nn.Sequential(*layers)


class InvertedResidual(nn.Layer):
    def __init__(self, in_c, out_c, stride, act="relu"):
        super().__init__()
        self.stride = stride
        branch_c = out_c // 2
        if stride == 1:
            self.branch2 = nn.Sequential(
                _conv_bn(branch_c, branch_c, 1, act=act),
                _conv_bn(branch_c, branch_c, 3, stride, groups=branch_c, act=None),
                _conv_bn(branch_c, branch_c, 1, act=act),
            )
            self.branch1 = None
        else:
            self.branch1 = nn.Sequential(
                _conv_bn(in_c, in_c, 3, stride, groups=in_c, act=None),
                _conv_bn(in_c, branch_c, 1, act=act),
            )
            self.branch2 = nn.Sequential(
                _conv_bn(in_c, branch_c, 1, act=act),
                _conv_bn(branch_c, branch_c, 3, stride, groups=branch_c, act=None),
                _conv_bn(branch_c, branch_c, 1, act=act),
            )

    def forward(self, x):
        if self.stride == 1:
            c = x.shape[1] // 2
            x1, x2 = x[:, :c], x[:, c:]
            out = concat([x1, self.branch2(x2)], axis=1)
        else:
            out = concat([self.branch1(x), self.branch2(x)], axis=1)
        return channel_shuffle(out, 2)


_CFGS = {
    "swish": ([4, 8, 4], [24, 116, 232, 464, 1024], "swish"),
    "x0_25": ([4, 8, 4], [24, 24, 48, 96, 512], "relu"),
    "x0_33": ([4, 8, 4], [24, 32, 64, 128, 512], "relu"),
    "x0_5": ([4, 8, 4], [24, 48, 96, 192, 1024], "relu"),
    "x1_0": ([4, 8, 4], [24, 116, 232, 464, 1024], "relu"),
    "x1_5": ([4, 8, 4], [24, 176, 352, 704, 1024], "relu"),
    "x2_0": ([4, 8, 4], [24, 244, 488, 976, 2048], "relu"),
}


class ShuffleNetV2(nn.Layer):
    def __init__(self, scale="x1_0", act=None, num_classes=1000, with_pool=True):
        super().__init__()
        repeats, channels, cfg_act = _CFGS[scale]
        act = act or cfg_act
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.stem = nn.Sequential(
            _conv_bn(3, channels[0], 3, stride=2, act=act),
            nn.MaxPool2D(3, stride=2, padding=1),
        )
        stages = []
        in_c = channels[0]
        for stage_i, n in enumerate(repeats):
            out_c = channels[stage_i + 1]
            stages.append(InvertedResidual(in_c, out_c, 2, act))
            for _ in range(n - 1):
                stages.append(InvertedResidual(out_c, out_c, 1, act))
            in_c = out_c
        self.stages = nn.Sequential(*stages)
        self.conv_last = _conv_bn(in_c, channels[-1], 1, act=act)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = nn.Linear(channels[-1], num_classes)

    def forward(self, x):
        x = self.conv_last(self.stages(self.stem(x)))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(reshape(x, [x.shape[0], -1]))
        return x


def shufflenet_v2_x0_25(pretrained=False, **kw):
    return ShuffleNetV2("x0_25", **kw)


def shufflenet_v2_x0_33(pretrained=False, **kw):
    return ShuffleNetV2("x0_33", **kw)


def shufflenet_v2_x0_5(pretrained=False, **kw):
    return ShuffleNetV2("x0_5", **kw)


def shufflenet_v2_x1_0(pretrained=False, **kw):
    return ShuffleNetV2("x1_0", **kw)


def shufflenet_v2_x1_5(pretrained=False, **kw):
    return ShuffleNetV2("x1_5", **kw)


def shufflenet_v2_x2_0(pretrained=False, **kw):
    return ShuffleNetV2("x2_0", **kw)


def shufflenet_v2_swish(pretrained=False, **kw):
    return ShuffleNetV2("swish", **kw)
