"""Activation layers — the port of ``paddle_tpu/nn/layers_activation.py``:
the 26 activations of ``nn.functional`` as layers. Positional and
keyword arguments (beyond ``name``) are the function's own, in the
reference's order."""
from __future__ import annotations

from . import functional as F
from . import initializer as I
from .layer import Layer

__all__ = ["ReLU", "ReLU6", "GELU", "Sigmoid", "LogSigmoid", "Tanh",
           "Softmax", "LogSoftmax", "LeakyReLU", "ELU", "CELU", "SELU",
           "Silu", "Swish", "Hardswish", "Hardsigmoid", "Hardtanh", "Mish",
           "Softplus", "Softsign", "Tanhshrink", "Softshrink", "Hardshrink",
           "Maxout", "GLU", "PReLU"]


def _make(name, fn, **defaults):
    class _Act(Layer):
        def __init__(self, *args, **kwargs):
            super().__init__()
            self._kw = dict(defaults)
            keys = list(defaults)
            for i, a in enumerate(args):
                self._kw[keys[i]] = a
            self._kw.update({k: v for k, v in kwargs.items()
                             if k != "name"})

        def forward(self, x):
            return fn(x, **self._kw)

        def extra_repr(self):
            return ", ".join(f"{k}={v}" for k, v in self._kw.items())

    _Act.__name__ = _Act.__qualname__ = name
    return _Act


ReLU = _make("ReLU", F.relu)
ReLU6 = _make("ReLU6", F.relu6)
GELU = _make("GELU", F.gelu, approximate=False)
Sigmoid = _make("Sigmoid", F.sigmoid)
LogSigmoid = _make("LogSigmoid", F.logsigmoid)
Tanh = _make("Tanh", F.tanh)
Softmax = _make("Softmax", F.softmax, axis=-1)
LogSoftmax = _make("LogSoftmax", F.log_softmax, axis=-1)
LeakyReLU = _make("LeakyReLU", F.leaky_relu, negative_slope=0.01)
ELU = _make("ELU", F.elu, alpha=1.0)
CELU = _make("CELU", F.celu, alpha=1.0)
SELU = _make("SELU", F.selu)
Silu = _make("Silu", F.silu)
Swish = _make("Swish", F.swish)
Hardswish = _make("Hardswish", F.hardswish)
Hardsigmoid = _make("Hardsigmoid", F.hardsigmoid)
Hardtanh = _make("Hardtanh", F.hardtanh, min=-1.0, max=1.0)
Mish = _make("Mish", F.mish)
Softplus = _make("Softplus", F.softplus, beta=1, threshold=20)
Softsign = _make("Softsign", F.softsign)
Tanhshrink = _make("Tanhshrink", F.tanhshrink)
Softshrink = _make("Softshrink", F.softshrink, threshold=0.5)
Hardshrink = _make("Hardshrink", F.hardshrink, threshold=0.5)
Maxout = _make("Maxout", F.maxout, groups=2, axis=1)
GLU = _make("GLU", F.glu, axis=-1)


class PReLU(Layer):
    """``where(x > 0, x, weight * x)``, ``weight`` one slope or one per
    channel, starting at ``init``."""

    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None):
        super().__init__()
        self._data_format = data_format
        self.weight = self.create_parameter(
            (num_parameters,), attr=weight_attr,
            default_initializer=I.Constant(init))

    def forward(self, x):
        return F.prelu(x, self.weight, self._data_format)
