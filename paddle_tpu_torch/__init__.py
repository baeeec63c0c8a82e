"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu``.

The JAX package ``paddle_tpu`` is the reference; this package mirrors its
layout (``core/``, ``tensor_ops/``, ``framework/``, ``nn/``,
``optimizer/``, ``kernels/``, ``text/``, ``vision/``, ``serving/``,
``obs/``, ``distributed/``, ``analysis/``) so each module's counterpart is found
under the same name. It imports torch, numpy and the standard library
only — never jax and never ``paddle_tpu``.

The root is Paddle's dygraph surface, so a 2.x script runs against it:

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.text.gpt import GPTConfig, GPTForCausalLM

    paddle.seed(0)
    paddle.set_device("gpu")                  # or "cpu"
    model = GPTForCausalLM(GPTConfig(...)).train()
    opt = paddle.optimizer.AdamW(learning_rate=sched,
                                 parameters=model.parameters())
    loss = model(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
    loss.backward(); opt.step(); opt.clear_grad()
    paddle.save(model.state_dict(), "gpt.pdparams")
    model.set_state_dict(paddle.load("gpt.pdparams"))

``Tensor`` is a ``torch.Tensor`` subclass (``core.tensor``); the tensor
functions (``paddle.sum(x, axis=)`` ...) and ``paddle.linalg`` are
``tensor_ops``; ``save`` / ``load`` write and read the reference's
files; the dtype names are torch's dtypes. ``amp``, ``autograd``,
``jit``, ``metric``, ``hapi`` (``Model``, ``summary``, ``flops``),
``profiler``, ``callbacks`` and ``io.DataLoader`` are the reference's
training surface: ``paddle.Model(net).prepare(opt, loss, metrics,
amp_configs="O1").fit(train, eval, ...)`` runs on the card. Below the
surface, the GPT is served through the paged-KV engine (``serving``)
and trained (``train``) on the Hopper kernels (``kernels``).

Entry points run on CUDA unless the caller passes ``device="cpu"`` or
calls ``set_device("cpu")``; with no CUDA device they raise. ``seed(s)``
reseeds the process-wide key source of dropout and the random functions
(``core.rng``), as ``paddle.seed``.
"""
from __future__ import annotations

import importlib as _importlib

import numpy as _np
import torch as _torch

from ._device import resolve_device
from . import core  # noqa: F401
from .core import memory  # noqa: F401
from .core.dtype import get_default_dtype, set_default_dtype
from .core.place import (CPUPlace, CUDAPinnedPlace, CUDAPlace, Place,
                         device_count, get_device, is_compiled_with_cuda,
                         set_device)
from .core.rng import Generator, seed
from .core.tape import enable_grad, is_grad_enabled, no_grad, \
    set_grad_enabled
from .core.tensor import Tensor, to_tensor
from . import tensor_ops  # noqa: F401
from .tensor_ops import *  # noqa: F401,F403
from .tensor_ops import (creation, linalg, logic,  # noqa: F401
                         manipulation, math, search)
from .tensor_ops import methods as _methods
from . import framework  # noqa: F401
from .framework import LazyGuard, grad, in_dynamic_mode, load, save
from . import nn  # noqa: F401
from .nn.layer import ParamAttr
from . import optimizer  # noqa: F401
from . import regularizer  # noqa: F401
from . import io  # noqa: F401
from . import dataset  # noqa: F401
from . import reader  # noqa: F401
from .batch import batch
from . import amp  # noqa: F401
from . import autograd  # noqa: F401
from . import metric  # noqa: F401
from . import jit  # noqa: F401
from . import profiler  # noqa: F401
from . import hapi  # noqa: F401
from . import callbacks  # noqa: F401
from .hapi import Model, summary
from .hapi.dynamic_flops import flops

_methods.install()

# dtypes: torch's own, so ``x.dtype == paddle.float32`` holds
bool = _torch.bool  # noqa: A001 — Paddle's name shadows the builtin
uint8 = _torch.uint8
int8 = _torch.int8
int16 = _torch.int16
int32 = _torch.int32
int64 = _torch.int64
float16 = _torch.float16
bfloat16 = _torch.bfloat16
float32 = _torch.float32
float64 = _torch.float64
complex64 = _torch.complex64
complex128 = _torch.complex128
dtype = _torch.dtype

#: subpackages imported at first use (the serving stack is heavy)
_LAZY = ("serving", "text", "obs", "distributed", "analysis", "utils",
         "kernels", "train", "vision", "incubate")


def __getattr__(name):
    if name in _LAZY:
        return _importlib.import_module(f".{name}", __name__)
    if name == "DataParallel":
        return _importlib.import_module(".distributed",
                                        __name__).DataParallel
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_LAZY) | {"DataParallel"})


def is_compiled_with_ipu() -> bool:
    return False


def is_compiled_with_npu() -> bool:
    return False


def is_compiled_with_xpu() -> bool:
    return False


def is_grad_enabled_() -> bool:
    return is_grad_enabled()


def in_static_mode() -> bool:
    """False: the port has no static-graph mode."""
    return False


def disable_static(place=None) -> None:
    """The port is always in dynamic mode; ``place`` sets the device."""
    if place is not None:
        set_device(place if isinstance(place, str) else
                   "cpu" if place.device_type == "cpu" else
                   f"gpu:{place.get_device_id()}")


def shape(input):
    """The shape as an int32 tensor (the reference's ``paddle.shape``)."""
    t = input if isinstance(input, _torch.Tensor) else to_tensor(input)
    return _torch.tensor(list(t.shape), dtype=_torch.int32,
                         device=t.device).as_subclass(Tensor)


def check_shape(shape):  # noqa: A002 — Paddle's signature
    """Validate a shape argument: an int32/int64 tensor, or ints >= 0."""
    if isinstance(shape, _torch.Tensor):
        if shape.dtype not in (_torch.int32, _torch.int64):
            raise TypeError(f"shape tensor must be int32/int64, got "
                            f"{shape.dtype}")
        return
    for ele in shape:
        if isinstance(ele, _torch.Tensor):
            continue
        if not isinstance(ele, int):
            raise TypeError("All elements in `shape` must be integers")
        if ele < 0:
            raise ValueError("All elements in `shape` must be positive")


def set_printoptions(precision=None, threshold=None, edgeitems=None,
                     sci_mode=None, linewidth=None):
    """Print options for tensors (torch's) and their ``numpy()`` arrays."""
    kw = {k: v for k, v in dict(precision=precision, threshold=threshold,
                                edgeitems=edgeitems, linewidth=linewidth)
          .items() if v is not None}
    _torch.set_printoptions(sci_mode=sci_mode, **kw)
    if sci_mode is not None:
        kw["suppress"] = not sci_mode
    _np.set_printoptions(**kw)


def disable_signal_handler():
    """Nothing to do: the port installs no fault handlers."""


def get_cuda_rng_state():
    """The random-key schedule's state (``core.rng``'s key words)."""
    return [core.rng.default_generator().get_state()]


def set_cuda_rng_state(state):
    core.rng.default_generator().set_state(
        state[0] if isinstance(state, (list, tuple)) else state)
