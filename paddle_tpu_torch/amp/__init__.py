"""Automatic mixed precision — the port of ``paddle_tpu/amp/__init__.py``
(``auto_cast`` = ``amp_guard``, ``decorate``, ``WHITE_OPS``,
``BLACK_OPS``, ``amp_state``, ``maybe_cast_inputs``) and of
``grad_scaler.py`` (``GradScaler``).

The policy is the reference's, O1 and O2 exactly, not ``torch.autocast``
(whose lists differ: it runs ``softmax`` and ``exp`` in float32 and casts
ops the reference leaves alone). Under O1 a white-listed op casts its
floating inputs to the low dtype and a black-listed one casts low inputs
to float32; under O2 every op casts its floating inputs to the low dtype
but the black-listed ones, which take float32. Float64 is never cast. The
state is thread-local, as in the reference.

**Where the hook sits.** In the reference every op passes through the
dispatch layer (``core/dispatch.py``), which calls
``maybe_cast_inputs(name, arrays)``. The port has no dispatch layer: the
functions that carry a reference op name call it at their entry
(``nn.functional``'s ``linear``, ``conv1d/2d/3d``, ``batch_norm``,
``layer_norm``, the losses, ``log_softmax`` and
``scaled_dot_product_attention``; ``tensor_ops``' ``matmul``, ``sum``,
``einsum``, ``norm``, ``bmm``, ``mm`` and the element-wise binary
functions), at the cost of one thread-local read when AMP is off. The
``Tensor`` operators (``a + b``, ``a @ b``) are torch's own; while an
``auto_cast`` is active that names them (``"matmul"`` is on the default
white list, ``"add"`` can be put on a custom one, O2 casts them all)
:func:`auto_cast` installs amp-aware operators on the port's ``Tensor``
and takes them away when the last such scope exits, so they cost nothing
outside one. An operator inside one of the port's op functions (the
reference's jnp body of one op, which its dispatch never sees) is not
cast.

Under O1 the port's kernels thus see: the LayerNorm kernels float32
(``layer_norm`` is black), the flash kernels bfloat16
(``scaled_dot_product_attention`` is white), dropout whatever dtype reaches
it, AdamW float32 parameters. The flash and LayerNorm kernels take float32
and bfloat16 only: under ``auto_cast(dtype="float16")`` attention and a
float16 LayerNorm take their composites (``kernels.attention.sdpa``,
``nn.functional.layer_norm``), as the reference computes float16 through
``sdpa_reference`` and XLA; float16 kernels are ROADMAP Queue 2 open
work 10. The GPT's ``torch.nn.Linear`` layers take the ``linear`` op's
policy (``text.gpt.Linear``).
"""
from __future__ import annotations

import contextlib
import sys
import threading

import torch

from ..core.dtype import to_torch_dtype
from .grad_scaler import GradScaler  # noqa: F401

__all__ = ["auto_cast", "amp_guard", "decorate", "GradScaler", "WHITE_OPS",
           "BLACK_OPS", "amp_state", "maybe_cast_inputs"]

_tls = threading.local()

# O1 lists mirror the reference's amp lists (imperative/amp_auto_cast.cc)
WHITE_OPS = {"matmul", "linear", "conv2d", "conv1d", "conv3d", "bmm", "mm",
             "einsum", "scaled_dot_product_attention"}
BLACK_OPS = {"reduce_sum", "softmax_with_cross_entropy", "cross_entropy",
             "layer_norm", "batch_norm", "norm", "mse_loss", "log_softmax"}

_FLOATS = (torch.float32, torch.float16, torch.bfloat16)
_LOWS = (torch.float16, torch.bfloat16)


def amp_state():
    """The active policy (``{"level", "dtype", "white", "black"}``) of
    this thread, or None."""
    return getattr(_tls, "amp", None)


def maybe_cast_inputs(op_name, arrays):
    """``arrays`` cast for op ``op_name`` under the active policy (a new
    list; non-tensors and float64 pass as they are)."""
    st = amp_state()
    if st is None:
        return arrays
    low = st["low"]
    if st["level"] == "O2":
        if op_name in st["black"]:
            return [_to(a, torch.float32, _LOWS) for a in arrays]
        return [_to(a, low, _FLOATS) for a in arrays]
    if op_name in st["white"]:
        return [_to(a, low, _FLOATS) for a in arrays]
    if op_name in st["black"]:
        return [_to(a, torch.float32, _LOWS) for a in arrays]
    return arrays


def _to(a, dtype, when):
    if isinstance(a, torch.Tensor) and a.dtype in when and a.dtype != dtype:
        return a.to(dtype)
    return a


# ------------------------------------------------------------ Tensor operators
#: Tensor operator -> the reference's op name for it (``tensor_ops/
#: methods.py``'s ``_BINOPS``: ``__add__`` is ``math.add``, "add" ...)
OPERATOR_OPS = {
    "__add__": "add", "__radd__": "add", "__sub__": "subtract",
    "__rsub__": "rsub", "__mul__": "multiply", "__rmul__": "multiply",
    "__truediv__": "divide", "__rtruediv__": "rdiv",
    "__floordiv__": "floor_divide", "__mod__": "remainder",
    "__matmul__": "matmul", "__pow__": "pow",
}
_installed = {"depth": 0, "names": ()}
_install_lock = threading.Lock()
#: modules whose operators are the inside of one reference op (its jnp
#: body, which the reference's dispatch never sees): not cast
_OP_BODIES = ("paddle_tpu_torch.nn.functional", "paddle_tpu_torch.tensor_ops",
              "paddle_tpu_torch.kernels", "paddle_tpu_torch.core",
              "paddle_tpu_torch.amp", "paddle_tpu_torch.random", "torch.")


def _amp_operator(method, op_name):
    def op(self, other):
        if amp_state() is not None and not sys._getframe(1).f_globals.get(
                "__name__", "").startswith(_OP_BODIES):
            self, other = maybe_cast_inputs(op_name, [self, other])
        return method(self, other)

    op.__name__ = method.__name__
    op._amp_original = method
    return op


def _operator_names(state) -> tuple:
    if state["level"] == "O2":
        return tuple(OPERATOR_OPS)
    listed = state["white"] | state["black"]
    return tuple(m for m, op in OPERATOR_OPS.items() if op in listed)


@contextlib.contextmanager
def _operators(names):
    """Amp-aware ``Tensor`` operators for ``names`` while any scope that
    needs them is open (process-wide; each checks this thread's state)."""
    from ..core.tensor import Tensor

    with _install_lock:
        _installed["depth"] += 1
        for name in set(names) - set(_installed["names"]):
            setattr(Tensor, name, _amp_operator(getattr(torch.Tensor, name),
                                                OPERATOR_OPS[name]))
        _installed["names"] = tuple(set(_installed["names"]) | set(names))
    try:
        yield
    finally:
        with _install_lock:
            _installed["depth"] -= 1
            if _installed["depth"] == 0:
                for name in _installed["names"]:
                    if name in Tensor.__dict__:
                        delattr(Tensor, name)
                _installed["names"] = ()


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16"):
    """The mixed-precision policy for ops run inside: ``level`` "O1" (the
    lists) or "O2" (everything low but the black list), ``dtype``
    "bfloat16" or "float16"; custom lists add op names."""
    prev = amp_state()
    ops = contextlib.nullcontext()
    if enable:
        white = set(WHITE_OPS)
        black = set(BLACK_OPS)
        if custom_white_list:
            white |= set(custom_white_list)
        if custom_black_list:
            black |= set(custom_black_list)
        _tls.amp = {"level": level, "dtype": dtype, "white": white,
                    "black": black, "low": to_torch_dtype(dtype)}
        ops = _operators(_operator_names(_tls.amp))
    else:
        _tls.amp = None
    try:
        with ops:
            yield
    finally:
        _tls.amp = prev


amp_guard = auto_cast


def decorate(models, optimizers=None, level="O1", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """O2: cast the models' parameters to the low dtype (``_casted_dtype``
    records it) and give the optimizers float32 master weights
    (``_multi_precision``); O1 leaves both as they are."""
    if level == "O2":
        single = not isinstance(models, (list, tuple))
        for m in [models] if single else models:
            m.to(dtype=dtype)
            m._casted_dtype = dtype
        if optimizers is not None:
            opts = [optimizers] if not isinstance(optimizers, (list, tuple)) \
                else optimizers
            for o in opts:
                o._multi_precision = True
    if optimizers is None:
        return models
    return models, optimizers
