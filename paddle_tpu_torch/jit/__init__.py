"""``paddle.jit`` — the port of ``paddle_tpu/jit/__init__.py``
(``InputSpec``, ``TracedLayer``, ``to_static``, ``save``, ``load``,
``TranslatedLayer``, ``not_to_static``, ``ProgramTranslator``,
``set_code_level``, ``set_verbosity``).

``to_static`` keeps the reference's interface and its rules: the
dy2static pass (:mod:`.dy2static`) converts the target's control flow, a
cache keeps one runner a call signature (``_sig_of``), a call draws one
key (``core.rng.next_rng_key``) and runs inside ``trace_rng_scope(key)``
without recording (its output takes no gradient, as the reference's),
and a layer's buffers (BatchNorm's running statistics) are updated. The
reference compiles each signature with ``jax.jit``; the port runs the
target eagerly, on the card too, so its dropout draws the reference's
bits from the same key. (A CUDA graph a signature is speed work, ROADMAP
Queue 1 item 5.)

``save`` writes ``.pdparams`` as the reference does and, with
``input_spec``, a ``.pdmodel``: a pickle under the magic
``"paddle_tpu_torch.jit.v1"`` with the reference's feed/fetch fields,
holding a ``torch.export`` program of the eval forward at the spec's
static shapes, weights included (``torch.export.save`` to bytes), the
counterpart of the reference's StableHLO. The kernels launch through
``ctypes``, which ``torch.export`` cannot trace, so the forward entry
points an eval forward reaches (the LayerNorm forward and the flash
forward; dropout is the identity at eval) are ``torch.library`` custom
ops while ``torch.compiler.is_exporting()``: the loaded program
launches the same hand-written kernels, and their counters show it.
"""
from __future__ import annotations

import functools
import io
import os
import pickle
import sys

import numpy as np
import torch

from ..core import rng as rng_mod
from ..core.dtype import to_torch_dtype
from ..core.tensor import as_port

__all__ = ["InputSpec", "TracedLayer", "to_static", "save", "load",
           "TranslatedLayer", "not_to_static", "ignore_module",
           "ProgramTranslator", "set_code_level", "set_verbosity"]

#: the magic of the port's ``.pdmodel``; the reference's is its own
MAGIC = "paddle_tpu_torch.jit.v1"
REFERENCE_MAGIC = "paddle_tpu.jit.v1"


class InputSpec:
    """The reference's ``paddle.static.InputSpec``."""

    def __init__(self, shape, dtype="float32", name=None):
        self.shape = tuple(shape)
        self.dtype = dtype
        self.name = name


def _sig_of(args):
    sig = []
    for a in args:
        if isinstance(a, torch.Tensor):
            sig.append(("T", tuple(a.shape), str(a.dtype), str(a.device)))
        elif isinstance(a, np.ndarray):
            sig.append(("A", a.shape, str(a.dtype)))
        else:
            sig.append(("S", a))
    return tuple(sig)


def _as_input(x):
    return x if isinstance(x, torch.Tensor) else as_port(
        torch.as_tensor(np.asarray(x)))


class TracedLayer:
    """A layer or function behind ``to_static``: one runner a call
    signature, each running the target without recording under one key's
    scope."""

    def __init__(self, fn_or_layer, input_spec=None, donate_buffers=False):
        self._target = fn_or_layer
        self._input_spec = input_spec
        self._cache = {}
        self._is_layer = isinstance(fn_or_layer, torch.nn.Module)

    def __call__(self, *args, **kwargs):
        if not ProgramTranslator.get_instance().enable_to_static:
            # the global dy2static switch: run the original as it is
            return self._target(*args, **kwargs)
        key = _sig_of(args)
        if key not in self._cache:
            self._cache[key] = self._build(args, kwargs)
        return self._cache[key](*args, **kwargs)

    def _build(self, args, kwargs):
        target = self._target

        def runner(*xs, **kw):
            key = rng_mod.next_rng_key()
            with torch.no_grad(), rng_mod.trace_rng_scope(key):
                out = target(*[_as_input(x) for x in xs], **kw)
            return as_port(out)

        return runner


def to_static(layer=None, input_spec=None, build_strategy=None, backend=None,
              convert_control_flow=True, **kwargs):
    if layer is None:
        return functools.partial(to_static, input_spec=input_spec,
                                 convert_control_flow=convert_control_flow)
    if convert_control_flow:
        from .dy2static import convert_control_flow as _convert

        def _safe_convert(fn):
            try:
                return _convert(fn)
            except Exception as e:  # noqa: BLE001 — conversion must not
                # break functions it cannot parse: they run unconverted
                print(f"[paddle_tpu_torch] dy2static conversion of "
                      f"{getattr(fn, '__name__', fn)!r} failed "
                      f"({type(e).__name__}: {e}); running unconverted",
                      file=sys.stderr)
                return fn

        if isinstance(layer, torch.nn.Module):
            converted = _safe_convert(type(layer).forward)
            if converted is not type(layer).forward:
                layer.forward = converted.__get__(layer)
        else:
            layer = _safe_convert(layer)
    traced = TracedLayer(layer, input_spec)
    if isinstance(layer, torch.nn.Module):
        # keep the Layer's interface: the traced call beside it
        layer.__dict__["_traced"] = traced

        def patched_call(*args, **kw):
            return traced(*args, **kw)

        layer.__dict__["__traced_call__"] = patched_call
        layer.__dict__["forward_traced"] = traced
        return layer
    return traced


class _EvalForward(torch.nn.Module):
    """The layer's forward as the module ``torch.export`` traces (its
    parameters and buffers become the program's)."""

    def __init__(self, layer):
        super().__init__()
        self.layer = layer

    def forward(self, *xs):
        return self.layer(*xs)


def save(layer, path, input_spec=None, **configs):
    """``.pdparams`` (the state dict and the class name, as the
    reference writes them) and, given ``input_spec`` and a layer, the
    ``.pdmodel`` of its eval forward (see the module docstring)."""
    from ..framework import save as _save

    state = layer.state_dict() if hasattr(layer, "state_dict") else {}
    _save({"state_dict": state, "class": layer.__class__.__name__},
          path + ".pdparams")
    if input_spec is None or not isinstance(layer, torch.nn.Module):
        # drop a stale program from an earlier save: its weights no
        # longer match the .pdparams just written
        if os.path.exists(path + ".pdmodel"):
            os.remove(path + ".pdmodel")
        return
    device = next((p.device for p in layer.parameters()), None)
    example = tuple(torch.zeros(tuple(s.shape), dtype=to_torch_dtype(s.dtype),
                                device=device) for s in input_spec)
    was_training = layer.training
    layer.eval()
    try:
        with torch.no_grad():
            program = torch.export.export(_EvalForward(layer), example,
                                          strict=False)
    finally:
        if was_training:
            layer.train()
    buf = io.BytesIO()
    torch.export.save(program, buf)
    n_out = len(program.graph_signature.user_outputs)
    meta = {
        "magic": MAGIC,
        "program": buf.getvalue(),
        "in_shapes": [tuple(s.shape) for s in input_spec],
        "in_dtypes": [str(s.dtype) for s in input_spec],
        # the reference's feed/fetch view (static/io.py's schema)
        "feed_names": [getattr(s, "name", None) or f"x{i}"
                       for i, s in enumerate(input_spec)],
        "feed_shapes": [tuple(s.shape) for s in input_spec],
        "feed_dtypes": [str(s.dtype) for s in input_spec],
        "fetch_names": [f"out{i}" for i in range(n_out)],
    }
    with open(path + ".pdmodel", "wb") as f:
        pickle.dump(meta, f, protocol=4)


class TranslatedLayer:
    """A loaded, inference-only program (the reference's
    ``TranslatedLayer``): called with the spec's inputs, it runs the
    exported eval forward on the device its weights were saved from."""

    def __init__(self, meta):
        self._meta = meta
        self._program = torch.export.load(io.BytesIO(meta["program"]))
        self._module = self._program.module()
        self._device = next((t.device for t in
                             self._program.state_dict.values()), None)
        self.training = False

    def __call__(self, *xs):
        args = []
        for x, dt in zip(xs, self._meta["in_dtypes"]):
            t = x if isinstance(x, torch.Tensor) else torch.as_tensor(
                np.asarray(x))
            args.append(t.to(device=self._device, dtype=to_torch_dtype(dt)))
        with torch.no_grad():
            out = self._module(*args)
        if isinstance(out, (list, tuple)):
            outs = [as_port(o) for o in out]
            return outs[0] if len(outs) == 1 else outs
        return as_port(out)

    forward = __call__

    def eval(self):
        return self

    def train(self):
        raise RuntimeError("TranslatedLayer is inference-only; finetune from "
                           "the .pdparams state_dict instead")


def load(path, **configs):
    """A :class:`TranslatedLayer` for the port's ``.pdmodel``; else the
    ``.pdparams`` dict. The reference's own StableHLO artifact and a
    Paddle ProgramDesc raise (their ``.pdparams`` load with
    ``paddle.load``)."""
    from ..framework import load as _load

    if os.path.exists(path + ".pdmodel"):
        with open(path + ".pdmodel", "rb") as f:
            head = f.read(1)
        if head != b"\x80":  # a Paddle ProgramDesc protobuf
            raise NotImplementedError(
                f"{path}.pdmodel is a Paddle ProgramDesc: running a static "
                f"program is ROADMAP Queue 1 item 12f; its weights load "
                f"with paddle.load")
        with open(path + ".pdmodel", "rb") as f:
            meta = pickle.load(f)
        if meta.get("magic") == MAGIC:
            return TranslatedLayer(meta)
        if meta.get("magic") == REFERENCE_MAGIC:
            raise RuntimeError(
                f"{path}.pdmodel is the JAX package's StableHLO program "
                f"({REFERENCE_MAGIC!r}), which belongs to paddle_tpu and "
                f"does not run here; load its weights with "
                f"paddle.load({path + '.pdparams'!r}) into the layer, or "
                f"save the layer with this package's jit.save")
    return _load(path + ".pdparams")


def not_to_static(fn=None):
    return fn


def ignore_module(*args, **kwargs):
    return None


class ProgramTranslator:
    """The process-wide dy2static switch: ``enable(False)`` makes
    ``to_static`` targets run as they are."""

    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
            cls._instance.enable_to_static = True
        return cls._instance

    @classmethod
    def get_instance(cls):
        return cls()

    def enable(self, enable_to_static: bool):
        self.enable_to_static = bool(enable_to_static)


def set_code_level(level=100, also_to_stdout=False):
    """The dy2static code-dump level (an environment flag, as the
    reference's)."""
    os.environ["PADDLE_TPU_D2S_CODE_LEVEL"] = str(level)


def set_verbosity(level=0, also_to_stdout=False):
    """The dy2static logging verbosity (an environment flag)."""
    os.environ["PADDLE_TPU_D2S_VERBOSITY"] = str(level)
