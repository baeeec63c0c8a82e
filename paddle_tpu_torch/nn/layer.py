"""``Layer``, the module base class — the port of
``paddle_tpu/nn/layer.py`` (``ParamAttr``, ``Parameter``, ``Layer``).

**The decision:** ``Layer`` is a ``torch.nn.Module`` and a
:class:`Parameter` is a ``torch.nn.Parameter`` that also carries the
port's ``Tensor`` methods (``numpy``, ``stop_gradient``, ``set_value``
...). Torch's registry, ``__setattr__``, hooks, ``_apply``, autograd and
``torch.func.functional_call`` do the work; ``Layer`` adds Paddle's
names and return types on top:

- ``parameters()`` and ``buffers()`` are lists; ``named_parameters(prefix,
  include_sublayers)`` and ``named_buffers`` are generators, as in the
  reference; each also takes torch's ``recurse`` / ``remove_duplicate``,
  which torch's own code passes;
- ``state_dict()`` holds the live parameters and the persistable buffers
  under their structured names (``encoder.layers.0.linear1.weight``),
  which are the reference's;
- ``to(device, dtype, blocking)`` takes Paddle's strings (``"gpu"``,
  ``"bfloat16"``) and casts floating parameters and buffers;
- ``register_forward_pre_hook`` / ``register_forward_post_hook`` are
  torch's forward hooks (the same calling convention) and return torch's
  handles, whose ``remove()`` the reference's handles have;
- ``full_name()`` counts per prefix (``linear_0``, ``linear_1`` ...) as
  the reference's ``unique_name`` does; a parameter is named
  ``param_<n>`` from its own counter unless its ``ParamAttr`` names it.

Parameters are made on ``set_device``'s place, else the card, by the
initializers of :mod:`.initializer`, which draw from the key schedule
(``core.rng``) in the reference's order. Inside ``LazyGuard``
(``framework``) they are meta tensors until ``lazy_materialize``.

``LayerMixin`` gives any ``torch.nn.Module`` Paddle's ``set_state_dict``;
the GPT's modules, plain ``torch.nn.Module``\\ s, take it.
"""
from __future__ import annotations

import collections
import contextlib
import copy
import itertools
import threading

import numpy as np
import torch

from .. import _device
from .._device import resolve_device
from ..core.dtype import convert_dtype, get_default_dtype, to_torch_dtype
from ..core.tensor import Tensor
from . import initializer as I

__all__ = ["LayerMixin", "ParamAttr", "Parameter", "Layer", "unique_name"]


class _UniqueName:
    """The reference's ``unique_name.generate``: ``<prefix>_<n>``, ``n``
    counting from 0 per prefix, process-wide."""

    def __init__(self):
        self._counters: dict = {}
        self._lock = threading.Lock()

    def generate(self, prefix: str = "tmp") -> str:
        with self._lock:
            c = self._counters.setdefault(prefix, itertools.count())
            return f"{prefix}_{next(c)}"

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()


unique_name = _UniqueName()

#: > 0 inside ``framework.LazyGuard``: parameters are made on the meta device
_LAZY_INIT_DEPTH = 0


class LayerMixin:
    """Mixed into a ``torch.nn.Module`` before it."""

    def set_state_dict(self, state_dict, use_structured_name=True):
        """Copy each entry of ``state_dict`` (tensors or arrays, keyed by
        structured name, as ``state_dict()`` and ``paddle.load`` give
        them) into the module's parameter or buffer of that name, in
        place and cast to its dtype; the shapes must match. Returns
        ``(missing, unexpected)``: the module's names the dict lacks and
        the dict's names the module lacks, as the reference does.
        ``use_structured_name`` is the reference's argument; the keys are
        structured names either way."""
        own = self.state_dict(keep_vars=True)
        missing, unexpected = [], []
        with torch.no_grad():
            for k, v in state_dict.items():
                if k not in own:
                    unexpected.append(k)
                    continue
                dst = own[k]
                src = v if isinstance(v, torch.Tensor) \
                    else torch.as_tensor(np.array(v))
                if tuple(src.shape) != tuple(dst.shape):
                    raise ValueError(
                        f"set_state_dict {k}: shape {tuple(src.shape)} vs "
                        f"the module's {tuple(dst.shape)}")
                torch.Tensor.copy_(dst, src.detach().to(dst.dtype))
        missing = [k for k in own if k not in state_dict]
        return missing, unexpected

    load_dict = set_state_dict


class ParamAttr:
    """A parameter's attributes: its ``name``, ``initializer``, learning
    rate multiplier, regularizer (``L1Decay`` / ``L2Decay``: its
    coefficient replaces the optimizer's ``weight_decay`` for this
    parameter), ``trainable`` and ``need_clip``."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        if attr is None:
            return ParamAttr()
        if isinstance(attr, ParamAttr):
            return attr
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        if isinstance(attr, I.Initializer):
            return ParamAttr(initializer=attr)
        if attr is False:
            return False
        raise TypeError(f"Invalid ParamAttr spec: {attr!r}")


class Parameter(Tensor, torch.nn.Parameter):
    """A trainable tensor: a ``torch.nn.Parameter`` with the port's
    ``Tensor`` methods and the reference's attributes ``name``,
    ``trainable`` (``not stop_gradient``), ``optimize_attr``,
    ``regularizer`` and ``need_clip``. Torch operations on it return
    plain tensors, as on any ``torch.nn.Parameter``. A deep copy keeps
    the attributes (the name included), as the reference's does."""

    def __new__(cls, data=None, requires_grad=True, name=None):
        if data is None:
            data = torch.empty(0)
        return torch.Tensor._make_subclass(cls, data.detach(),
                                           bool(requires_grad))

    def __init__(self, data=None, requires_grad=True, name=None):
        self.name = name or unique_name.generate("param")
        self.optimize_attr = {"learning_rate": 1.0}
        self.regularizer = None
        self.need_clip = True

    @property
    def name(self) -> str:
        # torch.Tensor's own ``name`` is read-only; Paddle's is settable
        return self.__dict__.get("_name")

    @name.setter
    def name(self, value: str) -> None:
        self.__dict__["_name"] = value

    @property
    def trainable(self) -> bool:
        return self.requires_grad

    @trainable.setter
    def trainable(self, flag: bool) -> None:
        self.requires_grad_(bool(flag))

    def __deepcopy__(self, memo):
        if id(self) in memo:
            return memo[id(self)]
        out = Parameter.__new__(type(self), self.data.clone(
            memory_format=torch.preserve_format), self.requires_grad)
        memo[id(self)] = out
        out.__dict__.update(copy.deepcopy(self.__dict__, memo))
        return out

    def __repr__(self):
        return (f"Parameter {self.name} "
                f"(shape={list(self.shape)}, dtype={self.dtype}, "
                f"stop_gradient={self.stop_gradient}):\n"
                f"{torch.Tensor.__repr__(self.detach())}")


def _as_parameter(t, name=None) -> Parameter:
    """``t`` as a :class:`Parameter` (itself when it is one): the same
    storage, trainable unless ``t`` stops the gradient."""
    if isinstance(t, Parameter):
        return t
    trainable = t.requires_grad if isinstance(t, torch.Tensor) else True
    return Parameter(t.detach() if isinstance(t, torch.Tensor)
                     else torch.as_tensor(np.asarray(t)), trainable, name)


def _torch_device(device):
    """Paddle's device spellings (``"gpu"``, ``"gpu:1"``, a ``Place``) as
    a torch device; None stays None."""
    if device is None or isinstance(device, torch.device):
        return device
    if hasattr(device, "torch_device"):
        return torch.device(device.torch_device())
    name, _, idx = str(device).partition(":")
    if name in ("gpu", "cuda"):
        return resolve_device("cuda:" + (idx or "0"))
    return resolve_device(device)


@contextlib.contextmanager
def placed(device):
    """Parameters made inside the block go to ``device`` (None: leave
    ``set_device``'s choice as it is) — for layers that take torch's
    ``device`` argument beside Paddle's."""
    if device is None:
        yield
        return
    prev = _device._CURRENT
    _device._CURRENT = resolve_device(device)
    try:
        yield
    finally:
        _device._CURRENT = prev


class Layer(LayerMixin, torch.nn.Module):
    """Paddle's ``nn.Layer`` as a ``torch.nn.Module`` (see the module
    docstring). Subclasses define ``forward``; ``__call__`` runs the
    forward hooks around it."""

    def __init__(self, name_scope=None, dtype=None):
        torch.nn.Module.__init__(self)
        self._dtype = dtype or get_default_dtype()
        self._full_name = unique_name.generate(
            name_scope or self.__class__.__name__.lower())
        self._casted_dtype = None  # set by amp.decorate at O2

    # ------------------------------------------------------------ parameters
    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None):
        """A :class:`Parameter` of ``shape`` made by, in order of
        precedence, ``attr``'s initializer, ``set_global_initializer``'s,
        ``default_initializer``, else ``Constant(0)`` for a bias and
        ``XavierNormal`` otherwise — the reference's. ``attr=False``
        returns None. Inside ``LazyGuard`` the parameter is a meta tensor
        that remembers its initializer."""
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        dtype = dtype or self._dtype
        init = (attr.initializer or I._global_default(is_bias)
                or default_initializer)
        if init is None:
            init = I.Constant(0.0) if is_bias else I.XavierNormal()
        shape = tuple(int(s) for s in shape)
        if _LAZY_INIT_DEPTH > 0:
            if isinstance(init, I.Assign):
                shape = tuple(np.shape(init._array()))
            value = torch.empty(shape, dtype=to_torch_dtype(dtype),
                                device="meta")
            p = Parameter(value, attr.trainable, attr.name)
            p._lazy_init = (init, shape, dtype)
        else:
            p = Parameter(init(shape, dtype), attr.trainable, attr.name)
        p.optimize_attr = {"learning_rate": attr.learning_rate}
        p.regularizer = attr.regularizer
        p.need_clip = attr.need_clip
        return p

    def lazy_materialize(self, sharding_fn=None) -> int:
        """Give every meta parameter made under ``LazyGuard`` its value,
        drawn now by its initializer in ``named_parameters`` order (the
        reference's), on ``set_device``'s place. Returns how many were
        made. ``sharding_fn`` is the reference's per-parameter sharding;
        the port places whole parameters, so it must return None."""
        n = 0
        for name, p in list(self.named_parameters()):
            if not p.is_meta:
                continue
            if sharding_fn is not None and sharding_fn(name, p) is not None:
                raise NotImplementedError(
                    "sharded materialisation: the port places whole "
                    "parameters (ROADMAP Queue 1 item 12e)")
            init, shape, dtype = p._lazy_init
            new = Parameter.__new__(Parameter, init(shape, dtype),
                                    p.requires_grad)
            new.__dict__.update({k: v for k, v in p.__dict__.items()
                                 if k != "_lazy_init"})
            for mod in self.modules():
                for key, q in mod._parameters.items():
                    if q is p:
                        mod._parameters[key] = new
            n += 1
        return n

    def add_parameter(self, name: str, parameter):
        """Register ``parameter`` (a tensor becomes a :class:`Parameter`
        on the same storage; None is allowed) and return it."""
        p = None if parameter is None else _as_parameter(parameter)
        self.register_parameter(name, p)
        return p

    def add_sublayer(self, name: str, sublayer):
        self.add_module(str(name), sublayer)
        return sublayer

    def register_buffer(self, name: str, tensor, persistable=True,
                        persistent=None):
        """A buffer: moved and cast with the layer, in ``state_dict`` when
        ``persistable`` (torch's ``persistent``)."""
        keep = persistable if persistent is None else persistent
        torch.nn.Module.register_buffer(self, name, tensor,
                                        persistent=bool(keep))
        return tensor

    # ------------------------------------------------------------ traversal
    def parameters(self, include_sublayers=True, recurse=None) -> list:
        return [p for _, p in self.named_parameters(
            include_sublayers=include_sublayers, recurse=recurse)]

    def named_parameters(self, prefix="", include_sublayers=True,
                         recurse=None, remove_duplicate=True):
        if recurse is not None:
            include_sublayers = recurse
        return torch.nn.Module.named_parameters(
            self, prefix=prefix, recurse=include_sublayers,
            remove_duplicate=remove_duplicate)

    def buffers(self, include_sublayers=True, recurse=None) -> list:
        return [b for _, b in self.named_buffers(
            include_sublayers=include_sublayers, recurse=recurse)]

    def named_buffers(self, prefix="", include_sublayers=True, recurse=None,
                      remove_duplicate=True):
        if recurse is not None:
            include_sublayers = recurse
        return torch.nn.Module.named_buffers(
            self, prefix=prefix, recurse=include_sublayers,
            remove_duplicate=remove_duplicate)

    def sublayers(self, include_self=False) -> list:
        out = [self] if include_self else []
        for sub in self._modules.values():
            if sub is not None:
                out.extend(sub.sublayers(include_self=True)
                           if isinstance(sub, Layer) else sub.modules())
        return out

    def named_sublayers(self, prefix="", include_self=False):
        if include_self:
            yield prefix.rstrip("."), self
        for name, sub in self._modules.items():
            if sub is None:
                continue
            if isinstance(sub, Layer):
                yield from sub.named_sublayers(f"{prefix}{name}.", True)
            else:
                yield from sub.named_modules(prefix=f"{prefix}{name}")

    def apply(self, fn):
        """``fn`` on this layer, then on each sublayer in pre-order (the
        reference's order; torch's ``apply`` visits children first)."""
        for layer in self.sublayers(include_self=True):
            fn(layer)
        return self

    def full_name(self) -> str:
        return self._full_name

    # ------------------------------------------------------------ state
    def state_dict(self, destination=None, include_sublayers=True,
                   use_hook=True, *, prefix="", keep_vars=True):
        """The parameters and persistable buffers by structured name — the
        live tensors, as the reference returns them (torch's
        ``keep_vars=False`` gives detached ones). ``include_sublayers=
        False`` keeps this layer's own."""
        if include_sublayers:
            return torch.nn.Module.state_dict(
                self, destination=destination, prefix=prefix,
                keep_vars=keep_vars)
        dest = destination if destination is not None \
            else collections.OrderedDict()
        self._save_to_state_dict(dest, prefix, keep_vars)
        return dest

    # ------------------------------------------------------------ dtype
    def to(self, device=None, dtype=None, blocking=None, *args, **kwargs):
        """Move and cast: ``device`` a Paddle or torch spelling, ``dtype``
        a Paddle or torch dtype (floating parameters and buffers only).
        Torch's forms (``to(torch.bfloat16)``, ``to(tensor)``) work too."""
        if isinstance(device, (torch.dtype, str)) and dtype is None and \
                _is_dtype_name(device):
            device, dtype = None, device
        if isinstance(device, torch.Tensor):
            device, dtype = device.device, device.dtype
        dev = _torch_device(device)
        dt = to_torch_dtype(dtype)
        if dt is not None:
            self._dtype = convert_dtype(dt)
        return torch.nn.Module.to(
            self, **{k: v for k, v in (("device", dev), ("dtype", dt))
                     if v is not None},
            non_blocking=blocking is False)

    def astype(self, dtype):
        return self.to(dtype=dtype)

    # ------------------------------------------------------------ hooks
    def register_forward_pre_hook(self, hook):
        """``hook(layer, inputs)``, before ``forward``; a non-None result
        replaces the inputs. Returns a handle with ``remove()``."""
        return torch.nn.Module.register_forward_pre_hook(self, hook)

    def register_forward_post_hook(self, hook):
        """``hook(layer, inputs, outputs)``, after ``forward``; a non-None
        result replaces the outputs. Returns a handle with ``remove()``."""
        return torch.nn.Module.register_forward_hook(self, hook)

    # ------------------------------------------------------------ functional
    def functional_state(self):
        """``(params, buffers)``: ordered name -> tensor dicts."""
        return (collections.OrderedDict(self.named_parameters()),
                collections.OrderedDict(self.named_buffers()))

    def functional_call(self, params: dict, buffers: dict, *inputs,
                        **kwargs):
        """``forward`` with the tensors of ``params`` and ``buffers``
        (name -> tensor; names left out keep the layer's own) in place of
        the layer's, through ``torch.func.functional_call``; gradients
        flow to the given tensors. Returns ``(outputs, new_buffers)``:
        the given buffers are copied first, so an update made in the
        forward (BatchNorm's running statistics) lands in
        ``new_buffers`` and not in the caller's tensors."""
        new_buffers = {k: v.clone() for k, v in (buffers or {}).items()}
        out = torch.func.functional_call(
            self, {**params, **new_buffers}, tuple(inputs), kwargs,
            strict=False)
        own = dict(self.named_buffers())
        return out, {k: new_buffers.get(k, b) for k, b in own.items()}

    def clear_gradients(self) -> None:
        for p in self.parameters():
            p.grad = None

    def extra_repr(self) -> str:
        return ""


def _is_dtype_name(value) -> bool:
    if isinstance(value, torch.dtype):
        return True
    try:
        to_torch_dtype(value)
        return True
    except (ValueError, TypeError):
        return False
