"""The eager Tensor — the port of ``paddle_tpu/core/tensor.py``
(``Tensor``, ``to_tensor``).

**The decision:** ``paddle_tpu_torch.Tensor`` is a subclass of
``torch.Tensor``. ``to_tensor`` and every root function return it, and
torch's default ``__torch_function__`` keeps the subclass through every
torch operation, so a model fed these tensors returns them too (a loss
whose ``numpy()`` works) while its parameters, the serving engine and
the training step stay plain ``torch.Tensor``\\ s. Autograd is torch's:
``backward`` fills the parameters' ``.grad`` as for any tensor.

The subclass adds the reference's methods and properties that torch
lacks: ``numpy()`` (detached and copied to the host, so it works on a
CUDA tensor that requires a gradient; bfloat16 comes back as float32),
``stop_gradient`` over ``requires_grad``, ``astype``/``cast``,
``clear_grad``, ``set_value``, ``place``, ``gradient``, ``value`` and the
tensor functions installed by ``tensor_ops.methods``. A method torch
already has keeps torch's signature — ``shape`` stays a ``torch.Size``
(torch's own code does tuple arithmetic on it; ``paddle.shape(x)`` gives
the reference's tensor of dims), ``x.sum(dim=)``, ``x.transpose(d0,
d1)``, ``x.size()`` — and the root functions (``paddle.sum(x, axis=)``)
take the reference's.
"""
from __future__ import annotations

import copy
import hashlib

import numpy as np
import torch

from .._device import resolve_device
from . import dtype as dtype_mod
from .place import Place, place_of

__all__ = ["Tensor", "to_tensor", "as_port", "as_tensor_arg"]


class Tensor(torch.Tensor):
    """A ``torch.Tensor`` with the reference's ``Tensor`` methods."""

    # ------------------------------------------------------------ properties
    @property
    def stop_gradient(self) -> bool:
        return not self.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, flag: bool) -> None:
        flag = bool(flag)
        if flag == (not self.requires_grad):
            return
        if not self.is_leaf:
            raise RuntimeError(
                "stop_gradient=True on a computed tensor: take .detach() "
                "instead (torch keeps a non-leaf's gradient flag)")
        if not flag and not (self.is_floating_point() or self.is_complex()):
            return  # integer tensors never take a gradient (the reference's)
        self.requires_grad_(not flag)

    @property
    def place(self) -> Place:
        return place_of(self.device)

    # ------------------------------------------------------------ conversion
    def numpy(self) -> np.ndarray:
        """The values as a host ndarray (a copy for a CUDA tensor);
        bfloat16 is returned as float32, which numpy lacks."""
        t = self.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return torch.Tensor.numpy(t.cpu())

    def astype(self, dtype) -> "Tensor":
        return self.to(dtype_mod.to_torch_dtype(dtype))

    cast = astype

    # ------------------------------------------------------------ autograd
    def clear_grad(self) -> None:
        self.grad = None

    clear_gradient = clear_grad

    def retain_grads(self) -> None:
        self.retain_grad()

    def gradient(self):
        """The gradient as a host ndarray, or None."""
        return None if self.grad is None else as_port(self.grad).numpy()

    # ------------------------------------------------------------ mutation
    def set_value(self, value) -> None:
        """Write ``value`` (a tensor or anything ``np.asarray`` takes) into
        this tensor in place, cast to its dtype; the shapes must match."""
        src = value if isinstance(value, torch.Tensor) \
            else torch.as_tensor(np.asarray(value))
        if tuple(src.shape) != tuple(self.shape):
            raise ValueError(f"set_value shape mismatch: {tuple(src.shape)} "
                             f"vs {tuple(self.shape)}")
        with torch.no_grad():
            torch.Tensor.copy_(self, src.to(self.dtype))

    # ------------------------------------------------------------ copying
    def __deepcopy__(self, memo):
        """A copy of a leaf tensor (values, gradient flag, attributes),
        as torch's ``deepcopy`` of a tensor gives it, kept the port's
        ``Tensor`` (torch's own copy needs a subclass ``new_empty``)."""
        if id(self) in memo:
            return memo[id(self)]
        if not self.is_leaf:
            raise RuntimeError("only leaf tensors (made by the user, not "
                               "computed) support deepcopy, as in torch")
        with torch.no_grad():
            out = torch.Tensor.clone(self).as_subclass(type(self))
        out.requires_grad_(self.requires_grad)
        memo[id(self)] = out
        out.__dict__.update(copy.deepcopy(self.__dict__, memo))
        return out

    # ------------------------------------------------------------ misc
    def value(self) -> "Tensor":
        return self

    def get_tensor(self) -> "Tensor":
        return self

    def _md5sum(self) -> str:
        return hashlib.md5(self.numpy().tobytes()).hexdigest()


def _device_of(place) -> torch.device:
    if isinstance(place, Place):
        return resolve_device(place.torch_device())
    if isinstance(place, str):
        name, _, idx = place.partition(":")
        place = ("cuda:" + (idx or "0")) if name in ("gpu", "cuda") else place
    return resolve_device(place)


def as_port(x):
    """``x`` as the port's ``Tensor`` (no copy; the autograd graph is
    kept), recursively through lists and tuples."""
    if isinstance(x, Tensor):
        return x
    if isinstance(x, torch.Tensor):
        return x.as_subclass(Tensor)
    if isinstance(x, (list, tuple)):
        return type(x)(as_port(v) for v in x)
    return x


def to_tensor(data, dtype=None, place=None, stop_gradient=True) -> Tensor:
    """``paddle.to_tensor``: a new tensor of ``data`` on ``place`` (None:
    ``set_device``'s choice, else the card). A Python float (or a list of
    them) becomes the default dtype (float32), a Python int int64, a
    numpy array keeps its dtype; ``dtype`` casts. ``stop_gradient=False``
    makes a leaf that takes a gradient (floating dtypes only)."""
    dev = _device_of(place)
    tdt = dtype_mod.to_torch_dtype(dtype)
    if isinstance(data, torch.Tensor):
        t = data.detach().to(dev)
        t = t.to(tdt) if tdt is not None else t
        t = t.clone() if t.data_ptr() == data.data_ptr() else t
    elif isinstance(data, (list, tuple)) and data and all(
            isinstance(v, torch.Tensor) for v in data):
        t = torch.stack([v.detach().to(dev) for v in data])
        t = t.to(tdt) if tdt is not None else t
    else:
        was_ndarray = isinstance(data, np.ndarray)
        arr = np.asarray(data)
        if tdt is None and arr.dtype == np.float64 and not was_ndarray:
            tdt = dtype_mod.to_torch_dtype(dtype_mod.get_default_dtype())
        t = torch.from_numpy(np.array(arr, copy=True, order="C")).to(dev)
        t = t.to(tdt) if tdt is not None else t
    t = t.as_subclass(Tensor)
    if not stop_gradient and (t.is_floating_point() or t.is_complex()):
        t.requires_grad_(True)
    return t


def as_tensor_arg(x, like: torch.Tensor | None = None) -> torch.Tensor:
    """An operand as a tensor: a tensor as it is; anything else through
    ``to_tensor`` on ``like``'s device (else the current place)."""
    if isinstance(x, torch.Tensor):
        return x
    return to_tensor(x, place=None if like is None else like.device)
