"""``nn.utils`` — the port of ``paddle_tpu/nn/utils.py``: the weight-norm
and spectral-norm reparameterisations and the parameter/vector
conversions.

A reparameterisation replaces a layer's parameter by auxiliary
parameters and a forward pre-hook (``Layer.register_forward_pre_hook``)
that recomputes the weight from them before every call, as the
reference's hooks do: the weight becomes a plain attribute and the
auxiliaries are what trains.
"""
from __future__ import annotations

import torch

from .layer import Parameter

__all__ = ["weight_norm", "remove_weight_norm", "spectral_norm",
           "parameters_to_vector", "vector_to_parameters"]

_WHOLE = object()  # dim=None: the norm of the whole tensor


def _norm_except(w, dim):
    if dim is _WHOLE:
        return torch.sqrt((w * w).sum())
    axes = [i for i in range(w.dim()) if i != dim]
    return torch.sqrt((w * w).sum(axes, keepdim=True))


def _leaf(t) -> Parameter:
    return Parameter(t.detach().clone(), True)


def weight_norm(layer, name="weight", dim=0):
    """``w = g * v / ||v||``, the norm over every axis but ``dim`` (None:
    the whole tensor; a negative one counts from the end); ``<name>_v``
    and ``<name>_g`` become the layer's parameters in place of
    ``name``."""
    w = getattr(layer, name)
    if dim is not None and dim < 0:
        dim += w.dim()
    dim = _WHOLE if dim is None else dim
    layer.add_parameter(name + "_v", _leaf(w))
    layer.add_parameter(name + "_g", _leaf(_norm_except(w, dim)))

    def compute():
        v = getattr(layer, name + "_v")
        return v / _norm_except(v, dim) * getattr(layer, name + "_g")

    def hook(lyr, inputs):
        object.__setattr__(lyr, name, compute())

    if name in layer._parameters:
        del layer._parameters[name]
    handle = layer.register_forward_pre_hook(hook)
    layer._weight_norm_state = (name, dim, handle)
    object.__setattr__(layer, name, compute())
    return layer


def remove_weight_norm(layer, name="weight"):
    """Bake the current ``g * v / ||v||`` back into a parameter ``name``
    and drop ``<name>_v``, ``<name>_g`` and the hook."""
    state = getattr(layer, "_weight_norm_state", None)
    if state is None:
        raise ValueError(f"weight_norm was not applied to {layer!r}")
    _, dim, handle = state
    handle.remove()
    v = getattr(layer, name + "_v")
    w = v / _norm_except(v, dim) * getattr(layer, name + "_g")
    del layer._parameters[name + "_v"]
    del layer._parameters[name + "_g"]
    layer.__dict__.pop(name, None)
    layer.add_parameter(name, _leaf(w))
    del layer._weight_norm_state
    return layer


def _spectral(w, dim, power_iters, eps):
    """``w / sigma``: ``sigma`` by ``power_iters`` rounds of power
    iteration on ``w`` seen as ``[w.shape[dim], -1]``, from ones."""
    perm = [dim] + [i for i in range(w.dim()) if i != dim]
    mat = w.permute(perm).reshape(w.shape[dim], -1)
    u = torch.ones((mat.shape[0],), dtype=w.dtype, device=w.device)
    v = torch.ones((mat.shape[1],), dtype=w.dtype, device=w.device)
    for _ in range(power_iters):
        v = mat.T @ u
        v = v / (torch.linalg.vector_norm(v) + eps)
        u = mat @ v
        u = u / (torch.linalg.vector_norm(u) + eps)
    return w / (u @ mat @ v)


def spectral_norm(layer, name="weight", n_power_iterations=1, eps=1e-12,
                  dim=None):
    """``w / sigma_max(w)`` recomputed before every call from
    ``<name>_orig``, which takes ``name``'s place as a parameter."""
    dim = 0 if dim is None else dim
    orig = _leaf(getattr(layer, name))
    layer.add_parameter(name + "_orig", orig)
    if name in layer._parameters:
        del layer._parameters[name]

    def hook(lyr, inputs):
        object.__setattr__(lyr, name, _spectral(
            getattr(lyr, name + "_orig"), dim, n_power_iterations, eps))

    handle = layer.register_forward_pre_hook(hook)
    layer._spectral_norm_state = (name, handle)
    object.__setattr__(layer, name, _spectral(orig, dim, n_power_iterations,
                                              eps))
    return layer


def parameters_to_vector(parameters, name=None):
    """The parameters flattened and joined into one vector."""
    return torch.cat([p.reshape(-1) for p in parameters])


def vector_to_parameters(vec, parameters, name=None):
    """Copy consecutive slices of ``vec`` into the parameters, in place."""
    offset = 0
    with torch.no_grad():
        for p in parameters:
            n = p.numel()
            torch.Tensor.copy_(p, vec[offset:offset + n].reshape(p.shape))
            offset += n
    return parameters
