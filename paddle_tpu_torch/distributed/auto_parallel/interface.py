"""Auto-parallel annotations — the port of
``paddle_tpu/distributed/auto_parallel/interface.py``: ``TensorDistAttr``,
``shard_tensor``, ``shard_op``, ``dist_attr``, and ``local_shard``.

The reference's annotation is a ``NamedSharding``: ``shard_tensor`` lays
a host array out over the devices and the returned tensor is the global
array. The port's tensor is one rank's, so ``shard_tensor`` on a tensor
that every rank holds whole (a host array, or a parameter before
``Engine.prepare``) records the annotation (``_sharding_spec``, in the
reference's layout, and ``_dist_attr``) and keeps the value whole, so
every eager op computes the reference's values; :func:`local_shard` is
this rank's piece of it by the annotation, the counterpart of the
reference's ``addressable_shards``. ``Engine.prepare`` cuts annotated
parameters for real; ``reshard`` moves local pieces between layouts.
"""
from __future__ import annotations

import numpy as np
import torch

from ...core.tensor import as_port
from .process_mesh import ProcessMesh

__all__ = ["TensorDistAttr", "shard_tensor", "shard_op", "dist_attr",
           "local_shard"]


class TensorDistAttr:
    """process_mesh + dims_mapping (reference dist_attribute.py)."""

    def __init__(self, process_mesh: ProcessMesh, dims_mapping):
        self.process_mesh = process_mesh
        # dims_mapping[i] = mesh-dim name (or None) that tensor dim i is split over
        self.dims_mapping = list(dims_mapping)

    def partition_spec(self) -> tuple:
        return tuple(self.dims_mapping)

    def __eq__(self, other):
        return (isinstance(other, TensorDistAttr)
                and self.process_mesh == other.process_mesh
                and self.dims_mapping == other.dims_mapping)

    def __repr__(self):
        return f"TensorDistAttr({self.process_mesh}, {self.dims_mapping})"


def _normalize_spec(shard_spec, ndim, mesh: ProcessMesh):
    from .reshard import normalize_spec

    return normalize_spec(shard_spec, ndim, mesh.dim_names)


def _as_tensor(x):
    if isinstance(x, torch.Tensor):
        return x
    return as_port(torch.as_tensor(np.asarray(x)))


def shard_tensor(x, process_mesh: ProcessMesh, shard_spec=None):
    """Annotate ``x`` with a mesh-dim mapping (``["dp", None]`` splits dim
    0 over mesh dim ``dp``) and return it, whole (module docstring): a
    tensor is annotated in place, an array becomes the port's tensor."""
    t = _as_tensor(x)
    spec = _normalize_spec(shard_spec, t.dim(), process_mesh)
    t._sharding_spec = tuple(spec)
    t._dist_attr = TensorDistAttr(process_mesh, spec)
    return t


def local_shard(t, rank: int | None = None):
    """``rank``'s (default: this process's) piece of an annotated tensor
    by its ``_dist_attr``: each dim split over a mesh dim cut into that
    dim's size and the piece at the rank's coordinate kept. A piece that
    ``reshard`` made is its own local shard; None when the mesh does not
    hold the rank."""
    attr = getattr(t, "_dist_attr", None)
    if attr is None:
        return t
    if getattr(t, "_is_local", False):
        return t
    mesh = attr.process_mesh
    coord = mesh.coordinate(rank)
    if coord is None:
        return None
    out = t
    for dim, name in enumerate(attr.dims_mapping):
        if name is None:
            continue
        axis = mesh.dim_names.index(name)
        out = _piece(out, dim, mesh.shape[axis], coord[axis])
    return out


def _piece(t, dim: int, parts: int, index: int):
    size = t.shape[dim]
    if size % parts:
        raise ValueError(f"dimension {dim} of size {size} does not split "
                         f"into {parts}")
    k = size // parts
    return t.narrow(dim, index * k, k)


def shard_op(op_fn, process_mesh: ProcessMesh, in_shard_specs=None,
             out_shard_specs=None):
    """Wrap ``op_fn`` so that its inputs and outputs carry the given
    annotations (reference interface.py ``shard_op``)."""

    def wrapped(*args, **kwargs):
        args = list(args)
        if in_shard_specs is not None:
            for i, spec in enumerate(in_shard_specs):
                if spec is not None and i < len(args):
                    args[i] = shard_tensor(args[i], process_mesh, spec)
        out = op_fn(*args, **kwargs)
        if out_shard_specs is not None:
            single = not isinstance(out, (tuple, list))
            outs = [out] if single else list(out)
            for i, spec in enumerate(out_shard_specs):
                if spec is not None and i < len(outs):
                    outs[i] = shard_tensor(outs[i], process_mesh, spec)
            out = outs[0] if single else type(out)(outs)
        return out

    return wrapped


def dist_attr(x) -> "TensorDistAttr | None":
    return getattr(x, "_dist_attr", None)
