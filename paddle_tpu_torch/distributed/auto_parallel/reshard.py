"""Reshard — the port of ``paddle_tpu/distributed/auto_parallel/reshard.py``
(``normalize_spec``, ``needs_reshard``, ``reshard``, ``Resharder``).

The reference's reshard is one placement op (``device_put`` eagerly,
``with_sharding_constraint`` under a trace) and XLA emits the collectives.
The port's acts on this rank's local piece (``interface.local_shard``) and
moves it with the port's own collectives (``distributed.collective``), a
mesh dim at a time:

- split before, whole after: an all-gather over the dim's group;
- whole before, split after: a slice at this rank's coordinate;
- split on one tensor dim before, on another after: an all-to-all over
  the dim's group;
- another mesh: the source mesh's ranks gather the value, each rank of
  the target mesh receives it by send / recv from one of them, then
  keeps its slice.

Every rank of the process group calls it with the same arguments (the
meshes' groups are made on first use, by every rank). A piece it returns
is marked local (``_is_local``, its ``_dist_attr`` and ``_global_shape``);
ranks outside the target mesh get None. ``Resharder.log`` records, an
edge each, which of ``all_gather``, ``slice``, ``all_to_all`` and
``send_recv`` moved it (joined with ``+``), or ``noop``: the counterpart
of the reference's ``device_put`` / ``constraint`` / ``noop``.
"""
from __future__ import annotations

import torch

from .. import collective as coll
from .. import env as env_mod
from .interface import TensorDistAttr, local_shard
from .process_mesh import ProcessMesh

__all__ = ["Resharder", "reshard", "needs_reshard", "normalize_spec"]


def needs_reshard(src, dst) -> bool:
    """True when moving src -> dst (``TensorDistAttr``s) actually requires
    data movement (an unknown source always does)."""
    if src is None:
        return True
    if src.process_mesh != dst.process_mesh:
        return True
    return tuple(src.dims_mapping) != tuple(dst.dims_mapping)


def normalize_spec(shard_spec, ndim, dim_names):
    """Validate/expand a shard_spec against a mesh's dim names (the one shared
    implementation; interface._normalize_spec delegates here)."""
    spec = list(shard_spec) if shard_spec is not None else [None] * ndim
    if len(spec) != ndim:
        raise ValueError(f"shard_spec {shard_spec} for a {ndim}-d tensor")
    for s in spec:
        if s is not None and s not in dim_names:
            raise ValueError(f"unknown mesh dim {s!r}; mesh has {dim_names}")
    return spec


def _global_shape(x) -> tuple:
    shape = getattr(x, "_global_shape", None)
    return tuple(x.shape) if shape is None else tuple(shape)


def _mark(t, attr: TensorDistAttr, shape):
    t._is_local = True
    t._dist_attr = attr
    t._sharding_spec = tuple(attr.dims_mapping)
    t._global_shape = tuple(shape)
    return t


def reshard(x, process_mesh, shard_spec=None):
    """Functional reshard (the public auto-parallel API): this rank's piece
    of ``x`` on ``process_mesh`` under ``shard_spec`` (module docstring)."""
    spec = normalize_spec(shard_spec, len(_global_shape(x)),
                          process_mesh.dim_names)
    return Resharder().apply(x, TensorDistAttr(process_mesh, spec))


class Resharder:
    """Move tensors between layouts along producer -> consumer edges;
    ``log`` holds one ``(kinds, dst_spec)`` an edge."""

    def __init__(self):
        self.log = []

    def apply(self, x, dst: TensorDistAttr, src: TensorDistAttr | None = None):
        """``x``'s piece under ``dst``; ``src`` (default: ``x``'s own
        ``_dist_attr``; none: ``x`` is whole on every rank)."""
        src = src if src is not None else getattr(x, "_dist_attr", None)
        spec = tuple(dst.dims_mapping)
        shape = _global_shape(x)
        dst.process_mesh._ensure_groups()
        if src is None:  # whole on every rank
            src = TensorDistAttr(dst.process_mesh, [None] * len(shape))
            local = x
        else:
            local = x if getattr(x, "_is_local", False) else local_shard(x)
        if not needs_reshard(src, dst):
            self.log.append(("noop", spec))
            return x
        kinds = []
        if src.process_mesh != dst.process_mesh:
            out = self._across(local, x, src, dst, shape, kinds)
        else:
            out = self._within(local, src, dst, kinds)
        self.log.append(("+".join(kinds) or "noop", spec))
        return None if out is None else _mark(out, dst, shape)

    # ------------------------------------------------------------ one mesh
    def _within(self, local, src, dst, kinds):
        """A mesh dim whose split moves from tensor dim i to dim j goes by
        one all-to-all where neither dim is split by another mesh dim on
        the way (src[j] and dst[i] free); every other change gathers the
        old split first and then slices the new one (each tensor dim is
        split by one mesh dim at most, so these commute)."""
        mesh = dst.process_mesh
        if local is None:
            return None
        coord = mesh.coordinate()
        smap, dmap = list(src.dims_mapping), list(dst.dims_mapping)
        moves = []
        for axis, name in enumerate(mesh.dim_names):
            i, j = _dim_of(smap, name), _dim_of(dmap, name)
            if i != j:
                moves.append((axis, name, i, j))
        ops = []
        for axis, name, i, j in moves:
            if i is not None and j is not None and smap[j] is None and \
                    dmap[i] is None:
                ops.append((0, "all_to_all", axis, name, i, j))
            else:
                if i is not None:
                    ops.append((1, "all_gather", axis, name, i, j))
                if j is not None:
                    ops.append((2, "slice", axis, name, i, j))
        for _, kind, axis, name, i, j in sorted(ops, key=lambda o: o[0]):
            if kind == "all_to_all":
                local = _all_to_all(local, mesh, name, i, j)
            elif kind == "all_gather":
                local = _gather(local, mesh, name, i)
            else:
                k = local.shape[j] // mesh.shape[axis]
                local = local.narrow(j, coord[axis] * k, k)
            if kind not in kinds:
                kinds.append(kind)
        return local.contiguous()

    # ---------------------------------------------------------- two meshes
    def _across(self, local, x, src, dst, shape, kinds):
        """Gather on the source mesh, send / recv, slice on the target
        (the kinds logged are the edge's, the same on every rank)."""
        src_mesh, dst_mesh = src.process_mesh, dst.process_mesh
        src_mesh._ensure_groups()
        me = env_mod.get_rank()
        whole = None
        if me in src_mesh.process_ids:
            whole = self._within(local, src, TensorDistAttr(
                src_mesh, [None] * len(shape)), [])
        senders = src_mesh.process_ids
        for idx, d in enumerate(dst_mesh.process_ids):
            s = senders[idx % len(senders)]
            if s == d:
                continue
            if me == s:
                coll.send(whole.contiguous(), dst=d)
            elif me == d:
                whole = torch.empty(shape, dtype=x.dtype, device=x.device)
                coll.recv(whole, src=s)
        kinds += (["all_gather"] if any(src.dims_mapping) else []) + \
            ["send_recv"] + (["slice"] if any(dst.dims_mapping) else [])
        if me not in dst_mesh.process_ids:
            return None
        return self._within(whole, TensorDistAttr(
            dst_mesh, [None] * len(shape)), dst, [])


def _dim_of(mapping, name):
    for d, a in enumerate(mapping):
        if a == name:
            return d
    return None


def _order(mesh: ProcessMesh, name: str):
    """This rank's group along ``name`` and, for each coordinate along
    it, that rank's index in the group (whose ranks are sorted)."""
    g = mesh.group(name)
    me = env_mod.get_rank()
    row = next(r for r in mesh.rank_groups(name) if me in r)
    return g, [g.ranks.index(r) for r in row]


def _gather(local, mesh, name, dim):
    g, idx = _order(mesh, name)
    rows = coll.all_gather(None, local.contiguous(), group=g)
    return torch.cat([rows[i] for i in idx], dim=dim)


def _all_to_all(local, mesh, name, src_dim, dst_dim):
    g, idx = _order(mesh, name)
    n = len(idx)
    chunks = [c.contiguous() for c in local.chunk(n, dim=dst_dim)]
    ins = [None] * n
    for k, gi in enumerate(idx):
        ins[gi] = chunks[k]
    outs = coll.alltoall(ins, group=g)
    return torch.cat([outs[gi] for gi in idx], dim=src_dim)
