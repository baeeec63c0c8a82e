"""ProcessMesh — the port of
``paddle_tpu/distributed/auto_parallel/process_mesh.py``.

The reference's mesh is a named view over ``jax.devices()`` and
``jax_mesh()`` makes the ``jax.sharding.Mesh`` its annotations name. The
port's ranks are processes over ``torch.distributed``, so a mesh stands
for ranks instead: position ``i`` of the ids array holds global rank
``ids[i]``. In place of ``jax_mesh()`` it gives

- ``group(dim_name)``: this rank's ``collective.Group`` along a dim: the
  ranks that differ only in that dim's coordinate, taken from the ids
  array, never from ``arange`` (``mapper.build_process_mesh`` permutes
  them). A group lists its ranks sorted, as ``new_group`` makes it;
  ``rank_groups`` and ``coordinate`` give their order along the dim;
- ``coordinate(rank)``: where a rank sits in the mesh;
- ``topology()``: the ``CommunicateTopology`` of a mesh whose dims are
  named ``dp`` / ``sharding`` / ``mp`` (/ ``pp``), mapped to data /
  sharding / model (/ pipe), each rank at its place in the ids array.

Groups are made on first use, every group of every dim, on every rank
of the process group in the same order (``torch.distributed.new_group``
asks that of members and others alike), so every rank must reach the
first use of a mesh's groups.
"""
from __future__ import annotations

import numpy as np

from .. import collective as coll
from .. import env as env_mod
from ..topology import CommunicateTopology

__all__ = ["ProcessMesh"]

#: the mesh dim names a ``CommunicateTopology`` knows, and its names
TOPOLOGY_NAMES = {"dp": "data", "pp": "pipe", "sharding": "sharding",
                  "mp": "model"}


class _MeshTopology(CommunicateTopology):
    """A ``CommunicateTopology`` whose rank ``r`` sits where ``r`` stands
    in a mesh's ids array (the base class puts rank r at the r-th
    coordinate of ``itertools.product``)."""

    def __init__(self, names, ids: np.ndarray):
        super().__init__(names, list(ids.shape))
        coords = [None] * ids.size
        for pos in np.ndindex(*ids.shape):
            coords[int(ids[pos])] = tuple(int(i) for i in pos)
        self.coordinate = coords
        self._rank_of = {c: r for r, c in enumerate(coords)}


class ProcessMesh:
    def __init__(self, mesh, dim_names=None, process_ids=None):
        arr = np.asarray(mesh, dtype=np.int64)
        if arr.ndim == 0:
            arr = arr.reshape(1)
        self._shape = arr.shape
        self._ids = arr
        self._process_ids = [int(i) for i in arr.flatten()]
        if dim_names is None:
            dim_names = [f"d{i}" for i in range(arr.ndim)]
        if len(dim_names) != arr.ndim:
            raise ValueError(
                f"{len(dim_names)} dim_names for a {arr.ndim}-d mesh")
        self._dim_names = list(dim_names)
        self._groups = None

    @property
    def shape(self):
        return list(self._shape)

    @property
    def ndim(self):
        return len(self._shape)

    @property
    def process_ids(self):
        return list(self._process_ids)

    # paddle alias
    processes = process_ids

    @property
    def dim_names(self):
        return list(self._dim_names)

    @property
    def size(self):
        return int(np.prod(self._shape))

    @property
    def ids(self) -> np.ndarray:
        """The ids array, shaped as the mesh."""
        return self._ids.copy()

    def get_dim_size(self, dim_name: str) -> int:
        return self._shape[self._dim_names.index(dim_name)]

    def check_world(self, world_size: int | None = None) -> None:
        """Raise when a process id is not below the world size (the
        reference raises so when a mesh names more devices than exist)."""
        world = env_mod.get_world_size() if world_size is None \
            else int(world_size)
        if max(self._process_ids) >= world:
            raise ValueError(
                f"mesh needs process id {max(self._process_ids)} but only "
                f"{world} ranks are present")

    def coordinate(self, rank: int | None = None):
        """``rank``'s (default: this process's) index along each dim, or
        None when the mesh does not hold it."""
        rank = env_mod.get_rank() if rank is None else int(rank)
        where = np.argwhere(self._ids == rank)
        return None if where.size == 0 else tuple(int(i) for i in where[0])

    def rank_groups(self, dim_name: str) -> list:
        """The rank lists along ``dim_name``: one list a position of the
        other dims, each in the ids array's order along the dim."""
        axis = self._dim_names.index(dim_name)
        moved = np.moveaxis(self._ids, axis, -1)
        return [[int(r) for r in row]
                for row in moved.reshape(-1, self._shape[axis])]

    def _ensure_groups(self) -> dict:
        """Every dim's groups (made once, on every rank, in dim order)."""
        if self._groups is None:
            self.check_world()
            me = env_mod.get_rank()
            groups = {}
            for name in self._dim_names:
                for ranks in self.rank_groups(name):
                    g = coll.new_group(ranks) if env_mod.is_initialized() \
                        else coll.Group(None, sorted(ranks), -1)
                    if me in ranks:
                        groups[name] = g
            self._groups = groups
        return self._groups

    def group(self, dim_name: str):
        """This rank's group along ``dim_name`` (a ``collective.Group``),
        or None when the mesh does not hold this rank."""
        return self._ensure_groups().get(dim_name)

    def topology(self) -> CommunicateTopology:
        """The ``CommunicateTopology`` of a mesh over the ranks ``0 ..
        size - 1`` whose dims are named from ``dp`` / ``pp`` /
        ``sharding`` / ``mp``; rank r sits where the ids array holds r."""
        unknown = [n for n in self._dim_names if n not in TOPOLOGY_NAMES]
        if unknown:
            raise ValueError(f"dims {unknown} have no topology axis; name "
                             f"them from {sorted(TOPOLOGY_NAMES)}")
        if sorted(self._process_ids) != list(range(self.size)):
            raise ValueError("a topology spans the ranks 0 .. size - 1")
        return _MeshTopology([TOPOLOGY_NAMES[n] for n in self._dim_names],
                             self._ids)

    def __eq__(self, other):
        return (isinstance(other, ProcessMesh) and self._shape == other._shape
                and self._process_ids == other._process_ids
                and self._dim_names == other._dim_names)

    def __hash__(self):
        return hash((self._shape, tuple(self._process_ids),
                     tuple(self._dim_names)))

    def __repr__(self):
        return (f"ProcessMesh(shape={list(self._shape)}, "
                f"dim_names={self._dim_names})")

