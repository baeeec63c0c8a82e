"""Rank mapper — the port of ``paddle_tpu/distributed/auto_parallel/mapper.py``
(``order_axes_by_volume``, ``map_mesh``, ``build_process_mesh``).

Consecutive ranks share a host (a node's NVLink on the card's cluster,
``Cluster``'s ``ici``), so mapping reduces to axis order: the axes that
move the most bytes vary fastest (innermost), keeping their groups inside
a host; the lightest axis spans hosts (``dcn``). Plain numpy, the
reference's arithmetic.
"""
from __future__ import annotations

import numpy as np


def order_axes_by_volume(axis_sizes: dict, comm_bytes: dict) -> list:
    """Axis names outermost->innermost: ascending per-step comm volume, so
    the heaviest-communicating axis ends up innermost (contiguous ranks).
    Size-1 axes sort first (they never communicate). Ties keep dict order."""
    names = list(axis_sizes)
    return sorted(
        names,
        key=lambda a: (axis_sizes[a] > 1, float(comm_bytes.get(a, 0.0))),
    )


def map_mesh(cluster, axis_sizes: dict, comm_bytes: dict | None = None):
    """Build the device-id layout for a Mesh over `cluster`.

    axis_sizes: {axis_name: size} in the CALLER's desired mesh order.
    comm_bytes: {axis_name: bytes moved per step along that axis} — from
    cost_model.partition_comm_volumes; defaults to the conventional
    mp > sp > sharding > dp weighting when absent.

    Returns (device_ids ndarray shaped per axis_sizes order, placement)
    where placement maps axis -> 'ici' | 'dcn' | 'none' (size-1). The id
    array is transposed back to the caller's axis order, so a
    ``ProcessMesh(ids, names)`` gives each group the medium the mapper
    chose.
    """
    if comm_bytes is None:
        conventional = {"mp": 3, "sp": 2, "sharding": 1, "dp": 0}
        comm_bytes = {a: float(conventional.get(a, 0)) for a in axis_sizes}

    n = int(np.prod(list(axis_sizes.values())))
    if n > cluster.n_chips:
        raise ValueError(
            f"mesh needs {n} chips but cluster has {cluster.n_chips}")

    order = order_axes_by_volume(axis_sizes, comm_bytes)
    # ranks in row-major over [outermost..innermost]: innermost axis strides 1
    ids = np.arange(n).reshape([axis_sizes[a] for a in order])
    # transpose back to the caller's axis order
    perm = [order.index(a) for a in axis_sizes]
    ids = np.transpose(ids, perm)

    placement = {}
    for a in axis_sizes:
        if axis_sizes[a] <= 1:
            placement[a] = "none"
            continue
        stride = int(np.prod(
            [axis_sizes[b] for b in order[order.index(a) + 1:]], dtype=int))
        # classify over the axis's ACTUAL rank groups (all other axes
        # fixed), not the span heuristic — on non-power-of-two hosts a
        # group can straddle a host boundary even when size*stride fits
        groups = np.moveaxis(
            ids, list(axis_sizes).index(a), -1).reshape(-1, axis_sizes[a])
        placement[a] = cluster.axis_medium(axis_sizes[a], stride,
                                           groups=groups)
    return ids, placement


def build_process_mesh(cluster, axis_sizes: dict, comm_bytes: dict | None = None):
    """map_mesh -> ProcessMesh (ids + names) with its ``placement``."""
    from .process_mesh import ProcessMesh

    ids, placement = map_mesh(cluster, axis_sizes, comm_bytes)
    pm = ProcessMesh(ids, dim_names=list(axis_sizes))
    pm.placement = placement
    return pm
