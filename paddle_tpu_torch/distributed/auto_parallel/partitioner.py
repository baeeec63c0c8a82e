"""Partitioner — the port of
``paddle_tpu/distributed/auto_parallel/partitioner.py``: completed specs
into per-rank placements.

The reference resolves each parameter, batch and pipeline-stage tensor
to a ``NamedSharding`` on a device mesh, for one GSPMD program. The
port's ranks are processes, so a placement is a :class:`Placement`: the
``ProcessMesh``, the validated spec (the reference's layout) and, on
demand, this rank's group along each mesh dim the spec names.
``validate_spec`` relaxes a bad spec with a warning, as the reference's
does: an unknown mesh dim, or a tensor dim that the mesh dim's size does
not divide, is replicated.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass

from .completion import reference_layout
from .process_mesh import ProcessMesh

logger = logging.getLogger(__name__)

__all__ = ["Partitioner", "Placement"]


@dataclass
class Placement:
    """A tensor's place: ``mesh`` and ``spec`` (a mesh-dim name or None a
    tensor dim)."""

    mesh: ProcessMesh
    spec: tuple

    @property
    def groups(self) -> dict:
        """``{mesh dim: this rank's collective.Group}`` for the dims the
        spec splits over (made on first use, by every rank)."""
        return {a: self.mesh.group(a) for a in self.spec if a is not None}

    def local_shape(self, shape) -> tuple:
        """A rank's piece of a tensor of ``shape`` under the spec."""
        out = list(shape)
        for d, a in enumerate(self.spec):
            if a is not None:
                out[d] //= self.mesh.get_dim_size(a)
        return tuple(out)


class Partitioner:
    def __init__(self, mesh: ProcessMesh):
        self.mesh = mesh
        self.axis_sizes = dict(zip(mesh.dim_names, mesh.shape))

    # ------------------------------------------------------------- validation
    def validate_spec(self, shape, spec, name="<tensor>"):
        """Check a dims_mapping against the mesh; returns a (possibly relaxed)
        spec: unknown axes and non-divisible dims are replicated with a warning
        rather than failing the whole compile (the reference partitioner
        asserts; GSPMD would pad silently — we split the difference)."""
        if spec is None:
            return ()
        fixed = []
        for i, ax in enumerate(tuple(spec)[: len(shape)]):
            if ax is None:
                fixed.append(None)
                continue
            size = self.axis_sizes.get(ax)
            if size is None:
                logger.warning("%s dim %d: mesh has no axis %r; replicating",
                               name, i, ax)
                fixed.append(None)
            elif size > 1 and shape[i] % size != 0:
                logger.warning("%s dim %d (size %d) not divisible by axis %r "
                               "(%d); replicating", name, i, shape[i], ax, size)
                fixed.append(None)
            else:
                fixed.append(ax)
        fixed += [None] * (len(shape) - len(fixed))
        return tuple(fixed)

    # ------------------------------------------------------------ parameters
    def partition_params(self, model) -> dict:
        """``{param_name: Placement}`` from the completed
        ``_sharding_spec``s (checked against the parameter's shape in the
        reference's layout)."""
        flip = reference_layout(model)
        out = {}
        for name, p in model.named_parameters():
            shape = flip(name, tuple(int(s) for s in p.shape))
            spec = self.validate_spec(shape, getattr(p, "_sharding_spec",
                                                     None), name)
            out[name] = Placement(self.mesh, spec)
        return out

    def partition_batch(self, ndim, axes=("dp", "sharding")) -> Placement:
        """Batch-dim placement over the data axes present in the mesh."""
        present = tuple(a for a in axes if self.axis_sizes.get(a, 1) > 1)
        if not present or ndim == 0:
            return Placement(self.mesh, (None,) * ndim)
        lead = present if len(present) > 1 else present[0]
        return Placement(self.mesh, (lead,) + (None,) * (ndim - 1))

    # -------------------------------------------------------------- pipeline
    def partition_pipeline(self, pipe_layer, stage_meshes):
        """Per-stage placements for a PipelineLayer.

        Returns (per_stage_params, boundary_specs):
        - per_stage_params[s]: {param_name: Placement on stage s's mesh}
        - boundary_specs[s]: the spec the stage-s output must carry when
          entering stage s+1 (the edge reshard moves).
        """
        per_stage = []
        boundary = []
        for s, mesh in enumerate(stage_meshes):
            per_stage.append(Partitioner(mesh).partition_params(
                pipe_layer.stages[s]))
            if s + 1 < len(stage_meshes):
                sizes = dict(zip(stage_meshes[s + 1].dim_names,
                                 stage_meshes[s + 1].shape))
                axes = tuple(a for a in ("dp", "sharding")
                             if sizes.get(a, 1) > 1)
                boundary.append((axes if len(axes) > 1
                                 else (axes[0] if axes else None),))
        return per_stage, boundary
