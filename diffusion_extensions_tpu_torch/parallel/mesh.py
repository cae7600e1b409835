"""Device-mesh helpers (counterpart of
``diffusion_extensions_tpu/parallel/mesh.py``).

PyTorch runs one process per card, so a mesh is over the ranks of the
default process group: ``make_mesh([("dp", -1), ("tp", 2)])`` is a
``DeviceMesh`` whose named dimensions multiply to the world size (a -1
size is inferred).  ``P`` is the JAX package's ``PartitionSpec`` for the
functions that describe a layout (``parallel/gspmd.py``), one entry a
tensor dimension: a mesh axis name, or ``None`` for a dimension kept whole;
``placements`` turns one into DTensor placements.
"""
from __future__ import annotations

from typing import Sequence

import math

import torch.distributed as dist

__all__ = ["make_mesh", "axis_size", "data_sharding", "replicated", "placements", "P"]


class P(tuple):
    """PartitionSpec: ``P(None, "tp")`` shards a matrix's last dimension
    over the mesh axis "tp"; ``P()`` replicates."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


def make_mesh(axes: Sequence[tuple[str, int]] | None = None, device_type: str | None = None):
    """A ``DeviceMesh`` over the ranks of the default process group.

    Default: every rank on one ``"dp"`` axis.  ``axes=[("dp", 4), ("tp", 2)]``
    is a 2-D mesh; sizes must multiply to the world size (one -1 size is
    inferred).  ``device_type`` defaults to "cuda" when the group's backend
    is NCCL, else "cpu"."""
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size()
    if axes is None:
        axes = [("dp", n)]
    names = [a for a, _ in axes]
    sizes = [int(s) for _, s in axes]
    if -1 in sizes:
        sizes[sizes.index(-1)] = n // math.prod(s for s in sizes if s != -1)
    total = math.prod(sizes)
    if total != n:
        raise ValueError(f"mesh {dict(zip(names, sizes))} needs {total} processes, "
                         f"the group has {n}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(sizes), mesh_dim_names=tuple(names))


def axis_size(mesh, name: str) -> int:
    """The size of the mesh axis ``name`` (1 when the mesh has none)."""
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(name)) if name in names else 1


def placements(spec: P, mesh) -> list:
    """DTensor placements of a tensor laid out by ``spec`` on ``mesh``:
    ``Shard(d)`` on each mesh dimension that ``spec`` names at tensor
    dimension ``d``, ``Replicate()`` on the others."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate() for _ in mesh.mesh_dim_names]
    for d, name in enumerate(spec):
        if name is not None:
            out[mesh.mesh_dim_names.index(name)] = Shard(d)
    return out


def data_sharding(mesh, axis: str = "dp") -> list:
    """Placements of a batch whose leading dimension is split over ``axis``."""
    return placements(P(axis), mesh)


def replicated(mesh) -> list:
    """Placements of a tensor held whole on every rank."""
    return placements(P(), mesh)
