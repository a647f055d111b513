"""The process mesh (port of ``paddle_tpu/distributed/mesh.py``).

The reference builds one ``jax.sharding.Mesh`` over every chip of the job,
whose named axes are its communicator groups and whose GSPMD layouts place
each array. The port runs one card per process, so a mesh here only
describes the job's axes: their names and sizes over the ranks of
``torch.distributed``, and no layout. The default mesh is one ``dp`` axis
over every rank (``get_world_size()``), as the reference's default mesh is
one ``dp`` axis over every device. ``fleet.init`` sets the hybrid mesh
global: the axes ``pp``, ``dp``, ``sharding``, ``sp`` and ``mp`` over
the ranks in the topology's row-major order
(``HybridCommunicateGroup.mesh``), which ``HybridParallelEngine`` reads.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

__all__ = ["Mesh", "build_mesh", "set_global_mesh", "global_mesh",
           "mesh_axis_size"]


class Mesh:
    """Named axes over the job's ranks: ``devices`` is the array of ranks
    in the mesh's shape (the reference's array of devices), ``shape`` maps
    each axis name to its size."""

    def __init__(self, devices, axis_names: Sequence[str]):
        self.devices = np.asarray(devices)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"mesh of shape {self.devices.shape} needs "
                             f"{self.devices.ndim} axis names, got "
                             f"{self.axis_names}")
        self.shape = dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self):
        return f"Mesh({self.shape})"


_global_mesh: Optional[Mesh] = None


def build_mesh(axis_names: Sequence[str], shape: Sequence[int],
               devices=None) -> Mesh:
    """A mesh of ``shape`` over ``devices`` (default: the ranks
    ``0 .. get_world_size() - 1``); raises when the shape needs more ranks
    than there are."""
    if devices is None:
        from .parallel_env import get_world_size

        devices = list(range(get_world_size()))
    n = int(np.prod(shape))
    if n > len(devices):
        raise ValueError(f"mesh needs {n} devices, have {len(devices)}")
    return Mesh(np.asarray(devices[:n]).reshape(tuple(shape)),
                tuple(axis_names))


def set_global_mesh(mesh: Optional[Mesh]) -> None:
    global _global_mesh
    _global_mesh = mesh


def global_mesh() -> Mesh:
    """The mesh set by :func:`set_global_mesh`, else one ``dp`` axis over
    every rank of the current world (built anew, so it follows
    ``init_parallel_env``)."""
    if _global_mesh is not None:
        return _global_mesh
    from .parallel_env import get_world_size

    return Mesh(np.arange(get_world_size()), ("dp",))


def mesh_axis_size(axis: str) -> int:
    return int(global_mesh().shape.get(axis, 1))
