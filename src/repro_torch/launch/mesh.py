"""Mesh construction, as in ``repro/launch/mesh.py``: the same shapes and
axis names, as ``torch.distributed.device_mesh.DeviceMesh``es.

Functions, not module-level constants: importing this module touches no
process-group state. Each needs an initialised default group whose world
size is the mesh's size (``launch.dist``), and takes the ranks' device
type ("cuda" unless the caller asks for "cpu"). The ranks fill the mesh in
row-major order, so a rank's coordinate along an axis is its rank in that
axis's group.

``AbstractMesh`` is a mesh's axis names and sizes with no processes behind
it (JAX's ``jax.sharding.AbstractMesh``): the sharding rules read nothing
else, so they run on the production shapes without 256 or 512 ranks.
"""
from __future__ import annotations

import dataclasses

from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    axis_sizes: tuple
    axis_names: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` or an ``AbstractMesh``."""
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh.shape)


def production_shape(*, multi_pod: bool = False) -> AbstractMesh:
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def make_mesh(sizes: tuple, names: tuple,
              device_type: str = "cuda") -> DeviceMesh:
    """A ``DeviceMesh`` of ``sizes`` over the default group's ranks, axes
    ``names``."""
    return init_device_mesh(device_type, tuple(sizes),
                            mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    shape = production_shape(multi_pod=multi_pod)
    return make_mesh(shape.axis_sizes, shape.axis_names, device_type)


def make_worker_mesh(tp: int = 4, device_type: str = "cuda") -> DeviceMesh:
    """Mesh for one serving worker (TP-only sub-slice)."""
    return make_mesh((1, tp), ("data", "model"), device_type)


def make_host_mesh(device_type: str = "cuda") -> DeviceMesh:
    """Single-rank mesh for tests and examples."""
    return make_mesh((1, 1), ("data", "model"), device_type)
