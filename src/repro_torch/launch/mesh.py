"""Mesh construction (counterpart of ``repro/launch/mesh.py``).

Functions, never module-level meshes: importing this module touches no
device state and no process group.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the process group the
caller has already initialised (``torch.distributed.init_process_group``
with its own store, world size and rank), laid out in rank order: rank
r sits at the coordinates of r in the mesh's shape, major to minor, so a
group along some axes ranks its members in their block order
(``parallel/placement.py``).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..core.hw import MULTI_POD, SINGLE_POD, MeshDescriptor

__all__ = ["make_production_mesh", "make_mesh_from_descriptor",
           "descriptor_for", "make_smoke_mesh"]


def make_production_mesh(*, multi_pod: bool = False, device_type="cuda"):
    """16x16 single pod (256 chips) or 2x16x16 two-pod (512 chips)."""
    desc = descriptor_for(multi_pod=multi_pod)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < desc.n_chips:
        raise RuntimeError(
            f"mesh {desc.shape} needs a world of {desc.n_chips} ranks, have "
            f"{have} -- launch one process per device (torchrun "
            f"--nproc-per-node) across enough hosts")
    return make_mesh_from_descriptor(desc, device_type)


def descriptor_for(*, multi_pod: bool = False) -> MeshDescriptor:
    return MULTI_POD if multi_pod else SINGLE_POD


def make_mesh_from_descriptor(desc: MeshDescriptor, device_type="cuda"):
    """The descriptor's shape and axis names as a DeviceMesh over the
    first ``desc.n_chips`` ranks of the initialised world."""
    from torch.distributed.device_mesh import DeviceMesh
    if not dist.is_initialized():
        raise RuntimeError("initialise torch.distributed before building a "
                           "mesh")
    have = dist.get_world_size()
    if have < desc.n_chips:
        raise RuntimeError(f"need {desc.n_chips} ranks, have {have}")
    ranks = torch.arange(desc.n_chips).reshape(desc.shape)
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(desc.axes))


def make_smoke_mesh(shape=(2, 2), axes=("data", "model"),
                    device_type="cpu"):
    """Tiny mesh for CPU integration tests (gloo ranks)."""
    return make_mesh_from_descriptor(MeshDescriptor(shape, axes),
                                     device_type)
