"""Mesh construction, the reference's ``launch/mesh.py`` over a
``torch.distributed`` world.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the
process group's ranks, row-major: dims ``("data", "model")`` or, for
two pods, ``("pod", "data", "model")``.  The process group must be up
(``torch.distributed.init_process_group``); every rank of the world
builds the same mesh.  These are functions, so importing the module
touches no device and no group.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

PODS = 2
POD_X = 16
POD_Y = 16


def world_size() -> int:
    """The process group's size, 1 where none is up."""
    return dist.get_world_size() if dist.is_initialized() else 1


def device_type() -> str:
    """The mesh's device type: ``cuda`` under NCCL, else ``cpu`` (gloo,
    which also carries CUDA tensors)."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(shape, names):
    """A ``DeviceMesh`` of ``shape`` over the world's first
    ``prod(shape)`` ranks; raises with the count it needs where the world
    is smaller."""
    need = math.prod(shape)
    have = world_size()
    if not dist.is_initialized() or have < need:
        raise RuntimeError(
            f"need {need} ranks for mesh {tuple(shape)}, have {have}: run "
            f"under python -m torch.distributed.run --nproc-per-node {need}")
    from torch.distributed.device_mesh import DeviceMesh

    ranks = torch.arange(need, dtype=torch.int).reshape(tuple(shape))
    return DeviceMesh(device_type(), ranks, mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False):
    """The 16 x 16 pod mesh (256 ranks), or two of them (512)."""
    if multi_pod:
        return make_mesh((PODS, POD_X, POD_Y), ("pod", "data", "model"))
    return make_mesh((POD_X, POD_Y), ("data", "model"))


def make_mesh_for_devices(data: int, model: int):
    """A ``(data, model)`` mesh over the world's first data·model ranks."""
    return make_mesh((data, model), ("data", "model"))


def ici_topology(mesh):
    """The ICI torus under a mesh — Q-StaR's topology input: one pod
    (``data`` × ``model``) a 2-D torus, several pods a torus a pod on a
    pod axis (``core.topology.multipod``).  ``mesh`` is anything
    ``sharding.specs.axis_sizes`` reads."""
    from ..core.topology import multipod, torus
    from ..sharding.specs import axis_sizes

    sizes = axis_sizes(mesh)
    if "pod" in sizes:
        return multipod(sizes["pod"], sizes["data"], sizes["model"])
    return torus(sizes["data"], sizes["model"])
