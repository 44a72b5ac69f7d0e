"""Mesh construction, the reference's ``launch/mesh.py`` on
``torch.distributed.device_mesh``.

Functions, never a module-level mesh: a ``DeviceMesh`` needs an initialised
process group whose world size is the mesh's size (one rank per device, as
under ``torchrun``), and importing this module touches no process state.
``device_type`` is ``"cuda"`` by default; the tests pass ``"cpu"`` (gloo or
a fake process group).

:class:`MeshShape` is a mesh without devices (the reference's
``jax.sharding.AbstractMesh``): the spec builders of ``launch/shardings.py``
read only axis names and sizes, so they run on it with no process group.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch.distributed as dist

AXES = ("data", "model")
AXES_MULTI_POD = ("pod", "data", "model")


def mesh_shape(kind: str, multi_pod: bool = False) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """(shape, axis names) of the ``"prod"`` mesh, 16 x 16 (one pod) or
    2 x 16 x 16 (two pods), or of the ``"test"`` mesh, 4 x 4 or 2 x 2 x 4.
    "data" carries the batch and FSDP, "model" tensor and expert
    parallelism, "pod" the cross-pod data parallelism."""
    if kind not in ("prod", "test"):
        raise ValueError(f"mesh kind {kind!r} is not 'prod' or 'test'")
    if kind == "prod":
        return ((2, 16, 16), AXES_MULTI_POD) if multi_pod else ((16, 16), AXES)
    return ((2, 2, 4), AXES_MULTI_POD) if multi_pod else ((4, 4), AXES)


class MeshShape:
    """Axis names and sizes with ``DeviceMesh``'s accessors
    (``mesh_dim_names``, ``size(dim)``, ``shape``, ``ndim``) and no
    devices."""

    def __init__(self, shape, names):
        if len(shape) != len(names):
            raise ValueError(f"{len(shape)} sizes for {len(names)} axis names")
        self.shape = tuple(int(s) for s in shape)
        self.mesh_dim_names = tuple(names)
        self.ndim = len(self.shape)

    def size(self, mesh_dim=None) -> int:
        return math.prod(self.shape) if mesh_dim is None else self.shape[mesh_dim]

    def __repr__(self):
        return f"MeshShape({dict(zip(self.mesh_dim_names, self.shape))})"


def build_mesh(shape, names, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``names`` over the initialised
    process group, whose world size must be the mesh's size."""
    from torch.distributed.device_mesh import init_device_mesh

    need = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError(
            f"a {'x'.join(map(str, shape))} mesh needs a process group of world size {need} "
            "(one rank per device, e.g. under torchrun); none is initialised")
    if dist.get_world_size() != need:
        raise RuntimeError(
            f"a {'x'.join(map(str, shape))} mesh needs a process group of world size {need}; "
            f"this one has {dist.get_world_size()}")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    return build_mesh(*mesh_shape("prod", multi_pod), device_type=device_type)


def make_test_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    return build_mesh(*mesh_shape("test", multi_pod), device_type=device_type)


def axis_size(mesh, name: str) -> int:
    """The size of the axis ``name`` (the reference's ``mesh.shape[name]``)."""
    return mesh.size(mesh.mesh_dim_names.index(name))
