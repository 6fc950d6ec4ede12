"""Production mesh construction (port of `repro.launch.mesh`).

The reference's meshes are `jax.make_mesh` over placeholder devices; the
port's are `torch.distributed.device_mesh.DeviceMesh`es under PyTorch's
``fake`` process-group backend, which plans collectives without running
any: a production mesh never touches a card.  The sharding inference
(`dist.sharding`) reads only a mesh's axis names and sizes, so any object
with ``.shape`` (a name → size mapping) and ``.axis_names`` serves it as
well (`MeshShape`); `mesh_axes` reads either form.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch.distributed as dist


@dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, without devices or a process
    group: ``shape`` maps name → size in axis order."""

    shape: dict

    @property
    def axis_names(self) -> tuple:
        return tuple(self.shape)


def mesh_axes(mesh) -> dict:
    """``{axis name: size}`` in axis order, of a `DeviceMesh` or of a
    mesh-shaped object (``.shape`` mapping, ``.axis_names``)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def _fake_world(size: int) -> None:
    """Make the default process group a ``fake`` world of ``size`` ranks
    (rank 0), replacing a fake world of another size."""
    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == size:
            return
        if dist.get_backend() != "fake":
            raise RuntimeError(
                "a production mesh needs the fake backend's process group, "
                f"but a {dist.get_backend()!r} group is initialised")
        dist.destroy_process_group()
    # importing PyTorch's fake process group registers the "fake" backend
    import torch.testing._internal.distributed.fake_pg  # noqa: F401

    dist.init_process_group("fake", store=dist.HashStore(), rank=0,
                            world_size=size)


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 = 256 cards per pod; 2 pods = 512 cards multi-pod.  A
    `DeviceMesh` over the ``fake`` backend (no card, no collective runs);
    `release_production_mesh` takes its process group down."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    _fake_world(math.prod(shape))
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


def release_production_mesh() -> None:
    """Destroy the fake process group a production mesh made, if any."""
    if dist.is_initialized() and dist.get_backend() == "fake":
        dist.destroy_process_group()


def make_host_mesh(model: int = 1) -> MeshShape:
    """The mesh of this host's one card (tests / card smoke): ``(data 1,
    model 1)``.  The reference splits its host devices into (n/model,
    model); the port's SPMD step runs on one card, so ``model`` must be
    1."""
    if model != 1:
        raise ValueError(f"the host mesh is one card: model={model}")
    return MeshShape({"data": 1, "model": 1})


def dp_axes(mesh):
    """The data-parallel mesh axes: ("pod", "data") on the multi-pod
    production mesh, "data" on single-pod / host meshes.  Returned in the
    form PartitionSpec entries expect (a name or tuple of names)."""
    return ("pod", "data") if "pod" in mesh_axes(mesh) else "data"


def axis_size(mesh, axes) -> int:
    """Total device count across `axes` (a name, tuple of names, or None).

    Axes absent from the mesh count as size 1 — so the sharding-inference
    helpers work unchanged on meshes that carry only a subset of the
    production axes (e.g. the clients-only mesh of `repro_torch.mesh`).
    """
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = mesh_axes(mesh)
    size = 1
    for a in axes:
        size *= int(sizes.get(a, 1))
    return size
