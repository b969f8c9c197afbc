"""Device meshes: the JAX package's ``src/repro/launch/mesh.py`` on
``torch.distributed``.

A JAX ``Mesh`` becomes a ``torch.distributed.device_mesh.DeviceMesh`` with
the same axis names and shape, one rank a device. ``PartitionSpec`` and
``NamedSharding`` become the small copies ``P`` and ``NamedSharding`` below
(``distributed.planner.placements`` turns a spec into DTensor placements),
and ``AbstractMesh`` stands in for the reference's ``AbstractMesh``: axis names
and sizes with no process group, which is all the planner reads.

A DeviceMesh lives on a process group, which this module owns:
  * ``nccl`` for CUDA ranks, ``gloo`` for CPU ranks. A group of one rank
    (one H100, or a process on its own) is made here with a ``HashStore``
    and needs no ``MASTER_ADDR`` or other environment variable.
  * the ``fake`` backend with a ``FakeStore`` for the dry run's 256 or 512
    placeholder ranks: one process, rank 0, collectives that move nothing.
  * a group of several real ranks is the caller's to start: each rank calls
    ``init_group`` with its rank, the world size and a store address
    (``file://...`` or ``tcp://localhost:<port>``).

Mesh axes, as in the reference:
  * ``pod``   — data parallelism across pods; gradients cross the
                inter-pod link once a step (all-reduce).
  * ``data``  — FSDP/batch sharding within a pod.
  * ``model`` — tensor/expert/sequence parallelism within a pod.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple, Union

import torch
import torch.distributed as dist


class P(tuple):
    """A partition spec: one entry a tensor dim, each ``None``
    (replicated), a mesh axis name, or a tuple of names (the dim split over
    their product, the first name major). As ``PartitionSpec`` does, a
    tuple of one name is that name and an empty tuple is ``None``; it
    compares with ``==`` as a tuple, so a spec equals the reference's entry
    for entry."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            (e[0] if len(e) == 1 else e or None) if isinstance(e, tuple)
            else e for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes without devices (the reference's AbstractMesh):
    the planner's rules need nothing else."""
    axis_shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_shape))


Mesh = Union["dist.device_mesh.DeviceMesh", AbstractMesh]


def axis_names(mesh: Mesh) -> Tuple[str, ...]:
    if isinstance(mesh, AbstractMesh):
        return mesh.axis_names
    return tuple(mesh.mesh_dim_names)


def axis_sizes(mesh: Mesh) -> Dict[str, int]:
    """{axis name: size} in the mesh's order (JAX's ``mesh.shape``)."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec bound to a mesh, as the reference's ``NamedSharding``."""
    mesh: Mesh
    spec: P


# ---------------------------------------------------------------------------
# the process group
# ---------------------------------------------------------------------------

def _fake_store():
    # importing the module registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    return FakeStore()


def init_group(backend: Optional[str] = None, *, rank: int = 0,
               world_size: int = 1, init_method: Optional[str] = None,
               device="cuda") -> None:
    """Start this process's group unless one is running: ``backend``
    defaults to nccl for ``device`` cuda and gloo for the CPU; ``"fake"``
    is the dry run's placeholder group. Without ``init_method`` only a
    one-rank group (or a fake one) can be made."""
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    kw = dict(backend=backend, rank=rank, world_size=world_size)
    if backend == "fake":
        kw["store"] = _fake_store()
    elif init_method is not None:
        kw["init_method"] = init_method
    elif world_size == 1:
        kw["store"] = dist.HashStore()
    else:
        raise ValueError(f"a group of {world_size} ranks needs an "
                         f"init_method (file:// or tcp://localhost:<port>)")
    dist.init_process_group(**kw)


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], *,
              device="cuda"):
    """A DeviceMesh over ranks 0 .. prod(shape)-1 of the running group (a
    one-rank group on ``device`` is started when none runs). Generic mesh
    (tests, elastic re-meshing)."""
    from torch.distributed.device_mesh import DeviceMesh
    n = math.prod(shape)
    if not dist.is_initialized():
        if n != 1:
            raise RuntimeError(f"a mesh of {n} ranks needs a running group "
                               f"(init_group)")
        init_group(device=device)
    if dist.get_world_size() < n:
        raise ValueError(f"mesh {tuple(shape)} needs {n} ranks; the group "
                         f"has {dist.get_world_size()}")
    return DeviceMesh(_device_type(), torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    """(16, 16) ``("data", "model")`` or (2, 16, 16) ``("pod", "data",
    "model")``, as the reference's. Without a running group it starts the
    fake one of 256 or 512 ranks, as the reference's dry run fakes 512
    host devices: the planner then sees the reference's axis sizes."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if not dist.is_initialized():
        init_group("fake", world_size=math.prod(shape))
    return make_mesh(shape, axes)


def make_host_mesh(n: Optional[int] = None,
                   axes: Tuple[str, ...] = ("data", "model"), *,
                   device="cuda"):
    """Best-effort mesh over the ranks that exist now — the elastic-scaling
    entry point. ``n`` defaults to the group's world size, which is 1 for a
    process on its own (one rank a device: a second card needs a second
    process); a 2-D mesh takes the squarest factorization, so one H100 gives
    ``("data", "model")`` of shape (1, 1)."""
    if n is None:
        n = dist.get_world_size() if dist.is_initialized() else 1
    if len(axes) == 2:
        a = int(n ** 0.5)
        while n % a:
            a -= 1
        return make_mesh((n // a, a), axes, device=device)
    return make_mesh((n,), axes, device=device)


def batch_sharding(mesh) -> NamedSharding:
    """Input batches shard over every data-like axis (pod + data)."""
    axes = tuple(a for a in ("pod", "data") if a in axis_names(mesh))
    return NamedSharding(mesh, P(axes))


__all__ = ["P", "AbstractMesh", "NamedSharding", "axis_names", "axis_sizes",
           "init_group", "make_mesh", "make_production_mesh",
           "make_host_mesh", "batch_sharding"]
