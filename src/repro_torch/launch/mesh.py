"""Device meshes and the H100's roofline constants.

Counterpart of ``repro/launch/mesh.py``.  ``make_abstract_mesh`` is a
plain description (axis names and sizes) that needs no process group:
the sharding rules and their tests take it as JAX's take an
``AbstractMesh``.  ``make_production_mesh`` lays the production shapes,
(data=16, model=16) or (pod=2, data=16, model=16), over whatever world
the default process group has: the dry-run and fedrun create a ``fake``
world of 256 or 512 ranks in their first lines, as the JAX dry-run
forces 512 host devices.  ``make_host_mesh`` is (data=N, model=1) over
the local world.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True, eq=False)
class AbstractMesh:
    """Axis names and sizes, without devices or a process group."""
    axis_names: tuple[str, ...]
    shape: dict[str, int]

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())


def make_abstract_mesh(shape: tuple[int, ...],
                       axes: tuple[str, ...]) -> AbstractMesh:
    if len(shape) != len(axes):
        raise ValueError(f"{len(shape)} sizes for {len(axes)} axes")
    return AbstractMesh(tuple(axes), dict(zip(axes, (int(s) for s in shape))))


def axis_sizes(mesh) -> dict[str, int]:
    """Axis name → size of an :class:`AbstractMesh` or a ``DeviceMesh``."""
    if isinstance(mesh, AbstractMesh):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def _device_type() -> str:
    """The device type of the default group's backend: NCCL's ranks are
    cards, a ``gloo`` or ``fake`` world's are CPU ranks."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _world_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
                device_type: str):
    """A mesh over the first prod(shape) ranks of the default group's
    world."""
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("a device mesh needs a process group: "
                           "torch.distributed.init_process_group first")
    n, world = math.prod(shape), dist.get_world_size()
    if world == n:
        return init_device_mesh(device_type, shape, mesh_dim_names=axes)
    if world < n:
        raise RuntimeError(f"a {shape} mesh needs {n} ranks, the world has "
                           f"{world}")
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False):
    """Single pod: 256 ranks as (data=16, model=16).
    Multi-pod: 2 pods × 256 ranks as (pod=2, data=16, model=16).
    A larger world gives its first ranks (the dry-run's 512-rank world
    holds both meshes)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _world_mesh(shape, axes, _device_type())


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...]):
    """Any (axes, shape) mesh over the default group's world."""
    return _world_mesh(tuple(shape), tuple(axes), _device_type())


def make_host_mesh(device: str = "cuda"):
    """(data=N, model=1) over the world of the default group, N its size.
    Without a group, a world of one over an in-memory store: NCCL for
    the card, gloo for the CPU."""
    dev = torch.device(device).type
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0,
                                world_size=1)
    return _world_mesh((dist.get_world_size(), 1), ("data", "model"), dev)


# NVIDIA H100 SXM5 datasheet figures (per card, dense, no sparsity) for
# the roofline terms; a card set below 700 W runs slower under load.
PEAK_FLOPS_BF16 = 989.4e12      # FLOP/s, bf16 tensor cores (datasheet)
HBM_BW = 3.35e12                # bytes/s, HBM3 (datasheet)
NVLINK_BW = 450e9               # bytes/s per direction, NVLink 4 (datasheet)


def hbm_bytes() -> int:
    """The card's memory, read from the device."""
    return torch.cuda.get_device_properties(0).total_memory
