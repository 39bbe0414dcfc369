"""Mesh construction (``repro/launch/mesh.py``).

Kept as functions (never module-level constants), so importing this module
touches no process group.  A mesh of n devices needs a process group of n
ranks: on the card's machine a real one is 1 x 1; larger meshes are traced
on a fake process group (``fake_process_group``), which has no devices and
moves no data, as the dry run does.
"""
from __future__ import annotations

import contextlib
import math

from ..models.sharding import Mesh


def make_mesh(shape, axes, device_type: str = "cuda") -> Mesh:
    """A mesh of ``shape`` over the default process group's ranks, whose
    dimensions are named ``axes``; the group must hold exactly
    prod(shape) ranks."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = tuple(shape), tuple(axes)
    n = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != n:
        raise ValueError(
            f"a {'x'.join(map(str, shape))} mesh needs {n} ranks, one device "
            f"each; the process group has {have}")
    return Mesh(init_device_mesh(device_type, shape, mesh_dim_names=axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> Mesh:
    """16×16 = 256 chips per pod; 2 pods = 512 chips with a leading "pod"
    axis (pure DP over the slower inter-pod links)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_debug_mesh(n_data: int = 2, n_model: int = 2, *,
                    multi_pod: bool = False, device_type: str = "cuda") -> Mesh:
    """Small mesh for CI-scale dry-run tests (a process group of
    n_data * n_model ranks, twice that with ``multi_pod``)."""
    if multi_pod:
        return make_mesh((2, n_data, n_model), ("pod", "data", "model"),
                         device_type)
    return make_mesh((n_data, n_model), ("data", "model"), device_type)


@contextlib.contextmanager
def fake_process_group(world_size: int, rank: int = 0):
    """A process group of ``world_size`` ranks in this process alone, as
    ``rank``, whose collectives move nothing (PyTorch's "fake" backend, on an
    in-process store: no port, no peer); destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()
