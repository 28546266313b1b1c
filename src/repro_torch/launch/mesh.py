"""Production meshes.

Defined as FUNCTIONS so importing this module touches no process group: a
mesh is built inside a launched world (``torch.distributed`` initialized
with one rank per card, or per CPU process in the tests).
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

__all__ = ["PRODUCTION_MESHES", "make_production_mesh", "make_host_mesh", "slice_mesh"]


def _world(n: int, what: str) -> None:
    if not dist.is_initialized():
        raise RuntimeError(f"{what} needs torch.distributed initialized with {n} ranks")
    if dist.get_world_size() != n:
        raise RuntimeError(f"{what} needs a world of {n} ranks, this one has "
                           f"{dist.get_world_size()}")


#: the production meshes: (shape, dim names), single pod and multi-pod
PRODUCTION_MESHES = {False: ((32, 8), ("data", "model")),
                     True: ((2, 32, 8), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    """H100 meshes, one rank a card.  Single pod: (32, 8) ("data", "model")
    = 256 cards in 32 nodes, ``"model"`` the 8 NVLink cards of one node.
    Multi-pod: (2, 32, 8) ("pod", "data", "model") = 512 cards; "pod" is a
    batch axis crossing the inter-pod links.  Raises unless the world has
    that many ranks.  ``device_type="cpu"`` lays the same mesh over CPU
    ranks (the dry-run's CPU accounting, ``launch/dryrun.py``)."""
    shape, axes = PRODUCTION_MESHES[multi_pod]
    _world(math.prod(shape), "the production mesh")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(shape=(2, 2), axes=("data", "model"), device_type: str = "cpu") -> DeviceMesh:
    """Small mesh for tests: over the CPU processes of a gloo world (or the
    cards of an NCCL one with ``device_type="cuda"``)."""
    _world(math.prod(shape), "the host mesh")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def _device(mesh: DeviceMesh, rank: int) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return torch.device(mesh.device_type)


def slice_mesh(mesh: DeviceMesh, n_slices: int, axis: str = "data") -> list:
    """Split a mesh into ``n_slices`` disjoint slices along ``axis`` —
    trial-parallel HPO: each concurrent trial trains on one slice (see
    ``repro_torch.tune.scheduler``).  Returns, in the form the scheduler
    takes, one list of ``torch.device`` a slice (a rank's card; the CPU for
    every rank of a CPU mesh), in row-major rank order."""
    ranks = mesh.mesh  # tensor of global ranks, one dim per mesh axis
    ax = mesh.mesh_dim_names.index(axis)
    size = ranks.shape[ax]
    assert size % n_slices == 0, (size, n_slices)
    chunk = size // n_slices
    return [[_device(mesh, int(r)) for r in ranks.narrow(ax, i * chunk, chunk).flatten()]
            for i in range(n_slices)]
