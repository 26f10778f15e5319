"""Production mesh factories (a port of ``repro/launch/mesh.py``).

Meshes are ``torch.distributed`` ``DeviceMesh``es over the default process
group, which the caller starts first (``init_process_group``; the CPU tests
use the fake backend for the 256- and 512-rank production meshes). Nothing
here runs at import time. ``make_production_mesh``: (16, 16) data x model
single-pod, (2, 16, 16) pod x data x model multi-pod, as the reference lays
out TPU v5e pods of 256 chips.
"""
from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type=device_type)


def _world_size() -> int:
    if not dist.is_initialized():
        raise RuntimeError("a device mesh needs the default process group: call "
                           "torch.distributed.init_process_group first")
    return dist.get_world_size()


def make_mesh(shape, axes, *, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over every rank of the
    default process group, whose size must be the mesh's."""
    shape, axes = tuple(shape), tuple(axes)
    world = _world_size()
    if math.prod(shape) != world:
        raise ValueError(f"a mesh of shape {shape} needs {math.prod(shape)} ranks; the "
                         f"default process group has {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(model_degree: int = 1, *, device_type: str = "cuda"):
    """(data, model) over whatever ranks the default group has."""
    n = _world_size()
    data = max(1, n // model_degree)
    return make_mesh((data, min(model_degree, n)), ("data", "model"), device_type=device_type)
