"""Elastic scaling: replan the mesh for a changed device count and reshard
(a port of ``repro/runtime/elastic.py``).

Policy: preserve the model axis (TP degree is baked into per-layer math and
memory footprints); shrink/grow the data axis to the largest multiple that
fits the surviving devices. ``build_mesh`` lays the plan out as a
``DeviceMesh`` over the surviving ranks; restore flows through
``CheckpointManager.restore`` with the new mesh's shardings, so parameters
land sharded for the new topology without a full re-init.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class ElasticPlan:
    mesh_shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    dropped_devices: int
    global_batch_scale: float      # new_data_degree / old_data_degree


def plan_mesh_shape(
    n_devices: int,
    model_degree: int,
    *,
    pods: int = 1,
) -> Tuple[int, ...]:
    """Largest (pods, data, model) grid fitting n_devices with fixed model."""
    if model_degree <= 0:
        raise ValueError("model_degree must be positive")
    per_pod = n_devices // max(pods, 1)
    data = per_pod // model_degree
    if data < 1:
        # degenerate: shrink model degree to the largest power-of-two that fits
        m = model_degree
        while m > 1 and n_devices // m < 1:
            m //= 2
        return (1, max(n_devices // m, 1), m)
    return (pods, data, model_degree) if pods > 1 else (data, model_degree)


def plan_elastic(
    old_mesh_shape: Tuple[int, ...],
    axis_names: Tuple[str, ...],
    surviving_devices: int,
) -> ElasticPlan:
    axes = dict(zip(axis_names, old_mesh_shape))
    model = axes.get("model", 1)
    pods = axes.get("pod", 1)
    old_data = axes.get("data", 1)

    # try to keep the pod axis; drop it if a whole pod died
    for p in range(pods, 0, -1):
        shape = plan_mesh_shape(surviving_devices, model, pods=p)
        data = shape[-2] if len(shape) >= 2 else 1
        if data >= 1 and int(np.prod(shape)) <= surviving_devices:
            names = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
            used = int(np.prod(shape))
            return ElasticPlan(
                mesh_shape=shape,
                axis_names=names,
                dropped_devices=surviving_devices - used,
                global_batch_scale=(shape[-2] * (shape[0] if len(shape) == 3 else 1))
                / (old_data * pods),
            )
    raise RuntimeError("no viable mesh for surviving devices")



def build_mesh(plan: ElasticPlan, ranks=None, *, device_type: str = "cuda"):
    """A ``DeviceMesh`` of the plan's shape and axis names over the first
    ``prod(mesh_shape)`` of ``ranks`` (default: the default process group's
    ranks in order); ranks past them are dropped."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if ranks is None:
        if not dist.is_initialized():
            raise RuntimeError("build_mesh needs the default process group: call "
                               "torch.distributed.init_process_group first")
        ranks = range(dist.get_world_size())
    ranks = list(ranks)
    n = int(np.prod(plan.mesh_shape))
    if n > len(ranks):
        raise ValueError(f"plan {plan.mesh_shape} needs {n} ranks; {len(ranks)} given")
    grid = torch.tensor(ranks[:n], dtype=torch.int64).reshape(plan.mesh_shape)
    return DeviceMesh(device_type, grid, mesh_dim_names=tuple(plan.axis_names))
