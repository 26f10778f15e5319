"""Build the port's configuration objects and weights from the reference
package's.

A simulator has no weights: its state is its configuration. These helpers
take ``dataclasses.asdict`` of the reference package's ``HardwareConfig`` /
``Workload`` (enums as their values or as str-enum members) and build the
port's equal objects, so one configuration drives both packages. Index
traces are numpy arrays in both packages and pass as they are. The DLRM's
weights cross over as numpy arrays (``dlrm_params_from_jax``): the
reference draws them with ``jax.random``, which torch cannot reproduce. So
do the LM families' (``lm_params_from_jax``).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .core.hardware import (
    Dataflow,
    HardwareConfig,
    LookupSharding,
    MatrixUnit,
    OffChipMemory,
    OnChipMemory,
    OnChipPolicy,
    Topology,
    TranslationConfig,
    VectorUnit,
)
from .core.workload import EmbeddingOpSpec, MatrixOpSpec, VectorOp, Workload
from .models.config import (
    ArchConfig,
    EncDecConfig,
    HybridConfig,
    MLAConfig,
    MoEConfig,
    SSMConfig,
)
from .models.dlrm import DTYPES, DLRMConfig


def _value(x):
    return getattr(x, "value", x)


def hardware_from_dict(d: Dict[str, Any]) -> HardwareConfig:
    """``HardwareConfig`` from ``dataclasses.asdict`` of an equal config."""
    mu = dict(d["matrix_unit"], dataflow=Dataflow(_value(d["matrix_unit"]["dataflow"])))
    oc = dict(d["onchip"], policy=OnChipPolicy(_value(d["onchip"]["policy"])))
    if oc.get("policy_mix") is not None:
        oc["policy_mix"] = tuple((int(t), str(_value(p))) for t, p in oc["policy_mix"])
    tr = d.get("translation")
    return HardwareConfig(
        name=d["name"],
        clock_ghz=d["clock_ghz"],
        num_cores=d["num_cores"],
        topology=Topology(_value(d["topology"])),
        lookup_sharding=LookupSharding(_value(d["lookup_sharding"])),
        matrix_unit=MatrixUnit(**mu),
        vector_unit=VectorUnit(**d["vector_unit"]),
        onchip=OnChipMemory(**oc),
        offchip=OffChipMemory(**d["offchip"]),
        channel_affinity=d["channel_affinity"],
        placement=d["placement"],
        cache_backend=d["cache_backend"],
        translation=None if tr is None else TranslationConfig(**tr),
    )


def workload_from_dict(d: Dict[str, Any]) -> Workload:
    """``Workload`` from ``dataclasses.asdict`` of an equal workload."""
    return Workload(
        name=d["name"],
        matrix_ops=tuple(MatrixOpSpec(**op) for op in d["matrix_ops"]),
        embedding_ops=tuple(
            EmbeddingOpSpec(**dict(op, vector_op=VectorOp(_value(op["vector_op"]))))
            for op in d["embedding_ops"]
        ),
        batch_size=d["batch_size"],
        num_batches=d["num_batches"],
    )


def dlrm_params_from_jax(params: Dict[str, Any], cfg: DLRMConfig) -> Dict[str, torch.Tensor]:
    """``DLRM`` state dict (CPU tensors of ``cfg.dtype``) from the reference's
    ``dlrm.init`` tree as numpy arrays: ``{"tables", "bottom": [{"w", "b"},
    ...], "top": [...]}``. bf16 arrays pass through f32, which is exact."""
    dt = DTYPES[cfg.dtype]

    def tensor(x):
        return torch.from_numpy(np.array(x, dtype=np.float32)).to(dt)

    want = (cfg.num_tables * cfg.rows_per_table, cfg.dim)
    if tuple(np.shape(params["tables"])) != want:
        raise ValueError(f"tables has shape {np.shape(params['tables'])}, cfg needs {want}")
    state = {"tables": tensor(params["tables"])}
    for part, dims in (("bottom", cfg.bottom_mlp), ("top", cfg.top_mlp)):
        if len(params[part]) != len(dims):
            raise ValueError(f"{part}: {len(params[part])} layers, cfg has {len(dims)}")
        for i, layer in enumerate(params[part]):
            state[f"{part}_w.{i}"] = tensor(layer["w"])
            state[f"{part}_b.{i}"] = tensor(layer["b"])
    return state


_SUB_CONFIGS = {"moe": MoEConfig, "mla": MLAConfig, "ssm": SSMConfig, "hybrid": HybridConfig,
                "encdec": EncDecConfig}


def arch_config_from_dict(d: Dict[str, Any]) -> ArchConfig:
    """``ArchConfig`` from ``dataclasses.asdict`` of an equal config."""
    return ArchConfig(**{k: (_SUB_CONFIGS[k](**v) if k in _SUB_CONFIGS and v is not None else v)
                         for k, v in d.items()})


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def lm_params_from_jax(params: Dict[str, Any], cfg: ArchConfig) -> Dict[str, torch.Tensor]:
    """The LM's state dict (CPU tensors) from the reference's ``init_lm``
    tree (whisper's ``init_model``) as numpy arrays, for every family: the
    tree flattened to dotted names (``groups.mixer.in_z``, ...), each array
    checked against the port's shape and cast to its dtype (bf16 goes
    through f32, which is exact; the MoE router stays f32 in every model
    dtype, as in the reference)."""
    from .models.registry import family_module

    want = _flatten(family_module(cfg).init_params(cfg, generator=None,
                                                   device=torch.device("meta")))
    got = _flatten(params)
    if set(got) != set(want):
        raise ValueError(f"{cfg.name}: parameters missing {sorted(set(want) - set(got))}, "
                         f"unexpected {sorted(set(got) - set(want))}")
    state = {}
    for name, ref in want.items():
        arr = np.array(got[name], dtype=np.float32)
        if arr.shape != tuple(ref.shape):
            raise ValueError(f"{cfg.name}: {name} has shape {arr.shape}, the port needs "
                             f"{tuple(ref.shape)}")
        state[name] = torch.from_numpy(arr).to(ref.dtype)
    return state
