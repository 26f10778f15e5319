"""The DLRM family: the port's ``repro_torch.models.DLRM``.

The weights are drawn on the device from the seed (tables N(0, 1) x 0.01
in one call; MLP weights N(0, 1) / sqrt(in), biases N(0, 1) x 0.01) and
the same tensors go to the program and to the plain reference. The program
is ``DLRM.forward`` on the plain path (``ops.embedding_bag``, K3).
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from bench.harness.util import subseed
from bench.reference import dlrm as reference
from bench.reference.precision import exact


def port_config(config: dict):
    from repro_torch.models.dlrm import DLRMConfig
    return DLRMConfig(num_tables=config["num_tables"], rows_per_table=config["rows_per_table"],
                      dim=config["dim"], lookups_per_table=config["lookups_per_table"],
                      dense_features=config["dense_features"],
                      bottom_mlp=tuple(config["bottom_mlp"]), top_mlp=tuple(config["top_mlp"]),
                      dtype=config["dtype"])


def prepare(config: dict) -> dict:
    """The configuration with the top MLP's input width (``interact_dim``)."""
    return dict(config, interact_dim=port_config(config).interact_dim)


def make_weights(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The benchmark's weights, named as the program's state dict."""
    from repro_torch.models.layers import DTYPES
    dt = DTYPES[config["dtype"]]
    g = torch.Generator(device=device).manual_seed(subseed(seed, "weights"))
    T, R, D = config["num_tables"], config["rows_per_table"], config["dim"]
    w = {"tables": torch.empty((T * R, D), dtype=dt, device=device).normal_(0.0, 0.01, generator=g)}
    dims = {"bottom": [config["dense_features"], *config["bottom_mlp"]],
            "top": [config["interact_dim"], *config["top_mlp"]]}
    shapes = [(f"{part}_{kind}.{i}", (d[i], d[i + 1]) if kind == "w" else (d[i + 1],))
              for part, d in dims.items() for i in range(len(d) - 1) for kind in ("w", "b")]
    flat = torch.randn(sum(int(np.prod(s)) for _, s in shapes), generator=g, device=device)
    at = 0
    for name, shape in shapes:
        n = int(np.prod(shape))
        scale = 1.0 / np.sqrt(shape[0]) if name.split(".")[0].endswith("_w") else 0.01
        w[name] = (flat[at:at + n].view(shape) * scale).to(dt)
        at += n
    return w


def build(config: dict, weights: Dict[str, torch.Tensor]):
    """``DLRM`` with the benchmark's weights: the module is built at one row
    a table on the CPU (its structure), then every parameter is replaced by
    the benchmark's tensor of the same name and the full configuration set."""
    import dataclasses
    from torch import nn
    from repro_torch.models.dlrm import DLRM
    cfg = port_config(config)
    model = DLRM(dataclasses.replace(cfg, rows_per_table=1), device="cpu",
                 generator=torch.Generator().manual_seed(0))
    names = {n for n, _ in model.named_parameters()}
    if names != set(weights):
        raise RuntimeError(f"DLRM parameters {sorted(names)} != benchmark weights {sorted(weights)}")
    for name, tensor in weights.items():
        owner, _, leaf = name.rpartition(".")
        module = model.get_submodule(owner) if owner else model
        if isinstance(module, nn.ParameterList):
            module[int(leaf)] = nn.Parameter(tensor, requires_grad=False)
        else:
            setattr(module, leaf, nn.Parameter(tensor, requires_grad=False))
    model.cfg = cfg
    return model


def reference_scores(weights: Dict[str, torch.Tensor], dense: torch.Tensor, sparse: torch.Tensor,
                     config: dict, mm: Callable = exact) -> torch.Tensor:
    """The plain reference's (B,) scores of one batch."""
    return reference.scores(weights, dense, sparse, config, mm=mm)
