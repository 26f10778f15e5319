"""DLRM — the paper's evaluation workload (Table I: DLRM-RMC2-small).

Bottom MLP over dense features, embedding-bag lookups over T tables (the
paper's operation, through the kernels K3, or K5 + K4 on the hot-pinned
path), dot-product feature interaction, top MLP.

``DLRM`` holds the parameters of the reference's ``init`` tree as
``nn.Parameter``s: ``tables`` ``(T*R, D)``, ``bottom_w.i``/``bottom_b.i``
and ``top_w.i``/``top_b.i`` (``w`` is ``(in, out)``). It serves: the kernels
compute no gradients, so the parameters do not require them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..core.profiling import stage
from ..device import DeviceLike, resolve_device
from ..kernels import ops
from .layers import DTYPES, _dense_init


@dataclass(frozen=True)
class DLRMConfig:
    num_tables: int = 60
    rows_per_table: int = 1_000_000
    dim: int = 128
    lookups_per_table: int = 120
    dense_features: int = 13
    bottom_mlp: Tuple[int, ...] = (256, 128, 128)
    top_mlp: Tuple[int, ...] = (128, 64, 1)
    dtype: str = "float32"

    def __post_init__(self):
        if self.bottom_mlp[-1] != self.dim:
            raise ValueError("dot-interaction requires bottom_mlp[-1] == embedding dim, got "
                             f"{self.bottom_mlp} and {self.dim}")
        if self.dtype not in DTYPES:
            raise ValueError(f"dtype must be one of {sorted(DTYPES)}, got {self.dtype!r}")

    @property
    def n_vectors(self) -> int:
        return self.num_tables + 1  # + bottom-MLP output

    @property
    def interact_dim(self) -> int:
        n = self.n_vectors
        return n * (n - 1) // 2 + self.bottom_mlp[-1]


def smoke_config() -> DLRMConfig:
    return DLRMConfig(num_tables=4, rows_per_table=1000, dim=32,
                      lookups_per_table=8, bottom_mlp=(64, 32), top_mlp=(32, 1))


def _mlp_apply(ws, bs, x: torch.Tensor) -> torch.Tensor:
    """Linear layers with ReLU between them (none after the last); each
    product runs in the promoted dtype of its operands, as jnp promotes."""
    for i, (w, b) in enumerate(zip(ws, bs)):
        dt = torch.promote_types(x.dtype, w.dtype)
        x = x.to(dt) @ w.to(dt) + b.to(dt)
        if i < len(ws) - 1:
            x = torch.relu(x)
    return x


def interact(dense_vec: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """Dot-product interaction. dense_vec (B, D), emb (B, T, D) ->
    (B, n(n-1)/2), the strict upper triangle in row-major order."""
    dt = torch.promote_types(dense_vec.dtype, emb.dtype)
    allv = torch.cat([dense_vec[:, None, :].to(dt), emb.to(dt)], dim=1)   # (B, n, D)
    z = torch.bmm(allv, allv.transpose(1, 2))
    n = allv.shape[1]
    iu, ju = torch.triu_indices(n, n, offset=1, device=allv.device)
    return z[:, iu, ju]


class DLRM(nn.Module):
    """The DLRM with parameters drawn as the reference's ``init`` draws them
    (tables ``N(0, 1) * 0.01``, weights ``N(0, 1) / sqrt(in)``, zero biases)
    from ``generator`` (default: seeded 0) on ``device`` (default: the card;
    raises without one). The stacked table is filled one table at a time,
    on the device."""

    def __init__(self, cfg: DLRMConfig, device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        dt = DTYPES[cfg.dtype]
        self.cfg = cfg
        R, D = cfg.rows_per_table, cfg.dim
        tables = torch.empty((cfg.num_tables * R, D), dtype=dt, device=dev)
        for t in range(cfg.num_tables):
            tables[t * R:(t + 1) * R] = _dense_init(
                (R, D), scale=0.01, dtype=dt, generator=generator, device=dev)
        self.tables = nn.Parameter(tables, requires_grad=False)
        self.bottom_w, self.bottom_b = self._mlp(cfg.bottom_mlp, cfg.dense_features, dt,
                                                 generator, dev)
        self.top_w, self.top_b = self._mlp(cfg.top_mlp, cfg.interact_dim, dt, generator, dev)

    @staticmethod
    def _mlp(dims, in_dim, dtype, generator, device):
        ws, bs, d = [], [], in_dim
        for out in dims:
            ws.append(nn.Parameter(_dense_init((d, out), dtype=dtype, generator=generator,
                                               device=device), requires_grad=False))
            bs.append(nn.Parameter(torch.zeros(out, dtype=dtype, device=device),
                                   requires_grad=False))
            d = out
        return nn.ParameterList(ws), nn.ParameterList(bs)

    def forward(
        self,
        dense: torch.Tensor,       # (B, dense_features)
        sparse: torch.Tensor,      # (B, T, L) int32 per-table row ids
        pinned: Optional[Dict[str, torch.Tensor]] = None,
    ) -> torch.Tensor:             # (B,) logit
        """Logits; with ``pinned`` (``hot_table``, ``positions``, ``mask``)
        the embeddings take the hot-pinned path. Each layer is a span of
        ``core.profiling`` under the call's ``dlrm.forward``."""
        cfg = self.cfg
        with stage("dlrm.forward"):
            with stage("dlrm.bottom_mlp"):
                bot = _mlp_apply(self.bottom_w, self.bottom_b, dense)     # (B, D)
            with stage("dlrm.embedding"):
                if pinned is not None:
                    emb = ops.embedding_bag_pinned(
                        self.tables, pinned["hot_table"], sparse,
                        pinned["positions"], pinned["mask"], cfg.rows_per_table,
                    )
                else:
                    emb = ops.embedding_bag(self.tables, sparse, cfg.rows_per_table)  # (B, T, D)
            with stage("dlrm.interact"):
                pairs = interact(bot, emb)
            with stage("dlrm.top_mlp"):
                feat = torch.cat([bot, pairs], dim=1)
                return _mlp_apply(self.top_w, self.top_b, feat)[:, 0]


def bce_loss(logit: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    z = logit.float()
    return torch.mean(torch.clamp_min(z, 0) - z * label + torch.log1p(torch.exp(-torch.abs(z))))
