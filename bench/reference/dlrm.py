"""The plain DLRM reference: f32 torch, no kernel, nothing of the program.

scores = top_mlp([bot, triu(V V^T)]) with bot = bottom_mlp(dense) and V the
rows [bot, e_1 .. e_T], e_t the sum of table t's rows at the sample's
lookups (DLRM, arXiv:1906.00091; the dot interaction keeps the strict upper
triangle, row-major). MLPs are ``x @ w + b`` with ReLU between layers and
none after the last. Rows are gathered in blocks of samples so the
reference fits beside the model.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from .precision import exact


def mlp(weights: Dict[str, torch.Tensor], part: str, x: torch.Tensor, n: int,
        mm: Callable = exact) -> torch.Tensor:
    for i in range(n):
        x = mm(x, weights[f"{part}_w.{i}"].float()) + weights[f"{part}_b.{i}"].float()
        if i < n - 1:
            x = torch.relu(x)
    return x


def scores(weights: Dict[str, torch.Tensor], dense: torch.Tensor, sparse: torch.Tensor,
           config: dict, mm: Callable = exact, block: int = 256) -> torch.Tensor:
    """(B,) f32 scores of ``dense`` (B, F) and per-table row ids ``sparse``
    (B, T, L), from the benchmark's ``weights`` (``tables`` (T*R, D),
    ``bottom_w.i`` (in, out), ``bottom_b.i``, ``top_w.i``, ``top_b.i``)."""
    T, R = config["num_tables"], config["rows_per_table"]
    nb, nt = len(config["bottom_mlp"]), len(config["top_mlp"])
    table = weights["tables"]
    offsets = torch.arange(T, device=sparse.device, dtype=torch.int64)[None, :, None] * R
    n = T + 1
    iu, ju = torch.triu_indices(n, n, offset=1, device=sparse.device)
    out = []
    for b0 in range(0, sparse.shape[0], block):
        idx = sparse[b0:b0 + block].long() + offsets
        emb = table[idx].float().sum(dim=2)                          # (b, T, D)
        bot = mlp(weights, "bottom", dense[b0:b0 + block].float(), nb, mm)
        vecs = torch.cat([bot[:, None, :], emb], dim=1)                # (b, n, D)
        z = mm(vecs, vecs.transpose(1, 2))
        feat = torch.cat([bot, z[:, iu, ju]], dim=1)
        out.append(mlp(weights, "top", feat, nt, mm)[:, 0])
        del idx, emb
    return torch.cat(out)
