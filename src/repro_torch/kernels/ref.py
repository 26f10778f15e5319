"""Plain torch oracles of the kernels (the allclose targets).

Ports of ``repro/kernels/ref.py``: the embedding oracles (one gather of
every row, then one reduction over L, in whatever order torch sums) and the
LM oracles ``flash_attention_ref``, ``decode_attention_ref``,
``mamba2_ssd_ref`` (the exact sequential recurrence) and
``mamba2_final_state`` (the closed-form state after a prompt).
``chunked_attention`` is not ported: the reference sends MLA's dv != dq
there, and the port sends it through K6 with v padded (``ops``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def embedding_bag_ref(table: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """table (T*R, D), indices (B, T, L) pre-offset -> (B, T, D) sum-pool."""
    gathered = table[indices.long()]                  # (B, T, L, D)
    return gathered.float().sum(dim=2).to(table.dtype)


def embedding_gather_ref(table: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    return table[indices.long()]


def embedding_bag_pinned_ref(
    hot_table: torch.Tensor,     # (H, D)
    positions: torch.Tensor,     # (B, T, L) position in hot table (0 if cold)
    mask: torch.Tensor,          # (B, T, L) 1 = hot
) -> torch.Tensor:
    rows = hot_table[positions.long()].float()       # (B, T, L, D)
    rows = rows * mask[..., None].float()
    return rows.sum(dim=2).to(hot_table.dtype)


def flash_attention_ref(
    q: torch.Tensor,   # (B, Hq, S, d)
    k: torch.Tensor,   # (B, Hkv, S, d)
    v: torch.Tensor,
    *,
    causal: bool = True,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    B, Hq, S, d = q.shape
    group = Hq // k.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    kf = k.repeat_interleave(group, dim=1).float()
    vf = v.repeat_interleave(group, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * sm_scale
    if causal:
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, torch.tensor(-1e30, device=q.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)


def decode_attention_ref(
    q: torch.Tensor,          # (B, Hq, dh)
    k: torch.Tensor,          # (B, Hkv, S, dh)
    v: torch.Tensor,
    valid_len: int,
) -> torch.Tensor:            # (B, Hq, dh)
    B, Hq, dh = q.shape
    G = Hq // k.shape[1]
    S = k.shape[2]
    kf = k.repeat_interleave(G, dim=1).float()
    vf = v.repeat_interleave(G, dim=1).float()
    s = torch.einsum("bhd,bhkd->bhk", q.float(), kf) / math.sqrt(dh)
    span = torch.arange(S, device=q.device)
    s = torch.where(span[None, None, :] < valid_len, s, torch.tensor(-1e30, device=q.device))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhk,bhkd->bhd", w, vf).to(q.dtype)


def mamba2_final_state(
    x: torch.Tensor,    # (B, H, S, P)
    adt: torch.Tensor,  # (B, H, S)
    dt: torch.Tensor,   # (B, H, S)
    Bm: torch.Tensor,   # (B, S, N)
) -> torch.Tensor:      # (B, H, P, N) — state after the full sequence
    cum = torch.cumsum(adt.float(), dim=-1)
    w = torch.exp(cum[..., -1:] - cum) * dt.float()                  # (B,H,S)
    return torch.einsum("bhs,bhsp,bsn->bhpn", w, x.float(), Bm.float())


def mamba2_ssd_ref(
    x: torch.Tensor,    # (B, H, S, P)
    adt: torch.Tensor,  # (B, H, S)
    dt: torch.Tensor,   # (B, H, S)
    Bm: torch.Tensor,   # (B, S, N)
    C: torch.Tensor,    # (B, S, N)
) -> torch.Tensor:      # (B, H, S, P)
    """Exact sequential recurrence, one step per position."""
    Bsz, H, S, P = x.shape
    N = Bm.shape[-1]
    xf, adtf, dtf, Bf, Cf = x.float(), adt.float(), dt.float(), Bm.float(), C.float()
    state = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        decay = torch.exp(adtf[:, :, t])[..., None, None]
        outer = (dtf[:, :, t, None, None] * xf[:, :, t, :, None]) * Bf[:, None, t, None, :]
        state = decay * state + outer
        ys.append(torch.einsum("bhpn,bn->bhp", state, Cf[:, t]))
    return torch.stack(ys, dim=2).to(x.dtype)
