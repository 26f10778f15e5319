"""Plain torch oracles of the kernels (the allclose targets).

Ports of ``repro/kernels/ref.py``: the embedding oracles (one gather of
every row, then one reduction over L, in whatever order torch sums) and the
LM oracles ``flash_attention_ref``, ``chunked_attention`` (online softmax
over key blocks, for dv != dq and S > 2048), ``decode_attention_ref``,
``mamba2_ssd_ref`` (the exact sequential recurrence) and
``mamba2_final_state`` (the closed-form state after a prompt). The
``use_pallas=False`` route of ``ops`` runs them; so does training, whose
gradients flow through them (no kernel has a backward).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .. import loops


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
    q_offset: int = 0,
) -> torch.Tensor:
    """``q_offset``: the position of q's first row among the keys (a slice
    of the queries, as one rank holds under a mesh); the causal mask is
    ``offset + row >= col``."""
    B, Hq, S, d = q.shape
    group = Hq // k.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    kf = k.repeat_interleave(group, dim=1).float()
    vf = v.repeat_interleave(group, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * sm_scale
    if causal:
        if q_offset or S != k.shape[2]:
            rows = q_offset + torch.arange(S, device=q.device)
            mask = rows[:, None] >= torch.arange(k.shape[2], device=q.device)[None, :]
        else:
            mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, torch.tensor(-1e30, device=q.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)


def chunked_attention(
    q: torch.Tensor,   # (B, Hq, S, dq)
    k: torch.Tensor,   # (B, Hkv, Sk, dq)
    v: torch.Tensor,   # (B, Hkv, Sk, dv)
    *,
    causal: bool = True,
    sm_scale: Optional[float] = None,
    k_block: int = 512,
    q_offset: int = 0,
) -> torch.Tensor:
    """Online-softmax attention over blocks of ``k_block`` keys (never the
    whole (S, Sk) scores), GQA by expanding each block's k, v, any dv. As the
    reference computes it: the scores from q and k in their dtype with f32
    sums, p rounded to v's dtype before p.v (f32 sums), the running max from
    -1e30, the output divided by max(l, 1e-30). ``q_offset`` as in
    ``flash_attention_ref``."""
    B, Hq, S, dq = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    G = Hq // Hkv
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(dq)
    k_block = min(k_block, Sk)
    rows = q_offset + torch.arange(S, device=q.device)
    qf = q.float()
    m = torch.full((B, Hq, S, 1), -1e30, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, Hq, S, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Hq, S, dv), dtype=torch.float32, device=q.device)
    neg = torch.tensor(-1e30, device=q.device)
    for lo in range(0, Sk, k_block):
        kc = k[:, :, lo:lo + k_block].repeat_interleave(G, dim=1)
        vc = v[:, :, lo:lo + k_block].repeat_interleave(G, dim=1)
        if kc.shape[2] < k_block:            # the reference pads the last block
            kc = torch.nn.functional.pad(kc, (0, 0, 0, k_block - kc.shape[2]))
            vc = torch.nn.functional.pad(vc, (0, 0, 0, k_block - vc.shape[2]))
        s = torch.einsum("bhsd,bhtd->bhst", qf, kc.float()) * sm_scale
        cols = lo + torch.arange(k_block, device=q.device)
        mask = (cols[None, :] < Sk).expand(S, k_block)
        if causal:
            mask = mask & (rows[:, None] >= cols[None, :])
        s = torch.where(mask, s, neg)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhst,bhtd->bhsd", p.to(v.dtype).float(), vc.float())
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)


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
    """Exact sequential recurrence, one step per position (steps of one
    body: ``loops.trips``)."""
    Bsz, H, S, P = x.shape
    N = Bm.shape[-1]
    xf, adtf, dtf, Bf, Cf = x.float(), adt.float(), dt.float(), Bm.float(), C.float()
    state = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in loops.trips(S):
        decay = torch.exp(adtf[:, :, t])[..., None, None]
        outer = (dtf[:, :, t, None, None] * xf[:, :, t, :, None]) * Bf[:, None, t, None, :]
        state = decay * state + outer
        ys.append(torch.einsum("bhpn,bn->bhp", state, Cf[:, t]))
    return loops.stacked(ys, S, dim=2).to(x.dtype)
