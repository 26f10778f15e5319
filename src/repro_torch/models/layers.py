"""Layers of the model zoo, ported from ``repro/models/layers.py``.

The LM part: RMS and layer norms, RoPE, GQA attention (prefill and decode
against a KV cache), DeepSeek's MLA attention (latent cache, weight-absorbed
decode), the SwiGLU and GELU MLPs, the sort-based capacity MoE, the
Mamba2/SSD block with its decode step, embedding and LM head; and the DLRM's
initialiser.

Parameters are nested dicts of tensors, or ``ParamTree`` modules that index
the same way (``p["attn"]["wq"]``); ``init_*`` draw them from an explicit
``torch.Generator`` on an explicit device, with the reference's shapes,
dtypes and scales. The apply functions compute in the dtypes the reference
names, and round to bf16 where it rounds. The attention and SSD products go
through ``kernels.ops`` (the kernels K6, K7 and K8), the embedding through
K4: the reference's ``use_pallas=True`` route, which the port always takes.
The products the reference computes outside Pallas stay plain torch on
every device: MLA's absorbed decode and the MoE's router, dispatch, expert
FFNs and combine. The reference's sharding hints (``shard_attention_q``,
``constrain``) do nothing on one device and are dropped.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..device import resolve_device
from ..kernels import ops
from ..kernels import ref as kref
from .config import ArchConfig

Params = Dict[str, Any]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def model_dtype(cfg: ArchConfig) -> torch.dtype:
    if cfg.dtype not in DTYPES:
        raise ValueError(f"dtype must be one of {sorted(DTYPES)}, got {cfg.dtype!r}")
    return DTYPES[cfg.dtype]


def _dense_init(shape: Sequence[int], *, generator: torch.Generator, device: torch.device,
                scale: Optional[float] = None, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``randn(shape) * scale`` in f32 from ``generator`` on ``device``, cast
    to ``dtype``; ``scale`` defaults to ``1 / sqrt(shape[0])``."""
    if scale is None:
        scale = 1.0 / math.sqrt(shape[0])
    x = torch.randn(tuple(shape), generator=generator, device=device, dtype=torch.float32)
    return x.mul_(scale).to(dtype)


# --------------------------------------------------------------------------
# Parameter trees
# --------------------------------------------------------------------------

class ParamTree(nn.Module):
    """A nested dict of tensors as a module of frozen parameters.

    ``tree["a"]["b"]`` reads parameter ``a.b``; the state dict's names are
    the dotted paths, so a reference tree converts by flattening.
    """

    def __init__(self, tree: Params):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, ParamTree(v))
            else:
                self.register_parameter(k, nn.Parameter(v, requires_grad=False))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._modules or key in self._parameters

    def keys(self) -> List[str]:
        return list(self._modules) + list(self._parameters)


def new_params(init_params, cfg: ArchConfig, device, generator) -> "ParamTree":
    """``ParamTree(init_params(cfg, ...))`` on ``device`` (resolved: the card
    unless the caller asks for the CPU) from ``generator`` (default: seeded
    0 on that device)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return ParamTree(init_params(cfg, generator=generator, device=dev))


def stacked_layers(tree, key: str, depth: int = 1):
    """Views of the layers stacked in ``tree[key]``: a list (of lists, for
    ``depth`` 2) of plain dicts whose tensors index the leading dims."""
    def leaf(t, idx):
        if isinstance(t, torch.Tensor):
            return t[idx]
        return {k: leaf(t[k], idx) for k in t.keys()}

    def split(t, d):
        first = t
        while not isinstance(first, torch.Tensor):
            first = first[next(iter(first.keys()))]
        items = [leaf(t, i) for i in range(first.shape[0])]
        return items if d == 1 else [split(x, d - 1) for x in items]

    return split(tree[key], depth)


def init_stacked(make: Callable[[], Params], n: int) -> Params:
    """``n`` draws of ``make()`` stacked along a new first dim, filled one
    draw at a time. Each leaf of a draw is freed as soon as it is copied in
    (the stacked leaf allocated on the first draw), so filling holds at most
    one draw and one stacked leaf beside the result: less than a draw's own
    f32 transient (arctic's single layer of 28 GB peaks in ``make``)."""
    def fill(dst, src, i):
        for k in list(src):
            v = src.pop(k)
            if isinstance(v, dict):
                dst[k] = fill(dst.get(k, {}), v, i)
            else:
                if k not in dst:
                    dst[k] = torch.empty((n, *v.shape), dtype=v.dtype, device=v.device)
                dst[k][i].copy_(v)
            del v
        return dst

    out = {}
    for i in range(n):
        out = fill(out, make(), i)
    return out


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as the reference computes it, ``x * (1 / (1 +
    exp(-x)))``, each op rounded to x's dtype (one f32 ``F.silu`` rounded
    once differs from it in a third of the bf16 outputs)."""
    return x * (1 / (1 + torch.exp(-x)))


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------

def init_rmsnorm(d: int, dtype=torch.float32, *, device) -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * p["scale"].float()).to(x.dtype)


def init_layernorm(d: int, dtype=torch.float32, *, device) -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
                            / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, d); positions: (S,). Rotates the two halves of each head
    (not interleaved pairs), in f32, and casts back."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                            # (d/2,)
    angles = positions[..., :, None].float() * freqs                  # (S, d/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


# --------------------------------------------------------------------------
# GQA attention
# --------------------------------------------------------------------------

def init_attention(cfg: ArchConfig, dtype, *, generator, device) -> Params:
    D, Hq, Hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.attn_head_dim
    kw = dict(dtype=dtype, generator=generator, device=device)
    return {
        "wq": _dense_init((D, Hq * dh), **kw),
        "wk": _dense_init((D, Hkv * dh), **kw),
        "wv": _dense_init((D, Hkv * dh), **kw),
        "wo": _dense_init((Hq * dh, D), **kw),
    }


def write_cache(cache: torch.Tensor, new: torch.Tensor, cache_index: int) -> int:
    """Write ``new`` (B, Hkv, S, dh) into ``cache`` (B, Hkv, S_max, dh) in
    place at position ``cache_index``, clamped as ``dynamic_update_slice``
    clamps: the start moves back so the update fits. Returns the start."""
    S, S_max = new.shape[2], cache.shape[2]
    if S > S_max:
        raise ValueError(f"cannot write {S} positions into a cache of {S_max}")
    start = min(max(int(cache_index), 0), S_max - S)
    cache[:, :, start:start + S] = new
    return start


def attention(
    p: Params,
    x: torch.Tensor,               # (B, S, D)
    cfg: ArchConfig,
    *,
    positions: Optional[torch.Tensor] = None,
    causal: bool = True,
    kv_cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    cache_index: Optional[int] = None,
    use_rope: bool = True,
    prefill: bool = False,
) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    """Returns (out, kv_cache). With a cache, x is the new-token slice and
    k, v are written into the cache in place (copying the cache per step
    would move all of it); ``cache_index`` is a host int.

    ``prefill=True``: the cache is empty and x is the full prompt, so
    attention is causal flash (K6) over the new tokens only; one new token
    decodes through K7. Any other cached step takes the reference's
    full-cache path (``_decode_attention``), plain torch, so it runs only on
    the CPU: no kernel covers several new tokens against a cache yet, and on
    the card it raises ``NotImplementedError``.
    """
    B, S, D = x.shape
    Hq, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.attn_head_dim
    if positions is None:
        positions = torch.arange(S, device=x.device)

    q = (x @ p["wq"]).reshape(B, S, Hq, dh).transpose(1, 2)
    k = (x @ p["wk"]).reshape(B, S, Hkv, dh).transpose(1, 2)
    v = (x @ p["wv"]).reshape(B, S, Hkv, dh).transpose(1, 2)
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    if kv_cache is not None:
        ck, cv = kv_cache                       # (B, Hkv, S_max, dh)
        write_cache(ck, k.to(ck.dtype), cache_index)
        write_cache(cv, v.to(cv.dtype), cache_index)
        if prefill:
            out = ops.flash_attention(q, k, v, causal=causal)
        elif S == 1:
            out = ops.decode_attention(q[:, :, 0], ck, cv, cache_index + S)[:, :, None, :]
        else:
            if q.device.type != "cpu":
                raise NotImplementedError(
                    f"attention: a cached step of {S} new tokens on {q.device} (no kernel "
                    "covers it; prefill and one-token decode do)")
            out = _decode_attention(q, ck, cv, cache_index + S, Hq // Hkv)
    else:
        out = ops.flash_attention(q, k, v, causal=causal)

    out = out.transpose(1, 2).reshape(B, S, Hq * dh)
    return out @ p["wo"], kv_cache


def _decode_attention(q, ck, cv, valid_len: int, group: int) -> torch.Tensor:
    """Full-cache attention with length masking, for several new tokens.

    q: (B, Hq, S_new, dh); cache: (B, Hkv, S_max, dh). Every new token sees
    the whole valid length, as in the reference."""
    dh = q.shape[-1]
    kf = ck.repeat_interleave(group, dim=1)
    vf = cv.repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf.float()) / math.sqrt(dh)
    span = torch.arange(ck.shape[2], device=q.device)
    s = torch.where(span < valid_len, s, torch.tensor(-1e30, device=q.device))
    w = torch.exp(s - s.amax(dim=-1, keepdim=True))
    out = torch.einsum("bhqk,bhkd->bhqd", w.to(vf.dtype).float(), vf.float())
    return (out / w.sum(dim=-1, keepdim=True)).to(q.dtype)


# --------------------------------------------------------------------------
# MLA attention (DeepSeek-V2): latent KV compression
# --------------------------------------------------------------------------

def init_mla(cfg: ArchConfig, dtype, *, generator, device) -> Params:
    m = cfg.mla
    D, H = cfg.d_model, cfg.n_heads
    qd = m.qk_nope_head_dim + m.qk_rope_head_dim
    kw = dict(dtype=dtype, generator=generator, device=device)
    return {
        "wq": _dense_init((D, H * qd), **kw),
        "w_dkv": _dense_init((D, m.kv_lora_rank + m.qk_rope_head_dim), **kw),
        "w_uk": _dense_init((m.kv_lora_rank, H * m.qk_nope_head_dim), **kw),
        "w_uv": _dense_init((m.kv_lora_rank, H * m.v_head_dim), **kw),
        "wo": _dense_init((H * m.v_head_dim, D), **kw),
    }


def mla_attention(
    p: Params,
    x: torch.Tensor,               # (B, S, D)
    cfg: ArchConfig,
    *,
    positions: Optional[torch.Tensor] = None,
    causal: bool = True,
    kv_cache: Optional[torch.Tensor] = None,   # latent cache (B, S_max, r + rope)
    cache_index: Optional[int] = None,
    prefill: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Returns (out, kv_cache). With a cache, the new tokens' latents (the
    compressed kv and the roped key) are written into it in place at host
    position ``cache_index``; a step that is not the prefill then attends in
    the latent space (``_mla_absorbed_decode``, every new token over the
    whole valid length, as in the reference). Otherwise per-head k and v
    are expanded from the new tokens' latents and attention runs through K6,
    whose one head width takes v padded to the query's (``ops``)."""
    m = cfg.mla
    B, S, D = x.shape
    H, r = cfg.n_heads, m.kv_lora_rank
    if positions is None:
        positions = torch.arange(S, device=x.device)

    q = (x @ p["wq"]).reshape(B, S, H, -1).transpose(1, 2)
    q_nope, q_rope = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    latent = x @ p["w_dkv"]                                   # (B, S, r + rope)
    kv_l, k_rope = latent[..., :r], latent[..., r:]
    k_rope = apply_rope(k_rope[:, None], positions, cfg.rope_theta)  # (B, 1, S, rope)

    if kv_cache is not None:
        lat_new = torch.cat([kv_l, k_rope[:, 0]], dim=-1)
        write_cache(kv_cache[:, None], lat_new.to(kv_cache.dtype)[:, None], cache_index)
        if not prefill:
            out = _mla_absorbed_decode(p, q_nope, q_rope, kv_cache, cache_index + S, m, H)
            out = out.transpose(1, 2).reshape(B, S, H * m.v_head_dim)
            return out @ p["wo"], kv_cache

    k_nope = (kv_l @ p["w_uk"]).reshape(B, -1, H, m.qk_nope_head_dim).transpose(1, 2)
    vv = (kv_l @ p["w_uv"]).reshape(B, -1, H, m.v_head_dim).transpose(1, 2)
    k = torch.cat([k_nope, k_rope.expand(*k_nope.shape[:3], m.qk_rope_head_dim)], dim=-1)
    qq = torch.cat([q_nope, q_rope], dim=-1)
    out = ops.flash_attention(qq, k, vv, causal=causal)
    out = out.transpose(1, 2).reshape(B, S, H * m.v_head_dim)
    return out @ p["wo"], kv_cache


def _mla_absorbed_decode(p, q_nope, q_rope, latent_cache, valid_len: int, m, H):
    """Weight-absorbed latent attention, all in f32: scores (q_nope W_uk^T) .
    latent + q_rope . k_rope over the cache's first ``valid_len`` positions,
    then (softmax . latent) W_uv. q_nope/q_rope: (B, H, Sn, .);
    latent_cache: (B, S_max, r + rope)."""
    r = m.kv_lora_rank
    lat = latent_cache[..., :r].float()                      # (B, S, r)
    k_rope = latent_cache[..., r:].float()                   # (B, S, rope)
    w_uk = p["w_uk"].reshape(r, H, m.qk_nope_head_dim).float()
    q_lat = torch.einsum("bhqn,rhn->bhqr", q_nope.float(), w_uk)
    s = torch.einsum("bhqr,bsr->bhqs", q_lat, lat)
    s = s + torch.einsum("bhqp,bsp->bhqs", q_rope.float(), k_rope)
    s = s / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    span = torch.arange(lat.shape[1], device=lat.device)
    w = torch.softmax(s.masked_fill(span >= valid_len, -1e30), dim=-1)
    ctx = torch.einsum("bhqs,bsr->bhqr", w, lat)
    w_uv = p["w_uv"].reshape(r, H, m.v_head_dim).float()
    return torch.einsum("bhqr,rhv->bhqv", ctx, w_uv).to(q_nope.dtype)


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------

def init_swiglu(d: int, f: int, dtype, *, generator, device) -> Params:
    kw = dict(dtype=dtype, generator=generator, device=device)
    return {"wg": _dense_init((d, f), **kw), "wu": _dense_init((d, f), **kw),
            "wd": _dense_init((f, d), **kw)}


def swiglu(p: Params, x: torch.Tensor) -> torch.Tensor:
    return (silu(x @ p["wg"]) * (x @ p["wu"])) @ p["wd"]


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (the tanh approximation, its default) as the
    reference computes it, ``x * (0.5 * (1 + tanh(c * (x + 0.044715 x^3))))``
    op by op in x's dtype (``F.gelu(approximate="tanh")`` rounds once and
    differs from it in many bf16 outputs)."""
    c = torch.tensor(math.sqrt(2 / math.pi), dtype=torch.float32).to(x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + 0.044715 * (x * x * x)))))


def init_gelu_mlp(d: int, f: int, dtype, *, generator, device) -> Params:
    kw = dict(dtype=dtype, generator=generator, device=device)
    return {"w1": _dense_init((d, f), **kw), "b1": torch.zeros((f,), dtype=dtype, device=device),
            "w2": _dense_init((f, d), **kw), "b2": torch.zeros((d,), dtype=dtype, device=device)}


def gelu_mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    return gelu(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]


# --------------------------------------------------------------------------
# Mixture of Experts (sort-based capacity dispatch)
# --------------------------------------------------------------------------

def init_moe(cfg: ArchConfig, dtype, *, generator, device) -> Params:
    """Router (f32 in every model dtype), the experts' SwiGLU weights
    stacked (E, ...), and the shared experts' SwiGLU when there are any."""
    m = cfg.moe
    D, E, F_ = cfg.d_model, m.num_experts, m.d_ff_expert
    kw = dict(dtype=dtype, generator=generator, device=device)
    p = {
        "router": _dense_init((D, E), dtype=torch.float32, generator=generator, device=device),
        "wg": _dense_init((E, D, F_), **kw),
        "wu": _dense_init((E, D, F_), **kw),
        "wd": _dense_init((E, F_, D), **kw),
    }
    if m.num_shared_experts:
        p["shared"] = init_swiglu(D, m.d_ff_shared or F_ * m.num_shared_experts, dtype,
                                  generator=generator, device=device)
    return p


def _rank_within_group(ids: torch.Tensor) -> torch.Tensor:
    """Position of each element within its run of equal ids along the last
    axis (ids sorted), batched over the leading dims."""
    iota = torch.arange(ids.shape[-1], device=ids.device).expand(ids.shape)
    first = torch.ones_like(ids, dtype=torch.bool)
    first[..., 1:] = ids[..., 1:] != ids[..., :-1]
    start = torch.cummax(torch.where(first, iota, 0), dim=-1).values
    return iota - start


def moe(p: Params, x: torch.Tensor, cfg: ArchConfig, *,
        capacity_factor: Optional[float] = None) -> torch.Tensor:
    """Sort-based capacity MoE with group-local dispatch, the reference's
    semantics (they decide which tokens are dropped): the T tokens split
    into ``dispatch_groups`` groups (one when T is not a multiple), routed
    top-k by f32 softmax probabilities (ties to the lower expert), sorted by
    expert within the group (stably), packed into a (G, E, C, D) buffer
    with capacity C = max(1, int(Tg K cf) // E) (an assignment past C is
    dropped: zero input, zero weight), run through the experts' SwiGLU as
    batched products, and combined with the normalised gate weights. Each
    token's K contributions are added into zeros in x's dtype in ascending
    expert order, the order of the reference's scatter-add, by a fixed loop
    of gathers (no atomics, so a run repeats bit for bit on the card).
    """
    m = cfg.moe
    B, S, D = x.shape
    T = B * S
    E, K = m.num_experts, m.top_k
    cf = capacity_factor if capacity_factor is not None else m.capacity_factor
    G = m.dispatch_groups if T % m.dispatch_groups == 0 else 1
    Tg = T // G
    C = max(1, int(Tg * K * cf) // E)

    xg = x.reshape(G, Tg, D)
    probs = torch.softmax(xg.float() @ p["router"], dim=-1)              # (G, Tg, E)
    gate_w, gate_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_w, gate_e = gate_w[..., :K], gate_e[..., :K]                    # (G, Tg, K)
    gate_w = gate_w / gate_w.sum(dim=-1, keepdim=True).clamp_min(1e-9)

    a_expert = gate_e.reshape(G, Tg * K)
    order = torch.argsort(a_expert, dim=-1, stable=True)                # per-group sort
    se = torch.gather(a_expert, 1, order)
    st = order // K                                                      # token of each
    rank = _rank_within_group(se)
    keep = rank < C
    slot = se * C + rank.clamp(max=C - 1)

    # The buffer: kept assignments at their slots, the rest zeros (a dropped
    # assignment adds zeros to its expert's last slot in the reference). A
    # dropped one is written to a trash row past the buffer, sliced off, so
    # no mask has to be resolved on the host.
    g_idx = torch.arange(G, device=x.device)[:, None].expand(G, Tg * K)
    buf = torch.zeros((G * E * C + 1, D), dtype=x.dtype, device=x.device)
    dest = torch.where(keep, g_idx * (E * C) + slot, G * E * C)
    buf[dest.reshape(-1)] = xg.reshape(G * Tg, D)[(g_idx * Tg + st).reshape(-1)]
    h = buf[:-1].reshape(G, E, C, D)
    act = silu(torch.einsum("gecd,edf->gecf", h, p["wg"])) * torch.einsum(
        "gecd,edf->gecf", h, p["wu"])
    out_buf = torch.einsum("gecf,efd->gecd", act, p["wd"]).reshape(G, E * C, D)

    # Each assignment's weighted output, back in (token, k) order: sorted
    # position order[i] holds assignment order[i] = token * K + k.
    contrib = torch.gather(out_buf, 1, slot[..., None].expand(G, Tg * K, D))
    contrib = contrib * (torch.gather(gate_w.reshape(G, Tg * K), 1, order)
                         * keep)[..., None].to(out_buf.dtype)
    by_assignment = torch.empty_like(contrib)
    by_assignment.scatter_(1, order[..., None].expand(G, Tg * K, D), contrib.to(x.dtype))
    by_assignment = by_assignment.reshape(G, Tg, K, D)
    k_order = torch.argsort(gate_e, dim=-1)                              # ascending expert
    out = torch.zeros((G, Tg, D), dtype=x.dtype, device=x.device)
    for j in range(K):
        idx = k_order[..., j, None, None].expand(G, Tg, 1, D)
        out = out + torch.gather(by_assignment, 2, idx)[:, :, 0]
    out = out.reshape(B, S, D)

    if "shared" in p:
        out = out + swiglu(p["shared"], x)
    return out


# --------------------------------------------------------------------------
# Mamba2 / SSD block
# --------------------------------------------------------------------------

def init_mamba2(cfg: ArchConfig, dtype, *, generator, device) -> Params:
    s = cfg.ssm
    D = cfg.d_model
    di = s.d_inner(D)
    H = s.num_heads(D)
    N = s.state_dim
    conv_ch = di + 2 * N
    kw = dict(dtype=dtype, generator=generator, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_z": _dense_init((D, di), **kw),
        "in_xbc": _dense_init((D, conv_ch), **kw),
        "in_dt": _dense_init((D, H), **kw),
        "conv_w": _dense_init((s.conv_width, conv_ch), scale=0.5, **kw),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=device),
        "a_log": torch.log(torch.linspace(1.0, 16.0, H, **f32)),
        "dt_bias": torch.zeros((H,), **f32),
        "d_skip": torch.ones((H,), **f32),
        "norm": init_rmsnorm(di, dtype=dtype, device=device),
        "out_proj": _dense_init((di, D), **kw),
    }


def _causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   state: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv. x: (B, S, Ch), w: (W, Ch). Returns (y,
    new_state); the state is the last W-1 rows of the input before the
    conv (the padded input), which decode carries."""
    W = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], W - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    else:
        pad = state
    xp = torch.cat([pad, x], dim=1)                     # (B, S+W-1, Ch)
    S = x.shape[1]
    y = xp[:, 0:S] * w[0]
    for i in range(1, W):
        y = y + xp[:, i:i + S] * w[i]
    new_state = xp[:, -(W - 1):] if W > 1 else torch.zeros_like(pad)
    return silu(y + b), new_state


def mamba2_block(
    p: Params,
    x: torch.Tensor,                           # (B, S, D)
    cfg: ArchConfig,
    *,
    ssm_state: Optional[torch.Tensor] = None,  # (B, H, P, N) decode carry
    conv_state: Optional[torch.Tensor] = None,  # (B, W-1, Ch)
    return_final_state: bool = False,          # prefill: parallel scan + state out
) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
    """Returns (out, new_ssm_state, new_conv_state). Without a state the
    prompt runs through the chunked SSD scan (K8) and, when asked, the state
    after it comes from the closed form ``mamba2_final_state``; with one,
    the new tokens step through ``_ssd_decode_step``."""
    s = cfg.ssm
    B, S, D = x.shape
    di = s.d_inner(D)
    H = s.num_heads(D)
    N, P = s.state_dim, s.head_dim

    z = x @ p["in_z"]
    xbc = x @ p["in_xbc"]
    dt_raw = x @ p["in_dt"]

    xbc, new_conv = _causal_conv1d(xbc, p["conv_w"], p["conv_b"], conv_state)
    xs = xbc[..., :di]
    Bm = xbc[..., di:di + N]
    Cm = xbc[..., di + N:]

    # softplus as the reference writes it, log(1 + exp(x)) without torch's
    # linear branch above a threshold
    dt = torch.logaddexp(dt_raw.float() + p["dt_bias"], torch.zeros((), device=x.device))
    A = -torch.exp(p["a_log"])                                        # (H,)

    xh = xs.reshape(B, S, H, P).transpose(1, 2)                        # (B,H,S,P)
    dt_h = dt.transpose(1, 2)                                          # (B,H,S)
    adt = A[None, :, None] * dt_h

    if ssm_state is None:
        y = ops.mamba2_ssd(xh, adt, dt_h, Bm, Cm, chunk=s.chunk)      # (B,H,S,P)
        new_state = kref.mamba2_final_state(xh, adt, dt_h, Bm) if return_final_state else None
    else:
        y, new_state = _ssd_decode_step(xh, adt, dt_h, Bm, Cm, ssm_state)

    y = y + p["d_skip"][None, :, None, None] * xh.float()
    y = y.transpose(1, 2).reshape(B, S, di).to(x.dtype)
    y = y * silu(z)
    y = rmsnorm(p["norm"], y, cfg.norm_eps)
    return y @ p["out_proj"], new_state, new_conv


def _ssd_decode_step(xh, adt, dt_h, Bm, Cm, state):
    """Sequential steps over the (short) new-token window, carrying the f32
    state: returns (y (B,H,S,P) f32, state (B,H,P,N))."""
    S = xh.shape[2]
    st = state.float()
    ys = []
    for t in range(S):
        decay = torch.exp(adt[:, :, t])[..., None, None]
        outer = (dt_h[:, :, t, None, None] * xh[:, :, t, :, None]) * Bm[:, None, t, None, :]
        st = decay * st + outer
        ys.append(torch.einsum("bhpn,bn->bhp", st, Cm[:, t].float()))
    return torch.stack(ys, dim=2), st


# --------------------------------------------------------------------------
# Embedding / logits
# --------------------------------------------------------------------------

def init_embedding(vocab: int, d: int, dtype, *, generator, device) -> Params:
    return {"table": _dense_init((vocab, d), scale=0.02, dtype=dtype, generator=generator,
                                 device=device)}


def embed(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    """Token rows through the row gather (K4)."""
    return ops.embedding_gather(p["table"], tokens)


def init_lm_head(d: int, vocab: int, dtype, *, generator, device) -> Params:
    return {"w": _dense_init((d, vocab), dtype=dtype, generator=generator, device=device)}


def lm_logits(p: Params, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"]
