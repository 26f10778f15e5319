"""Zamba2-style hybrid: Mamba2 backbone + ONE shared attention+MLP block
applied every ``attn_every`` layers (the shared block's parameters are reused
at every application — Zamba2's signature weight-sharing trick).

A port of ``repro/models/hybrid.py``. The Mamba2 layers are stacked
``(G, E, ...)`` as in the reference (``groups``), G = n_layers / attn_every
applications of the shared block. On the prompt every Mamba2 layer runs K8
and every application of the shared block K6; each decoded token runs K7 in
every application. The reference's sharding calls do nothing on one device
and are dropped; so is ``remat``. Caches are updated in place.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..device import DeviceLike, resolve_device
from . import layers as L
from . import mamba
from .config import ArchConfig
from .transformer import hidden_to_logits, lm_tree

Params = L.Params


def _check(cfg: ArchConfig):
    if cfg.hybrid is None or cfg.ssm is None:
        raise ValueError(f"{cfg.name}: the hybrid family needs hybrid= and ssm= configs")
    if cfg.n_layers % cfg.hybrid.attn_every:
        raise ValueError(f"{cfg.name}: n_layers {cfg.n_layers} is not a multiple of "
                         f"attn_every {cfg.hybrid.attn_every}")


def _groups(cfg: ArchConfig):
    return cfg.n_layers // cfg.hybrid.attn_every, cfg.hybrid.attn_every


def init_params(cfg: ArchConfig, *, generator: Optional[torch.Generator],
                device: torch.device) -> Params:
    """The reference's ``init_lm`` tree as a dict (``device`` may be
    ``meta``, to read shapes and dtypes): ``groups`` stacked (G, E, ...)."""
    _check(cfg)
    G, E = _groups(cfg)
    kw = dict(generator=generator, device=device)
    groups = L.init_stacked(
        lambda: L.init_stacked(lambda: mamba.init_layer(cfg, **kw), E), G)
    dt = L.model_dtype(cfg)
    shared = {
        "norm1": L.init_rmsnorm(cfg.d_model, device=device),
        "attn": L.init_attention(cfg, dt, **kw),
        "norm2": L.init_rmsnorm(cfg.d_model, device=device),
        "mlp": L.init_swiglu(cfg.d_model, cfg.hybrid.shared_d_ff or 4 * cfg.d_model, dt, **kw),
    }
    return lm_tree(cfg, {"groups": groups, "shared": shared}, generator, device)


def init_lm(cfg: ArchConfig, *, device: DeviceLike = "cuda",
            generator: Optional[torch.Generator] = None) -> L.ParamTree:
    """The reference's ``init_lm`` tree as a ``ParamTree``, drawn from
    ``generator`` (default: seeded 0) on ``device`` (default: the card;
    raises without one)."""
    return L.new_params(init_params, cfg, device, generator)


def _shared_block(cfg, shared, x, positions, *, kv_cache=None, cache_index=None,
                  prefill=False):
    h = L.rmsnorm(shared["norm1"], x, cfg.norm_eps)
    attn_out, new_cache = L.attention(
        shared["attn"], h, cfg, positions=positions,
        kv_cache=kv_cache, cache_index=cache_index, prefill=prefill,
    )
    x = x + attn_out
    h = L.rmsnorm(shared["norm2"], x, cfg.norm_eps)
    return x + L.swiglu(shared["mlp"], h), new_cache


def final_hidden(params: Params, tokens: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    _check(cfg)
    x = L.embed(params["embed"], tokens)
    positions = torch.arange(tokens.shape[1], device=x.device)
    for group in L.stacked_layers(params, "groups", 2):
        for lp in group:
            x, _, _ = mamba._apply_layer(cfg, lp, x)
        x, _ = _shared_block(cfg, params["shared"], x, positions)
    return L.rmsnorm(params["final_norm"], x, cfg.norm_eps)


def forward(params: Params, tokens: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    return hidden_to_logits(params, final_hidden(params, tokens, cfg), cfg)


# --------------------------------------------------------------------------
# Serving: SSM states per mamba layer + KV cache per shared-block application
# --------------------------------------------------------------------------

def init_state_cache(cfg: ArchConfig, batch: int, max_seq: int, *,
                     device: DeviceLike = "cuda"):
    """(ssm (G, E, B, H, P, N) f32, conv (G, E, B, W-1, Ch), (k, v) each
    (G, B, Hkv, max_seq, dh)), zero."""
    _check(cfg)
    dev = resolve_device(device)
    G, E = _groups(cfg)
    s = cfg.ssm
    H = s.num_heads(cfg.d_model)
    conv_ch = s.d_inner(cfg.d_model) + 2 * s.state_dim
    dt = L.model_dtype(cfg)
    ssm = torch.zeros((G, E, batch, H, s.head_dim, s.state_dim), dtype=torch.float32,
                      device=dev)
    conv = torch.zeros((G, E, batch, s.conv_width - 1, conv_ch), dtype=dt, device=dev)
    kv_shape = (G, batch, cfg.n_kv_heads, max_seq, cfg.attn_head_dim)
    kv = (torch.zeros(kv_shape, dtype=dt, device=dev), torch.zeros(kv_shape, dtype=dt, device=dev))
    return ssm, conv, kv


def prefill_with_state(params: Params, tokens: torch.Tensor, cfg: ArchConfig, *,
                       max_seq: Optional[int] = None, caches=None):
    """Parallel prompt pass: chunked SSD (K8) for the mamba layers and
    causal flash (K6) for the shared attention, whose k, v land at cache
    position 0. Leaves every state in ``caches`` (made for ``max_seq``,
    default S, when not given). Returns (last-token logits, caches)."""
    _check(cfg)
    B, S = tokens.shape
    if caches is None:
        caches = init_state_cache(cfg, B, max_seq or S, device=tokens.device)
    ssm_c, conv_c, (kv_k, kv_v) = caches
    x = L.embed(params["embed"], tokens)
    positions = torch.arange(S, device=x.device)
    for g, group in enumerate(L.stacked_layers(params, "groups", 2)):
        for e, lp in enumerate(group):
            x, st, cv = mamba._prefill_layer(cfg, lp, x)
            ssm_c[g, e].copy_(st)
            conv_c[g, e].copy_(cv)
        x, _ = _shared_block(cfg, params["shared"], x, positions,
                             kv_cache=(kv_k[g], kv_v[g]), cache_index=0, prefill=True)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return hidden_to_logits(params, x[:, -1:], cfg), caches


def decode_step(params: Params, tokens: torch.Tensor, cache_index: int, caches,
                cfg: ArchConfig):
    """One step of ``tokens`` (B, S_new) at host position ``cache_index``;
    every cache is updated in place. Returns (logits, caches)."""
    _check(cfg)
    ssm_c, conv_c, (kv_k, kv_v) = caches
    x = L.embed(params["embed"], tokens)
    positions = cache_index + torch.arange(tokens.shape[1], device=x.device)
    for g, group in enumerate(L.stacked_layers(params, "groups", 2)):
        for e, lp in enumerate(group):
            x, st, cv = mamba._apply_layer(cfg, lp, x, ssm_state=ssm_c[g, e],
                                           conv_state=conv_c[g, e])
            ssm_c[g, e].copy_(st)
            conv_c[g, e].copy_(cv)
        x, _ = _shared_block(cfg, params["shared"], x, positions,
                             kv_cache=(kv_k[g], kv_v[g]), cache_index=cache_index)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return hidden_to_logits(params, x, cfg), caches
