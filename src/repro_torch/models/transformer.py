"""Decoder-only LM of the dense family: GQA attention + SwiGLU FFN over
stacked layers, with KV-cache prefill and decode.

A port of ``repro/models/transformer.py`` for ``family="dense"`` with the
SwiGLU MLP; MoE, MLA, the GELU MLP and the vlm family are not ported yet
(``registry.family_module`` refuses them). The reference's sharding calls
(``activation_constraint``, ``fsdp_unshard``) do nothing on one device and
are dropped; so is ``remat``, since serving keeps no activations. Caches are
updated in place.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from ..device import DeviceLike, resolve_device
from . import layers as L
from .config import ArchConfig

Params = L.Params


def init_layer(cfg: ArchConfig, *, generator: torch.Generator, device) -> Params:
    dt = L.model_dtype(cfg)
    kw = dict(generator=generator, device=device)
    return {
        "norm1": L.init_rmsnorm(cfg.d_model, device=device),
        "norm2": L.init_rmsnorm(cfg.d_model, device=device),
        "attn": L.init_attention(cfg, dt, **kw),
        "mlp": L.init_swiglu(cfg.d_model, cfg.d_ff, dt, **kw),
    }


def lm_tree(cfg: ArchConfig, body: Params, generator, device) -> Params:
    """Embedding, the family's body, final norm and (untied) head."""
    dt = L.model_dtype(cfg)
    kw = dict(generator=generator, device=device)
    p = {"embed": L.init_embedding(cfg.vocab, cfg.d_model, dt, **kw), **body,
         "final_norm": L.init_rmsnorm(cfg.d_model, device=device)}
    if not cfg.tie_embeddings:
        p["head"] = L.init_lm_head(cfg.d_model, cfg.vocab, dt, **kw)
    return p


def init_params(cfg: ArchConfig, *, generator: Optional[torch.Generator],
                device: torch.device) -> Params:
    """The reference's ``init_lm`` tree as a dict (``device`` may be
    ``meta``, to read shapes and dtypes)."""
    layers = L.init_stacked(lambda: init_layer(cfg, generator=generator, device=device),
                            cfg.n_layers)
    return lm_tree(cfg, {"layers": layers}, generator, device)


def init_lm(cfg: ArchConfig, *, device: DeviceLike = "cuda",
            generator: Optional[torch.Generator] = None) -> L.ParamTree:
    """The reference's ``init_lm`` tree as a ``ParamTree``, drawn from
    ``generator`` (default: seeded 0) on ``device`` (default: the card;
    raises without one)."""
    return L.new_params(init_params, cfg, device, generator)


def _apply_layer(cfg: ArchConfig, p: Params, x: torch.Tensor, positions: torch.Tensor, *,
                 kv_cache=None, cache_index: Optional[int] = None,
                 prefill: bool = False) -> Tuple[torch.Tensor, Any]:
    h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
    attn_out, new_cache = L.attention(
        p["attn"], h, cfg, positions=positions,
        kv_cache=kv_cache, cache_index=cache_index, prefill=prefill,
    )
    x = x + attn_out
    h = L.rmsnorm(p["norm2"], x, cfg.norm_eps)
    return x + L.swiglu(p["mlp"], h), new_cache


def hidden_to_logits(params: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return x @ params["embed"]["table"].T
    return L.lm_logits(params["head"], x)


def final_hidden(params: Params, tokens: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Hidden states after the final norm."""
    x = L.embed(params["embed"], tokens)
    positions = torch.arange(tokens.shape[1], device=x.device)
    for lp in L.stacked_layers(params, "layers"):
        x, _ = _apply_layer(cfg, lp, x, positions)
    return L.rmsnorm(params["final_norm"], x, cfg.norm_eps)


def forward(params: Params, tokens: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """(B, S) int tokens -> (B, S, vocab) logits."""
    return hidden_to_logits(params, final_hidden(params, tokens, cfg), cfg)


# --------------------------------------------------------------------------
# Serving: KV cache prefill / decode
# --------------------------------------------------------------------------

def init_kv_cache(cfg: ArchConfig, batch: int, max_seq: int, *,
                  device: DeviceLike = "cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_seq, cfg.attn_head_dim)
    dt = L.model_dtype(cfg)
    return (torch.zeros(shape, dtype=dt, device=dev), torch.zeros(shape, dtype=dt, device=dev))


def _cached_hidden(params, tokens, cache_index: int, caches, cfg, prefill: bool):
    B, Sn = tokens.shape
    x = L.embed(params["embed"], tokens)
    positions = cache_index + torch.arange(Sn, device=x.device)
    ck, cv = caches
    for i, lp in enumerate(L.stacked_layers(params, "layers")):
        x, _ = _apply_layer(cfg, lp, x, positions, kv_cache=(ck[i], cv[i]),
                            cache_index=cache_index, prefill=prefill)
    return L.rmsnorm(params["final_norm"], x, cfg.norm_eps)


def decode_step(params: Params, tokens: torch.Tensor, cache_index: int, caches, cfg: ArchConfig,
                *, prefill: bool = False):
    """One step of ``tokens`` (B, S_new) at host position ``cache_index``
    against the KV caches (updated in place). Returns (logits, caches)."""
    x = _cached_hidden(params, tokens, cache_index, caches, cfg, prefill)
    return hidden_to_logits(params, x, cfg), caches


def prefill(params: Params, tokens: torch.Tensor, caches, cfg: ArchConfig):
    """Fill the caches with a full prompt; returns the last token's logits
    (B, 1, vocab). Attention runs flash (K6) over the prompt."""
    x = _cached_hidden(params, tokens, 0, caches, cfg, prefill=True)
    return hidden_to_logits(params, x[:, -1:], cfg), caches
