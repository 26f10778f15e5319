"""Generic decoder-only LM of the dense / moe / vlm (early-fusion) families:
GQA or MLA attention + SwiGLU, GELU or MoE FFN over stacked layers, with
KV-cache prefill and decode.

A port of ``repro/models/transformer.py``. An early-fusion VLM (chameleon)
is this model: its image tokens are vocabulary entries. MLA keeps one
latent cache ``(L, B, S_max, r + rope)`` instead of per-head k and v. The
reference's sharding hints are called where it calls them: the embedding's
output pinned batch-sharded (``activation_constraint``) and each layer's
weights gathered at point of use (``fsdp_unshard``); without a mesh they do
nothing. Every entry point takes the reference's ``use_pallas`` (default
True here: the kernels; False: its plain route, which the dry run traces),
and ``final_hidden`` and ``forward`` its ``remat`` (each layer recomputed in
the backward; nothing to do without gradients). Caches are updated in
place.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from ..device import DeviceLike, resolve_device
from ..distributed.sharding import activation_constraint, fsdp_unshard
from . import layers as L
from .config import ArchConfig

Params = L.Params


def init_layer(cfg: ArchConfig, *, generator: torch.Generator, device) -> Params:
    dt = L.model_dtype(cfg)
    kw = dict(generator=generator, device=device)
    p = {"norm1": L.init_rmsnorm(cfg.d_model, device=device),
         "norm2": L.init_rmsnorm(cfg.d_model, device=device),
         "attn": (L.init_mla if cfg.mla is not None else L.init_attention)(cfg, dt, **kw)}
    init_mlp = L.init_gelu_mlp if cfg.mlp_type == "gelu" else L.init_swiglu
    if cfg.moe is not None:
        p["moe"] = L.init_moe(cfg, dt, **kw)
    if cfg.moe is None or cfg.d_ff:   # arctic: a dense residual MLP beside the MoE
        p["mlp"] = init_mlp(cfg.d_model, cfg.d_ff, dt, **kw)
    return p


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
                 prefill: bool = False, use_pallas: bool = True) -> Tuple[torch.Tensor, Any]:
    h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
    attend = L.mla_attention if cfg.mla is not None else L.attention
    attn_out, new_cache = attend(
        p["attn"], h, cfg, positions=positions,
        kv_cache=kv_cache, cache_index=cache_index, prefill=prefill, use_pallas=use_pallas,
    )
    x = L.residual(x, attn_out)
    h = L.rmsnorm(p["norm2"], x, cfg.norm_eps)
    dense_mlp = L.gelu_mlp if cfg.mlp_type == "gelu" else L.swiglu
    if cfg.moe is not None:
        ff = L.moe(p["moe"], h, cfg)
        if "mlp" in p:
            ff = ff + dense_mlp(p["mlp"], h)
    else:
        ff = dense_mlp(p["mlp"], h)
    return L.residual(x, ff), new_cache


def hidden_to_logits(params: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return x @ fsdp_unshard(params["embed"])["table"].T
    return L.lm_logits(fsdp_unshard({"head": params["head"]})["head"], x)


def final_hidden(params: Params, tokens: torch.Tensor, cfg: ArchConfig, *,
                 use_pallas: bool = True, remat: bool = True) -> torch.Tensor:
    """Hidden states after the final norm."""
    x = activation_constraint(L.embed(params["embed"], tokens, use_pallas=use_pallas))
    positions = torch.arange(tokens.shape[1], device=x.device)

    def body(x, lp):
        return _apply_layer(cfg, fsdp_unshard(lp), x, positions, use_pallas=use_pallas)[0]

    for lp in L.stacked_layers(params, "layers"):
        x = L.remat_call(body, x, lp, remat=remat)
    return L.rmsnorm(params["final_norm"], x, cfg.norm_eps)


def forward(params: Params, tokens: torch.Tensor, cfg: ArchConfig, *,
            use_pallas: bool = True, remat: bool = True) -> torch.Tensor:
    """(B, S) int tokens -> (B, S, vocab) logits."""
    return hidden_to_logits(
        params, final_hidden(params, tokens, cfg, use_pallas=use_pallas, remat=remat), cfg)


# --------------------------------------------------------------------------
# Serving: KV cache prefill / decode
# --------------------------------------------------------------------------

def init_kv_cache(cfg: ArchConfig, batch: int, max_seq: int, *, device: DeviceLike = "cuda"):
    """Per-head (k, v) caches (L, B, Hkv, S_max, dh), or MLA's one latent
    cache (L, B, S_max, r + rope)."""
    dev = resolve_device(device)
    dt = L.model_dtype(cfg)
    if cfg.mla is not None:
        width = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
        return torch.zeros((cfg.n_layers, batch, max_seq, width), dtype=dt, device=dev)
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_seq, cfg.attn_head_dim)
    return (torch.zeros(shape, dtype=dt, device=dev), torch.zeros(shape, dtype=dt, device=dev))


def _cached_hidden(params, tokens, cache_index: int, caches, cfg, prefill: bool,
                   use_pallas: bool):
    B, Sn = tokens.shape
    x = activation_constraint(L.embed(params["embed"], tokens, use_pallas=use_pallas))
    positions = cache_index + torch.arange(Sn, device=x.device)
    for i, lp in enumerate(L.stacked_layers(params, "layers")):
        cache = caches[i] if cfg.mla is not None else (caches[0][i], caches[1][i])
        x, _ = _apply_layer(cfg, fsdp_unshard(lp), x, positions, kv_cache=cache,
                            cache_index=cache_index, prefill=prefill, use_pallas=use_pallas)
    return L.rmsnorm(params["final_norm"], x, cfg.norm_eps)


def decode_step(params: Params, tokens: torch.Tensor, cache_index: int, caches, cfg: ArchConfig,
                *, prefill: bool = False, use_pallas: bool = True):
    """One step of ``tokens`` (B, S_new) at host position ``cache_index``
    against the KV caches (updated in place). Returns (logits, caches)."""
    x = _cached_hidden(params, tokens, cache_index, caches, cfg, prefill, use_pallas)
    return hidden_to_logits(params, x, cfg), caches


def prefill(params: Params, tokens: torch.Tensor, caches, cfg: ArchConfig, *,
            use_pallas: bool = True):
    """Fill the caches with a full prompt; returns the last token's logits
    (B, 1, vocab). Attention runs flash (K6) over the prompt."""
    x = _cached_hidden(params, tokens, 0, caches, cfg, True, use_pallas)
    return hidden_to_logits(params, x[:, -1:], cfg), caches
