"""Whisper-style encoder-decoder backbone (audio family).

A port of ``repro/models/whisper.py``. The conv/mel frontend is a stub:
``frames`` are precomputed frame embeddings (B, S_enc, d_model). The
backbone: a pre-LN encoder (non-causal self-attention without rope + GELU
MLP) and decoder (causal self-attention without rope, cross-attention over
the encoder's states, GELU MLP), sinusoidal encoder positions, learned
decoder positions (``pos_dec``, 4,096 of them) and tied embeddings.

Attention goes through the kernels: the encoder's and the prompt's
self-attention through K6 (the encoder's at S_enc = 1,500, ragged), a
decoded token's self-attention through K7 against the KV cache; cross-
attention of a prompt through K6 with S_dec queries over S_enc keys, of one
decoded token through K7 with ``valid_len = S_enc`` (the reference computes
both with its plain oracle, the same function). The cross-attention's k, v
of the encoder's states are projected once (``cross_kv``) and passed to the
decoder and every step: the same numbers as the reference's projection in
each layer of each step.
The reference's sharding calls do nothing on one device and are dropped;
caches are updated in place.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from ..device import DeviceLike
from ..kernels import ops
from . import layers as L
from .config import ArchConfig
from .transformer import init_kv_cache  # noqa: F401  (the decoder's self-attention caches)

Params = L.Params
POS_DEC = 4096


def sinusoids(length: int, channels: int, device=None) -> torch.Tensor:
    """(length, channels) f32: sin then cos of position x
    exp(-log(10000) / (channels / 2 - 1) x i), as the reference computes it
    in f32."""
    log_timescale = torch.log(torch.tensor(10000.0)) / (channels // 2 - 1)
    inv = torch.exp(-log_timescale * torch.arange(channels // 2, dtype=torch.float32)).to(device)
    scaled = torch.arange(length, device=device)[:, None].float() * inv[None, :]
    return torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=1)


def cross_attention(p: Params, x: torch.Tensor, enc_kv: Tuple[torch.Tensor, torch.Tensor],
                    cfg: ArchConfig) -> torch.Tensor:
    """x: (B, S_dec, D); enc_kv: the encoder's (k, v) (B, Hkv, S_enc, dh).
    One query token attends through K7 over all S_enc positions, a prompt
    through K6 (not causal, S_dec queries over S_enc keys)."""
    B, S, D = x.shape
    Hq, dh = cfg.n_heads, cfg.attn_head_dim
    q = (x @ p["wq"]).reshape(B, S, Hq, dh).transpose(1, 2)
    k, v = enc_kv
    if S == 1:
        out = ops.decode_attention(q[:, :, 0], k, v, k.shape[2])[:, :, None, :]
    else:
        out = ops.flash_attention(q, k, v, causal=False)
    return out.transpose(1, 2).reshape(B, S, Hq * dh) @ p["wo"]


def encode_kv(p: Params, enc_out: torch.Tensor, cfg: ArchConfig):
    B, S, D = enc_out.shape
    Hkv, dh = cfg.n_kv_heads, cfg.attn_head_dim
    k = (enc_out @ p["wk"]).reshape(B, S, Hkv, dh).transpose(1, 2)
    v = (enc_out @ p["wv"]).reshape(B, S, Hkv, dh).transpose(1, 2)
    return k, v


def cross_kv(params: Params, enc_out: torch.Tensor, cfg: ArchConfig) -> List[Tuple]:
    """Every decoder layer's cross-attention (k, v) of ``enc_out``."""
    return [encode_kv(lp["cross_attn"], enc_out, cfg)
            for lp in L.stacked_layers(params, "dec_layers")]


def init_params(cfg: ArchConfig, *, generator: Optional[torch.Generator],
                device: torch.device) -> Params:
    """The reference's ``init_model`` tree as a dict (``device`` may be
    ``meta``, to read shapes and dtypes)."""
    dt = L.model_dtype(cfg)
    kw = dict(generator=generator, device=device)
    D = cfg.d_model

    def enc_layer():
        return {"norm1": L.init_layernorm(D, device=device),
                "attn": L.init_attention(cfg, dt, **kw),
                "norm2": L.init_layernorm(D, device=device),
                "mlp": L.init_gelu_mlp(D, cfg.d_ff, dt, **kw)}

    def dec_layer():
        return {"norm1": L.init_layernorm(D, device=device),
                "self_attn": L.init_attention(cfg, dt, **kw),
                "norm2": L.init_layernorm(D, device=device),
                "cross_attn": L.init_attention(cfg, dt, **kw),
                "norm3": L.init_layernorm(D, device=device),
                "mlp": L.init_gelu_mlp(D, cfg.d_ff, dt, **kw)}

    return {
        "embed": L.init_embedding(cfg.vocab, D, dt, **kw),
        "pos_dec": L._dense_init((POS_DEC, D), scale=0.01, dtype=dt, **kw),
        "enc_layers": L.init_stacked(enc_layer, cfg.encdec.encoder_layers),
        "enc_norm": L.init_layernorm(D, device=device),
        "dec_layers": L.init_stacked(dec_layer, cfg.n_layers),
        "dec_norm": L.init_layernorm(D, device=device),
    }


def init_model(cfg: ArchConfig, *, device: DeviceLike = "cuda",
               generator: Optional[torch.Generator] = None) -> L.ParamTree:
    """The reference's ``init_model`` tree as a ``ParamTree``, drawn from
    ``generator`` (default: seeded 0) on ``device`` (default: the card;
    raises without one)."""
    return L.new_params(init_params, cfg, device, generator)


def encode(params: Params, frames: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """frames: (B, S_enc, D) stub embeddings -> encoder states."""
    x = frames + sinusoids(frames.shape[1], cfg.d_model, frames.device).to(frames.dtype)
    for p in L.stacked_layers(params, "enc_layers"):
        h = L.layernorm(p["norm1"], x, cfg.norm_eps)
        a, _ = L.attention(p["attn"], h, cfg, causal=False, use_rope=False)
        x = x + a
        h = L.layernorm(p["norm2"], x, cfg.norm_eps)
        x = x + L.gelu_mlp(p["mlp"], h)
    return L.layernorm(params["enc_norm"], x, cfg.norm_eps)


def decode_hidden(params: Params, tokens: torch.Tensor, enc_kv: List[Tuple],
                  cfg: ArchConfig, *, positions: Optional[torch.Tensor] = None,
                  kv_caches=None, cache_index: Optional[int] = None, prefill: bool = False):
    """The decoder's final hidden states (B, S, D) and the caches; the
    cross-attention's k, v of each layer come from ``enc_kv``
    (``cross_kv``)."""
    B, S = tokens.shape
    x = L.embed(params["embed"], tokens)
    if positions is None:
        positions = torch.arange(S, device=x.device)
    x = x + params["pos_dec"][positions]
    for i, p in enumerate(L.stacked_layers(params, "dec_layers")):
        cache = None if kv_caches is None else (kv_caches[0][i], kv_caches[1][i])
        h = L.layernorm(p["norm1"], x, cfg.norm_eps)
        a, _ = L.attention(p["self_attn"], h, cfg, positions=positions, causal=True,
                           kv_cache=cache, cache_index=cache_index, use_rope=False,
                           prefill=prefill)
        x = x + a
        h = L.layernorm(p["norm2"], x, cfg.norm_eps)
        x = x + cross_attention(p["cross_attn"], h, enc_kv[i], cfg)
        h = L.layernorm(p["norm3"], x, cfg.norm_eps)
        x = x + L.gelu_mlp(p["mlp"], h)
    return L.layernorm(params["dec_norm"], x, cfg.norm_eps), kv_caches


def forward(params: Params, tokens: torch.Tensor, frames: torch.Tensor,
            cfg: ArchConfig) -> torch.Tensor:
    """Full encoder-decoder forward -> decoder logits (tied embeddings)."""
    enc_out = encode(params, frames, cfg)
    x, _ = decode_hidden(params, tokens, cross_kv(params, enc_out, cfg), cfg)
    return x @ params["embed"]["table"].T


def decode_step(params: Params, tokens: torch.Tensor, cache_index: int, caches,
                enc_kv: List[Tuple], cfg: ArchConfig, *, prefill: bool = False):
    """``tokens`` (B, S_new) at host position ``cache_index`` against the
    self-attention caches (updated in place) and the encoder's cross k, v
    ``enc_kv`` (``cross_kv``). Returns (logits, caches)."""
    positions = cache_index + torch.arange(tokens.shape[1], device=tokens.device)
    x, caches = decode_hidden(params, tokens, enc_kv, cfg, positions=positions,
                              kv_caches=caches, cache_index=cache_index, prefill=prefill)
    return x @ params["embed"]["table"].T, caches
