"""Mamba2 (SSD) decoder-only LM — the attention-free family.

A port of ``repro/models/mamba.py``. The prompt pass runs every layer's
chunked SSD scan through K8 and takes each layer's state from the closed
form, so decode continues with O(1) state per layer. The reference's
sharding hints (``activation_constraint`` after the embedding,
``fsdp_unshard`` on each layer) are called where it calls them, and do
nothing without a mesh. Every entry point takes ``use_pallas``, and
``final_hidden`` and ``forward`` ``remat``, as ``transformer``'s do. The
state caches are updated in place.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..device import DeviceLike, resolve_device
from ..distributed.sharding import activation_constraint, fsdp_unshard
from . import layers as L
from .config import ArchConfig
from .transformer import hidden_to_logits, lm_tree

Params = L.Params


def init_layer(cfg: ArchConfig, *, generator: torch.Generator, device) -> Params:
    return {
        "norm": L.init_rmsnorm(cfg.d_model, device=device),
        "mixer": L.init_mamba2(cfg, L.model_dtype(cfg), generator=generator, device=device),
    }


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


def _apply_layer(cfg, p, x, *, ssm_state=None, conv_state=None, use_pallas=True):
    h = L.rmsnorm(p["norm"], x, cfg.norm_eps)
    y, new_ssm, new_conv = L.mamba2_block(p["mixer"], h, cfg, ssm_state=ssm_state,
                                          conv_state=conv_state, use_pallas=use_pallas)
    return L.residual(x, y), new_ssm, new_conv


def _prefill_layer(cfg, p, x, use_pallas=True):
    """A prompt pass through one layer: (x out, final ssm state, conv state)."""
    h = L.rmsnorm(p["norm"], x, cfg.norm_eps)
    y, st, cv = L.mamba2_block(p["mixer"], h, cfg, return_final_state=True,
                               use_pallas=use_pallas)
    return L.residual(x, y), st, cv


def final_hidden(params: Params, tokens: torch.Tensor, cfg: ArchConfig, *,
                 use_pallas: bool = True, remat: bool = True) -> torch.Tensor:
    x = activation_constraint(L.embed(params["embed"], tokens, use_pallas=use_pallas))

    def body(x, lp):
        return _apply_layer(cfg, fsdp_unshard(lp), x, use_pallas=use_pallas)[0]

    for lp in L.stacked_layers(params, "layers"):
        x = L.remat_call(body, x, lp, remat=remat)
    return L.rmsnorm(params["final_norm"], x, cfg.norm_eps)


def forward(params: Params, tokens: torch.Tensor, cfg: ArchConfig, *,
            use_pallas: bool = True, remat: bool = True) -> torch.Tensor:
    return hidden_to_logits(
        params, final_hidden(params, tokens, cfg, use_pallas=use_pallas, remat=remat), cfg)


# --------------------------------------------------------------------------
# Serving: constant-size state cache
# --------------------------------------------------------------------------

def init_state_cache(cfg: ArchConfig, batch: int, *,
                     device: DeviceLike = "cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    dev = resolve_device(device)
    s = cfg.ssm
    H = s.num_heads(cfg.d_model)
    conv_ch = s.d_inner(cfg.d_model) + 2 * s.state_dim
    ssm = torch.zeros((cfg.n_layers, batch, H, s.head_dim, s.state_dim), dtype=torch.float32,
                      device=dev)
    conv = torch.zeros((cfg.n_layers, batch, s.conv_width - 1, conv_ch),
                       dtype=L.model_dtype(cfg), device=dev)
    return ssm, conv


def prefill_with_state(params: Params, tokens: torch.Tensor, cfg: ArchConfig, *,
                       caches=None, use_pallas: bool = True):
    """Parallel (chunked-SSD) prompt pass that also leaves each layer's
    (ssm_state, conv_state) in ``caches`` (made when not given) so decode
    can continue. Returns (last-token logits (B, 1, vocab), caches)."""
    if caches is None:
        caches = init_state_cache(cfg, tokens.shape[0], device=tokens.device)
    ssm_c, conv_c = caches
    x = activation_constraint(L.embed(params["embed"], tokens, use_pallas=use_pallas))
    for i, lp in enumerate(L.stacked_layers(params, "layers")):
        x, st, cv = _prefill_layer(cfg, fsdp_unshard(lp), x, use_pallas)
        ssm_c[i].copy_(st)
        conv_c[i].copy_(cv)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return hidden_to_logits(params, x[:, -1:], cfg), caches


def decode_step(params: Params, tokens: torch.Tensor, cache_index: int, caches,
                cfg: ArchConfig, *, use_pallas: bool = True):
    """Decode with O(1) state, updated in place (``cache_index`` is kept for
    interface parity)."""
    ssm_c, conv_c = caches
    x = activation_constraint(L.embed(params["embed"], tokens, use_pallas=use_pallas))
    for i, lp in enumerate(L.stacked_layers(params, "layers")):
        x, st, cv = _apply_layer(cfg, fsdp_unshard(lp), x, ssm_state=ssm_c[i],
                                 conv_state=conv_c[i], use_pallas=use_pallas)
        ssm_c[i].copy_(st)
        conv_c[i].copy_(cv)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return hidden_to_logits(params, x, cfg), caches
