"""Serving: cache init, prefill/decode step builders, and a small batched
greedy engine. A port of ``repro/serving/engine.py``.

The decode step for each family:
  * dense / moe / vlm: GQA KV cache (one K7 decode-attention step per layer)
                       or MLA's latent cache (the absorbed decode)
  * ssm (mamba2):      O(1) carried state
  * hybrid (zamba2):   SSM states + KV caches for the shared attention block
  * audio (whisper):   decoder self-KV + the cross-attention k, v of the
                       encoder's output, projected once per generate

Prompt positions and cache indices are host ints, so no step reads a device
scalar. ``ServeConfig.use_pallas`` chooses the route as the reference's
does, but defaults to True: the kernels (K4, K6, K7, K8); False is the
reference's plain route, which the dry run traces.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ..models import family_module
from ..models.config import ArchConfig
from ..device import DeviceLike


@dataclass(frozen=True)
class ServeConfig:
    batch: int
    max_seq: int
    use_pallas: bool = True


def init_cache(cfg: ArchConfig, scfg: ServeConfig, *, device: DeviceLike = "cuda"):
    mod = family_module(cfg)
    if cfg.family == "ssm":
        return mod.init_state_cache(cfg, scfg.batch, device=device)
    if cfg.family == "hybrid":
        return mod.init_state_cache(cfg, scfg.batch, scfg.max_seq, device=device)
    return mod.init_kv_cache(cfg, scfg.batch, scfg.max_seq, device=device)


def build_serve_step(cfg: ArchConfig, scfg: ServeConfig) -> Callable:
    """Returns step(params, tokens (B, 1), cache_index: int, caches[,
    enc_kv]) -> (logits, caches); the audio family's ``enc_kv`` is
    ``whisper.cross_kv`` of the encoder's output."""
    mod = family_module(cfg)

    if cfg.family == "audio":
        def step(params, tokens, cache_index, caches, enc_kv):
            # decoder positions wrap at the learned table's 4,096 (whisper's)
            return mod.decode_step(params, tokens, cache_index % mod.POS_DEC, caches, enc_kv,
                                   cfg, use_pallas=scfg.use_pallas)
        return step

    def step(params, tokens, cache_index, caches):
        return mod.decode_step(params, tokens, cache_index, caches, cfg,
                               use_pallas=scfg.use_pallas)

    return step


def build_prefill(cfg: ArchConfig, scfg: ServeConfig) -> Callable:
    """Returns prefill(params, tokens (B, S), caches[, enc_kv]) ->
    (last logits (B, 1, vocab), caches); the prompt's states are written
    into caches."""
    mod = family_module(cfg)

    if cfg.family == "audio":
        def prefill(params, tokens, caches, enc_kv):
            logits, caches = mod.decode_step(params, tokens, 0, caches, enc_kv, cfg,
                                             prefill=True, use_pallas=scfg.use_pallas)
            return logits[:, -1:], caches
        return prefill

    if cfg.family == "ssm":
        def prefill(params, tokens, caches):
            return mod.prefill_with_state(params, tokens, cfg, caches=caches,
                                          use_pallas=scfg.use_pallas)
        return prefill

    if cfg.family == "hybrid":
        def prefill(params, tokens, caches):
            return mod.prefill_with_state(params, tokens, cfg, max_seq=scfg.max_seq,
                                          caches=caches, use_pallas=scfg.use_pallas)
        return prefill

    def prefill(params, tokens, caches):
        return mod.prefill(params, tokens, caches, cfg, use_pallas=scfg.use_pallas)

    return prefill


def _device_of(params) -> torch.device:
    if isinstance(params, torch.nn.Module):
        return next(params.parameters()).device
    return params["embed"]["table"].device


class ServingEngine:
    """Batched greedy decoding on the device that holds ``params``."""

    def __init__(self, cfg: ArchConfig, params, scfg: ServeConfig):
        self.cfg = cfg
        self.params = params
        self.scfg = scfg
        self.device = _device_of(params)
        self.prefill = build_prefill(cfg, scfg)
        self.step = build_serve_step(cfg, scfg)

    def generate(self, prompts: np.ndarray, max_new_tokens: int = 16,
                 enc_out: Optional[torch.Tensor] = None) -> np.ndarray:
        """(B, S_prompt) int prompts -> (B, max_new_tokens) greedy tokens;
        the audio family also takes the encoder's output ``enc_out``. The
        tokens stay on the device until the end, so the host never waits
        for the card between steps."""
        B, Sp = prompts.shape
        if B != self.scfg.batch:
            raise ValueError(f"batch of {B} prompts, ServeConfig.batch is {self.scfg.batch}")
        if Sp + max_new_tokens > self.scfg.max_seq:
            raise ValueError(f"{Sp} + {max_new_tokens} tokens exceed max_seq {self.scfg.max_seq}")
        if (enc_out is None) != (self.cfg.family != "audio"):
            raise ValueError(f"{self.cfg.name}: enc_out is for the audio family only, and "
                             "that family needs it")
        with torch.inference_mode():
            args = ()
            if enc_out is not None:
                args = (family_module(self.cfg).cross_kv(self.params, enc_out, self.cfg),)
            caches = init_cache(self.cfg, self.scfg, device=self.device)
            tokens = torch.from_numpy(np.asarray(prompts, dtype=np.int32)).to(self.device)
            logits, caches = self.prefill(self.params, tokens, caches, *args)
            out = []
            tok = logits[:, -1].argmax(dim=-1).to(torch.int32)[:, None]
            for i in range(max_new_tokens):
                out.append(tok)
                logits, caches = self.step(self.params, tok, Sp + i, caches, *args)
                tok = logits[:, -1].argmax(dim=-1).to(torch.int32)[:, None]
            return torch.cat(out, dim=1).cpu().numpy()
