"""Gradient compression with error feedback (a port of
``repro/training/compression.py``).

Two compressors of the data-parallel gradient exchange: int8 blockwise
(absmax scales over blocks of ``CBLOCK``) and top-k magnitude
sparsification. With error feedback the compression residual is added back
into the next step's gradient. ``compress_grads`` returns the gradients as
they arrive after the wire.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Tuple

import torch

from .. import tree as T

CBLOCK = 256


@dataclass(frozen=True)
class CompressionConfig:
    kind: str = "none"              # none | int8 | topk
    topk_density: float = 0.01
    error_feedback: bool = True

    @property
    def enabled(self) -> bool:
        return self.kind != "none"


def init_error(params: Any) -> Any:
    return T.map_up_to(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                       params)


def _int8_roundtrip(g: torch.Tensor) -> torch.Tensor:
    flat = g.reshape(-1)
    pad = (-flat.numel()) % CBLOCK
    fp = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, CBLOCK)
    scale = torch.amax(torch.abs(fp), dim=1, keepdim=True) / 127.0
    q = torch.round(fp / torch.clamp(scale, min=1e-12)).to(torch.int8)   # half to even
    deq = (q.float() * scale).reshape(-1)[: flat.numel()]
    return deq.reshape(g.shape)


def _topk_roundtrip(g: torch.Tensor, density: float) -> torch.Tensor:
    """The ``k`` largest magnitudes kept, ties to the lower index as
    ``lax.top_k`` breaks them: a stable sort of -|g| (``torch.topk`` on the
    card promises no order among equal values)."""
    flat = g.reshape(-1)
    k = max(1, int(flat.numel() * density))
    idx = torch.sort(-torch.abs(flat), stable=True).indices[:k]
    out = torch.zeros_like(flat)
    out[idx] = flat[idx]
    return out.reshape(g.shape)


def compress_grads(grads: Any, error: Any,
                   cfg: CompressionConfig) -> Tuple[Any, Any, dict]:
    """Returns (decompressed grads as they arrive after the wire, new error
    state, metrics). Identity when disabled."""
    if not cfg.enabled:
        return grads, error, {"compression_ratio": 1.0}
    if cfg.kind == "int8":
        ratio = 4.0 * CBLOCK / (CBLOCK + 4)         # int8 payload + fp32 scale
    elif cfg.kind == "topk":
        ratio = 1.0 / (2 * cfg.topk_density)        # value+index per entry
    else:
        raise ValueError(cfg.kind)

    def one(g, e):
        gf = g.float() + (e if cfg.error_feedback else 0.0)
        if cfg.kind == "int8":
            sent = _int8_roundtrip(gf)
        else:
            sent = _topk_roundtrip(gf, cfg.topk_density)
        new_e = gf - sent if cfg.error_feedback else torch.zeros_like(gf)
        return sent.to(g.dtype), new_e

    outs = T.map_up_to(one, grads, error)
    new_g = T.map_up_to(lambda o: o[0], outs)
    new_e = T.map_up_to(lambda o: o[1], outs)
    return new_g, new_e, {"compression_ratio": ratio if T.leaves(grads) else 1.0}
