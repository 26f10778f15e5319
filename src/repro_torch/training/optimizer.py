"""AdamW with optional 8-bit (block-quantized) first/second moments (a port
of ``repro/training/optimizer.py``).

The 8-bit option stores each moment int8 with an f32 absmax scale per block
of ``QBLOCK`` along the last dim (the parameter's shape kept), and the
second moment in the sqrt domain with a half-step floor. ``apply`` keeps
the reference's op order in f32; unlike the reference, which returns new
trees, it writes the new parameters and moments into the given tensors,
leaf by leaf, so one leaf's f32 temporaries are all it holds beside the
state (at stablelm-3b's width, new trees would hold a second 22.4 GB of
moments).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple, Tuple

import torch

from .. import tree as T

QBLOCK = 256


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    quantize_state: bool = False      # int8 moments + fp32 block scales
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up, then cosine decay to ``min_lr_ratio``; f32."""
    step = torch.as_tensor(step)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


# ---- blockwise int8 quantization ------------------------------------------
# Blocks run along the LAST dim so the int8 moment keeps the parameter's
# shape; scales get shape[:-1] + (nb,).

def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    last = x.shape[-1] if x.dim() else 1
    xr = x.reshape(*x.shape[:-1], last) if x.dim() else x.reshape(1)
    nb = -(-last // QBLOCK)
    xp = torch.nn.functional.pad(xr, (0, nb * QBLOCK - last))
    blocks = xp.reshape(*xr.shape[:-1], nb, QBLOCK)
    scale = torch.amax(torch.abs(blocks), dim=-1) / 127.0              # (..., nb)
    q = torch.round(blocks / torch.clamp(scale[..., None], min=1e-12)).to(torch.int8)
    q = q.reshape(*xr.shape[:-1], nb * QBLOCK)[..., :last]
    return q.reshape(x.shape), scale.float()


def _dequantize(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    last = q.shape[-1] if q.dim() else 1
    nb = scale.shape[-1]
    qp = torch.nn.functional.pad(q.reshape(*q.shape[:-1], last), (0, nb * QBLOCK - last))
    blocks = qp.reshape(*q.shape[:-1], nb, QBLOCK).float()
    return (blocks * scale[..., None]).reshape(*q.shape[:-1], nb * QBLOCK)[..., :last].reshape(shape)


def _broadcast_scale(scale: torch.Tensor, shape) -> torch.Tensor:
    last = shape[-1] if len(shape) else 1
    return torch.repeat_interleave(scale, QBLOCK, dim=-1)[..., :last].reshape(shape)


def _init_moment(p: torch.Tensor, quantize: bool):
    if quantize:
        return _quantize(torch.zeros(p.shape, dtype=torch.float32, device=p.device))
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _read_moment(m, p: torch.Tensor, quantize: bool, kind: str = "mu") -> torch.Tensor:
    if not quantize:
        return m
    q, s = m
    if kind == "nu":
        # second moment stored in sqrt domain with a half-step floor:
        # linear absmax int8 rounds small v to 0 and m/(sqrt(0)+eps)
        # explodes. The floor makes tiny-v params UNDER-step instead.
        root = torch.maximum(_dequantize(q, s, p.shape), 0.5 * _broadcast_scale(s, p.shape))
        return root * root
    return _dequantize(q, s, p.shape)


def _write_moment(dst, val: torch.Tensor, quantize: bool, kind: str = "mu") -> None:
    """Store ``val`` into the moment ``dst`` in place."""
    if not quantize:
        dst.copy_(val)
        return
    q, s = _quantize(torch.sqrt(torch.clamp(val, min=0.0)) if kind == "nu" else val)
    dst[0].copy_(q)
    dst[1].copy_(s)


class AdamWState(NamedTuple):
    step: torch.Tensor
    mu: Any
    nu: Any


def init(params: Any, cfg: AdamWConfig) -> AdamWState:
    mu = T.map_up_to(lambda p: _init_moment(p, cfg.quantize_state), params)
    nu = T.map_up_to(lambda p: _init_moment(p, cfg.quantize_state), params)
    device = T.leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device), mu=mu, nu=nu)


def global_norm(grads: Any) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in T.leaves(grads)))


@torch.no_grad()
def apply(params: Any, grads: Any, state: AdamWState,
          cfg: AdamWConfig) -> Tuple[Any, AdamWState, dict]:
    """One AdamW step with global-norm clipping: the parameters and moments
    are updated in place; returns (params, the new state, {"lr",
    "grad_norm"})."""
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)

    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()

    def upd(p, g, m, v):
        g = g.float() * scale
        m_f = _read_moment(m, p, cfg.quantize_state, "mu")
        v_f = _read_moment(v, p, cfg.quantize_state, "nu")
        m_f = b1 * m_f + (1 - b1) * g
        v_f = b2 * v_f + (1 - b2) * g * g
        u = (m_f / bc1) / (torch.sqrt(v_f / bc2) + cfg.eps)
        pf = p.float()
        p.copy_((pf - lr * (u + cfg.weight_decay * pf)).to(p.dtype))
        _write_moment(m, m_f, cfg.quantize_state, "mu")
        _write_moment(v, v_f, cfg.quantize_state, "nu")

    T.map_up_to(upd, params, grads, state.mu, state.nu)
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu), {"lr": lr, "grad_norm": gnorm}
