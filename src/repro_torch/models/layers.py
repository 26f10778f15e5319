"""Layers of the model zoo, ported from ``repro/models/layers.py``.

The LM part: RMSNorm, RoPE, GQA attention (prefill and decode against
a KV cache), SwiGLU, the Mamba2/SSD block with its decode step, embedding
and LM head; and the DLRM's initialiser. MLA, MoE and the GELU MLP are not
ported yet (``registry`` refuses the configurations that need them).

Parameters are nested dicts of tensors, or ``ParamTree`` modules that index
the same way (``p["attn"]["wq"]``); ``init_*`` draw them from an explicit
``torch.Generator`` on an explicit device, with the reference's shapes,
dtypes and scales. The apply functions compute in the dtypes the reference
names, and round to bf16 where it rounds. The attention and SSD products go
through ``kernels.ops`` (the kernels K6, K7 and K8), the embedding through
K4: the reference's ``use_pallas=True`` route, which the port always takes.
The reference's sharding hints (``shard_attention_q``) do nothing on one
device and are dropped.
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
    return (x * scale).to(dtype)


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
    draw at a time."""
    first = make()

    def alloc(t):
        if isinstance(t, dict):
            return {k: alloc(v) for k, v in t.items()}
        return torch.empty((n, *t.shape), dtype=t.dtype, device=t.device)

    def fill(dst, src, i):
        for k, v in src.items():
            if isinstance(v, dict):
                fill(dst[k], v, i)
            else:
                dst[k][i].copy_(v)

    out = alloc(first)
    fill(out, first, 0)
    for i in range(1, n):
        fill(out, make(), i)
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
# MLPs
# --------------------------------------------------------------------------

def init_swiglu(d: int, f: int, dtype, *, generator, device) -> Params:
    kw = dict(dtype=dtype, generator=generator, device=device)
    return {"wg": _dense_init((d, f), **kw), "wu": _dense_init((d, f), **kw),
            "wd": _dense_init((f, d), **kw)}


def swiglu(p: Params, x: torch.Tensor) -> torch.Tensor:
    return (silu(x @ p["wg"]) * (x @ p["wu"])) @ p["wd"]


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
