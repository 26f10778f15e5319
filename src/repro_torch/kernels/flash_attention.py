"""K6: flash attention, the CUDA kernel and its plain torch version.

Replaces ``_flash_kernel`` of ``repro/kernels/flash_attention.py`` (the
prefill attention of the LM families): tiled online-softmax attention of
q ``(B, Hq, S, d)`` over k, v ``(B, Hkv, Sk, d)``, query head h reading kv
head ``h // (Hq // Hkv)``, causal or not, ``sm_scale = 1/sqrt(d)`` by
default, f32 accumulation, output in q's dtype. Causal attention needs
``Sk == S``; without the mask the key length is free (a decoder's queries
over an encoder's states), as in the reference's oracle.

``flash_attention_kernel`` launches ``csrc/flash_attention.cu`` for CUDA
tensors and runs ``flash_attention_plain`` (the reference's oracle,
``ref.flash_attention_ref``) for CPU tensors. On the card the dtype picks
the route: bf16 goes to the tensor-core kernel (``wgmma``, TMA loads; P is
rounded to bf16 before p.v, as ``flash_attention_bf16p_plain`` does), f32
to the scalar kernel, which keeps the reference's 2e-5. Each route launches
or raises; ``flash_attention_kernel.routes`` counts the launches of each
(``launches`` is their sum). Both take any S (the reference sends
S % 128 != 0 to its oracle; the kernels mask the ragged tile themselves),
any d up to 256 and strided q, k, v whose last dimension is contiguous. The
tensor-core route reads through TMA, which needs 16-byte strides: the
wrapper copies an operand whose strides are not, and pads d to a multiple
of 8 when it is not one.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from ._build import check_launch, count_launch, load_library, on_device
from .ref import flash_attention_ref

DTYPE_IDS = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _fn(route: str):
    lib = load_library("flash_attention")
    fn = lib.flash_attention_bf16_launch if route == "wgmma" else lib.flash_attention_f32_launch
    fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P]
    fn.restype = ctypes.c_int
    return fn


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool) -> None:
    name = "flash_attention"
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{name}: q must be (B, Hq, S, d) and k, v one (B, Hkv, Sk, d) shape; "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Hq, S, d = q.shape
    if k.shape[0] != B or k.shape[3] != d or (causal and k.shape[2] != S) or k.shape[2] < 1:
        raise ValueError(f"{name}: k/v {tuple(k.shape)} do not match q {tuple(q.shape)}"
                         f"{' (causal attention needs Sk == S)' if causal else ''}")
    if k.shape[1] < 1 or Hq % k.shape[1]:
        raise ValueError(f"{name}: q heads {Hq} are not a multiple of kv heads {k.shape[1]}")
    if q.dtype not in DTYPE_IDS or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q, k, v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"{name}: tensors on {q.device}, {k.device}, {v.device}")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {d} > {MAX_HEAD_DIM}")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, sm_scale: Optional[float] = None) -> torch.Tensor:
    """The reference's oracle: full (S, Sk) f32 scores, softmax, p.v."""
    return flash_attention_ref(q, k, v, causal=causal, sm_scale=sm_scale)


def flash_attention_bf16p_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                                causal: bool = True,
                                sm_scale: Optional[float] = None) -> torch.Tensor:
    """The oracle with the tensor-core route's one extra rounding point:
    p = exp(s - max) is rounded to bf16 before p.v; the row sum is taken over
    the f32 p, as the reference's is."""
    B, Hq, S, d = q.shape
    group = Hq // k.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    kf = k.repeat_interleave(group, dim=1).float()
    vf = v.repeat_interleave(group, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * sm_scale
    if causal:
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, torch.tensor(-1e30, device=q.device))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    out = torch.einsum("bhqk,bhkd->bhqd", p.bfloat16().float(), vf)
    return (out / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)).to(q.dtype)


def _inner_contiguous(t: torch.Tensor) -> torch.Tensor:
    return t if t.stride(-1) == 1 else t.contiguous()


def _tma_ready(t: torch.Tensor) -> torch.Tensor:
    """``t`` if TMA can read it (16-byte aligned, every stride of a dim
    longer than 1 a multiple of 8 bf16 elements), else a contiguous copy."""
    ok = t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and all(
        st % 8 == 0 for n, st in zip(t.shape[:3], t.stride()[:3]) if n > 1)
    return t if ok else t.contiguous()


def _strides(t: torch.Tensor):
    """Element strides (b, h, s); a dim of length 1 gets its contiguous
    stride, so that a stride nothing reads never fails TMA's 16-byte rule."""
    natural = (t.shape[1] * t.shape[2] * t.shape[3], t.shape[2] * t.shape[3], t.shape[3])
    return [st if n > 1 else nat for n, st, nat in zip(t.shape[:3], t.stride()[:3], natural)]


def _launch(fn, q, k, v, out, causal: bool, scale: float, stream) -> int:
    """Call a C launch function on q, k, v (last dim contiguous) -> out."""
    B, Hq, S, d = q.shape
    strides = (ctypes.c_int64 * 9)(*_strides(q), *_strides(k), *_strides(v))
    return fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
              B, Hq, k.shape[1], S, k.shape[2], d, int(causal), scale, stream)


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                           causal: bool = True, sm_scale: Optional[float] = None,
                           round_p: bool = False) -> torch.Tensor:
    """Attention ``(B, Hq, S, d)`` of q over k, v (see the module docstring).

    On the card, the tensor-core kernel for bf16 and the scalar kernel for
    f32; ``flash_attention_plain`` for CPU tensors, or with ``round_p`` (a
    caller whose reference is the JAX package's chunked oracle, which rounds
    p to v's dtype before p.v) ``flash_attention_bf16p_plain`` for bf16 ones,
    the card's bf16 route in either case. A failed build or launch raises.
    """
    _check(q, k, v, causal)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        plain = (flash_attention_bf16p_plain if round_p and q.dtype == torch.bfloat16
                 else flash_attention_plain)
        return plain(q, k, v, causal=causal, sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if q.numel() == 0:
        return torch.empty(q.shape, dtype=q.dtype, device=q.device)
    route = "wgmma" if q.dtype == torch.bfloat16 else "scalar"
    d = q.shape[-1]
    if route == "wgmma" and d % 8:
        q, k, v = (F.pad(t, (0, 8 - d % 8)) for t in (q, k, v))
    prep = _tma_ready if route == "wgmma" else _inner_contiguous
    q, k, v = (prep(t) for t in (q, k, v))
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    with on_device(q.device):
        err = _launch(_fn(route), q, k, v, out, causal, float(sm_scale),
                      torch.cuda.current_stream(q.device).cuda_stream)
    check_launch("flash_attention", err)
    count_launch(flash_attention_kernel, route=route)
    return out if out.shape[-1] == d else out[..., :d].contiguous()


flash_attention_kernel.launches = 0
flash_attention_kernel.routes = {"wgmma": 0, "scalar": 0}
