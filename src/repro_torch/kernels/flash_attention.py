"""K6: flash attention, the CUDA kernel and its plain torch version.

Replaces ``_flash_kernel`` of ``repro/kernels/flash_attention.py`` (the
prefill attention of the LM families): tiled online-softmax attention of
q ``(B, Hq, S, d)`` over k, v ``(B, Hkv, S, d)``, query head h reading kv
head ``h // (Hq // Hkv)``, causal or not, ``sm_scale = 1/sqrt(d)`` by
default, f32 accumulation, output in q's dtype.

``flash_attention_kernel`` launches ``csrc/flash_attention.cu`` for CUDA
tensors and runs ``flash_attention_plain`` (the reference's oracle,
``ref.flash_attention_ref``) for CPU tensors. The kernel takes any S (the
reference sends S % 128 != 0 to its oracle; the kernel masks the ragged
tile itself), any d up to 256, f32 or bf16, and strided q, k, v whose last
dimension is contiguous.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from ._build import check_launch, load_library
from .ref import flash_attention_ref

DTYPE_IDS = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _fn():
    fn = load_library("flash_attention").flash_attention_launch
    fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float, _I, _P]
    fn.restype = ctypes.c_int
    return fn


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    name = "flash_attention"
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{name}: q must be (B, Hq, S, d) and k, v one (B, Hkv, S, d) shape; "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Hq, S, d = q.shape
    if k.shape[0] != B or k.shape[2] != S or k.shape[3] != d:
        raise ValueError(f"{name}: k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
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
    """The reference's oracle: full (S, S) f32 scores, softmax, p.v."""
    return flash_attention_ref(q, k, v, causal=causal, sm_scale=sm_scale)


def _inner_contiguous(t: torch.Tensor) -> torch.Tensor:
    return t if t.stride(-1) == 1 else t.contiguous()


def _launch(fn, q, k, v, out, causal: bool, scale: float, stream) -> int:
    """Call the C launch function on q, k, v (last dim contiguous) -> out."""
    B, Hq, S, d = q.shape
    strides = (ctypes.c_int64 * 9)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    return fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
              B, Hq, k.shape[1], S, d, int(causal), scale, DTYPE_IDS[q.dtype], stream)


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                           causal: bool = True,
                           sm_scale: Optional[float] = None) -> torch.Tensor:
    """Attention ``(B, Hq, S, d)`` of q over k, v (see the module docstring).

    The CUDA kernel for CUDA tensors, ``flash_attention_plain`` for CPU
    tensors. A failed build or launch raises.
    """
    _check(q, k, v)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, sm_scale=sm_scale)
    if q.device.type != "cuda" or q.device.index not in (None, 0):
        raise ValueError(f"flash_attention: the kernels launch on cuda:0, got {q.device}")
    q, k, v = (_inner_contiguous(t) for t in (q, k, v))
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if q.numel() == 0:
        return out
    err = _launch(_fn(), q, k, v, out, causal, float(sm_scale),
                  torch.cuda.current_stream(q.device).cuda_stream)
    check_launch("flash_attention", err)
    flash_attention_kernel.launches += 1
    return out


flash_attention_kernel.launches = 0
