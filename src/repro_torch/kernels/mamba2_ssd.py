"""K8: the chunked Mamba2 SSD scan, the CUDA kernel and its plain version.

Replaces ``_ssd_kernel`` of ``repro/kernels/mamba2_ssd.py`` (the prompt pass
of every Mamba2 layer). Per batch b and head h, with ngroups = 1::

    state_t = exp(adt_t) * state_{t-1} + dt_t * x_t (x) B_t
    y_t     = state_t @ C_t

for x ``(B, H, S, P)`` and B, C ``(B, S, N)`` in the model dtype (f32 or
bf16) and adt = A*dt, dt ``(B, H, S)`` in f32; y ``(B, H, S, P)`` in x's
dtype. Both routes compute it chunk by chunk as the reference kernel does:
inside a chunk the decayed ``(Q, Q)`` scores times x, across chunks
``exp(cum) C.state^T``, and a ``(P, N)`` f32 state carried in order.

``mamba2_ssd_kernel`` launches ``csrc/mamba2_ssd.cu`` for CUDA tensors and
runs ``mamba2_ssd_plain`` (a torch loop over chunks with the kernel's
arithmetic) for CPU tensors. Both take any S: a ragged last chunk is
padded with adt = dt = 0, which adds nothing (the reference sends
S % chunk != 0 to its sequential oracle). The chunk is
``kernel_chunk(chunk, S, P, N)``: the caller's, at most 128 and at most S,
halved until one block's tiles fit in shared memory (N = 128 at P = 64
takes 64). x, B and C may be strided views whose last dimension is
contiguous; adt and dt any strides.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ._build import check_launch, load_library

DTYPE_IDS = {torch.float32: 0, torch.bfloat16: 1}
MAX_CHUNK, MAX_P, MAX_N = 128, 64, 128
# Shared memory one block may use on an H100 (the opt-in maximum).
SMEM_LIMIT = 232_448

_P, _I = ctypes.c_void_p, ctypes.c_int


def smem_bytes(Q: int, P: int, N: int) -> int:
    """Shared memory of one block (``csrc/mamba2_ssd.cu`` smem_floats): x
    ``(Q, P)``, C^T and B^T ``(N, Q+1)``, the state ``(N, P)``, the scores
    ``(Q, Q+1)`` and three ``(Q,)`` vectors, in f32."""
    return 4 * (Q * P + 2 * N * (Q + 1) + N * P + Q * (Q + 1) + 3 * Q)


def kernel_chunk(chunk: int, S: int, P: int, N: int) -> int:
    """The chunk both routes use for ``chunk`` at this shape."""
    q = max(1, min(chunk, S, MAX_CHUNK))
    while q > 1 and smem_bytes(q, P, N) > SMEM_LIMIT:
        q = (q + 1) // 2
    return q


@functools.lru_cache(maxsize=None)
def _fn():
    fn = load_library("mamba2_ssd").mamba2_ssd_launch
    fn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]
    fn.restype = ctypes.c_int
    return fn


def _check(x, adt, dt, Bm, C, chunk: int) -> None:
    name = "mamba2_ssd"
    if x.dim() != 4 or adt.dim() != 3 or dt.shape != adt.shape or Bm.dim() != 3 \
            or C.shape != Bm.shape:
        raise ValueError(f"{name}: want x (B, H, S, P), adt and dt (B, H, S), B and C "
                         f"(B, S, N); got {tuple(x.shape)}, {tuple(adt.shape)}, "
                         f"{tuple(dt.shape)}, {tuple(Bm.shape)}, {tuple(C.shape)}")
    Bsz, H, S, P = x.shape
    N = Bm.shape[-1]
    if tuple(adt.shape) != (Bsz, H, S) or tuple(Bm.shape[:2]) != (Bsz, S):
        raise ValueError(f"{name}: shapes {tuple(x.shape)}, {tuple(adt.shape)}, "
                         f"{tuple(Bm.shape)} do not agree")
    if P > MAX_P or N > MAX_N:
        raise ValueError(f"{name}: head dim {P} > {MAX_P} or state dim {N} > {MAX_N}")
    if chunk < 1:
        raise ValueError(f"{name}: chunk must be >= 1, got {chunk}")
    if x.dtype not in DTYPE_IDS or Bm.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"{name}: x, B, C must share float32 or bfloat16, got "
                        f"{x.dtype}, {Bm.dtype}, {C.dtype}")
    if adt.dtype != torch.float32 or dt.dtype != torch.float32:
        raise TypeError(f"{name}: adt and dt must be float32, got {adt.dtype}, {dt.dtype}")
    if len({t.device for t in (x, adt, dt, Bm, C)}) != 1:
        raise ValueError(f"{name}: inputs on several devices")


def _cumsum_in_order(a: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum over the last dim, one f32 add at a time, in order:
    the kernel's sum. (``torch.cumsum`` on the card adds in a tree; where
    adt is large the chunk's decays exp(cum_i - cum_j) are differences of
    large sums, and the two orders then part by a few bf16 steps.)"""
    out = torch.empty_like(a)
    run = torch.zeros_like(a[..., 0])
    for i in range(a.shape[-1]):
        run = run + a[..., i]
        out[..., i] = run
    return out


def mamba2_ssd_plain(x, adt, dt, Bm, C, chunk: int = 128) -> torch.Tensor:
    """The chunked scan in f32 torch, chunk by chunk as the kernel runs it."""
    Bsz, H, S, P = x.shape
    N = Bm.shape[-1]
    Q = kernel_chunk(chunk, S, P, N)
    pad = -S % Q
    xf = torch.nn.functional.pad(x.float(), (0, 0, 0, pad))
    af = torch.nn.functional.pad(adt.float(), (0, pad))
    df = torch.nn.functional.pad(dt.float(), (0, pad))
    Bf = torch.nn.functional.pad(Bm.float(), (0, 0, 0, pad))
    Cf = torch.nn.functional.pad(C.float(), (0, 0, 0, pad))
    tril = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    state = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for c0 in range(0, S + pad, Q):
        sl = slice(c0, c0 + Q)
        xc, ac, dc, Bc, Cc = xf[:, :, sl], af[:, :, sl], df[:, :, sl], Bf[:, sl], Cf[:, sl]
        cum = _cumsum_in_order(ac)                                      # (B,H,Q)
        decay = torch.where(tril, torch.exp(cum[..., :, None] - cum[..., None, :]), 0.0)
        scores = (Cc @ Bc.transpose(1, 2))[:, None] * decay * dc[..., None, :]
        y = scores @ xc
        y = y + torch.exp(cum)[..., None] * torch.einsum("bin,bhpn->bhip", Cc, state)
        w = torch.exp(cum[..., -1:] - cum) * dc                         # (B,H,Q)
        state = (state * torch.exp(cum[..., -1])[..., None, None]
                 + torch.einsum("bhjp,bjn->bhpn", xc * w[..., None], Bc))
        ys.append(y)
    return torch.cat(ys, dim=2)[:, :, :S].to(x.dtype)


def _launch(fn, x, adt, dt, Bm, C, y, Q: int, stream) -> int:
    """Call the C launch function; x, B, C with a contiguous last dim."""
    Bsz, H, S, P = x.shape
    strides = (ctypes.c_int64 * 13)(*x.stride()[:3], *adt.stride(), *dt.stride(),
                                    *Bm.stride()[:2], *C.stride()[:2])
    return fn(x.data_ptr(), adt.data_ptr(), dt.data_ptr(), Bm.data_ptr(), C.data_ptr(),
              y.data_ptr(), strides, Bsz, H, S, P, Bm.shape[-1], Q, DTYPE_IDS[x.dtype], stream)


def mamba2_ssd_kernel(x, adt, dt, Bm, C, *, chunk: int = 128) -> torch.Tensor:
    """SSD scan output ``(B, H, S, P)`` (see the module docstring).

    The CUDA kernel for CUDA tensors, ``mamba2_ssd_plain`` for CPU tensors.
    A failed build or launch raises.
    """
    _check(x, adt, dt, Bm, C, chunk)
    if x.device.type == "cpu":
        return mamba2_ssd_plain(x, adt, dt, Bm, C, chunk)
    if x.device.type != "cuda" or x.device.index not in (None, 0):
        raise ValueError(f"mamba2_ssd: the kernels launch on cuda:0, got {x.device}")
    x, Bm, C = (t if t.stride(-1) == 1 else t.contiguous() for t in (x, Bm, C))
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if x.numel() == 0:
        return y
    Q = kernel_chunk(chunk, x.shape[2], x.shape[3], Bm.shape[-1])
    err = _launch(_fn(), x, adt, dt, Bm, C, y, Q, torch.cuda.current_stream(x.device).cuda_stream)
    check_launch("mamba2_ssd", err)
    mamba2_ssd_kernel.launches += 1
    return y


mamba2_ssd_kernel.launches = 0
