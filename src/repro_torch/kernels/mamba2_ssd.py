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
S % chunk != 0 to its sequential oracle). On the card both routes run a
cumsum pre-pass, then one block per (b, h, P-slice) with its products on
``mma.sync``; the dtype picks the kernel: bf16 runs ``ssd_mma_kernel``
(bf16 operands, f32 ones split into bf16 hi + lo), f32 ``ssd_tf32_kernel``
(3xTF32). The chunk is ``kernel_chunk(chunk, S, P, N, dtype)``: the
caller's, at most 128 and at most S; on the f32 route it is halved until
two blocks' f32 tiles fit one SM (64 at Zamba2's P 64, N 64). x, B and C
may be strided views whose last dimension is contiguous; adt and dt any
strides. Both routes copy x, B or C when a row does not start on 16 bytes
or its width is not one the kernels take (P a multiple of 16, N one of 16,
32, 64, 128: the copy pads with zeros).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ._build import check_launch, count_launch, load_library, on_device

DTYPE_IDS = {torch.float32: 0, torch.bfloat16: 1}
MAX_CHUNK, MAX_P, MAX_N = 128, 64, 128
# Shared memory one block may use on an H100 (the opt-in maximum), and what
# each of two blocks on one SM may use (228 KB an SM, 1 KB reserved a block).
SMEM_LIMIT = 232_448
TWO_BLOCKS = 228 * 1024 // 2 - 1024
# The P-slice widths and state dims the kernels are built for, and the
# P-slice both routes run wherever P allows, chosen on the card
# (scripts/ssd_ablation.py, PERF.md): 64, so that no block recomputes
# another's C.B^T (on the f32 route at the chunk of 64 that two blocks an
# SM hold).
P_SLICES = (16, 32, 64)
MMA_N = (16, 32, 64, 128)
P_SLICE = 64

_P, _I = ctypes.c_void_p, ctypes.c_int


def _up16(n: int) -> int:
    return -(-n // 16) * 16


def smem_bytes(Q: int, ps: int, N: int) -> int:
    """Shared memory of one block of the f32 route (``csrc/mamba2_ssd.cu``
    tf32_smem_bytes), for chunk rows QP = Q rounded up to 16: x ``(QP,
    ps)``, B and C ``(QP, N)`` in f32, rows padded by 4, cum and dt ``(QP,)``;
    the state's hi and lo ``(ps, N + 4)``."""
    QP = _up16(Q)
    return 4 * (QP * (ps + 4) + 2 * QP * (N + 4) + 2 * QP + 2 * ps * (N + 4))


def mma_smem_bytes(Q: int, ps: int, N: int) -> int:
    """Shared memory of one block of the bf16 route (``csrc/mamba2_ssd.cu``
    mma_smem_bytes), for chunk rows QP = Q rounded up to 16: x ``(QP,
    ps)``, B and C ``(QP, N)`` in bf16, rows padded by 8; two copies of the
    state's bf16 hi and lo halves ``(ps, N)``; cum and dt ``(QP,)`` in f32."""
    QP = _up16(Q)
    return 2 * (QP * (ps + 8) + 2 * QP * (N + 8) + 4 * ps * (N + 8)) + 4 * 2 * QP


def mma_widths(P: int, N: int) -> tuple:
    """The (P, N) the bf16 route runs: P rounded up to 16, N up to one of
    ``MMA_N`` (the wrapper pads x, B and C with zeros to them)."""
    return _up16(P), next(n for n in MMA_N if n >= N)


def p_slice(P: int) -> int:
    """The P-slice of both routes for a padded head dim P (a multiple of
    16): ``P_SLICE`` when it divides P, else the widest of ``P_SLICES`` below
    it that does (16 at P = 48)."""
    return max(w for w in P_SLICES if w <= P_SLICE and P % w == 0)


def kernel_chunk(chunk: int, S: int, P: int, N: int, dtype=torch.float32) -> int:
    """The chunk both routes use for ``chunk`` at this shape and dtype."""
    q = max(1, min(chunk, S, MAX_CHUNK))
    if dtype == torch.bfloat16:     # bf16 tiles: two blocks hold 128 at N <= 64
        return q
    Pp, Np = mma_widths(P, N)
    ps = p_slice(Pp)
    while q > 1 and smem_bytes(q, ps, Np) > TWO_BLOCKS:
        q = (q + 1) // 2
    return q


@functools.lru_cache(maxsize=None)
def _fn(name: str):
    fn = getattr(load_library("mamba2_ssd"), name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


_ARGTYPES = {
    "mamba2_ssd_launch": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                          _P, _P, _I, _P],
    "mamba2_ssd_cumsum_launch": [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P],
    "mamba2_ssd_occupancy": [_I, _I, _I, _I, ctypes.POINTER(ctypes.c_int)],
}


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


def _strides(t: torch.Tensor, dims: int) -> list:
    """The first ``dims`` element strides of ``t``, 0 for a dimension of
    length 1 (never stepped over; a view may give it any stride)."""
    return [0 if n == 1 else st for n, st in zip(t.shape[:dims], t.stride()[:dims])]


def _stride_array(x, adt, dt, Bm, C):
    return (ctypes.c_int64 * 13)(*_strides(x, 3), *adt.stride(), *dt.stride(),
                                 *_strides(Bm, 2), *_strides(C, 2))


def _mma_ready(t: torch.Tensor, width: int) -> torch.Tensor:
    """``t`` if the kernels' 16-byte copies can read it as it is (last dim
    ``width`` and contiguous, every row on 16 bytes), else a contiguous copy
    with the last dim padded with zeros to ``width``."""
    dims = t.dim() - 1
    if (t.shape[-1] == width and t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(st * t.element_size() % 16 == 0 for st in _strides(t, dims))):
        return t
    return torch.nn.functional.pad(t, (0, width - t.shape[-1])).contiguous()


def chunk_cumsum_plain(adt: torch.Tensor, Q: int) -> torch.Tensor:
    """The kernels' pre-pass in torch: the inclusive cumsum of adt
    within each chunk of Q steps, added in order (``_cumsum_in_order``)."""
    S = adt.shape[-1]
    out = torch.empty(adt.shape, dtype=torch.float32, device=adt.device)
    for c0 in range(0, S, Q):
        out[..., c0:c0 + Q] = _cumsum_in_order(adt[..., c0:c0 + Q].float())
    return out


def mamba2_ssd_plain(x, adt, dt, Bm, C, chunk: int = 128) -> torch.Tensor:
    """The chunked scan in f32 torch, chunk by chunk as the kernel runs it."""
    Bsz, H, S, P = x.shape
    N = Bm.shape[-1]
    Q = kernel_chunk(chunk, S, P, N, x.dtype)
    pad = -S % Q
    xf = torch.nn.functional.pad(x.float(), (0, 0, 0, pad))
    cf = chunk_cumsum_plain(torch.nn.functional.pad(adt.float(), (0, pad)), Q)
    df = torch.nn.functional.pad(dt.float(), (0, pad))
    Bf = torch.nn.functional.pad(Bm.float(), (0, 0, 0, pad))
    Cf = torch.nn.functional.pad(C.float(), (0, 0, 0, pad))
    tril = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    state = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for c0 in range(0, S + pad, Q):
        sl = slice(c0, c0 + Q)
        xc, cum, dc, Bc, Cc = xf[:, :, sl], cf[:, :, sl], df[:, :, sl], Bf[:, sl], Cf[:, sl]
        last = cum[..., -1:]                                            # (B,H,1)
        decay = torch.where(tril, torch.exp(cum[..., :, None] - cum[..., None, :]), 0.0)
        scores = (Cc @ Bc.transpose(1, 2))[:, None] * decay * dc[..., None, :]
        y = scores @ xc
        y = y + torch.exp(cum)[..., None] * torch.einsum("bin,bhpn->bhip", Cc, state)
        w = torch.exp(last - cum) * dc                                  # (B,H,Q)
        state = (state * torch.exp(last)[..., None]
                 + torch.einsum("bhjp,bjn->bhpn", xc * w[..., None], Bc))
        ys.append(y)
    return torch.cat(ys, dim=2)[:, :, :S].to(x.dtype)


def _launch(x, adt, dt, Bm, C, Q: int, stream):
    """Pads or copies what the copies cannot read and launches the route of
    x's dtype; returns (y, CUDA error code)."""
    Bsz, H, S, P = x.shape
    Pp, Np = mma_widths(P, Bm.shape[-1])
    x, Bm, C = _mma_ready(x, Pp), _mma_ready(Bm, Np), _mma_ready(C, Np)
    y = torch.empty((Bsz, H, S, Pp), dtype=x.dtype, device=x.device)
    cum = torch.empty((Bsz, H, S), dtype=torch.float32, device=x.device)
    dtc = torch.empty_like(cum)
    err = _fn("mamba2_ssd_launch")(
        x.data_ptr(), adt.data_ptr(), dt.data_ptr(), Bm.data_ptr(), C.data_ptr(), y.data_ptr(),
        _stride_array(x, adt, dt, Bm, C), Bsz, H, S, Pp, Np, Q, p_slice(Pp),
        cum.data_ptr(), dtc.data_ptr(), int(x.dtype == torch.float32), stream)
    return (y if Pp == P else y[..., :P].contiguous()), err


def blocks_per_sm(Q: int, P: int, N: int, dtype=torch.bfloat16) -> int:
    """Blocks of a route resident on one SM of the current card at this
    shape, chunk Q as the kernel runs it (sets the kernel's shared-memory
    opt-in)."""
    Pp, Np = mma_widths(P, N)
    blocks = ctypes.c_int(0)
    check_launch("mamba2_ssd (occupancy)", _fn("mamba2_ssd_occupancy")(
        int(dtype == torch.float32), _up16(Q), p_slice(Pp), Np, ctypes.byref(blocks)))
    return blocks.value


def mamba2_ssd_kernel(x, adt, dt, Bm, C, *, chunk: int = 128) -> torch.Tensor:
    """SSD scan output ``(B, H, S, P)`` (see the module docstring).

    The CUDA kernels for CUDA tensors (bf16: ``ssd_mma_kernel``, route
    "mma"; f32: ``ssd_tf32_kernel``, route "tf32"), ``mamba2_ssd_plain`` for
    CPU tensors. A failed build or launch raises.
    """
    _check(x, adt, dt, Bm, C, chunk)
    if x.device.type == "cpu":
        return mamba2_ssd_plain(x, adt, dt, Bm, C, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"mamba2_ssd: unsupported device {x.device}")
    Bsz, H, S, P = x.shape
    if x.numel() == 0:
        return torch.empty(x.shape, dtype=x.dtype, device=x.device)
    Q = kernel_chunk(chunk, S, P, Bm.shape[-1], x.dtype)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with on_device(x.device):
        y, err = _launch(x, adt, dt, Bm, C, Q, stream)
    check_launch("mamba2_ssd", err)
    count_launch(mamba2_ssd_kernel, route="mma" if x.dtype == torch.bfloat16 else "tf32")
    return y


mamba2_ssd_kernel.launches = 0
mamba2_ssd_kernel.routes = {"mma": 0, "tf32": 0}
