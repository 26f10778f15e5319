"""K7: one-token GQA decode attention, the CUDA kernel and its plain version.

Replaces ``_decode_kernel`` of ``repro/kernels/decode_attention.py`` (the
serving hot loop): q ``(B, Hq, dh)``, one new token per sequence, attends
over a KV cache k, v ``(B, Hkv, S_max, dh)`` whose first ``valid_len``
positions count; query head ``h`` reads kv head ``h // (Hq // Hkv)``.
Scores are f32, positions at or past ``valid_len`` are masked with -1e30,
the output is in q's dtype.

``decode_attention_kernel`` launches ``csrc/decode_attention.cu`` for CUDA
tensors and runs ``decode_attention_plain`` (the reference's oracle,
``ref.decode_attention_ref``) for CPU tensors. ``valid_len`` is a host int:
no device scalar is read per step. The kernel splits the cache into chunks
of ``chunk`` positions, one block each, and merges the chunks' partial
softmaxes by the log-sum-exp rule in a second kernel (flash-decoding);
``decode_attention_split_plain`` is that algorithm in torch, for the tests.
The kernel reads the cache only up to ``valid_len`` and takes any S_max
(the reference sends S_max % 512 != 0 to its oracle) and any dh up to 256.

``CHUNK`` = 128 positions was chosen on an H100 (``PERF.md`` §6): at
Zamba2's decode shape it gives 9 chunks x 256 (b, kv head) = 2,304 blocks of
~40 KB of copies in flight each. A head group too wide for a block's shared
memory at that chunk halves it (``kernel_chunk``), down to ``MIN_CHUNK`` = 8
positions, which still holds granite's 48 query heads of 128 on one kv head
(bf16: 227,072 bytes); the chunk never depends on ``valid_len``, so the
launch shape is the same at every step.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from ._build import check_launch, count_launch, load_library, on_device
from .ref import decode_attention_ref

DTYPE_IDS = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
# Shared memory one block may use on an H100 (the opt-in maximum).
SMEM_LIMIT = 232_448
CHUNK = 128
MIN_CHUNK = 8

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _fns():
    lib = load_library("decode_attention")
    launch = lib.decode_attention_launch
    launch.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float,
                       _I, _P]
    launch.restype = ctypes.c_int
    smem = lib.decode_attention_smem_bytes
    smem.argtypes = [_I, _I, _I, _I]
    smem.restype = ctypes.c_int64
    return launch, smem


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, valid_len: int) -> None:
    name = "decode_attention"
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{name}: q must be (B, Hq, dh) and k, v one (B, Hkv, S_max, dh) "
                         f"shape; got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Hq, dh = q.shape
    if k.shape[0] != B or k.shape[3] != dh:
        raise ValueError(f"{name}: cache {tuple(k.shape)} does not match q {tuple(q.shape)}")
    if k.shape[1] < 1 or Hq % k.shape[1]:
        raise ValueError(f"{name}: q heads {Hq} are not a multiple of kv heads {k.shape[1]}")
    if q.dtype not in DTYPE_IDS or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q, k, v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"{name}: tensors on {q.device}, {k.device}, {v.device}")
    if dh > MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {dh} > {MAX_HEAD_DIM}")
    if not isinstance(valid_len, int) or valid_len < 1:
        raise ValueError(f"{name}: valid_len must be a host int >= 1, got {valid_len!r}")


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           valid_len: int) -> torch.Tensor:
    """The reference's oracle: all S_max scores, masked, softmax, p.v."""
    return decode_attention_ref(q, k, v, valid_len)


def decode_attention_split_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 valid_len: int, chunk: int) -> torch.Tensor:
    """The kernel's algorithm in torch (for the tests): the cache cut into
    chunks of ``chunk`` positions, each chunk's max m, sum l and unnormalised
    p.v in f32 (an empty chunk m = -1e30, l = 0, acc = 0), merged in chunk
    order by the log-sum-exp rule."""
    B, Hq, dh = q.shape
    G, S_max = Hq // k.shape[1], k.shape[2]
    qf = q.float().reshape(B, k.shape[1], G, dh)
    parts = []
    for p0 in range(0, S_max, chunk):
        n = min(chunk, valid_len - p0)
        if n <= 0:
            parts.append((torch.full(qf.shape[:3], -1e30, device=q.device),
                          torch.zeros(qf.shape[:3], device=q.device), torch.zeros_like(qf)))
            continue
        kc, vc = k[:, :, p0:p0 + n].float(), v[:, :, p0:p0 + n].float()
        s = torch.einsum("bhgd,bhkd->bhgk", qf, kc) / math.sqrt(dh)
        m = s.amax(dim=-1)
        p = torch.exp(s - m[..., None])
        parts.append((m, p.sum(dim=-1), torch.einsum("bhgk,bhkd->bhgd", p, vc)))
    M = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    L, acc = torch.zeros_like(M), torch.zeros_like(qf)
    for m, l, a in parts:
        w = torch.exp(m - M)
        L = L + w * l
        acc = acc + w[..., None] * a
    return (acc / L.clamp_min(1e-30)[..., None]).reshape(B, Hq, dh).to(q.dtype)


def kernel_chunk(G: int, dh: int, dtype: torch.dtype, smem) -> int:
    """``CHUNK``, halved while a block's shared memory would not hold it;
    0 when even ``MIN_CHUNK`` does not fit."""
    chunk = CHUNK
    while chunk >= MIN_CHUNK:
        if smem(G, dh, DTYPE_IDS[dtype], chunk) <= SMEM_LIMIT:
            return chunk
        chunk //= 2
    return 0


def _launch(fn, q, k, v, out, part, valid: int, chunk: int, stream) -> int:
    """Call the C launch function: q contiguous, k/v last dim contiguous."""
    B, Hq, dh = q.shape
    Hkv, S_max = k.shape[1], k.shape[2]
    strides = (ctypes.c_int64 * 6)(*k.stride()[:3], *v.stride()[:3])
    return fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), part.data_ptr(), strides,
              B, Hkv, Hq // Hkv, S_max, dh, valid, chunk, 1.0 / math.sqrt(dh),
              DTYPE_IDS[q.dtype], stream)


def decode_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            valid_len: int) -> torch.Tensor:
    """Attention ``(B, Hq, dh)`` of one token over the cache's first
    ``valid_len`` positions (see the module docstring).

    The CUDA kernel for CUDA tensors, ``decode_attention_plain`` for CPU
    tensors. A failed build or launch raises.
    """
    _check(q, k, v, valid_len)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, valid_len)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    launch, smem = _fns()
    G = q.shape[1] // k.shape[1]
    chunk = kernel_chunk(G, q.shape[2], q.dtype, smem)
    if chunk == 0:
        raise ValueError(f"decode_attention: {G} query heads per kv head of width {q.shape[2]} "
                         "exceed a block's shared memory")
    q = q.contiguous()
    k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (k, v))
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if q.numel() == 0:
        return out
    n_chunks = -(-k.shape[2] // chunk)
    part = torch.empty(q.shape[0] * q.shape[1] * n_chunks * (q.shape[2] + 2),
                       dtype=torch.float32, device=q.device)
    with on_device(q.device):
        err = _launch(launch, q, k, v, out, part, min(valid_len, k.shape[2]), chunk,
                      torch.cuda.current_stream(q.device).cuda_stream)
    check_launch("decode_attention", err)
    count_launch(decode_attention_kernel)
    return out


decode_attention_kernel.launches = 0
