"""D2: the FIFO / SRRIP per-set row scans and their plain torch versions.

Replaces the two ``lax.scan`` s of ``repro/core/memory/rrip.py``,
``_fifo_scan_rows`` and ``_srrip_scan_rows``. They are scans, not Pallas
kernels, but they sit on the simulator's path: every srrip/fifo
classification under ``cache_backend="stack"``/``"stack_pallas"`` and
every FIFO TLB runs them, and a TLB row is up to tens of thousands of
dependent steps, which a Python loop of torch ops would launch one kernel
per op per step for. One row is one cache set's compressed access
sequence; rows are independent. Per position they return whether the
access hit.

* FIFO: a ring of ``ways`` tags (init -1) and a head. A hit changes
  nothing; a valid miss writes the tag at the head and advances the head
  mod ``ways``.
* SRRIP: ``ways`` (tag, key) pairs (init -1, 0), an age ``A`` and a fill
  count ``nf`` (both init 0). A hit sets the matching ways' key to ``A``. A
  valid miss with ``nf < ways`` fills way ``nf`` with key ``A - 2`` and
  counts it; a warm miss takes ``m = min(keys)``, fills the first way
  holding ``m`` with key ``m + 1`` and sets ``A = m + 3``.

An invalid position changes nothing and reports no hit.

``rrip_scan_rows`` launches the CUDA kernel (``csrc/rrip_scan.cu``) for
CUDA tensors and runs the plain version for CPU tensors; there is no other
route. The kernel is bound by latency (a row's steps depend on each other),
not bytes; its source says how it keeps a step short.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import check_launch, check_tensors, load_library

POLICY_IDS = {"fifo": 0, "srrip": 1}
# The kernel holds a row's ways in registers, as many as the power of two
# at or above ``ways``.
MAX_WAYS = 64


def _check_rows(tags, valid) -> None:
    if tags.dim() != 2 or tags.shape != valid.shape:
        raise ValueError(
            f"rrip_scan: tags and valid must share one (B, L) shape; got "
            f"{tuple(tags.shape)}, {tuple(valid.shape)}")
    check_tensors("rrip_scan", (tags, torch.int32), (valid, torch.bool))


def fifo_scan_rows_plain(tags, valid, ways: int):
    """FIFO over ``(B, L)`` rows, a torch loop over L vectorised over the
    rows, step for step the reference's ``_fifo_scan_rows``."""
    B, L = tags.shape
    dev = tags.device
    iota = torch.arange(ways, dtype=torch.int32, device=dev)[None, :]
    state = torch.full((B, ways), -1, dtype=torch.int32, device=dev)
    head = torch.zeros(B, dtype=torch.int32, device=dev)
    hits = torch.zeros((B, L), dtype=torch.bool, device=dev)
    for i in range(L):
        tag, v = tags[:, i], valid[:, i]
        hit = (state == tag[:, None]).any(dim=1)
        missb = ~hit & v
        oh = iota == head[:, None]
        state = torch.where(missb[:, None] & oh, tag[:, None], state)
        nxt = head + 1
        head = torch.where(missb, torch.where(nxt == ways, 0, nxt), head)
        hits[:, i] = hit & v
    return hits


def srrip_scan_rows_plain(tags, valid, ways: int):
    """SRRIP over ``(B, L)`` rows, a torch loop over L vectorised over the
    rows, step for step the reference's ``_srrip_scan_rows``."""
    B, L = tags.shape
    dev = tags.device
    iota = torch.arange(ways, dtype=torch.int32, device=dev)[None, :]
    state = torch.full((B, ways), -1, dtype=torch.int32, device=dev)
    keys = torch.zeros((B, ways), dtype=torch.int32, device=dev)
    A = torch.zeros(B, dtype=torch.int32, device=dev)
    nf = torch.zeros(B, dtype=torch.int32, device=dev)
    hits = torch.zeros((B, L), dtype=torch.bool, device=dev)
    for i in range(L):
        tag, v = tags[:, i], valid[:, i]
        hv = state == tag[:, None]
        hit = hv.any(dim=1)
        m = keys.amin(dim=1)
        warm = nf >= ways
        # argmin's first minimum: the lowest way holding m
        first_min = torch.where(keys == m[:, None], iota, ways).amin(dim=1)
        vic = torch.where(warm, first_min, nf)
        fill_key = torch.where(warm, m + 1, A - 2)
        oh = iota == vic[:, None]
        hitb = hit & v
        missb = ~hit & v
        state = torch.where(missb[:, None] & oh, tag[:, None], state)
        keys = torch.where(
            hitb[:, None] & hv,
            A[:, None],
            torch.where(missb[:, None] & oh, fill_key[:, None], keys),
        )
        A = torch.where(missb & warm, m + 3, A)
        nf = torch.where(missb & ~warm, nf + 1, nf)
        hits[:, i] = hitb
    return hits


PLAIN = {"fifo": fifo_scan_rows_plain, "srrip": srrip_scan_rows_plain}


def _launcher():
    fn = load_library("rrip_scan").rrip_scan_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def blocks_per_sm(L: int, ways: int, policy: str) -> int:
    """Blocks of 32 rows of one launch of this shape resident on one SM of
    the current card."""
    blocks = ctypes.c_int(0)
    check_launch("rrip_scan (occupancy)", load_library("rrip_scan").rrip_scan_occupancy(
        ctypes.c_int(L), ctypes.c_int(ways), ctypes.c_int(POLICY_IDS[policy]),
        ctypes.byref(blocks)))
    return blocks.value


def rrip_scan_rows(tags, valid, ways: int, policy: str):
    """Per-position hit flags of ``(B, L)`` per-set rows under ``policy``
    ("fifo" or "srrip") with ``ways`` ways.

    ``tags`` is int32 ``(B, L)``, ``valid`` bool ``(B, L)``, both contiguous
    on one device. Returns bool ``(B, L)`` there: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors. The kernel takes
    ``1 <= ways <= MAX_WAYS``; a CUDA call outside it, or a failed build or
    launch, raises.
    """
    if policy not in POLICY_IDS:
        raise ValueError(f"unknown policy {policy!r}; options: {sorted(POLICY_IDS)}")
    if ways < 1:
        raise ValueError(f"rrip_scan: ways must be >= 1, got {ways}")
    _check_rows(tags, valid)
    if tags.device.type == "cpu":
        return PLAIN[policy](tags, valid, int(ways))
    if ways > MAX_WAYS:
        raise ValueError(f"rrip_scan takes 1 <= ways <= {MAX_WAYS}; got ways={ways}")
    B, L = tags.shape
    hits = torch.empty((B, L), dtype=torch.bool, device=tags.device)
    if B == 0 or L == 0:
        return hits
    err = _launcher()(
        tags.data_ptr(), valid.data_ptr(), hits.data_ptr(), B, L, int(ways),
        POLICY_IDS[policy], torch.cuda.current_stream(tags.device).cuda_stream,
    )
    check_launch("rrip_scan", err)
    rrip_scan_rows.launches += 1
    return hits


rrip_scan_rows.launches = 0
