"""D1 and D3: the DRAM event-scan kernels and their plain torch versions.

Replaces the ``lax.scan`` of ``_scan_channel_chunked`` in
``repro/core/memory/dram.py``. That is a scan, not a Pallas kernel, but it
is the simulator's hot path: as a Python loop of torch ops it launched one
kernel per op per step. One row is one (segment, channel) event stream over
same-(bank, block) chunks; the carry is the per-bank open row and bank-free
cycle, the bus-free cycle, and the row's aggregates (f32 latency sum, int32
row-hit count, f32 latest completion). Per chunk it emits the first
completion and whether the chunk's first access hit the open row.

``dram_scan_chunked`` launches the CUDA kernel (``csrc/dram_scan.cu``) for
CUDA tensors and runs ``dram_scan_plain`` for CPU tensors; there is no
other route. Both reproduce the reference's f32 add chain bitwise. The
kernel is bound by latency (Lc dependent steps per row), not bytes; its
source says how it keeps each step short: loader warps stage tiles of
every row in shared memory ahead of the one compute warp, whose lanes walk
the rows.

D3 (``dram_scan_full``, ``csrc/dram_scan_full.cu``) replaces the
``lax.scan`` of ``_scan_channel_full``: the per-access scan with an arrival
time per access, which ``simulate_dram`` takes when its issue interval or
start cycle is non-zero. One row is one channel's service-ordered slots,
one access a step; per slot it emits the completion (``done + t_cas``),
the latency (that minus the arrival) and the row hit. D1's layout, one
access a step and ``max(arrival, bank_free)`` where D1 has ``max(0, .)``;
``dram_scan_full_plain`` is its CPU version.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ._build import check_launch, check_tensors, count_launch, load_library, on_device

# What the kernel takes: the bank state of 32 rows in shared memory beside
# two stages of tiles, and an access loop unrolled to 8 (``chunk_rows``
# caps k_max at 8).
MAX_BANKS = 192
MAX_K = 8
# D3's stages hold five words a slot (D1's four), so fewer banks fit.
FULL_MAX_BANKS = 160


def _f32(x: float) -> float:
    """``x`` rounded once to f32 (as JAX rounds a Python float argument)."""
    return float(np.float32(x))


def dram_scan_plain(bkc, rowc, kc, valid, banks: int, k_max: int,
                    t_row_act: float, t_cas: float, bus_cycles_per_line: float):
    """Plain torch chunked scan, a loop over Lc vectorised over the R rows.

    Returns ``((lat_acc, hit_acc, dmax), (done0, row_hit))`` with shapes
    ``(R,)`` and ``(R, Lc)``, in the reference's exact op order.
    """
    R, Lc = bkc.shape
    dev = bkc.device

    def scalar(x):
        return torch.tensor(_f32(x), dtype=torch.float32, device=dev)

    t_row, cas, bus = scalar(t_row_act), scalar(t_cas), scalar(bus_cycles_per_line)
    zero, neg_inf = scalar(0.0), scalar(float("-inf"))
    bank_ids = torch.arange(banks, dtype=torch.int32, device=dev)[None, :]
    open_row = torch.full((R, banks), -1, dtype=torch.int32, device=dev)
    bank_free = torch.zeros((R, banks), dtype=torch.float32, device=dev)
    bus_free = torch.zeros(R, dtype=torch.float32, device=dev)
    lat_acc = torch.zeros(R, dtype=torch.float32, device=dev)
    hit_acc = torch.zeros(R, dtype=torch.int32, device=dev)
    dmax = torch.zeros(R, dtype=torch.float32, device=dev)
    done0_out = torch.zeros((R, Lc), dtype=torch.float32, device=dev)
    hit_out = torch.zeros((R, Lc), dtype=torch.bool, device=dev)
    for i in range(Lc):
        b, r, k, v = bkc[:, i], rowc[:, i], kc[:, i], valid[:, i]
        sel = bank_ids == b[:, None]
        row_hit = (sel & (open_row == r[:, None])).any(dim=1)
        occ = torch.where(row_hit, zero, t_row)
        bank_prev = torch.where(sel, bank_free, neg_inf).amax(dim=1)
        bank_avail = torch.maximum(zero, bank_prev) + occ
        done0 = torch.maximum(bank_avail, bus_free) + bus
        dlast = done0
        lc = done0 + cas
        for j in range(1, k_max):
            live = j < k
            dlast = torch.where(live, dlast + bus, dlast)
            lc = torch.where(live, lc + (dlast + cas), lc)
        upd = sel & v[:, None]
        open_row = torch.where(upd, r[:, None], open_row)
        bank_free = torch.where(upd, dlast[:, None], bank_free)
        bus_free = torch.where(v, dlast, bus_free)
        lat_acc = lat_acc + torch.where(v, lc, zero)
        hit_acc = hit_acc + torch.where(v, k - 1 + row_hit.to(torch.int32), 0)
        dmax = torch.maximum(dmax, torch.where(v, dlast, zero))
        done0_out[:, i] = torch.where(v, done0, zero)
        hit_out[:, i] = row_hit & v
    return (lat_acc, hit_acc, dmax), (done0_out, hit_out)


def _launcher():
    fn = load_library("dram_scan").dram_scan_launch
    fn.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_float] * 3
        + [ctypes.c_void_p] * 6
    )
    fn.restype = ctypes.c_int
    return fn


def blocks_per_sm(banks: int) -> int:
    """Blocks of 32 rows resident on one SM of the current card."""
    blocks = ctypes.c_int(0)
    check_launch("dram_scan (occupancy)", load_library("dram_scan").dram_scan_occupancy(
        ctypes.c_int(banks), ctypes.byref(blocks)))
    return blocks.value


def dram_scan_chunked(bkc, rowc, kc, valid, banks: int, k_max: int,
                      t_row_act: float, t_cas: float, bus_cycles_per_line: float):
    """Per-(segment, channel) scan over same-(bank, block) chunks.

    ``bkc``/``rowc``/``kc`` are int32 ``(R, Lc)`` (bank, row and access
    count 1..k_max of each chunk; 0 = pad), ``valid`` bool ``(R, Lc)``. The
    scalar timings are rounded to f32 once here. Returns
    ``((lat_acc f32, hit_acc int32, dmax f32) (R,), (done0 f32, row_hit
    bool) (R, Lc))`` on the inputs' device: the CUDA kernel for CUDA
    tensors, ``dram_scan_plain`` for CPU tensors. The kernel takes
    ``1 <= banks <= MAX_BANKS`` and ``1 <= k_max <= MAX_K``; a CUDA call
    outside them, or a failed build or launch, raises.
    """
    if bkc.dim() != 2 or not (bkc.shape == rowc.shape == kc.shape == valid.shape):
        raise ValueError("dram_scan: bkc, rowc, kc and valid must share one (R, Lc) shape")
    check_tensors("dram_scan", (bkc, torch.int32), (rowc, torch.int32),
                  (kc, torch.int32), (valid, torch.bool))
    if bkc.device.type == "cpu":
        return dram_scan_plain(bkc, rowc, kc, valid, banks, k_max,
                               t_row_act, t_cas, bus_cycles_per_line)
    if not (1 <= banks <= MAX_BANKS and 1 <= k_max <= MAX_K):
        raise ValueError(f"dram_scan takes 1 <= banks <= {MAX_BANKS} and 1 <= k_max <= {MAX_K}; "
                         f"got banks={banks}, k_max={k_max}")
    R, Lc = bkc.shape
    dev = bkc.device
    lat = torch.empty(R, dtype=torch.float32, device=dev)
    hit = torch.empty(R, dtype=torch.int32, device=dev)
    dmax = torch.empty(R, dtype=torch.float32, device=dev)
    done0 = torch.empty((R, Lc), dtype=torch.float32, device=dev)
    row_hit = torch.empty((R, Lc), dtype=torch.bool, device=dev)
    if R == 0:
        return (lat, hit, dmax), (done0, row_hit)
    with on_device(dev):
        err = _launcher()(
            bkc.data_ptr(), rowc.data_ptr(), kc.data_ptr(), valid.data_ptr(),
            R, Lc, int(banks), int(k_max), _f32(t_row_act), _f32(t_cas),
            _f32(bus_cycles_per_line), lat.data_ptr(), hit.data_ptr(),
            dmax.data_ptr(), done0.data_ptr(), row_hit.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    check_launch("dram_scan", err)
    count_launch(dram_scan_chunked)
    return (lat, hit, dmax), (done0, row_hit)


dram_scan_chunked.launches = 0


def dram_scan_full_plain(bk, row, arrive, valid, banks: int, t_cas: float,
                         t_row_act: float, bus_cycles_per_line: float):
    """Plain torch per-access scan, a loop over L vectorised over the R rows.

    Per row ``banks + 2`` bank entries: the banks, then two spares that
    stand in for the kernel's checks. A bank outside ``[0, banks)`` reads
    the first, never written (an open row no int32 row equals, a bank-free
    cycle of -inf): it never hits and sees no bank-free cycle. Steps that
    change nothing (an invalid slot, such a bank) write the second. What
    does not depend on the state (the slots read and written, the outputs'
    masks and the latency subtraction) is computed for all steps at once.
    Returns ``(done, lat, hit)`` of shape ``(R, L)``, in the reference's
    exact op order.
    """
    R, L = bk.shape
    dev = bk.device
    if L == 0:
        empty = torch.zeros((R, 0), dtype=torch.float32, device=dev)
        return empty, empty.clone(), torch.zeros((R, 0), dtype=torch.bool, device=dev)

    def scalar(x):
        return torch.tensor(_f32(x), dtype=torch.float32, device=dev)

    cas, t_row, bus = scalar(t_cas), scalar(t_row_act), scalar(bus_cycles_per_line)
    zero = scalar(0.0)
    inb = (bk >= 0) & (bk < banks)
    read = torch.where(inb, bk.long(), banks)
    write = torch.where(valid & inb, read, banks + 1)
    # step-major copies: one contiguous (R, 1) column a step
    read_t, write_t = read.t().unsqueeze(2).contiguous(), write.t().unsqueeze(2).contiguous()
    row_t = row.t().unsqueeze(2).to(torch.int64).contiguous()
    arrive_t, valid_t = arrive.t().contiguous(), valid.t().contiguous()
    open_row = torch.full((R, banks + 2), -1, dtype=torch.int64, device=dev)
    open_row[:, banks] = -(1 << 40)
    bank_free = torch.zeros((R, banks + 2), dtype=torch.float32, device=dev)
    bank_free[:, banks] = float("-inf")
    bus_free = torch.zeros(R, dtype=torch.float32, device=dev)
    done_steps, hit_steps = [], []
    for i in range(L):
        s, w = read_t[i], write_t[i]
        row_hit = open_row.gather(1, s)[:, 0] == row_t[i, :, 0]
        occ = torch.where(row_hit, zero, t_row)
        bank_avail = torch.maximum(arrive_t[i], bank_free.gather(1, s)[:, 0]) + occ
        done = torch.maximum(bank_avail, bus_free) + bus
        open_row.scatter_(1, w, row_t[i])
        bank_free.scatter_(1, w, done[:, None])
        bus_free = torch.where(valid_t[i], done, bus_free)
        done_steps.append(done)
        hit_steps.append(row_hit)
    out = torch.stack(done_steps, dim=1) + cas
    return (torch.where(valid, out, zero), torch.where(valid, out - arrive, zero),
            torch.stack(hit_steps, dim=1) & valid)


def _full_launcher():
    fn = load_library("dram_scan_full").dram_scan_full_launch
    fn.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_float] * 3
        + [ctypes.c_void_p] * 4
    )
    fn.restype = ctypes.c_int
    return fn


def dram_scan_full(bk, row, arrive, valid, banks: int, t_cas: float, t_row_act: float,
                   bus_cycles_per_line: float):
    """Per-channel scan over service-ordered accesses with arrival times.

    ``bk``/``row`` are int32 ``(R, L)`` (each slot's bank and row),
    ``arrive`` f32 ``(R, L)``, ``valid`` bool ``(R, L)``; the arguments of
    the reference's ``_scan_channel_full``. The scalar timings are rounded
    to f32 once here. Returns ``(done, lat, hit)`` ``(R, L)`` (f32, f32,
    bool) on the inputs' device: the CUDA kernel for CUDA tensors,
    ``dram_scan_full_plain`` for CPU tensors. The kernel takes
    ``1 <= banks <= FULL_MAX_BANKS``; a CUDA call outside it, or a failed
    build or launch, raises.
    """
    if bk.dim() != 2 or not (bk.shape == row.shape == arrive.shape == valid.shape):
        raise ValueError("dram_scan_full: bk, row, arrive and valid must share one (R, L) shape")
    check_tensors("dram_scan_full", (bk, torch.int32), (row, torch.int32),
                  (arrive, torch.float32), (valid, torch.bool))
    if bk.device.type == "cpu":
        return dram_scan_full_plain(bk, row, arrive, valid, banks, t_cas, t_row_act,
                                    bus_cycles_per_line)
    if not 1 <= banks <= FULL_MAX_BANKS:
        raise ValueError(f"dram_scan_full takes 1 <= banks <= {FULL_MAX_BANKS}; got {banks}")
    R, L = bk.shape
    dev = bk.device
    done = torch.empty((R, L), dtype=torch.float32, device=dev)
    lat = torch.empty((R, L), dtype=torch.float32, device=dev)
    hit = torch.empty((R, L), dtype=torch.bool, device=dev)
    if R == 0 or L == 0:
        return done, lat, hit
    with on_device(dev):
        err = _full_launcher()(
            bk.data_ptr(), row.data_ptr(), arrive.data_ptr(), valid.data_ptr(), R, L,
            int(banks), _f32(t_cas), _f32(t_row_act), _f32(bus_cycles_per_line),
            done.data_ptr(), lat.data_ptr(), hit.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    check_launch("dram_scan_full", err)
    count_launch(dram_scan_full)
    return done, lat, hit


dram_scan_full.launches = 0
