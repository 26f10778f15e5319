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
the latency (that minus the arrival) and the row hit. Up to
``REG_MAX_BANKS`` banks it runs a pre-pass (``dram_prepass``: the row hits
and a code a slot, which depend only on the order of the accesses) and
then a scan whose lanes hold the banks' free cycles in registers, three
dependent f32 ops a step at most; wider channels take D1's layout with one
access a step. ``dram_prepass_plain`` and ``dram_scan_full_plain`` are the
same algorithm on the CPU.
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


# The registers route: banks <= REG_MAX_BANKS, a pre-pass then the scan.
REG_MAX_BANKS = 16
# The pre-pass's code: bits 0-4 the lane to read (the bank, or LANE_OUT for
# a bank out of range), then the flags, the one-hot distance d = 2..MAX_DIST
# to the bank's previous update (bit DIST_SHIFT + d - 2) and the one-hot
# bank the slot updates (bit WRITE_SHIFT + b). The lane and write fields
# are filled for banks <= REG_MAX_BANKS only; the flags always.
LANE_OUT = 31
VALID, HIT, SAME = 1 << 5, 1 << 6, 1 << 7
DIST_SHIFT, MAX_DIST, WRITE_SHIFT = 8, 5, 16


def dram_prepass_plain(bk, row, valid, banks: int):
    """What D3's scan needs to know before it runs, per slot, vectorised.

    An access's previous update of its bank ``j`` (the last valid access to
    the same bank before it, -1 if none) gives the open row it finds (the
    row ``j`` wrote, -1 at first), so the row hit; with the previous valid
    access ``pv``, ``same`` (``j == pv``: the bank-free cycle it reads is
    the bus-free cycle). Returns ``(code, hit)``: int32 codes (see
    ``VALID``, ``HIT``, ``SAME``, ``DIST_SHIFT``, ``WRITE_SHIFT``) and the
    hit output (``row_hit & valid``), both ``(R, L)``.
    """
    R, L = bk.shape
    dev = bk.device
    idx = torch.arange(L, dtype=torch.int64, device=dev).expand(R, L)
    none = torch.full((R, 1), -1, dtype=torch.int64, device=dev)

    def before(x):
        """Per slot, the largest of ``x`` at the slots before it (-1)."""
        return torch.cat([none, x.cummax(dim=1).values[:, :-1]], dim=1)

    inb = (bk >= 0) & (bk < banks)
    upd = valid & inb
    j = torch.full((R, L), -1, dtype=torch.int64, device=dev)
    for b in range(banks):
        mine = bk == b
        j = torch.where(mine & inb, before(torch.where(upd & mine, idx, -1)), j)
    open_row = torch.where(j >= 0, row.gather(1, j.clamp(min=0)), -1)
    hit = upd & (open_row == row)
    has = upd & (j >= 0)
    same = has & (j == before(torch.where(valid, idx, -1)))
    code = (valid.long() * VALID) | (hit.long() * HIT) | (same.long() * SAME)
    dist = idx - j
    for d in range(2, MAX_DIST + 1):
        code |= (has & (dist == d)).long() << (DIST_SHIFT + d - 2)
    if banks <= REG_MAX_BANKS:
        code |= torch.where(inb, bk.long(), LANE_OUT)
        code |= torch.where(upd, torch.ones_like(code) << (WRITE_SHIFT + bk.long().clamp(0, 15)), 0)
    return code.to(torch.int32), hit


def _full_terms(code, arrive, t_row_act: float, bus_cycles_per_line: float):
    """The scan's four f32 terms a slot from the pre-pass's codes, as D3's
    loader warp stages them: ``ao`` (a + occ; -inf if invalid), ``occ`` (0
    or t_row_act; 0 if invalid), ``cc`` (occ where ``same``, else 0) and
    ``bus`` (0 if invalid)."""
    dev = arrive.device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    v = (code & VALID) != 0
    occ = torch.where(v & ((code & HIT) == 0),
                      torch.tensor(_f32(t_row_act), dtype=torch.float32, device=dev), zero)
    ao = torch.where(v, arrive + occ, torch.tensor(float("-inf"), device=dev))
    cc = torch.where((code & SAME) != 0, occ, zero)
    bus = torch.where(v, torch.tensor(_f32(bus_cycles_per_line), dtype=torch.float32,
                                      device=dev), zero)
    return ao, occ, cc, bus


def dram_scan_full_plain(bk, row, arrive, valid, banks: int, t_cas: float,
                         t_row_act: float, bus_cycles_per_line: float):
    """Plain torch per-access scan: the pre-pass (``dram_prepass_plain``),
    then a loop over L vectorised over the R rows.

    With the row hits known, a step is ``done = max(max(ao, bp + occ),
    bus_free + cc) + bus``, bitwise the reference's ``max(max(a, bp) + occ,
    bus_free) + bus`` (rounding is monotone, and bp <= bus_free, with
    equality where ``cc`` is ``occ``); an invalid slot leaves the bus-free
    cycle as it was. ``bp`` is the slot's bank-free cycle, from ``banks + 2``
    entries a row: the banks, one never written (-inf: a bank out of range)
    and a spare for the steps that update no bank. Returns ``(done, lat,
    hit)`` of shape ``(R, L)``. Needs ``t_row_act >= 0`` and
    ``bus_cycles_per_line >= 0``.
    """
    R, L = bk.shape
    dev = bk.device
    if L == 0:
        empty = torch.zeros((R, 0), dtype=torch.float32, device=dev)
        return empty, empty.clone(), torch.zeros((R, 0), dtype=torch.bool, device=dev)
    code, hit = dram_prepass_plain(bk, row, valid, banks)
    ao, occ, cc, bus = (t.t().contiguous() for t in _full_terms(
        code, arrive, t_row_act, bus_cycles_per_line))
    inb = (bk >= 0) & (bk < banks)
    read = torch.where(inb, bk.long(), banks)
    write = torch.where(valid & inb, read, banks + 1)
    # step-major copies: one contiguous (R, 1) column a step
    read_t, write_t = read.t().unsqueeze(2).contiguous(), write.t().unsqueeze(2).contiguous()
    bank_free = torch.zeros((R, banks + 2), dtype=torch.float32, device=dev)
    bank_free[:, banks] = float("-inf")
    bus_free = torch.zeros(R, dtype=torch.float32, device=dev)
    done_steps = []
    for i in range(L):
        bp = bank_free.gather(1, read_t[i])[:, 0]
        y = torch.maximum(ao[i], bp + occ[i])
        bus_free = torch.maximum(y, bus_free + cc[i]) + bus[i]
        bank_free.scatter_(1, write_t[i], bus_free[:, None])
        done_steps.append(bus_free)
    out = torch.stack(done_steps, dim=1) + _f32(t_cas)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    return torch.where(valid, out, zero), torch.where(valid, out - arrive, zero), hit


def _launch_fn(name: str, argtypes):
    fn = getattr(load_library("dram_scan_full"), name)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def _full_launcher():
    return _launch_fn("dram_scan_full_launch", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                      + [ctypes.c_float] * 3 + [ctypes.c_void_p] * 4)


def _prepass_launcher():
    return _launch_fn("dram_prepass_launch", [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                      + [ctypes.c_void_p] * 3)


def _regs_launcher():
    return _launch_fn("dram_scan_regs_launch", [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
                      + [ctypes.c_float] * 3 + [ctypes.c_void_p] * 3)


def _check_full(name, bk, row, valid, *more):
    if bk.dim() != 2 or not all(t.shape == bk.shape for t in (row, valid, *more)):
        raise ValueError(f"{name}: bk, row, arrive and valid must share one (R, L) shape")


def dram_prepass(bk, row, valid, banks: int):
    """D3's pre-pass (see ``dram_prepass_plain``): ``(code, hit)`` for the
    int32 ``(R, L)`` bank and row and bool valid. The CUDA kernel
    (``dram_prepass_kernel``, 1 <= banks <= ``REG_MAX_BANKS``) for CUDA
    tensors, ``dram_prepass_plain`` for CPU tensors; a CUDA call outside the
    banks it takes, or a failed build or launch, raises."""
    _check_full("dram_prepass", bk, row, valid)
    check_tensors("dram_prepass", (bk, torch.int32), (row, torch.int32), (valid, torch.bool))
    if bk.device.type == "cpu":
        return dram_prepass_plain(bk, row, valid, banks)
    if not 1 <= banks <= REG_MAX_BANKS:
        raise ValueError(f"dram_prepass takes 1 <= banks <= {REG_MAX_BANKS}; got {banks}")
    R, L = bk.shape
    code = torch.empty((R, L), dtype=torch.int32, device=bk.device)
    hit = torch.empty((R, L), dtype=torch.bool, device=bk.device)
    if R == 0 or L == 0:
        return code, hit
    with on_device(bk.device):
        err = _prepass_launcher()(bk.data_ptr(), row.data_ptr(), valid.data_ptr(), R, L,
                                  int(banks), code.data_ptr(), hit.data_ptr(),
                                  torch.cuda.current_stream(bk.device).cuda_stream)
    check_launch("dram_prepass", err)
    count_launch(dram_prepass)
    return code, hit


dram_prepass.launches = 0


def dram_scan_full(bk, row, arrive, valid, banks: int, t_cas: float, t_row_act: float,
                   bus_cycles_per_line: float):
    """Per-channel scan over service-ordered accesses with arrival times.

    ``bk``/``row`` are int32 ``(R, L)`` (each slot's bank and row),
    ``arrive`` f32 ``(R, L)``, ``valid`` bool ``(R, L)``; the arguments of
    the reference's ``_scan_channel_full``. The scalar timings are rounded
    to f32 once here; ``t_row_act`` and ``bus_cycles_per_line`` must not be
    negative. Returns ``(done, lat, hit)`` ``(R, L)`` (f32, f32, bool) on
    the inputs' device: for CUDA tensors, with ``banks <=
    REG_MAX_BANKS`` the registers route (``dram_prepass``, then
    ``dram_scan_regs_kernel``; one launch of each), else the shared route
    (``dram_scan_full_kernel``, banks <= ``FULL_MAX_BANKS``);
    ``dram_scan_full_plain`` for CPU tensors. ``dram_scan_full.routes``
    counts each route's launches. A CUDA call outside the banks, or a
    failed build or launch, raises.
    """
    _check_full("dram_scan_full", bk, row, valid, arrive)
    check_tensors("dram_scan_full", (bk, torch.int32), (row, torch.int32),
                  (arrive, torch.float32), (valid, torch.bool))
    if not (_f32(t_row_act) >= 0 and _f32(bus_cycles_per_line) >= 0):
        raise ValueError(f"dram_scan_full needs t_row_act >= 0 and bus_cycles_per_line >= 0; "
                         f"got {t_row_act}, {bus_cycles_per_line}")
    if bk.device.type == "cpu":
        return dram_scan_full_plain(bk, row, arrive, valid, banks, t_cas, t_row_act,
                                    bus_cycles_per_line)
    if not 1 <= banks <= FULL_MAX_BANKS:
        raise ValueError(f"dram_scan_full takes 1 <= banks <= {FULL_MAX_BANKS}; got {banks}")
    R, L = bk.shape
    dev = bk.device
    done = torch.empty((R, L), dtype=torch.float32, device=dev)
    lat = torch.empty((R, L), dtype=torch.float32, device=dev)
    if R == 0 or L == 0:
        return done, lat, torch.empty((R, L), dtype=torch.bool, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if banks <= REG_MAX_BANKS:
        code, hit = dram_prepass(bk, row, valid, banks)
        with on_device(dev):
            err = _regs_launcher()(code.data_ptr(), arrive.data_ptr(), R, L, _f32(t_cas),
                                   _f32(t_row_act), _f32(bus_cycles_per_line),
                                   done.data_ptr(), lat.data_ptr(), stream)
        route = "registers"
    else:
        hit = torch.empty((R, L), dtype=torch.bool, device=dev)
        with on_device(dev):
            err = _full_launcher()(
                bk.data_ptr(), row.data_ptr(), arrive.data_ptr(), valid.data_ptr(), R, L,
                int(banks), _f32(t_cas), _f32(t_row_act), _f32(bus_cycles_per_line),
                done.data_ptr(), lat.data_ptr(), hit.data_ptr(), stream)
        route = "shared"
    check_launch("dram_scan_full", err)
    count_launch(dram_scan_full, route=route)
    return done, lat, hit


dram_scan_full.launches = 0
dram_scan_full.routes = {"registers": 0, "shared": 0}
