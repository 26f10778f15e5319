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

A call scans the rows of a flat buffer that a ``RowTable`` describes, all
with one ways count, by one of two routes:

* **short** (every row shorter than ``LONG_ROW`` steps; the on-chip
  cache's rows): one launch, a lane per row;
* **chunked** (some row of ``LONG_ROW`` steps or more; a TLB's rows): each
  row is cut into chunks of ``CHUNK`` steps, and every chunk gets a lane of
  its own that first runs the steps before it from the empty state (a
  warm-up of 4 steps a way, at least 16), then the chunk (the *speculate*
  launch). A second launch (the *fix-up*) walks each row's chunks in order
  and re-runs a chunk whose speculative start state differs from the true
  state before it: exact for any warm-up. States compare canonically: a FIFO ring as read from its
  head, an SRRIP state by its tags, ``nf`` and each filled way's
  ``key - A`` (both policies' updates keep their meaning under a rotation
  of the ring, and under one constant added to ``A`` and every key).

``rrip_scan_flat`` launches the CUDA kernels (``csrc/rrip_scan.cu``) for
CUDA tensors and runs the plain versions for CPU tensors, by the same
route; there is no other route. ``rrip_scan_rows`` is the same on the
rows of a ``(B, L)`` matrix.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ._build import check_launch, check_tensors, count_launch, load_library, on_device

POLICY_IDS = {"fifo": 0, "srrip": 1}
# The kernel holds a row's ways in registers, as many as the power of two
# at or above ``ways``.
MAX_WAYS = 64
# The chunked route's parameters: a chunk of CHUNK steps (a multiple of
# 16), the warm-up a chunk's lane runs before it from the empty state
# (``warmup_steps``: WARMUP_PER_WAY steps a way, at least WARMUP), and
# LONG_ROW, the row length from which a call takes the chunked route.
# Chosen by ``scripts/scan_ablation.py rrip_scan`` on the full-size FIFO TLB
# (NVIDIA H100 80GB HBM3, 700 W; PERF.md, D2's findings), L1 (4 ways) + L2
# (8 ways) through the bare launcher: 0.0334-0.0362 ms at C = 64, 0.0354 at
# 128 (a tie within the spread), 0.047 at 256, 0.128 at 1024 (K = 16); K = 8
# re-ran 10 + 142 chunks, 16 and more none. On the same page stream at 16
# ways (4 sets, and 1 set: the whole stream one row) K = 16 re-ran 1,319 /
# 544 chunks (4.12 / 6.59 ms) and K = 64 none (0.158 / 0.559 ms), against
# 11.1 / 44.2 ms for a lane per row: a ring refills from a set's presorted
# stream within about 4 steps a way. T = 1024 and 2048 both put the L2's
# rows (up to 3,690 steps) on the chunked route, 4096 left them on the
# short one (0.247 ms for the L2 alone).
CHUNK = 64
WARMUP = 16
WARMUP_PER_WAY = 4
LONG_ROW = 1024
ROWS_PER_BLOCK = 32


def warmup_steps(ways: int) -> int:
    """The chunked route's warm-up at ``ways`` ways."""
    return max(WARMUP, WARMUP_PER_WAY * int(ways))


def state_ints(ways: int, policy: str) -> int:
    """int32s of one row state in the chunked route's scratch: the FIFO ring
    and its head; the SRRIP tags, each way's ``key - A`` and ``nf``."""
    return ways + 1 if policy == "fifo" else 2 * ways + 1


class _Fifo:
    """FIFO state of B rows: a ring of ``ways`` tags and its head."""

    def __init__(self, ring, head):
        self.ring, self.head = ring, head

    @classmethod
    def empty(cls, B, ways, dev):
        return cls(torch.full((B, ways), -1, dtype=torch.int32, device=dev),
                   torch.zeros(B, dtype=torch.int32, device=dev))

    def step(self, tag, v):
        ways = self.ring.shape[1]
        hit = (self.ring == tag[:, None]).any(dim=1)
        missb = ~hit & v
        oh = torch.arange(ways, device=tag.device)[None, :] == self.head[:, None]
        self.ring = torch.where(missb[:, None] & oh, tag[:, None], self.ring)
        nxt = self.head + 1
        self.head = torch.where(missb, torch.where(nxt == ways, 0, nxt), self.head)
        return hit & v

    def canonical(self):
        """The ring read from its head, oldest fill first."""
        ways = self.ring.shape[1]
        idx = (self.head[:, None] + torch.arange(ways, device=self.ring.device)) % ways
        return torch.gather(self.ring, 1, idx.long())

    def rows(self, idx):
        return _Fifo(self.ring[idx], self.head[idx])

    def put(self, idx, other):
        self.ring[idx], self.head[idx] = other.ring, other.head


class _Srrip:
    """SRRIP state of B rows: (tag, key) per way, the age A, the fill count nf."""

    def __init__(self, tags, keys, A, nf):
        self.tags, self.keys, self.A, self.nf = tags, keys, A, nf

    @classmethod
    def empty(cls, B, ways, dev):
        z = torch.zeros(B, dtype=torch.int32, device=dev)
        return cls(torch.full((B, ways), -1, dtype=torch.int32, device=dev),
                   torch.zeros((B, ways), dtype=torch.int32, device=dev), z, z.clone())

    def step(self, tag, v):
        ways = self.tags.shape[1]
        iota = torch.arange(ways, dtype=torch.int32, device=tag.device)[None, :]
        hv = self.tags == tag[:, None]
        hit = hv.any(dim=1)
        m = self.keys.amin(dim=1)
        warm = self.nf >= ways
        # argmin's first minimum: the lowest way holding m
        first_min = torch.where(self.keys == m[:, None], iota, ways).amin(dim=1)
        vic = torch.where(warm, first_min, self.nf)
        fill_key = torch.where(warm, m + 1, self.A - 2)
        oh = iota == vic[:, None]
        hitb = hit & v
        missb = ~hit & v
        self.tags = torch.where(missb[:, None] & oh, tag[:, None], self.tags)
        self.keys = torch.where(
            hitb[:, None] & hv,
            self.A[:, None],
            torch.where(missb[:, None] & oh, fill_key[:, None], self.keys),
        )
        self.A = torch.where(missb & warm, m + 3, self.A)
        self.nf = torch.where(missb & ~warm, self.nf + 1, self.nf)
        return hitb

    def canonical(self):
        """Tags, each filled way's key - A (0 for a way not filled yet: its
        key is overwritten when it fills), and nf."""
        ways = self.tags.shape[1]
        filled = torch.arange(ways, device=self.tags.device)[None, :] < self.nf[:, None]
        rel = torch.where(filled, self.keys - self.A[:, None], 0)
        return torch.cat([self.tags, rel, self.nf[:, None]], dim=1)

    def rows(self, idx):
        return _Srrip(self.tags[idx], self.keys[idx], self.A[idx], self.nf[idx])

    def put(self, idx, other):
        self.tags[idx], self.keys[idx] = other.tags, other.keys
        self.A[idx], self.nf[idx] = other.A, other.nf


STATE = {"fifo": _Fifo, "srrip": _Srrip}


def _check_rows(tags, valid) -> None:
    if tags.dim() != 2 or tags.shape != valid.shape:
        raise ValueError(
            f"rrip_scan: tags and valid must share one (B, L) shape; got "
            f"{tuple(tags.shape)}, {tuple(valid.shape)}")
    check_tensors("rrip_scan", (tags, torch.int32), (valid, torch.bool))


def _scan_plain(state, tags, valid):
    B, L = tags.shape
    hits = torch.zeros((B, L), dtype=torch.bool, device=tags.device)
    for i in range(L):
        hits[:, i] = state.step(tags[:, i], valid[:, i])
    return hits


def fifo_scan_rows_plain(tags, valid, ways: int):
    """FIFO over ``(B, L)`` rows, a torch loop over L vectorised over the
    rows, step for step the reference's ``_fifo_scan_rows``."""
    return _scan_plain(_Fifo.empty(tags.shape[0], ways, tags.device), tags, valid)


def srrip_scan_rows_plain(tags, valid, ways: int):
    """SRRIP over ``(B, L)`` rows, a torch loop over L vectorised over the
    rows, step for step the reference's ``_srrip_scan_rows``."""
    return _scan_plain(_Srrip.empty(tags.shape[0], ways, tags.device), tags, valid)


PLAIN = {"fifo": fifo_scan_rows_plain, "srrip": srrip_scan_rows_plain}


def rrip_scan_chunked_plain(tags, valid, ways: int, policy: str, lengths=None,
                            chunk: int = CHUNK, warmup: int = None):
    """The chunked route in plain torch, on ``(B, L)`` rows of which row
    ``b`` is its first ``lengths[b]`` steps (all L when None). Returns
    ``(hits (B, L), reruns)``: hits past a row's length are False;
    ``reruns`` counts the chunks the fix-up ran again.

    Speculate: every chunk of every row at once, each from the empty state
    over the ``warmup`` steps before it (fewer at the row's start), with
    its state taken where the chunk starts and where it ends (``warmup``
    None: ``warmup_steps(ways)``). Fix-up: a loop over the chunk index,
    vectorised over the rows, carrying the true state; a chunk whose
    speculative start is not canonically equal to it runs again from it.
    """
    C, K = int(chunk), warmup_steps(ways) if warmup is None else int(warmup)
    B, L = tags.shape
    dev = tags.device
    lengths = (torch.full((B,), L, dtype=torch.int64, device=dev) if lengths is None
               else torch.as_tensor(lengths, dtype=torch.int64, device=dev))
    hits = torch.zeros((B, L), dtype=torch.bool, device=dev)
    nch = (lengths + C - 1) // C
    V = int(nch.sum())
    if V == 0:
        return hits, 0
    first = torch.cumsum(nch, 0) - nch                      # each row's chunk 0
    row = torch.repeat_interleave(torch.arange(B, device=dev), nch)
    c0 = (torch.arange(V, device=dev) - first[row]) * C     # each chunk's first step
    end = torch.minimum(c0 + C, lengths[row])
    pos = c0[:, None] - K + torch.arange(K + C, device=dev)[None, :]
    inb = (pos >= 0) & (pos < end[:, None])
    at = pos.clamp(0, max(L - 1, 0))
    vt = tags[row[:, None], at]
    vv = valid[row[:, None], at] & inb

    spec = STATE[policy].empty(V, ways, dev)
    vh = torch.zeros((V, K + C), dtype=torch.bool, device=dev)
    for i in range(K + C):
        if i == K:
            start = spec.canonical()
        vh[:, i] = spec.step(vt[:, i], vv[:, i])
    keep = inb[:, K:]
    hits[row[:, None].expand(-1, C)[keep], pos[:, K:][keep]] = vh[:, K:][keep]

    carried = spec.rows(first.clamp(max=V - 1))
    reruns = 0
    steps = torch.arange(C, device=dev)[None, :]
    for c in range(1, int(nch.max())):
        rows = torch.nonzero(nch > c).squeeze(1)
        v = first[rows] + c
        same = (carried.rows(rows).canonical() == start[v]).all(dim=1)
        carried.put(rows[same], spec.rows(v[same]))
        bad = rows[~same]
        if bad.numel():
            redo = carried.rows(bad)
            p = (c * C + steps).expand(bad.numel(), -1)
            inr = p < lengths[bad][:, None]
            p = p.clamp(max=L - 1)
            for j in range(C):
                h = redo.step(tags[bad, p[:, j]], valid[bad, p[:, j]] & inr[:, j])
                hits[bad[inr[:, j]], p[inr[:, j], j]] = h[inr[:, j]]
            carried.put(bad, redo)
            reruns += int(bad.numel())
    return hits, reruns


class RowTable:
    """The rows of one D2 call and the route it takes.

    Row ``r`` is the steps ``[off[r], off[r] + length[r])`` of a flat
    buffer; every step of the buffer lies in exactly one row (the rows tile
    ``[0, total)``, in any order), and every row has ``ways`` ways. The
    call takes the chunked route when some row has ``long_row`` steps or
    more, cutting each row into ``ceil(length / chunk)`` chunks; a block
    of the speculate (or only) launch walks 32 consecutive entries, rows on
    the short route, chunks on the chunked one, so rows of similar length
    should be neighbours. ``chunk``, ``warmup`` and ``long_row`` are the
    route's parameters: ``CHUNK``, ``warmup_steps(ways)`` and ``LONG_ROW``
    unless given.
    """

    def __init__(self, off, length, ways: int, *, chunk: int = CHUNK, warmup: int = None,
                 long_row: int = LONG_ROW):
        off = np.asarray(off, np.int64).reshape(-1)
        length = np.asarray(length, np.int64).reshape(-1)
        if off.shape != length.shape or (length < 0).any():
            raise ValueError("RowTable: off and length must be one (R,) shape, length >= 0")
        if ways < 1:
            raise ValueError(f"rrip_scan: ways must be >= 1, got {ways}")
        order = np.argsort(off, kind="stable")
        ls = length[order]
        if not np.array_equal(off[order], np.cumsum(ls) - ls):
            raise ValueError("RowTable: the rows must tile [0, total) of the flat buffer")
        self.chunk, self.long_row = int(chunk), int(long_row)
        self.warmup = warmup_steps(ways) if warmup is None else int(warmup)
        if self.chunk < 16 or self.chunk % 16 or self.warmup < 0:
            raise ValueError(f"RowTable: chunk must be a positive multiple of 16 and warmup "
                             f">= 0; got chunk={self.chunk}, warmup={self.warmup}")
        self.off, self.length, self.ways = off, length, int(ways)
        self.rows = off.size
        self.total = int(length.sum())
        if self.total >= 2**31:
            raise ValueError("RowTable: the flat buffer must hold < 2^31 steps")
        self.max_len = int(length.max()) if self.rows else 0
        self.chunked = self.max_len >= self.long_row
        nch = -(-length // self.chunk) if self.chunked else np.zeros_like(length)
        cbase = np.concatenate(([0], np.cumsum(nch)))
        self.virtual_rows = int(cbase[-1]) if self.chunked else self.rows
        self.blocks = -(-self.virtual_rows // ROWS_PER_BLOCK)
        # Steps a virtual row stages: at most a chunk and its warm-up
        # rounded up to 16.
        self.max_steps = (min(self.max_len, self.chunk + -(-self.warmup // 16) * 16)
                          if self.chunked else self.max_len)
        self.host = np.concatenate((off, length, cbase)).astype(np.int32)
        self._device = {}

    def on(self, device) -> torch.Tensor:
        """``off``, ``length`` and the exclusive prefix of chunks per row as
        one int32 tensor on ``device`` (copied once per device)."""
        key = str(device)
        if key not in self._device:
            self._device[key] = torch.from_numpy(self.host).to(device)
        return self._device[key]


def _launcher():
    fn = load_library("rrip_scan").rrip_scan_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    return fn


def blocks_per_sm(steps: int, ways: int, policy: str) -> int:
    """Blocks of 32 (virtual) rows resident on one SM of the current card,
    for rows of at most ``steps`` steps."""
    blocks = ctypes.c_int(0)
    check_launch("rrip_scan (occupancy)", load_library("rrip_scan").rrip_scan_occupancy(
        ctypes.c_int(steps), ctypes.c_int(ways), ctypes.c_int(POLICY_IDS[policy]),
        ctypes.byref(blocks)))
    return blocks.value


def _plain_flat(tags, valid, table: RowTable, policy: str, out, reruns) -> None:
    """The CPU route: the table's rows gathered into a matrix, scanned by
    the route the kernel takes, scattered back."""
    if reruns is not None:
        reruns.zero_()
    if table.total == 0:
        return
    off = torch.from_numpy(table.off)
    length = torch.from_numpy(table.length)
    at = off[:, None] + torch.arange(max(table.max_len, 1))[None, :]
    inr = at < (off + length)[:, None]
    at = at.clamp(max=table.total - 1)
    t = tags[at]
    v = valid[at] & inr
    if table.chunked:
        h, n = rrip_scan_chunked_plain(t, v, table.ways, policy, lengths=length,
                                       chunk=table.chunk, warmup=table.warmup)
    else:
        h, n = PLAIN[policy](t, v, table.ways), 0
    out[at[inr]] = h[inr]
    if reruns is not None:
        reruns.fill_(n)


def rrip_scan_flat(tags, valid, table: RowTable, policy: str, *, out=None, reruns=None):
    """Per-step hit flags of the rows ``table`` describes in the flat int32
    ``tags`` / bool ``valid`` buffers (1-D, ``table.total`` steps, contiguous,
    one device), under ``policy`` ("fifo" or "srrip") with ``table.ways``
    ways.

    Returns bool hits of the same shape, written into ``out`` when given.
    CUDA tensors launch the kernels (one launch on the short route, two on
    the chunked), CPU tensors run the plain versions by the same route.
    ``reruns``, a one-element int32 tensor on the same device, receives the
    count of chunks the fix-up ran again (0 on the short route); the main
    path does not read it. The kernel takes ``1 <= ways <= MAX_WAYS``; a
    CUDA call outside it, or a failed build or launch, raises.
    """
    if policy not in POLICY_IDS:
        raise ValueError(f"unknown policy {policy!r}; options: {sorted(POLICY_IDS)}")
    if tags.dim() != 1 or tags.shape != valid.shape or tags.numel() != table.total:
        raise ValueError(
            f"rrip_scan: tags and valid must be 1-D of the table's {table.total} steps; got "
            f"{tuple(tags.shape)}, {tuple(valid.shape)}")
    pairs = [(tags, torch.int32), (valid, torch.bool)]
    if out is not None:
        if out.shape != tags.shape:
            raise ValueError(f"rrip_scan: out must have shape {tuple(tags.shape)}")
        pairs.append((out, torch.bool))
    if reruns is not None:
        if reruns.numel() != 1:
            raise ValueError("rrip_scan: reruns must hold one int32")
        pairs.append((reruns, torch.int32))
    check_tensors("rrip_scan", *pairs)
    if out is None:
        out = (torch.zeros if tags.device.type == "cpu" else torch.empty)(
            tags.shape, dtype=torch.bool, device=tags.device)
    if tags.device.type == "cpu":
        _plain_flat(tags, valid, table, policy, out, reruns)
        return out
    if table.ways > MAX_WAYS:
        raise ValueError(f"rrip_scan takes 1 <= ways <= {MAX_WAYS}; got ways={table.ways}")
    if table.total == 0:      # no step to scan (rows of length 0 or none): no launch
        if reruns is not None:
            reruns.zero_()
        return out
    states = count = None
    if table.chunked:
        states = torch.empty(2 * table.virtual_rows * state_ints(table.ways, policy),
                             dtype=torch.int32, device=tags.device)
        count = reruns if reruns is not None else torch.empty(
            1, dtype=torch.int32, device=tags.device)
    elif reruns is not None:
        reruns.zero_()
    rows = table.on(tags.device)
    with on_device(tags.device):
        err = _launcher()(
            tags.data_ptr(), valid.data_ptr(), out.data_ptr(), rows.data_ptr(),
            table.rows, table.virtual_rows, table.max_steps, table.ways, POLICY_IDS[policy],
            table.chunk if table.chunked else 0, table.warmup,
            0 if states is None else states.data_ptr(),
            0 if count is None else count.data_ptr(),
            torch.cuda.current_stream(tags.device).cuda_stream,
        )
    check_launch("rrip_scan", err)
    count_launch(rrip_scan_flat, 2 if table.chunked else 1,
                 route="chunked" if table.chunked else "short")
    return out


rrip_scan_flat.launches = 0
rrip_scan_flat.routes = {"short": 0, "chunked": 0}


def rrip_scan_rows(tags, valid, ways: int, policy: str, *, reruns=None, chunk: int = CHUNK,
                   warmup: int = None, long_row: int = LONG_ROW):
    """``rrip_scan_flat`` on the rows of ``(B, L)`` int32 ``tags`` / bool
    ``valid`` (row ``b`` is steps ``[b L, (b + 1) L)``), by the route of a
    ``RowTable`` with ``chunk``, ``warmup`` and ``long_row``; returns bool
    ``(B, L)``."""
    if policy not in POLICY_IDS:
        raise ValueError(f"unknown policy {policy!r}; options: {sorted(POLICY_IDS)}")
    if ways < 1:
        raise ValueError(f"rrip_scan: ways must be >= 1, got {ways}")
    _check_rows(tags, valid)
    B, L = tags.shape
    table = RowTable(np.arange(B, dtype=np.int64) * L, np.full(B, L, np.int64), ways,
                     chunk=chunk, warmup=warmup, long_row=long_row)
    return rrip_scan_flat(tags.reshape(-1), valid.reshape(-1), table, policy,
                          reruns=reruns).view(B, L)
