"""DRAMSim-lite: off-chip memory timing model.

The paper adopts mNPUsim's off-chip path (NPU memory controller +
DRAMSim3-based DRAM). This model implements the same *interface* — a
per-access event model over (channel, bank, row) with row-buffer hits/misses
and bandwidth occupancy — with a simplified timing core:

  * address interleave: line -> channel (line-granular striping) -> bank -> row;
  * per access: row hit costs tCAS, row miss tRP+tRCD+tCAS (precharge+activate);
  * each channel's data bus is occupied line_bytes/channel_bw per transfer;
  * banks within a channel overlap row operations, the channel bus serializes
    data transfers.

Hot-path engine (``kernels/dram_scan.py``): FR-FCFS keeps a block's lines
consecutive, and within such a run every access after the first is a row hit
whose completion is exactly ``prev_done + bus_cycles``. The scan therefore
steps over *chunks* — runs of up to ``lines_per_block`` same-(bank, block)
accesses — carrying the identical f32 state chain, which cuts the sequential
step count ~8x for vector-granular miss bursts while remaining bit-exact with
a per-access scan. On the card the scan is one CUDA kernel launch per
``simulate_dram_contended`` call (one thread per (segment, channel) row);
on the CPU it is the kernel's plain torch version. Everything around the
scan is host numpy: FR-FCFS ordering argsorts block *runs* and the
per-segment aggregates are reduced on the host in original access order.

``estimate_dram_fast`` is a closed-form vectorized estimate (per-channel bus
occupancy vs per-bank row-op serialization) used for very long traces.

``simulate_dram`` with a non-zero issue interval or start cycle needs the
reference's per-access scan with arrival times (``_scan_channel_full``, D3),
which is not ported yet: it raises ``NotImplementedError``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from ...kernels.dram_scan import dram_scan_chunked
from ..hardware import HardwareConfig
from ...device import DeviceLike, resolve_device
from ..profiling import is_active as _profiling_active, stage


@dataclass
class DramResult:
    finish_cycle: float          # cycle when the last access completes
    total_latency_cycles: float  # sum of per-access latencies
    row_hits: int
    row_misses: int
    accesses: int
    detailed: bool = True

    @property
    def row_hit_rate(self) -> float:
        return self.row_hits / max(self.accesses, 1)


@dataclass(frozen=True)
class DramModel:
    channels: int
    banks_per_channel: int
    lines_per_row: int
    t_cas: int
    t_rcd: int
    t_rp: int
    base_latency: int
    chan_bytes_per_cycle: float
    line_bytes: int
    lines_per_block: int = 8     # channel-interleave granularity in lines
    queue_depth: int = 32

    @staticmethod
    def from_hardware(hw: HardwareConfig) -> "DramModel":
        off = hw.offchip
        line = hw.onchip.line_bytes
        return DramModel(
            channels=off.channels,
            banks_per_channel=off.banks_per_channel,
            lines_per_row=max(1, off.row_bytes // line),
            t_cas=off.t_cas_cycles,
            t_rcd=off.t_rcd_cycles,
            t_rp=off.t_rp_cycles,
            base_latency=off.base_latency_cycles,
            chan_bytes_per_cycle=off.channel_bytes_per_cycle(hw.clock_ghz),
            line_bytes=line,
            lines_per_block=max(1, off.interleave_bytes // line),
        )

    def decompose(self, lines: np.ndarray):
        """line -> (channel, bank, row) under block-granular interleaving.

        Consecutive ``lines_per_block`` lines form one interleave block living
        in a single (channel, bank, row); blocks stripe across channels, then
        banks. Coarse interleave keeps an embedding vector inside one row
        (one activate per vector), fine interleave spreads it across channels
        (activate per line) — a first-class EONSim config knob.
        """
        return self.decompose_blocks(lines // self.lines_per_block)

    def decompose_blocks(self, blk: np.ndarray):
        """block -> (channel, bank, row); every line of a block shares these,
        so run-compressed paths decompose once per block run, not per line."""
        ch = (blk % self.channels).astype(np.int32)
        in_ch = blk // self.channels
        bk = (in_ch % self.banks_per_channel).astype(np.int32)
        blocks_per_row = max(1, self.lines_per_row // self.lines_per_block)
        row = (in_ch // self.banks_per_channel // blocks_per_row).astype(np.int32)
        return ch, bk, row


def _argsort_stable(key: np.ndarray) -> np.ndarray:
    """Stable argsort of non-negative int64 keys, radix-accelerated.

    numpy's ``kind="stable"`` runs an O(n) radix sort for 16-bit integer
    dtypes but falls back to mergesort (~8x slower at FR-FCFS sizes) for
    wider ones. An LSD radix sort built from stable uint16-digit passes
    produces the *identical* permutation: each pass sorts by one more
    significant digit with ties resolved by the previous pass's order, so
    the composition is exactly the unique stable order by the full key
    (test-enforced against ``np.argsort(key, kind="stable")``).
    """
    kmax = int(key.max()) if key.size else 0
    if kmax < (1 << 16):
        return np.argsort(key.astype(np.uint16), kind="stable")
    order = np.argsort((key & 0xFFFF).astype(np.uint16), kind="stable")
    k = key[order] >> 16
    shift = 16
    while True:
        nxt = np.argsort((k & 0xFFFF).astype(np.uint16), kind="stable")
        order = order[nxt]
        shift += 16
        if (kmax >> shift) == 0:
            return order
        k = k[nxt] >> 16


def _frfcfs_order(
    ch: np.ndarray,
    bk: np.ndarray,
    blk: np.ndarray,
    banks: int,
    channels: int,
    seg: np.ndarray | None = None,
) -> np.ndarray:
    """FR-FCFS-style service order within each channel.

    Real controllers pick ready requests: banks are served round-robin at
    interleave-*block* granularity (one activate per block), while a block's
    lines stay consecutive so an open row streams at burst rate. Per-bank
    request order is preserved, keeping row-buffer locality exact.

    ``seg`` (optional) qualifies every key with a segment id so one call
    orders many independent sub-traces at once: within each segment the
    resulting relative order is identical to an unsegmented call on that
    segment alone (the segmented engine relies on this for bit-exactness).

    Two stable argsorts on composite integer keys; within any fixed
    (channel, bank) the arrival rank increases with the original index, so a
    stable sort on the coarser key already orders per-bank streams by
    arrival — no explicit rank key needed (the reference package's
    ``_frfcfs_order_ref`` spells the ranks out; equality is test-enforced).
    """
    n = ch.size
    chq = ch.astype(np.int64)                 # segment-qualified channel id
    if seg is not None:
        chq = seg.astype(np.int64) * channels + chq
    gb = chq * banks + bk
    order0 = _argsort_stable(gb)              # per-bank streams, in order
    gb_s, blk_s = gb[order0], blk[order0]
    first = np.ones(n, dtype=bool)
    first[1:] = gb_s[1:] != gb_s[:-1]
    new_inst = first.copy()
    new_inst[1:] |= blk_s[1:] != blk_s[:-1]
    cs = np.cumsum(new_inst)
    base = np.maximum.accumulate(np.where(first, cs - 1, 0))
    inst_s = cs - 1 - base                    # block-instance index within bank
    # Final service key (chq, inst, bk); ties = arrival order via stability.
    key = np.empty(n, dtype=np.int64)
    key[order0] = (chq[order0] * (n + 1) + inst_s) * banks + bk[order0]
    return _argsort_stable(key)


def _chunk_bucket_len(n: int) -> int:
    """Bucketed padding for chunk rows (compiled-shape reuse).

    Half-octave steps (64, 96, 128, 192, ...): scan wall time is linear in
    the padded length, so pure powers of two waste up to ~2x sequential
    steps on rows that just cross a boundary; the 1.5x intermediates cap
    the padding overhead at 33% for at most twice the compiled-shape pool.
    """
    b = 64
    while b < n:
        if n <= b + b // 2:
            return b + b // 2
        b *= 2
    return b


def simulate_dram_contended(
    lines: np.ndarray,
    seg: np.ndarray,
    src: np.ndarray,
    num_segments: int,
    num_sources: int,
    model: DramModel,
    aggregate: str = "device",
    *,
    device: DeviceLike = "cuda",
):
    """Shared-DRAM timing with cross-source contention within each segment.

    A segment (one inference batch) starts from fresh DRAM state, but WITHIN
    a segment
    all sources (cores) share one controller/bank/bus state — their
    interleaved miss bursts contend for channels instead of each core seeing
    an empty DRAM. ``src`` tags each access with its source; arrival order is
    the given trace order (callers merge per-core streams deterministically).

    Returns ``(results, finish)``: one ``DramResult`` per segment for the
    shared stream, plus ``finish[num_segments, num_sources]`` — each source's
    last completion cycle (0.0 where a source issued nothing), so per-core
    DRAM stall under contention is directly observable.

    Engine: run-compressed FR-FCFS ordering on the host, then ONE chunked
    scan over all (segment, channel) rows (``dram_scan_chunked``: one kernel
    launch on ``device="cuda"``, its plain torch version on ``"cpu"``).
    All host bookkeeping is RUN-granular — chunks are built directly from
    merged block runs, with no per-access expansion on the default path.
    The scan carries per-row aggregates (latency sum, row-hit count, max
    completion), so for single-source requests the extraction is three
    ``(segments * channels,)``-sized arrays folded to per-segment results by
    pure reshapes. Multi-source requests stay run-granular too: run
    boundaries fold ``src`` (order-preserving — no block instance is added),
    so each run is source-pure and its maximum completion is its last line;
    per-source finish reduces over runs, never per-access.

    ``aggregate`` selects where per-segment totals reduce: ``"device"``
    (default) trusts the in-scan carry aggregates; ``"host"`` ignores them
    and re-derives every total from the per-chunk ``(done0, row_hit)``
    outputs with an independent host implementation of the same IEEE op
    chains. The two modes are bitwise identical (test-enforced) — ``"host"``
    exists as the differential reference, not as a performance path.

    Exactness: every per-access completion (hence ``finish_cycle`` and the
    per-source ``finish`` attribution) and all row-hit counts are bitwise
    identical to the per-access scan. ``total_latency_cycles`` is the f32
    per-(segment, channel) service-order chain summed in f64 across
    channels — sequential adds of ``(completion + t_cas)`` exactly as the
    device scan accumulates them (padding adds exact 0.0, so the value is
    independent of dispatch layout and of which segments share a dispatch).
    Nothing downstream of ``DramResult`` consumes it for timing.
    """
    if aggregate not in ("device", "host"):
        raise ValueError(f"unknown aggregate mode: {aggregate!r}")
    dev = resolve_device(device)
    return _contended_finish(
        _contended_start(lines, seg, src, num_segments, num_sources, model, dev),
        aggregate,
    )


def simulate_dram(
    lines: np.ndarray,
    model: DramModel,
    issue_interval_cycles: float = 0.0,
    start_cycle: float = 0.0,
    *,
    device: DeviceLike = "cuda",
) -> DramResult:
    """Event-scan the (miss) line trace through the DRAM model.

    ``issue_interval_cycles`` models the upstream request rate; 0 means the
    controller queue is always full (memory-bound phase), the usual regime for
    embedding gathers. That default (zero issue interval, zero start cycle)
    routes through the chunked one-segment engine, the same code path as the
    segmented/contended timing. Non-zero arrivals need the per-access scan
    with arrival times (the reference's ``_scan_channel_full``, queued as D3
    in ROADMAP.md), which is not ported yet: they raise.
    """
    lines = np.asarray(lines, dtype=np.int64).reshape(-1)
    n = lines.size
    if n == 0:
        return DramResult(start_cycle, 0.0, 0, 0, 0)
    if issue_interval_cycles != 0.0 or start_cycle != 0.0:
        raise NotImplementedError(
            "simulate_dram with a non-zero issue interval or start cycle needs "
            "the per-access DRAM scan with arrival times (D3), which is not "
            "ported yet (see ROADMAP.md)"
        )
    results, _ = simulate_dram_contended(
        lines,
        np.zeros(n, dtype=np.int64),
        np.zeros(n, dtype=np.int64),
        1,
        1,
        model,
        device=device,
    )
    return results[0]


def simulate_dram_segmented(
    lines: np.ndarray,
    seg: np.ndarray,
    num_segments: int,
    model: DramModel,
    *,
    device: DeviceLike = "cuda",
) -> List[DramResult]:
    """One batched event scan over a concatenated multi-segment miss trace.

    Each segment (e.g. one inference batch) is timed against *fresh* DRAM
    state, exactly as if ``simulate_dram`` ran per segment, but all
    (segment, channel) scans run as one launch. Implemented as the
    one-source reduction of the contended multi-core scan, so the
    single-core and cluster DRAM paths cannot drift apart.
    """
    lines = np.asarray(lines, dtype=np.int64).reshape(-1)
    results, _ = simulate_dram_contended(
        lines,
        seg,
        np.zeros(lines.size, dtype=np.int64),
        num_segments,
        1,
        model,
        device=device,
    )
    return results


def chunk_rows(
    lines: np.ndarray,
    seg: np.ndarray,
    src: np.ndarray,
    num_segments: int,
    num_sources: int,
    model: DramModel,
) -> dict:
    """Host prep of one contended call: FR-FCFS order and the chunk rows.

    Returns the state ``_contended_finish`` reads, including the scan's
    ``(R, Lc)`` host inputs ``bk_m``, ``row_m``, ``k_m`` (int32) and
    ``va_m`` (bool) and its scalars ``k_max`` and ``bus_cyc``.
    """
    lines = np.asarray(lines, dtype=np.int64).reshape(-1)
    seg = np.asarray(seg, dtype=np.int64).reshape(-1)
    src = np.asarray(src, dtype=np.int64).reshape(-1)
    n = lines.size
    C = model.channels
    if n == 0:
        return dict(
            n=0, num_segments=num_segments, num_sources=num_sources,
            model=model,
        )

    with stage("dram"):
        lpb = model.lines_per_block
        if lpb & (lpb - 1) == 0:
            blk = lines >> (lpb.bit_length() - 1)   # pow2: shift, not divide
        else:
            blk = lines // lpb
        # Run compression: maximal stretches of same-(segment, block) lines
        # in arrival order share one (channel, bank, row) and identical
        # FR-FCFS keys, so ordering operates on RUNS (~8x fewer elements for
        # vector-expanded miss bursts — the argsorts were the host hot spot).
        # Stability keeps a run's lines consecutive and per-bank arrival
        # order intact, and block-instance counting over runs merges adjacent
        # same-block runs exactly like the per-line derivation, so the
        # implied service order is bitwise identical to line-level ordering
        # (test-enforced vs the golden DRAM model).
        new_run0 = np.ones(n, dtype=bool)
        new_run0[1:] = (seg[1:] != seg[:-1]) | (blk[1:] != blk[:-1])
        if num_sources > 1:
            # Source-pure runs: splitting a run at a source boundary adds no
            # block instance (same bank stream, same block), so every
            # FR-FCFS key — and the stable order around the split — is
            # unchanged; the halves stay adjacent and re-merge into the same
            # chunks. Buys run-granular per-source finish attribution below.
            new_run0[1:] |= src[1:] != src[:-1]
        rstart = np.nonzero(new_run0)[0]
        nr = rstart.size
        rlen = np.diff(np.append(rstart, n))
        rblk = blk[rstart]
        rseg = seg[rstart]
        rch, rbk, rrow = model.decompose_blocks(rblk)
        order_r = _frfcfs_order(
            rch, rbk, rblk, model.banks_per_channel, C, seg=rseg
        )
        n_seg = np.bincount(
            rseg, weights=rlen, minlength=num_segments
        ).astype(np.int64)

        rlen_o = rlen[order_r]
        pre_o = np.cumsum(rlen_o) - rlen_o       # line offset of each run

        # Chunking: FR-FCFS keeps a block's accesses consecutive; adjacent
        # ordered runs with the same (segment-qualified channel, block) are
        # one merged service run. Cap chunks at the interleave-block size so
        # the chunk length is a compile-time constant — splitting a longer
        # run is exact (the split point sees bank_free == bus_free == prev
        # done). Chunks are derived from merged runs directly (run-granular;
        # no n-sized intermediates).
        chq_o = rseg[order_r] * C + rch[order_r]
        blk_o = rblk[order_r]
        new_merged = np.ones(nr, dtype=bool)
        new_merged[1:] = (chq_o[1:] != chq_o[:-1]) | (blk_o[1:] != blk_o[:-1])
        mstart_r = np.nonzero(new_merged)[0]     # first ordered run of each
        nm = mstart_r.size
        mlen = np.diff(np.append(pre_o[mstart_r], n))  # lines per merged run
        k_max = max(1, min(model.lines_per_block, 8))
        nchunks_m = -(-mlen // k_max)
        n_chunks = int(nchunks_m.sum())
        chunk_ofs = np.cumsum(nchunks_m) - nchunks_m
        chunk_merged = np.repeat(np.arange(nm), nchunks_m)
        pos_c = np.arange(n_chunks) - chunk_ofs[chunk_merged]
        k_of = np.minimum(
            k_max, mlen[chunk_merged] - pos_c * k_max
        ).astype(np.int32)
        first_run = mstart_r[chunk_merged]
        cchq = chq_o[first_run]

        R = num_segments * C
        chunks_per_row = np.bincount(cchq, minlength=R)
        Lc = _chunk_bucket_len(int(chunks_per_row.max()))
        row_chunk_start = np.concatenate(([0], np.cumsum(chunks_per_row)))
        col_of_chunk = np.arange(n_chunks) - row_chunk_start[cchq]

        bk_m = np.zeros((R, Lc), dtype=np.int32)
        row_m = np.zeros((R, Lc), dtype=np.int32)
        k_m = np.zeros((R, Lc), dtype=np.int32)
        va_m = np.zeros((R, Lc), dtype=bool)
        cflat = cchq * Lc + col_of_chunk
        bk_m.reshape(-1)[cflat] = rbk[order_r][first_run]
        row_m.reshape(-1)[cflat] = rrow[order_r][first_run]
        k_m.reshape(-1)[cflat] = k_of
        va_m.reshape(-1)[cflat] = True

    return dict(
        n=n, num_segments=num_segments, num_sources=num_sources, model=model,
        C=C, nr=nr, n_chunks=n_chunks, k_max=k_max, R=R, Lc=Lc,
        bus_cyc=float(model.line_bytes / model.chan_bytes_per_cycle),
        n_seg=n_seg, cflat=cflat, k_of=k_of, cchq=cchq,
        new_merged=new_merged, pre_o=pre_o, mstart_r=mstart_r,
        chunk_ofs=chunk_ofs, rlen_o=rlen_o, rseg_o=rseg[order_r],
        src_run=src[rstart][order_r] if num_sources > 1 else None,
        rstart_o=rstart[order_r], seg=seg, src=src,
        bk_m=bk_m, row_m=row_m, k_m=k_m, va_m=va_m,
    )


def _contended_start(
    lines: np.ndarray,
    seg: np.ndarray,
    src: np.ndarray,
    num_segments: int,
    num_sources: int,
    model: DramModel,
    device: torch.device,
) -> dict:
    """Host prep + asynchronous scan launch for one contended call.

    Returns an opaque state consumed by ``_contended_finish``. On the card
    the scan is one kernel launch, not waited on; ``_contended_finish``
    copies its results back.
    """
    st = chunk_rows(lines, seg, src, num_segments, num_sources, model)
    if st["n"] == 0:
        return st
    with stage("dram"):
        (st["lat_d"], st["hitn_d"], st["dmax_d"]), (st["done0_d"], st["hit0_d"]) = (
            dram_scan_chunked(
                *(torch.from_numpy(st[k]).to(device)
                  for k in ("bk_m", "row_m", "k_m", "va_m")),
                model.banks_per_channel,
                st["k_max"],
                float(model.t_rp + model.t_rcd),
                float(model.t_cas),
                st["bus_cyc"],
            )
        )
        if _profiling_active() and device.type == "cuda":
            # Attribute async device compute to "dram", not to the
            # extraction in ``_contended_finish`` (profiling sessions only).
            torch.cuda.synchronize(device)
    return st


def _contended_finish(st: dict, aggregate: str = "device"):
    """Extraction + per-segment aggregation for a started contended call."""
    num_segments = st["num_segments"]
    num_sources = st["num_sources"]
    model = st["model"]
    empty = DramResult(0.0, 0.0, 0, 0, 0)
    finish = np.zeros((num_segments, num_sources), dtype=np.float64)
    if st["n"] == 0:
        return [empty] * num_segments, finish
    n, C, nr = st["n"], st["C"], st["nr"]
    n_chunks, k_max, R, Lc = st["n_chunks"], st["k_max"], st["R"], st["Lc"]
    n_seg, cflat, k_of, cchq = st["n_seg"], st["cflat"], st["k_of"], st["cchq"]
    new_merged, pre_o = st["new_merged"], st["pre_o"]
    mstart_r, chunk_ofs, rlen_o = st["mstart_r"], st["chunk_ofs"], st["rlen_o"]
    rseg_o, src_run, rstart_o = st["rseg_o"], st["src_run"], st["rstart_o"]
    seg, src = st["seg"], st["src"]
    lat_d, hitn_d, dmax_d = st["lat_d"], st["hitn_d"], st["dmax_d"]
    done0_d, hit0_d = st["done0_d"], st["hit0_d"]
    bus32 = np.float32(st["bus_cyc"])
    cas32 = np.float32(model.t_cas)
    need_chunks = aggregate == "host" or num_sources > 1

    with stage("host_sync"):
        if aggregate == "device":
            # ROW-granular extraction: three (segments * channels,)-sized
            # aggregates — finished per-row sums/maxima straight off the
            # scan carry, independent of trace length.
            lat_row = lat_d.cpu().numpy().reshape(-1)
            hit_row = hitn_d.cpu().numpy().reshape(-1)
            dmax_row = dmax_d.cpu().numpy().reshape(-1)
        if need_chunks:
            # CHUNK-granular extraction — for the host reference mode and
            # for per-source finish attribution (chunk-first completions
            # anchor the run-granular per-source maxima).
            done0_flat = done0_d.cpu().numpy().reshape(-1)
        if aggregate == "host":
            hit0_flat = hit0_d.cpu().numpy().reshape(-1)

    with stage("dram"):
        if need_chunks:
            done0_chunk = done0_flat[cflat]                   # f32 per chunk

        if aggregate == "device":
            lat_seg = (
                lat_row.astype(np.float64).reshape(num_segments, C).sum(axis=1)
            )
            hit_seg = (
                hit_row.astype(np.int64).reshape(num_segments, C).sum(axis=1)
            )
            fin_row = np.where(
                dmax_row > 0, (dmax_row + cas32).astype(np.float64), 0.0
            )
            fin_seg = fin_row.reshape(num_segments, C).max(axis=1)
        else:
            # Independent host re-derivation of every aggregate from the
            # per-chunk scan outputs: replay the in-chunk f32 completion /
            # latency chain, then reduce at chunk granularity. Same IEEE op
            # chains as the device carry (sequential f32 adds in service
            # order; 0.0-padding is exact), different implementation — the
            # differential reference for the device aggregates.
            hit0_chunk = hit0_flat[cflat]
            d = done0_chunk
            lc = done0_chunk + cas32
            for step in range(1, k_max):
                live = step < k_of
                d = np.where(live, d + bus32, d)
                lc = np.where(live, lc + (d + cas32), lc)
            lc_m = np.zeros((R, Lc), dtype=np.float32)
            lc_m.reshape(-1)[cflat] = lc
            lat_row_h = np.cumsum(lc_m, axis=1, dtype=np.float32)[:, -1]
            lat_seg = (
                lat_row_h.astype(np.float64)
                .reshape(num_segments, C)
                .sum(axis=1)
            )
            done_last = (d + cas32).astype(np.float64)  # chunk-last + CAS
            hit_chunk = hit0_chunk.astype(np.int64) + (k_of - 1)
            cseg = cchq // C
            hit_seg = np.bincount(
                cseg, weights=hit_chunk, minlength=num_segments
            ).astype(np.int64)
            fin_seg = np.zeros(num_segments, dtype=np.float64)
            np.maximum.at(fin_seg, cseg, done_last)

        if num_sources == 1:
            finish[:, 0] = fin_seg
        elif aggregate == "device":
            # Run-granular per-source finish: runs are source-pure (the run
            # boundary folds ``src``), and within a merged run completions
            # are non-decreasing in service order (each chunk resumes at
            # ``max(dlast, dlast) + bus``, and f32 adds of positive
            # constants are monotone), so a run's maximum completion is its
            # LAST line. Its value is the chunk-first completion plus the
            # same sequential f32 bus adds the scan applied — bitwise equal
            # to the per-access expansion the host mode keeps as reference.
            m_of_run = np.cumsum(new_merged) - 1
            pos_in_m = pre_o - pre_o[mstart_r][m_of_run]
            p_last = pos_in_m + rlen_o - 1
            c_last = chunk_ofs[m_of_run] + p_last // k_max
            j_last = p_last % k_max
            val = done0_chunk[c_last]
            for step in range(1, k_max):
                val = np.where(j_last >= step, val + bus32, val)
            key_run = rseg_o * num_sources + src_run
            np.maximum.at(
                finish.reshape(-1), key_run, (val + cas32).astype(np.float64)
            )
        else:
            # Expand per-access completions: chunk's first completion + j
            # sequential f32 adds of the bus occupancy + t_cas — the exact
            # op chain the device scan applied.
            run_of_line = np.repeat(np.arange(nr), rlen_o)
            within = np.arange(n) - pre_o[run_of_line]
            order = rstart_o[run_of_line] + within
            chunk_of_line = np.repeat(np.arange(n_chunks), k_of)
            j_of = np.arange(n) - np.repeat(
                np.cumsum(k_of) - k_of, k_of
            )
            val = done0_chunk[chunk_of_line]
            for step in range(1, k_max):
                val = np.where(j_of >= step, val + bus32, val)
            done_acc = np.zeros(n, dtype=np.float64)
            done_acc[order] = val + cas32
            key = seg * num_sources + src
            np.maximum.at(finish.reshape(-1), key, done_acc)
        finish[finish > 0] += model.base_latency

        results: List[DramResult] = []
        for s in range(num_segments):
            ns = int(n_seg[s])
            if ns == 0:
                results.append(empty)
                continue
            row_hits = int(hit_seg[s])
            results.append(DramResult(
                finish_cycle=float(fin_seg[s]) + model.base_latency,
                total_latency_cycles=float(lat_seg[s]) + model.base_latency * ns,
                row_hits=row_hits,
                row_misses=ns - row_hits,
                accesses=ns,
            ))
    return results, finish


def estimate_dram_fast(
    lines: np.ndarray,
    model: DramModel,
    start_cycle: float = 0.0,
) -> DramResult:
    """Closed-form estimate for long traces (no event scan).

    finish = max over channels of max(bus occupancy, slowest bank's row-op
    serialization); row transitions counted exactly per bank.
    """
    lines = np.asarray(lines, dtype=np.int64).reshape(-1)
    n = lines.size
    if n == 0:
        return DramResult(start_cycle, 0.0, 0, 0, 0, detailed=False)
    ch, bk, row = model.decompose(lines)
    C, B = model.channels, model.banks_per_channel
    gb = ch.astype(np.int64) * B + bk
    # row transitions per (channel, bank) in arrival order
    order = np.argsort(gb, kind="stable")
    gb_s, row_s = gb[order], row[order]
    first = np.ones(n, dtype=bool)
    first[1:] = gb_s[1:] != gb_s[:-1]
    trans = first | np.concatenate(([True], row_s[1:] != row_s[:-1]))
    # per-bank counts
    counts = np.bincount(gb_s, minlength=C * B)
    misses = np.bincount(gb_s[trans], minlength=C * B)
    bus_cyc = model.line_bytes / model.chan_bytes_per_cycle
    bank_time = counts * bus_cyc + misses * (model.t_rp + model.t_rcd)
    bank_bound = bank_time.reshape(C, B).max(axis=1)
    bus_bound = np.bincount(ch, minlength=C) * bus_cyc
    finish = (
        float(np.maximum(bank_bound, bus_bound).max())
        + model.base_latency
        + model.t_cas
    )
    row_hits = int(n - trans.sum())
    return DramResult(
        finish_cycle=start_cycle + finish,
        total_latency_cycles=finish * 1.0,
        row_hits=row_hits,
        row_misses=n - row_hits,
        accesses=n,
        detailed=False,
    )


# Engine switches to the fast path above this trace length.
DETAILED_DRAM_MAX = 2_000_000


def dram_timing(
    lines: np.ndarray, model: DramModel, *, device: DeviceLike = "cuda", **kw
) -> DramResult:
    if np.asarray(lines).size > DETAILED_DRAM_MAX:
        return estimate_dram_fast(lines, model)
    return simulate_dram(lines, model, device=device, **kw)


def dram_timing_segmented(
    lines: np.ndarray,
    seg: np.ndarray,
    num_segments: int,
    model: DramModel,
    *,
    device: DeviceLike = "cuda",
) -> List[DramResult]:
    """Segmented counterpart of ``dram_timing``.

    Segments longer than ``DETAILED_DRAM_MAX`` use the closed-form estimate
    (matching the per-segment switch in ``dram_timing``); the rest share one
    batched event scan. One-source reduction of ``dram_timing_contended``.
    """
    lines = np.asarray(lines, dtype=np.int64).reshape(-1)
    out, _ = dram_timing_contended(
        lines, seg, np.zeros(lines.size, dtype=np.int64), num_segments, 1, model,
        device=device,
    )
    return out


def dram_timing_contended(
    lines: np.ndarray,
    seg: np.ndarray,
    src: np.ndarray,
    num_segments: int,
    num_sources: int,
    model: DramModel,
    *,
    device: DeviceLike = "cuda",
):
    """Event-scan dispatch for the contended shared-DRAM path.

    Segments longer than ``DETAILED_DRAM_MAX`` fall back to the closed-form
    estimate over the merged stream (per-source finish approximated by the
    segment finish — the shared bus bounds every core in that regime).

    """
    lines = np.asarray(lines, dtype=np.int64).reshape(-1)
    seg = np.asarray(seg, dtype=np.int64).reshape(-1)
    src = np.asarray(src, dtype=np.int64).reshape(-1)
    sizes = np.bincount(seg, minlength=num_segments)
    big_ids = np.nonzero(sizes > DETAILED_DRAM_MAX)[0]
    if big_ids.size == 0:
        return simulate_dram_contended(
            lines, seg, src, num_segments, num_sources, model, device=device
        )
    small_ids = np.nonzero(sizes <= DETAILED_DRAM_MAX)[0]
    remap = np.full(num_segments, -1, dtype=np.int64)
    remap[small_ids] = np.arange(small_ids.size)
    keep = remap[seg] >= 0
    small_res, small_fin = simulate_dram_contended(
        lines[keep], remap[seg[keep]], src[keep],
        int(small_ids.size), num_sources, model, device=device,
    )
    out: List[DramResult] = [None] * num_segments  # type: ignore[list-item]
    finish = np.zeros((num_segments, num_sources), dtype=np.float64)
    for i, s in enumerate(small_ids):
        out[s] = small_res[i]
        finish[s] = small_fin[i]
    for s in big_ids:
        mask = seg == s
        res = estimate_dram_fast(lines[mask], model)
        out[s] = res
        present = np.bincount(src[mask], minlength=num_sources) > 0
        finish[s][present] = res.finish_cycle
    return out, finish


@dataclass(frozen=True)
class DramRequest:
    """One deferred DRAM-timing dispatch: exactly the argument tuple of
    ``dram_timing_contended``."""

    lines: np.ndarray
    seg: np.ndarray
    src: np.ndarray
    num_segments: int
    num_sources: int
    model: DramModel


def dram_timing_single(req: DramRequest, device: DeviceLike = "cuda"):
    """Time one request."""
    return dram_timing_contended(
        req.lines, req.seg, req.src, req.num_segments, req.num_sources,
        req.model, device=device,
    )


def _timing_contended_start(lines, seg, src, num_segments, num_sources, model, device):
    """``dram_timing_contended`` split for pipelined dispatch.

    The common case (no segment above ``DETAILED_DRAM_MAX``) returns a
    pending ``_contended_start`` state (its scan launched, not waited on);
    the estimate fallback is evaluated eagerly.
    """
    n_total = np.asarray(lines).size
    if n_total > DETAILED_DRAM_MAX and (np.bincount(
        np.asarray(seg, dtype=np.int64).reshape(-1), minlength=num_segments
    ) > DETAILED_DRAM_MAX).any():
        return ("eager", dram_timing_contended(
            lines, seg, src, num_segments, num_sources, model, device=device
        ))
    return ("pending", _contended_start(
        lines, seg, src, num_segments, num_sources, model, device
    ))


def _timing_contended_finish(started):
    tag, value = started
    if tag == "eager":
        return value
    return _contended_finish(value)


def dram_timing_many(
    requests: "list[DramRequest]", batch: bool = True, *, device: DeviceLike = "cuda"
):
    """Time many independent requests; same-``DramModel`` requests share ONE
    batched event scan.

    Each request's segments are remapped into a disjoint range of one
    concatenated ``dram_timing_contended`` call. Per-segment results are
    independent of which other segments share a dispatch (FR-FCFS ordering is
    segment-qualified, per-segment aggregation runs on the host in original
    access order), so every request's results are bitwise identical to its
    unbatched ``dram_timing_single`` dispatch. ``batch=False`` is that
    reference path.

    Returns one ``(results, finish)`` pair per request, where ``finish`` is
    sliced back to the request's own ``num_sources``.
    """
    dev = resolve_device(device)
    out = [None] * len(requests)
    if not batch:
        return [dram_timing_single(r, dev) for r in requests]
    groups: "dict[tuple, list[int]]" = {}
    for i, r in enumerate(requests):
        # Group by model AND estimated padded row length: co-dispatching a
        # tiny miss trace with a huge one would pad the tiny one's
        # (segment, channel) rows to the huge one's chunk count. The estimate
        # only shapes the grouping — results are exact for any grouping.
        n_req = np.asarray(r.lines).size
        est_row = max(1, n_req // max(1, r.num_segments * r.model.channels
                                      * max(1, min(r.model.lines_per_block, 8))))
        groups.setdefault((r.model, _chunk_bucket_len(est_row)), []).append(i)
    # Start every group (host prep + a launch that is not waited on) before
    # finishing any, then drain singles, then extract, so each group's host
    # bookkeeping overlaps the earlier groups' scans on the card. Grouping
    # never changes results.
    singles: "list[int]" = []
    started = []
    for (model, _), idxs in groups.items():
        if len(idxs) == 1:
            singles.append(idxs[0])
            continue
        reqs = [requests[i] for i in idxs]
        with stage("dram"):
            offsets = np.cumsum([0] + [r.num_segments for r in reqs])
            lines = np.concatenate([
                np.asarray(r.lines, dtype=np.int64).reshape(-1) for r in reqs
            ])
            seg = np.concatenate([
                np.asarray(r.seg, dtype=np.int64).reshape(-1) for r in reqs
            ])
            # One in-place remap pass instead of per-request temporaries.
            seg += np.repeat(
                offsets[:-1],
                [np.asarray(r.seg).size for r in reqs],
            )
            src = np.concatenate([
                np.asarray(r.src, dtype=np.int64).reshape(-1) for r in reqs
            ])
            num_sources = max(r.num_sources for r in reqs)
        st = _timing_contended_start(
            lines, seg, src, int(offsets[-1]), num_sources, model, dev
        )
        started.append((idxs, reqs, offsets, st))
    for i in singles:
        out[i] = dram_timing_single(requests[i], dev)
    for idxs, reqs, offsets, st in started:
        results, finish = _timing_contended_finish(st)
        for i, r, lo, hi in zip(idxs, reqs, offsets[:-1], offsets[1:]):
            out[i] = (results[lo:hi], finish[lo:hi, :r.num_sources].copy())
    return out


def bulk_transfer_cycles(data_bytes: float, hw: HardwareConfig) -> float:
    """Paper's analytical model for large tile transfers: T = D/B + L."""
    off = hw.offchip
    return data_bytes / off.bytes_per_cycle(hw.clock_ghz) + off.base_latency_cycles
