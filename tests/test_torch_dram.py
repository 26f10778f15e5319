"""The PyTorch port's DRAM model, held bitwise against the JAX package: the
plain chunked event scan (D1's CPU version) vs the reference ``lax.scan``,
the contended timing in both aggregate modes, the FR-FCFS ordering, and
the per-access scan with arrival times (D3's CPU version, ``simulate_dram``
and ``dram_timing`` with a non-zero issue interval or start cycle)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from differential import assert_bitwise_equal_results

from repro.core.hardware import tpuv6e as r_tpuv6e
from repro.core.memory import dram as rdram
from repro_torch.core.hardware import tpuv6e
from repro_torch.core.memory import dram as tdram
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.dram_scan import (
    dram_prepass, dram_prepass_plain, dram_scan_chunked, dram_scan_full)


def _models():
    return rdram.DramModel.from_hardware(r_tpuv6e()), tdram.DramModel.from_hardware(tpuv6e())


def _chunk_inputs(rng, R, Lc, banks, k_max):
    bk = rng.integers(0, banks, size=(R, Lc)).astype(np.int32)
    row = rng.integers(0, 4, size=(R, Lc)).astype(np.int32)
    k = rng.integers(1, k_max + 1, size=(R, Lc)).astype(np.int32)
    valid = rng.random((R, Lc)) < 0.85
    valid[:, Lc - Lc // 4:] = False          # padded tail, as the engine pads
    k[~valid] = 0
    bk[~valid] = 0
    row[~valid] = 0
    return bk, row, k, valid


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


@pytest.mark.parametrize("R,Lc,banks,k_max,seed", [
    (4, 64, 8, 8, 0), (7, 96, 4, 3, 1), (3, 128, 8, 1, 2), (32, 64, 16, 8, 3),
])
def test_plain_chunked_scan_equals_jax_scan_bitwise(R, Lc, banks, k_max, seed):
    rng = np.random.default_rng(seed)
    bk, row, k, valid = _chunk_inputs(rng, R, Lc, banks, k_max)
    bus = 64 / (1600.0 / 0.94 / 16)
    ref = rdram._scan_channel_chunked(bk, row, k, valid, banks, k_max, 44.0, 22.0, bus)
    ours = dram_scan_chunked(*(torch.from_numpy(a) for a in (bk, row, k, valid)),
                             banks, k_max, 44.0, 22.0, bus)
    for a, b in zip(ours[0] + ours[1], ref[0] + ref[1]):
        np.testing.assert_array_equal(_bits(a.numpy()), _bits(b))


def _vec_trace(rng, n_vec, space, lpv=8):
    base = rng.integers(0, space, size=n_vec) * lpv
    return (base[:, None] + np.arange(lpv)[None, :]).reshape(-1)


def _as_dicts(out):
    results, finish = out
    return [dataclasses.asdict(r) for r in results], finish


@pytest.mark.parametrize("aggregate", ["device", "host"])
@pytest.mark.parametrize("num_sources", [1, 3])
@pytest.mark.parametrize("pattern", ["vectors", "random"])
def test_contended_timing_equals_jax_bitwise(pattern, num_sources, aggregate):
    rng = np.random.default_rng(4)
    lines = _vec_trace(rng, 1500, 50_000) if pattern == "vectors" else rng.integers(0, 400_000, size=9000)
    num_segments = 4
    seg = np.sort(rng.integers(0, num_segments, size=lines.size))
    seg[seg == 2] = 3                     # leave one segment empty
    src = rng.integers(0, num_sources, size=lines.size)
    rm, tm = _models()
    ref = rdram.simulate_dram_contended(lines, seg, src, num_segments, num_sources, rm,
                                        aggregate=aggregate)
    ours = tdram.simulate_dram_contended(lines, seg, src, num_segments, num_sources, tm,
                                         aggregate=aggregate, device="cpu")
    assert_bitwise_equal_results(_as_dicts(ours), _as_dicts(ref))


def test_contended_timing_tiny_and_empty():
    rm, tm = _models()
    empty = np.zeros(0, dtype=np.int64)
    res, fin = tdram.simulate_dram_contended(empty, empty, empty, 2, 2, tm, device="cpu")
    assert all(r.accesses == 0 for r in res) and not fin.any()
    for lines in ([5], [5, 5, 5], list(range(8)), [9, 1000, 9]):
        arr = np.asarray(lines, dtype=np.int64)
        z = np.zeros(arr.size, dtype=np.int64)
        assert_bitwise_equal_results(
            _as_dicts(tdram.simulate_dram_contended(arr, z, z, 1, 1, tm, device="cpu")),
            _as_dicts(rdram.simulate_dram_contended(arr, z, z, 1, 1, rm)),
        )


def test_contended_timing_rejects_unknown_aggregate():
    _, tm = _models()
    with pytest.raises(ValueError, match="aggregate"):
        tdram.simulate_dram_contended(np.array([1]), np.array([0]), np.array([0]), 1, 1, tm,
                                      aggregate="gpu", device="cpu")


@pytest.mark.parametrize("segmented", [False, True])
def test_frfcfs_order_equals_jax_package(segmented):
    rng = np.random.default_rng(9)
    n = 6000
    ch = rng.integers(0, 16, size=n).astype(np.int32)
    bk = rng.integers(0, 8, size=n).astype(np.int32)
    blk = rng.integers(0, 300, size=n).astype(np.int64)
    seg = np.sort(rng.integers(0, 3, size=n)) if segmented else None
    ours = tdram._frfcfs_order(ch, bk, blk, 8, 16, seg=seg)
    np.testing.assert_array_equal(ours, rdram._frfcfs_order(ch, bk, blk, 8, 16, seg=seg))
    np.testing.assert_array_equal(ours, rdram._frfcfs_order_ref(ch, bk, blk, 8, 16, seg=seg))


def test_radix_argsort_matches_numpy_stable():
    rng = np.random.default_rng(1)
    for kmax in (1, 1 << 15, 1 << 16, 1 << 31, 1 << 50):
        for n in (0, 1, 5000):
            key = rng.integers(0, kmax + 1, n).astype(np.int64)
            np.testing.assert_array_equal(tdram._argsort_stable(key),
                                          np.argsort(key, kind="stable"))


def test_estimate_and_model_equal_jax_package():
    rm, tm = _models()
    assert dataclasses.asdict(tm) == dataclasses.asdict(rm)
    lines = _vec_trace(np.random.default_rng(2), 800, 90_000)
    assert dataclasses.asdict(tdram.estimate_dram_fast(lines, tm)) == \
        dataclasses.asdict(rdram.estimate_dram_fast(lines, rm))
    hw_r, hw_t = r_tpuv6e(), tpuv6e()
    assert tdram.bulk_transfer_cycles(12345.0, hw_t) == rdram.bulk_transfer_cycles(12345.0, hw_r)


def test_dram_scan_validates_inputs():
    a = torch.zeros((2, 8), dtype=torch.int32)
    v = torch.ones((2, 8), dtype=torch.bool)
    with pytest.raises(TypeError, match="int32"):
        dram_scan_chunked(a, a, a.float(), v, 8, 8, 44.0, 22.0, 0.6)
    with pytest.raises(ValueError, match="shape"):
        dram_scan_chunked(a, a, a[:, :4], v, 8, 8, 44.0, 22.0, 0.6)


def _requests(rng, rm, tm):
    """Requests of several sizes, segment counts and sources, one model
    (and a second model for one of them, so the groups split)."""
    out = []
    for n_vec, n_seg, n_src in ((400, 2, 1), (300, 3, 2), (20, 1, 1), (900, 2, 1), (0, 2, 1)):
        lines = _vec_trace(rng, n_vec, 30_000) if n_vec else np.zeros(0, np.int64)
        seg = np.sort(rng.integers(0, n_seg, size=lines.size))
        src = rng.integers(0, n_src, size=lines.size)
        out.append((lines, seg, src, n_seg, n_src))
    other = (dataclasses.replace(rm, channels=8), dataclasses.replace(tm, channels=8))
    models = [(rm, tm)] * 4 + [other]
    return ([rdram.DramRequest(*r, m[0]) for r, m in zip(out, models)],
            [tdram.DramRequest(*r, m[1]) for r, m in zip(out, models)])


def test_dram_timing_many_equals_per_request_and_jax_package():
    rm, tm = _models()
    rreqs, treqs = _requests(np.random.default_rng(6), rm, tm)
    batched = tdram.dram_timing_many(treqs, device="cpu")
    single = tdram.dram_timing_many(treqs, batch=False, device="cpu")
    ref = rdram.dram_timing_many(rreqs)
    assert len(batched) == len(treqs)
    for b, s, r in zip(batched, single, ref):
        assert_bitwise_equal_results(_as_dicts(b), _as_dicts(s))
        assert_bitwise_equal_results(_as_dicts(b), _as_dicts(r))
    assert tdram.dram_timing_many([], device="cpu") == []


@pytest.mark.parametrize("pattern", ["vectors", "random", "one", "empty"])
def test_simulate_dram_and_dram_timing_equal_jax_package(pattern):
    rng = np.random.default_rng(12)
    lines = {"vectors": _vec_trace(rng, 700, 40_000), "random": rng.integers(0, 10**6, size=3000),
             "one": np.array([77]), "empty": np.zeros(0, np.int64)}[pattern]
    rm, tm = _models()
    for ours, ref in (
        (tdram.simulate_dram(lines, tm, device="cpu"), rdram.simulate_dram(lines, rm)),
        (tdram.dram_timing(lines, tm, device="cpu"), rdram.dram_timing(lines, rm)),
    ):
        assert_bitwise_equal_results(dataclasses.asdict(ours), dataclasses.asdict(ref))
    seg = np.sort(rng.integers(0, 3, size=lines.size))
    for ours, ref in (
        (tdram.simulate_dram_segmented(lines, seg, 3, tm, device="cpu"),
         rdram.simulate_dram_segmented(lines, seg, 3, rm)),
        (tdram.dram_timing_segmented(lines, seg, 3, tm, device="cpu"),
         rdram.dram_timing_segmented(lines, seg, 3, rm)),
    ):
        assert_bitwise_equal_results([dataclasses.asdict(r) for r in ours],
                                     [dataclasses.asdict(r) for r in ref])


def test_dram_timing_switches_to_the_estimate_past_the_detailed_limit(monkeypatch):
    rng = np.random.default_rng(13)
    lines = _vec_trace(rng, 300, 40_000)
    rm, tm = _models()
    monkeypatch.setattr(tdram, "DETAILED_DRAM_MAX", 1000)
    monkeypatch.setattr(rdram, "DETAILED_DRAM_MAX", 1000)
    ours, ref = tdram.dram_timing(lines, tm, device="cpu"), rdram.dram_timing(lines, rm)
    assert not ours.detailed
    assert_bitwise_equal_results(dataclasses.asdict(ours), dataclasses.asdict(ref))
    seg = (np.arange(lines.size) >= 2000).astype(np.int64)    # 2,000 and 400 lines
    ours = tdram.dram_timing_segmented(lines, seg, 2, tm, device="cpu")
    ref = rdram.dram_timing_segmented(lines, seg, 2, rm)
    assert [r.detailed for r in ours] == [False, True]
    assert_bitwise_equal_results([dataclasses.asdict(r) for r in ours],
                                 [dataclasses.asdict(r) for r in ref])


def _full_inputs(rng, R, L, banks, interval, start):
    bk = rng.integers(0, banks, size=(R, L)).astype(np.int32)
    row = rng.integers(0, 3, size=(R, L)).astype(np.int32)
    arrive = (start + np.arange(R * L, dtype=np.float32).reshape(R, L) * interval).astype(np.float32)
    valid = rng.random((R, L)) < 0.85
    valid[:, L - L // 4:] = False            # padded tail, as simulate_dram pads
    return bk, row, arrive, valid


@pytest.mark.parametrize("R,L,banks,interval,start,seed", [
    (4, 64, 8, 0.5, 0.0, 0), (7, 100, 4, 2.0, 1000.0, 1), (1, 1, 8, 0.0, 3.25, 2),
    (16, 257, 16, 0.37, 13.3, 3), (3, 96, 1, 1.0, 0.0, 4),
])
def test_plain_full_scan_equals_jax_scan_bitwise(R, L, banks, interval, start, seed):
    """D3's plain version against the reference's ``_scan_channel_full``:
    every per-access completion, latency and hit."""
    rng = np.random.default_rng(seed)
    bk, row, arrive, valid = _full_inputs(rng, R, L, banks, interval, start)
    bus = 64 / (1600.0 / 0.94 / 16)
    ref = rdram._scan_channel_full(bk, row, arrive, valid, banks, 22.0, 44.0, bus)
    ours = dram_scan_full(*(torch.from_numpy(a) for a in (bk, row, arrive, valid)),
                          banks, 22.0, 44.0, bus)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(_bits(a.numpy()), _bits(np.asarray(b)))


def _frfcfs_rows(rng, R, L, banks, lo=0):
    """Bank rows in runs of 8 slots (a vector's lines, as FR-FCFS orders
    them) with single slots between, rows 0..3, some banks out of range
    when ``lo`` is negative."""
    bk = rng.integers(lo, banks + (1 if lo < 0 else 0), size=(R, L)).astype(np.int32)
    runs = np.repeat(bk[:, ::8], 8, axis=1)[:, :L]
    keep = rng.random((R, L)) < 0.7
    return np.where(keep, runs, bk).astype(np.int32), rng.integers(0, 4, size=(R, L)).astype(np.int32)


@pytest.mark.parametrize("banks", [1, 8, 16, 17])
@pytest.mark.parametrize("interval,start", [(0.5, 0.0), (2.0, 1000.0), (0.37, 13.3)])
def test_prepass_and_scan_equal_jax_scan_bitwise(banks, interval, start):
    """D3's plain pre-pass plus scan (the kernels' algorithm: row hits,
    codes, then the three-op chain) against the reference's
    ``_scan_channel_full`` on seeded FR-FCFS-like traces, invalid slots in
    the rows and a padded tail: every completion, latency and hit."""
    rng = np.random.default_rng(banks * 100 + int(interval * 10))
    R, L = 5, 700
    bk, row = _frfcfs_rows(rng, R, L, banks)
    arrive = (start + np.arange(R * L, dtype=np.float32).reshape(R, L) * interval).astype(np.float32)
    valid = rng.random((R, L)) < 0.9
    valid[:, L - 37:] = False
    bus = 64 / (1600.0 / 0.94 / 16)
    ref = rdram._scan_channel_full(bk, row, arrive, valid, banks, 22.0, 44.0, bus)
    ours = dram_scan_full(*(torch.from_numpy(a) for a in (bk, row, arrive, valid)),
                          banks, 22.0, 44.0, bus)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(_bits(a.numpy()), _bits(np.asarray(b)))


@pytest.mark.parametrize("banks,lo", [(8, 0), (8, -1), (16, 0), (3, -1)])
def test_prepass_codes_follow_the_serial_walk(banks, lo):
    """The plain pre-pass's codes against a serial walk of the reference's
    carry: per slot the lane it reads, valid, the row hit, whether the
    bank's previous update is the previous valid access, the distance back
    to it (2..5) and the bank it updates; the hit output; on the CPU no
    launch counted."""
    rng = np.random.default_rng(banks - lo)
    R, L = 3, 300
    bk, row = _frfcfs_rows(rng, R, L, banks, lo)
    valid = rng.random((R, L)) < 0.8
    reset_launch_counts()
    code, hit = dram_prepass(*(torch.from_numpy(a) for a in (bk, row, valid)), banks)
    assert launch_counts()["dram_prepass"] == 0
    want = np.zeros((R, L), np.int64)
    for r in range(R):
        last, open_row, pv = {}, {}, -1
        for i in range(L):
            b, inb, v = int(bk[r, i]), 0 <= bk[r, i] < banks, bool(valid[r, i])
            j = last.get(b, -1) if inb else -1
            h = v and inb and open_row.get(b, -1) == row[r, i]
            c = (b if inb else 31) | (32 if v else 0) | (64 if h else 0)
            if v and inb and j >= 0:
                c |= 128 if j == pv else 0
                c |= (1 << (8 + i - j - 2)) if 2 <= i - j <= 5 else 0
            if v and inb:
                c |= 1 << (16 + b)
                last[b], open_row[b] = i, row[r, i]
            pv = i if v else pv
            want[r, i] = c
    np.testing.assert_array_equal(code.numpy(), want.astype(np.int32))
    assert torch.equal(hit, torch.from_numpy((want & 64) != 0))
    np.testing.assert_array_equal(code.numpy(), dram_prepass_plain(
        *(torch.from_numpy(a) for a in (bk, row, valid)), banks)[0].numpy())


def test_full_scan_refuses_negative_timings():
    """The three-op chain needs t_row_act >= 0 and a bus time >= 0 (the
    DRAM model's are positive)."""
    z = torch.zeros((1, 4), dtype=torch.int32)
    a, v = torch.zeros((1, 4)), torch.ones((1, 4), dtype=torch.bool)
    with pytest.raises(ValueError, match="t_row_act >= 0"):
        dram_scan_full(z, z, a, v, 8, 22.0, -44.0, 0.6)
    with pytest.raises(ValueError, match="bus_cycles_per_line >= 0"):
        dram_scan_full(z, z, a, v, 8, 22.0, 44.0, -0.6)


@pytest.mark.parametrize("L", [1, 20, 32, 33, 100, 1000, 1025, 4096, 100_003])
def test_xla_row_sum_is_the_reference_reduction_bitwise(L):
    """``xla_row_sum`` adds in the order of XLA's CPU row sum (windows of
    32, zero-padded half in front), the sum the reference takes of each
    channel's latencies."""
    x = (np.random.default_rng(L).random((3, L)) * 3e3 + 1e3).astype(np.float32)
    want = np.asarray(jax.jit(lambda a: a.sum(axis=-1))(x))
    got = tdram.xla_row_sum(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


_ARRIVALS = {
    "interval": dict(issue_interval_cycles=2.0),
    "start": dict(start_cycle=10.0),
    "both": dict(issue_interval_cycles=2.0, start_cycle=1000.0),
    "fractional": dict(issue_interval_cycles=0.37, start_cycle=13.3),
    "fast_issue": dict(issue_interval_cycles=0.125),
}


@pytest.mark.parametrize("entry", ["simulate_dram", "dram_timing"])
@pytest.mark.parametrize("arrivals", sorted(_ARRIVALS))
def test_simulate_dram_with_arrivals_equals_reference(entry, arrivals):
    """The per-access route (D3) against the reference, every field bitwise,
    ``total_latency_cycles`` included (latencies non-integer: 0.6016 bus
    cycles a line)."""
    rng = np.random.default_rng(len(arrivals))
    lines = _vec_trace(rng, 700, 40_000)
    rm, tm = _models()
    ours = getattr(tdram, entry)(lines, tm, device="cpu", **_ARRIVALS[arrivals])
    ref = getattr(rdram, entry)(lines, rm, **_ARRIVALS[arrivals])
    assert_bitwise_equal_results(dataclasses.asdict(ours), dataclasses.asdict(ref))


@pytest.mark.parametrize("case", ["one_channel", "empty", "one_line", "line_trace"])
def test_simulate_dram_with_arrivals_edges(case):
    """One channel (a single row of L = n), an empty trace (the start cycle
    back, no scan), one access, and a line-granular (not vector) trace."""
    rng = np.random.default_rng(5)
    rm, tm = _models()
    lines = {"one_channel": _vec_trace(rng, 60, 5_000), "empty": np.zeros(0, np.int64),
             "one_line": np.array([12345]),
             "line_trace": rng.integers(0, 1 << 20, size=1_500)}[case]
    if case == "one_channel":
        rm, tm = dataclasses.replace(rm, channels=1), dataclasses.replace(tm, channels=1)
    kw = dict(issue_interval_cycles=1.5, start_cycle=7.0)
    for entry in ("simulate_dram", "dram_timing"):
        ours = getattr(tdram, entry)(lines, tm, device="cpu", **kw)
        ref = getattr(rdram, entry)(lines, rm, **kw)
        assert_bitwise_equal_results(dataclasses.asdict(ours), dataclasses.asdict(ref))


def test_dram_timing_above_detailed_max_ignores_arrivals(monkeypatch):
    """Above ``DETAILED_DRAM_MAX`` ``dram_timing`` takes the closed-form
    estimate, which ignores the arrival arguments, as the reference does."""
    rng = np.random.default_rng(6)
    lines = _vec_trace(rng, 300, 40_000)
    rm, tm = _models()
    monkeypatch.setattr(tdram, "DETAILED_DRAM_MAX", 1000)
    monkeypatch.setattr(rdram, "DETAILED_DRAM_MAX", 1000)
    kw = dict(issue_interval_cycles=2.0, start_cycle=50.0)
    ours, ref = tdram.dram_timing(lines, tm, device="cpu", **kw), rdram.dram_timing(lines, rm, **kw)
    assert not ours.detailed
    assert_bitwise_equal_results(dataclasses.asdict(ours), dataclasses.asdict(ref))
    assert dataclasses.asdict(ours) == dataclasses.asdict(tdram.estimate_dram_fast(lines, tm))


def test_simulate_dram_with_arrivals_needs_a_card_by_default():
    """No silent CPU fallback on the arrival route either."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _, tm = _models()
    with pytest.raises(RuntimeError):
        tdram.simulate_dram(np.arange(100), tm, issue_interval_cycles=2.0)
