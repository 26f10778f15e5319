"""The port's CUDA kernels against their plain torch versions, on the card.

Run on a machine with an NVIDIA GPU and nvcc:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_kernels_cuda.py

Without a card every test here skips (the kernels have no CPU mode; their
plain versions are held against the JAX package by the CPU tests).
"""
import ctypes

import numpy as np
import pytest
import torch

from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.cache_scan import cache_scan_groups, cache_scan_plain
from repro_torch.kernels.dram_scan import (
    dram_prepass, dram_prepass_plain, dram_scan_chunked, dram_scan_full, dram_scan_full_plain,
    dram_scan_plain)
from repro_torch.kernels.embedding_bag import (
    embedding_bag_kernel,
    embedding_bag_plain,
    embedding_gather_kernel,
    embedding_gather_plain,
    vmem_gather_pool_kernel,
    vmem_gather_pool_plain,
    vmem_tile_rows,
)
from repro_torch.kernels.decode_attention import CHUNK
from repro_torch.kernels.stack_distance import (
    stack_distance_by_set_plain, stack_distance_groups, stack_distance_plain)

pytestmark = pytest.mark.cuda

EDGE = [(1, 1), (1, 4), (3, 2), (7, 5), (16, 7), (16, 16), (4, 32), (2, 33), (2, 64)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _rows(cuda, S, W, B=4, L=192, seed=0):
    rng = np.random.default_rng(seed + 31 * S + W)
    valid = rng.random((B, L)) < 0.9
    valid[:, L - 40:] = False
    arrays = (rng.integers(0, S, size=(B, L)).astype(np.int32),
              rng.integers(0, S * W * 2 + 1, size=(B, L)).astype(np.int32), valid)
    return [torch.from_numpy(a).to(cuda) for a in arrays]


@pytest.mark.parametrize("policy", ["lru", "srrip", "fifo"])
@pytest.mark.parametrize("sets,ways", EDGE)
def test_cache_scan_kernel_equals_plain(cuda, policy, sets, ways):
    rows = _rows(cuda, sets, ways)
    reset_launch_counts()
    got = cache_scan_groups(*rows, sets, ways, policy)
    assert launch_counts()["cache_scan"] == 1
    want = cache_scan_plain(*rows, sets, ways, policy)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("sets,ways", EDGE)
def test_stack_distance_kernel_equals_plain(cuda, sets, ways):
    """K2 against both plain versions: the reference's recency-list scan and
    the kernel's own decomposition (a rank permutation per set)."""
    rows = _rows(cuda, sets, ways)
    reset_launch_counts()
    got = stack_distance_groups(*rows, sets, ways)
    assert launch_counts()["stack_distance"] == 1
    for plain in (stack_distance_plain, stack_distance_by_set_plain):
        want = plain(*rows, sets, ways)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("case", ["one_set", "tag_minus_one", "out_of_range", "two_tiles"])
@pytest.mark.parametrize("sets,ways", [(16, 16), (2, 33), (2, 64), (64, 16), (1, 1)])
def test_stack_distance_kernel_edge_rows(cuda, case, sets, ways):
    """K2's lane teams: a row whose every access falls in one set, valid
    tags of -1 into empty ways (distances past ``ways``), sets out of range
    (padding), a row over two 1,024-position tiles; 33 and 64 ways (a
    second slot per lane) and 64 sets x 16 lanes (1,024 threads)."""
    rng = np.random.default_rng(7 * sets + ways)
    B, L = 4, 1100 if case == "two_tiles" else 300
    sets_a = rng.integers(0, sets, size=(B, L)).astype(np.int32)
    tags = rng.integers(0, sets * ways * 2 + 1, size=(B, L)).astype(np.int32)
    valid = rng.random((B, L)) < 0.9
    valid[:, L - 40:] = False
    if case == "one_set":
        sets_a[0] = sets - 1
        tags[0] = rng.integers(0, 3 * ways, size=L)
    elif case == "tag_minus_one":
        tags[:, :6] = -1
        tags[:, 70:74] = -1
    elif case == "out_of_range":
        sets_a[1] = rng.integers(-3, sets + 3, size=L)
        sets_a[2] = sets
    rows = [torch.from_numpy(a).to(cuda) for a in (sets_a, tags, valid)]
    reset_launch_counts()
    got = stack_distance_groups(*rows, sets, ways)
    assert launch_counts()["stack_distance"] == 1
    want = stack_distance_plain(*rows, sets, ways)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("banks,k_max", [(8, 8), (4, 3), (16, 1)])
def test_dram_scan_kernel_equals_plain_bitwise(cuda, banks, k_max):
    rng = np.random.default_rng(banks)
    R, Lc = 40, 160
    arrays = (rng.integers(0, banks, size=(R, Lc)).astype(np.int32),
              rng.integers(0, 3, size=(R, Lc)).astype(np.int32),
              rng.integers(1, k_max + 1, size=(R, Lc)).astype(np.int32),
              rng.random((R, Lc)) < 0.8)
    args = [torch.from_numpy(a).to(cuda) for a in arrays]
    reset_launch_counts()
    got = dram_scan_chunked(*args, banks, k_max, 44.0, 22.0, 0.6016)
    assert launch_counts()["dram_scan"] == 1
    want = dram_scan_plain(*args, banks, k_max, 44.0, 22.0, 0.6016)
    for a, b in zip(got[0] + got[1], want[0] + want[1]):
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b)


@pytest.mark.parametrize("policy", ["lru", "srrip", "fifo"])
def test_cache_scan_kernel_set_chains(cuda, policy):
    """K1 walks each set of a row with its own team of lanes: a row whose
    every access falls in one set (the longest chain), rows of different
    valid lengths in one launch, and L = 1,024 (one full tile) at the
    16-set, 16-way geometry of ``tpuv6e()``'s set groups."""
    S, W, B, L = 16, 16, 6, 1024
    rng = np.random.default_rng(5)
    sets = rng.integers(0, S, size=(B, L)).astype(np.int32)
    sets[0] = 3
    tags = rng.integers(0, S * W * 3, size=(B, L)).astype(np.int32)
    tags[0] = rng.integers(0, 3 * W, size=L)
    valid = np.arange(L)[None, :] < np.array([L, L, 700, 129, 1, 0])[:, None]
    valid[1] &= rng.random(L) < 0.8
    rows = [torch.from_numpy(a).to(cuda) for a in (sets, tags, valid)]
    reset_launch_counts()
    got = cache_scan_groups(*rows, S, W, policy)
    assert launch_counts()["cache_scan"] == 1
    want = cache_scan_plain(*rows, S, W, policy)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert bool(want[0][0].any()) and bool(want[1][0].any())


@pytest.mark.parametrize("R,Lc,banks,k_max,offset", [
    (1, 400, 1, 1, 0),       # one row; a last tile of 16 of 128 chunks
    (33, 300, 192, 8, 0),    # two blocks; Lc not a multiple of 16: copied chunk by chunk
    (64, 384, 8, 8, 0),      # two full blocks of three full tiles
    (5, 200, 192, 1, 0),
    (33, 256, 8, 8, 1),      # inputs one int off 16 bytes: copied chunk by chunk
])
def test_dram_scan_kernel_tiles_and_blocks(cuda, R, Lc, banks, k_max, offset):
    """D1's staged tiles: Lc not a multiple of the 128-chunk tile, more
    than one block of 32 rows, banks 1 and 192, k_max 1 and 8, an
    all-padding row, out-of-range banks and access counts past k_max."""
    rng = np.random.default_rng(R * 1000 + Lc)
    arrays = [rng.integers(-1, banks + 1, size=(R, Lc)).astype(np.int32),
              rng.integers(0, 3, size=(R, Lc)).astype(np.int32),
              rng.integers(0, k_max + 2, size=(R, Lc)).astype(np.int32),
              rng.random((R, Lc)) < 0.8]
    arrays[3][R // 2] = False
    args = []
    for a in arrays:
        flat = torch.zeros(a.size + offset, dtype=torch.from_numpy(a).dtype, device=cuda)
        flat[offset:] = torch.from_numpy(a).reshape(-1).to(cuda)
        args.append(flat[offset:].view(R, Lc))
    reset_launch_counts()
    got = dram_scan_chunked(*args, banks, k_max, 44.0, 22.0, 0.6016)
    assert launch_counts()["dram_scan"] == 1
    want = dram_scan_plain(*args, banks, k_max, 44.0, 22.0, 0.6016)
    for a, b in zip(got[0] + got[1], want[0] + want[1]):
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b)
    assert float(got[0][0][R // 2]) == 0.0 and not bool(got[1][1][R // 2].any())


# ---------------------------------------------------------------------------
# D3 (the per-access DRAM scan with arrival times)
# ---------------------------------------------------------------------------

def _full_args(cuda, R, L, banks, interval, start, seed, offset=0, lo=0):
    rng = np.random.default_rng(seed)
    arrays = [rng.integers(lo, banks + (1 if lo < 0 else 0), size=(R, L)).astype(np.int32),
              rng.integers(0, 3, size=(R, L)).astype(np.int32),
              (start + np.arange(R * L, dtype=np.float32).reshape(R, L) * interval
               ).astype(np.float32),
              rng.random((R, L)) < 0.85]
    arrays[3][:, L - L // 4:] = False
    arrays[3][R // 2] = False
    args = []
    for a in arrays:
        flat = torch.zeros(a.size + offset, dtype=torch.from_numpy(a).dtype, device=cuda)
        flat[offset:] = torch.from_numpy(a).reshape(-1).to(cuda)
        args.append(flat[offset:].view(R, L))
    return args


def _assert_bitwise(got, want):
    for a, b in zip(got, want):
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b)


@pytest.mark.parametrize("interval,start", [(0.5, 0.0), (0.0, 1000.0), (2.0, 1000.0),
                                            (0.37, 13.3)])
@pytest.mark.parametrize("R,L", [(4, 1), (16, 100), (32, 2048), (40, 100)])
def test_dram_scan_full_kernel_equals_plain_bitwise(cuda, R, L, interval, start):
    """D3 against its plain version: 4, 16, 32 and 40 rows (two blocks), L
    of 1, 100 (not a multiple of 16: copied slot by slot) and 2,048 (16
    full tiles), non-zero interval, start, both and fractional values."""
    args = _full_args(cuda, R, L, 8, interval, start, seed=R * 7 + L)
    reset_launch_counts()
    got = dram_scan_full(*args, 8, 22.0, 44.0, 0.6016)
    counts = launch_counts()
    assert counts["dram_scan_full"] == 1 and counts["dram_prepass"] == 1 and counts["dram_scan"] == 0
    assert dram_scan_full.routes == {"registers": 1, "shared": 0}
    _assert_bitwise(got, dram_scan_full_plain(*args, 8, 22.0, 44.0, 0.6016))
    assert not bool(got[2][R // 2].any()) and float(got[0][R // 2].abs().max()) == 0.0


@pytest.mark.parametrize("R,L,banks,offset,lo", [
    (5, 256, 1, 0, 0), (33, 300, 160, 0, 0), (33, 256, 8, 1, 0), (7, 512, 8, 0, -1),
])
def test_dram_scan_full_kernel_edges(cuda, R, L, banks, offset, lo):
    """Banks 1 and 160 (the most the shared memory holds), inputs one
    element off 16 bytes (copied slot by slot), banks out of range (never a
    hit, no bank state)."""
    args = _full_args(cuda, R, L, banks, 0.75, 5.0, seed=R + L + banks, offset=offset, lo=lo)
    got = dram_scan_full(*args, banks, 22.0, 44.0, 0.6016)
    _assert_bitwise(got, dram_scan_full_plain(*args, banks, 22.0, 44.0, 0.6016))


@pytest.mark.parametrize("lo", [0, -1])
@pytest.mark.parametrize("L", [1, 15, 100, 2048, 5000])
@pytest.mark.parametrize("banks", [8, 16, 17, 160])
def test_dram_scan_full_both_routes_equal_plain(cuda, banks, L, lo):
    """Both routes against the plain version (the pre-pass, then the scan):
    at most 16 banks the registers route (the pre-pass kernel, its codes
    and hits bitwise the plain pre-pass's, then the scan), above it the
    shared route; invalid slots, banks out of range (lo = -1), L of 1, not
    a multiple of 16, and longer than a tile of both routes. Runs of 8
    slots on one bank, as FR-FCFS orders a vector's lines."""
    args = _full_args(cuda, 6, L, banks, 0.37, 13.3, seed=banks * 31 + L, lo=lo)
    runs = args[0].view(6, L)[:, ::8].repeat_interleave(8, dim=1)[:, :L]
    args[0] = args[0].clone()
    args[0][:, :(L // 16) * 8] = runs[:, :(L // 16) * 8]
    reset_launch_counts()
    got = dram_scan_full(*args, banks, 22.0, 44.0, 0.6016)
    route = "registers" if banks <= 16 else "shared"
    assert dram_scan_full.routes == {"registers": 0, "shared": 0, route: 1}
    assert launch_counts()["dram_prepass"] == int(route == "registers")
    _assert_bitwise(got, dram_scan_full_plain(*args, banks, 22.0, 44.0, 0.6016))
    if route == "registers":
        bk, row, _, valid = args
        _assert_bitwise(dram_prepass(bk, row, valid, banks),
                        dram_prepass_plain(bk, row, valid, banks))


def test_dram_scan_full_refuses_what_it_cannot_launch(cuda):
    s = torch.zeros((2, 8), dtype=torch.int32, device=cuda)
    a = torch.zeros((2, 8), dtype=torch.float32, device=cuda)
    v = torch.ones((2, 8), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="banks <= 160"):
        dram_scan_full(s, s, a, v, 161, 22.0, 44.0, 0.6016)
    with pytest.raises(TypeError):
        dram_scan_full(s, s, s, v, 8, 22.0, 44.0, 0.6016)
    assert dram_scan_full(s, s, a, v, 160, 22.0, 44.0, 0.6016)[0].shape == (2, 8)
    with pytest.raises(ValueError, match="t_row_act >= 0"):
        dram_scan_full(s, s, a, v, 8, 22.0, -1.0, 0.6016)
    with pytest.raises(ValueError, match="banks <= 16"):
        dram_prepass(s, s, v, 17)


@pytest.mark.parametrize("kw", [dict(issue_interval_cycles=0.5),
                                dict(issue_interval_cycles=2.0, start_cycle=1000.0),
                                dict(start_cycle=3.3)])
def test_simulate_dram_with_arrivals_on_the_card_equals_cpu(cuda, kw):
    """The arrival route of ``simulate_dram`` and ``dram_timing``: one D3
    launch and one of its pre-pass a call on the card (8 banks), no D1,
    every field equal to the CPU's."""
    import dataclasses

    from repro_torch.core.hardware import tpuv6e
    from repro_torch.core.memory.dram import DramModel, dram_timing, simulate_dram

    rng = np.random.default_rng(3)
    lines = ((rng.integers(0, 40_000, size=900) * 8)[:, None] + np.arange(8)).reshape(-1)
    dm = DramModel.from_hardware(tpuv6e())
    for fn in (simulate_dram, dram_timing):
        reset_launch_counts()
        got = fn(lines, dm, **kw)
        counts = launch_counts()
        assert counts["dram_scan_full"] == 1 and counts["dram_prepass"] == 1
        assert counts["dram_scan"] == 0
        assert dataclasses.asdict(got) == dataclasses.asdict(fn(lines, dm, device="cpu", **kw))


# ---------------------------------------------------------------------------
# D2 (the FIFO / SRRIP row scans)
# ---------------------------------------------------------------------------

RRIP_WAYS = [1, 2, 3, 4, 5, 7, 8, 13, 16, 17, 31, 32, 33, 63, 64]


def _rrip_rows(cuda, B, L, ways, seed, offset=0, max_len=None):
    """Random rows from a small tag space (refills and evictions), some
    valid tags of -1, ragged valid lengths (at most ``max_len``) padded with
    the pad tag -2, an all-padding row; ``offset`` shifts the tensors off
    16 bytes."""
    rng = np.random.default_rng(seed)
    tags = rng.integers(0, 2 * ways + 2, size=(B, L)).astype(np.int32)
    tags[rng.random((B, L)) < 0.03] = -1
    lens = rng.integers(0, (max_len or L) + 1, size=B)
    valid = (np.arange(L)[None, :] < lens[:, None]) & (rng.random((B, L)) < 0.95)
    valid[B // 2] = False
    tags[~valid] = -2
    out = []
    for a in (tags, valid):
        t = torch.from_numpy(a)
        flat = torch.zeros(a.size + offset, dtype=t.dtype, device=cuda)
        flat[offset:] = t.reshape(-1).to(cuda)
        out.append(flat[offset:].view(B, L))
    return out


@pytest.mark.parametrize("policy", ["fifo", "srrip"])
@pytest.mark.parametrize("ways", RRIP_WAYS)
def test_rrip_scan_kernel_equals_plain(cuda, policy, ways):
    """Two blocks of 32 rows (the second partial), L = 200 (not a multiple
    of 16: copied element by element), every instance of ways held (powers
    of two, with and without ways past the real count); the short route,
    one launch."""
    from repro_torch.kernels.rrip_scan import PLAIN, rrip_scan_rows

    rows = _rrip_rows(cuda, 37, 200, ways, seed=ways)
    reset_launch_counts()
    got = rrip_scan_rows(*rows, ways, policy)
    assert launch_counts()["rrip_scan"] == 1
    assert torch.equal(got, PLAIN[policy](*rows, ways))


@pytest.mark.parametrize("policy", ["fifo", "srrip"])
@pytest.mark.parametrize("B,L,ways,offset,max_len", [
    (16, 4096, 4, 0, None),   # a TLB's long rows: the chunked route
    (8, 8, 16, 0, None),      # the shortest rows: one group of 16, half past L
    (3, 1000, 8, 1, None),    # off 16 bytes: copied element by element
    (64, 256, 16, 0, None),   # one full tile, two full blocks
    (1, 1, 1, 0, None),
    (40, 1024, 4, 0, 100),    # rows far shorter than L: groups past them skipped
    (33, 512, 16, 0, 300),
])
def test_rrip_scan_kernel_tiles_and_blocks(cuda, policy, B, L, ways, offset, max_len):
    from repro_torch.kernels.rrip_scan import PLAIN, rrip_scan_rows

    rows = _rrip_rows(cuda, B, L, ways, seed=B * L, offset=offset, max_len=max_len)
    assert torch.equal(rrip_scan_rows(*rows, ways, policy), PLAIN[policy](*rows, ways))


def _chunked_check(rows, ways, policy, **route):
    """The kernel's chunked route against the serial plain version and the
    chunked plain version (hits and re-run count); returns the count."""
    from repro_torch.kernels.rrip_scan import PLAIN, rrip_scan_chunked_plain, rrip_scan_rows

    count = torch.zeros(1, dtype=torch.int32, device=rows[0].device)
    reset_launch_counts()
    got = rrip_scan_rows(*rows, ways, policy, reruns=count, **route)
    assert launch_counts()["rrip_scan"] == 2
    assert torch.equal(got, PLAIN[policy](*rows, ways))
    want, reruns = rrip_scan_chunked_plain(*rows, ways, policy, chunk=route["chunk"],
                                           warmup=route["warmup"])
    assert torch.equal(got, want) and int(count) == reruns
    return reruns


@pytest.mark.parametrize("policy", ["fifo", "srrip"])
@pytest.mark.parametrize("ways", RRIP_WAYS)
@pytest.mark.parametrize("case", ["warm-up 16", "no warm-up", "warm-up 40", "hot rows",
                                  "chunks of 80"])
def test_rrip_scan_chunked_kernel_equals_plain(cuda, policy, ways, case):
    """The chunked route (speculate + fix-up) at every instance: rows of
    300 steps in chunks of 32 (a ragged last chunk), 16-step and 40-step
    warm-ups (off 16: leading steps not walked), and re-runs forced by no
    warm-up or by rows of 3 tags that mostly hit, off 16 bytes; chunks of
    80 re-run in pieces of 32, 32 and 16 steps."""
    offset, space, warmup, chunk = {
        "warm-up 16": (0, None, 16, 32), "no warm-up": (0, None, 0, 32),
        "warm-up 40": (0, None, 40, 32), "hot rows": (1, 3, 8, 32),
        "chunks of 80": (0, None, 0, 80)}[case]
    rows = _rrip_rows(cuda, 13, 300, ways, seed=7 * ways, offset=offset)
    if space:
        rows[0].copy_(torch.where(rows[1], rows[0] % space, rows[0]))
    reruns = _chunked_check(rows, ways, policy, chunk=chunk, warmup=warmup, long_row=64)
    if warmup == 0 and ways > 1:
        assert reruns > 0


@pytest.fixture(scope="module")
def full_size_streams():
    """The full-width DLRM-RMC2 x tpuv6e() streams D2 sees: the lane stream
    of the on-chip cache, and the page streams of a FIFO TLB (entries 64,
    ways 4) and its L2 (1,024 entries, 8 ways) behind spm/stack."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch.core import dlrm_rmc2_small, tpuv6e
    from repro_torch.core.engine import build_embedding_traces
    from repro_torch.core.memory.system import MemorySystem, lane_geometry
    from repro_torch.core.memory.tlb import classify_tlb, tlb_pages

    hw = tpuv6e().with_policy("spm").with_translation(
        entries=64, ways=4, l2_entries=1024, replacement="fifo")
    etrace = build_embedding_traces(dlrm_rmc2_small(num_batches=2))[0]
    lane = lane_geometry(hw, etrace.spec)
    cs = MemorySystem.from_hardware(hw, "cuda").classify_embedding(etrace)
    tr = hw.translation
    pages = tlb_pages(cs.miss_lines, hw.onchip.line_bytes, tr.page_bytes)
    l1 = classify_tlb(pages, tr.num_sets, tr.ways, "fifo", device="cuda")
    return {"onchip": (etrace.vec_ids, lane.num_sets, lane.ways),
            "tlb_l1": (pages, tr.num_sets, tr.ways),
            "tlb_l2": (pages[~l1], tr.l2_num_sets, tr.l2_ways)}


@pytest.mark.parametrize("stream,policy,launches", [
    ("onchip", "srrip", 1), ("onchip", "fifo", 1), ("tlb_l1", "fifo", 2), ("tlb_l2", "fifo", 2),
    ("tlb_l1", "srrip", 2)])
def test_rrip_scan_kernel_equals_plain_full_size(cuda, full_size_streams, stream, policy,
                                                 launches):
    """The one call of D2 that classifying each full-size stream makes (the
    on-chip buckets in one launch; a TLB level on the chunked route) against
    the serial plain version and the plain version of its route (hits and
    re-run count)."""
    from repro_torch.core.memory.rrip import row_plan
    from repro_torch.kernels.rrip_scan import PLAIN, rrip_scan_flat

    lines, num_sets, ways = full_size_streams[stream]
    tags, valid, groups = row_plan(lines, num_sets, ways, policy)
    (base, table), = groups
    assert base == 0 and table.total == tags.size
    count = torch.zeros(1, dtype=torch.int32, device=cuda)
    reset_launch_counts()
    got = rrip_scan_flat(torch.from_numpy(tags).to(cuda), torch.from_numpy(valid).to(cuda),
                         table, policy, reruns=count).cpu()
    assert launch_counts()["rrip_scan"] == launches
    t, v = torch.from_numpy(tags), torch.from_numpy(valid)
    cpu_count = torch.zeros(1, dtype=torch.int32)
    assert torch.equal(got, rrip_scan_flat(t, v, table, policy, reruns=cpu_count))
    assert int(count) == int(cpu_count)
    at = torch.from_numpy(table.off)[:, None] + torch.arange(table.max_len)[None, :]
    inr = at < torch.from_numpy(table.off + table.length)[:, None]
    at = at.clamp(max=table.total - 1)
    want = PLAIN[policy](t[at].to(cuda), (v[at] & inr).to(cuda), ways).cpu()
    assert torch.equal(got[at[inr]], want[inr])


def test_kernels_refuse_what_they_do_not_take(cuda):
    s = torch.zeros((2, 8), dtype=torch.int32, device=cuda)
    v = torch.ones((2, 8), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="ways <= 64"):
        cache_scan_groups(s, s, v, 16, 4096, "lru")
    # K2 takes K1's limits: at most 64 ways, at most 1,024 threads of teams
    with pytest.raises(ValueError, match="ways <= 64"):
        stack_distance_groups(s, s, v, 16, 65)
    with pytest.raises(ValueError, match="num_sets x team <= 1024"):
        stack_distance_groups(s, s, v, 33, 64)
    with pytest.raises(ValueError, match="num_sets x team <= 1024"):
        stack_distance_groups(s, s, v, 65, 16)
    assert stack_distance_groups(s, s, v, 64, 16)[0].shape == (2, 8)
    with pytest.raises(ValueError, match="k_max <= 8"):
        dram_scan_chunked(s, s, s, v, 8, 9, 44.0, 22.0, 0.6016)
    from repro_torch.kernels.rrip_scan import rrip_scan_rows
    with pytest.raises(ValueError, match="ways <= 64"):
        rrip_scan_rows(s, v, 65, "srrip")
    assert rrip_scan_rows(s, v, 64, "fifo").shape == (2, 8)
    with pytest.raises(ValueError, match="contiguous"):
        cache_scan_groups(s.t().contiguous().t(), s, v, 1, 1, "lru")
    with pytest.raises(ValueError, match="devices|on cpu|cuda"):
        stack_distance_groups(s, s.cpu(), v, 1, 1)


@pytest.mark.parametrize("policy,backend,kernel,translation,n_rrip", [
    ("lru", "pallas", "cache_scan", None, 0), ("srrip", "pallas", "cache_scan", None, 0),
    ("fifo", "pallas", "cache_scan", None, 0),
    ("lru", "stack_pallas", "stack_distance", None, 0),
    ("lru", "stack", None, None, 0), ("spm", "stack", None, None, 0),
    ("srrip", "scan", None, None, 0), ("srrip", "stack", "rrip_scan", None, 1),
    ("fifo", "stack_pallas", "rrip_scan", None, 1), ("lru", "stack", None, "lru", 0),
    ("spm", "stack", "rrip_scan", "fifo", 2), ("srrip", "stack", "rrip_scan", "fifo", 3),
])
def test_simulate_on_the_card_equals_cpu(cuda, policy, backend, kernel, translation, n_rrip):
    """Launch counts of a small run (D2: one launch per classification, as
    its rows are short: the on-chip cache, then the TLB's L1 and L2)."""
    import dataclasses

    from repro_torch.core import dlrm_rmc2_small, simulate, tpuv6e

    wl = dlrm_rmc2_small(num_tables=2, rows_per_table=300, batch_size=2, num_batches=2)
    hw = tpuv6e().with_policy(policy, capacity_bytes=1 << 14, ways=3).with_cache_backend(backend)
    if translation:
        hw = hw.with_translation(entries=16, ways=4, l2_entries=64, replacement=translation)
    reset_launch_counts()
    on_card = simulate(wl, hw)
    counts = launch_counts()
    assert counts["dram_scan"] == 1
    for name in ("cache_scan", "stack_distance", "rrip_scan"):
        assert (counts[name] > 0) == (name == kernel), counts
    assert counts["rrip_scan"] == n_rrip, counts
    assert dataclasses.asdict(on_card) == dataclasses.asdict(simulate(wl, hw, device="cpu"))


# ---------------------------------------------------------------------------
# K3, K4, K5 (the embedding kernels)
# ---------------------------------------------------------------------------

DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _bits(x):
    return x.float().view(torch.int32)


def _table(cuda, rows, D, dtype, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return torch.randn((rows, D), generator=g, device=cuda).to(DT[dtype])


def _ints(cuda, lo, hi, shape, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(lo, hi, size=shape).astype(np.int32)).to(cuda)


@pytest.mark.parametrize("dtype", sorted(DT))
@pytest.mark.parametrize("rows,D,B,T,L", [
    (500, 128, 8, 6, 40), (300, 200, 3, 4, 9), (64, 32, 5, 3, 1), (90, 33, 2, 2, 130),
    (1000, 256, 2, 3, 17), (50, 1, 4, 1, 3), (40, 64, 2, 2, 0),
])
def test_embedding_bag_kernel_equals_plain_bitwise(cuda, rows, D, B, T, L, dtype):
    table = _table(cuda, rows, D, dtype)
    idx = _ints(cuda, -rows - 2, rows + 5, (B, T, L))        # some outside: clamped alike
    reset_launch_counts()
    got = embedding_bag_kernel(table, idx)
    assert launch_counts()["embedding_bag"] == 1
    want = embedding_bag_plain(table, idx)
    torch.cuda.synchronize()
    assert got.dtype == table.dtype and got.shape == (B, T, D)
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("L", [1, 31, 32, 33, 120, 300])
@pytest.mark.parametrize("D", [1, 3, 4, 100, 128, 200, 256, 512])
@pytest.mark.parametrize("dtype", sorted(DT))
def test_embedding_bag_warp_per_bag_bitwise(cuda, dtype, D, L, offset):
    """K3, one warp per bag: 4 consecutive columns a lane (one 16- or
    8-byte load a row) where D % 4 == 0 and the table is aligned, scalar
    columns where it is not (D 1/3/100-with-offset, a view one element
    off), one to four 128-column passes, L inside one block of 32 indices,
    at its edge and over several; indices negative or past the table
    (clamped as the reference clamps)."""
    rows, B, T = 300, 40, 25
    table = _table(cuda, rows + 1, D, dtype, seed=D).view(-1)[offset:offset + rows * D]
    table = table.view(rows, D)
    idx = _ints(cuda, -rows - 2, rows + 5, (B, T, L), seed=L)
    reset_launch_counts()
    got = embedding_bag_kernel(table, idx)
    assert launch_counts()["embedding_bag"] == 1
    want = embedding_bag_plain(table, idx)
    torch.cuda.synchronize()
    assert got.dtype == table.dtype and got.shape == (B, T, D)
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("D", [128, 3])
def test_embedding_bag_grid_stride(cuda, D):
    """More bags (40,000) than the card holds warps at once: the grid is
    what the card holds and each warp takes several bags in turn."""
    table = _table(cuda, 1000, D, "float32")
    idx = _ints(cuda, 0, 1000, (400, 100, 5), seed=D)
    reset_launch_counts()
    got = embedding_bag_kernel(table, idx)
    assert launch_counts()["embedding_bag"] == 1
    assert torch.equal(_bits(got), _bits(embedding_bag_plain(table, idx)))


@pytest.mark.parametrize("dtype", sorted(DT))
@pytest.mark.parametrize("D", [128, 200, 33, 1, 8])
@pytest.mark.parametrize("offset", [0, 1])
def test_embedding_gather_kernel_equals_plain_bitwise(cuda, D, dtype, offset):
    # offset 1 starts the table one row in, so the 16-byte copy path is not
    # always the one taken.
    table = _table(cuda, 301, D, dtype)[offset:]
    idx = _ints(cuda, -5, table.shape[0] + 5, (777,), seed=D)
    reset_launch_counts()
    got = embedding_gather_kernel(table, idx)
    assert launch_counts()["embedding_gather"] == 1
    want = embedding_gather_plain(table, idx)
    torch.cuda.synchronize()
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("dtype", sorted(DT))
@pytest.mark.parametrize("H,D,B,T,L", [
    (256, 128, 8, 6, 40), (1, 128, 2, 3, 5), (37, 200, 3, 2, 9), (16, 32, 4, 5, 1),
    (1024, 128, 4, 6, 50), (600, 200, 2, 3, 30),
])
def test_vmem_gather_pool_kernel_equals_plain(cuda, H, D, B, T, L, dtype):
    hot = _table(cuda, H, D, dtype, seed=H)
    pos = _ints(cuda, 0, H, (B, T, L), seed=1)
    mask = _ints(cuda, 0, 2, (B, T, L), seed=2)
    reset_launch_counts()
    got = vmem_gather_pool_kernel(hot, pos, mask)
    assert launch_counts()["vmem_gather_pool"] == 1
    want = vmem_gather_pool_plain(hot, pos, mask)
    torch.cuda.synchronize()
    tiles = -(-H // vmem_tile_rows(D * hot.element_size()))
    if tiles == 1:
        assert torch.equal(_bits(got), _bits(want))
    else:
        # the kernel sums tile by tile: the same terms, another order
        tol = 1e-5 if dtype == "float32" else 5e-2
        torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", sorted(DT))
@pytest.mark.parametrize("D", [1, 3, 100, 128, 256])
@pytest.mark.parametrize("B,T,L", [(4, 6, 40), (50, 100, 3), (1921, 1, 7)])
def test_vmem_gather_pool_warp_per_bag_bitwise(cuda, D, B, T, L, dtype):
    """One warp per bag: every D (vector and scalar columns, one and two
    passes), bag counts that leave a block's warps part-filled (5,000 and
    1,921 bags), and positions outside the table (clamped as the reference
    clamps), bit for bit."""
    H = 64
    hot = _table(cuda, H, D, dtype, seed=D)
    pos = _ints(cuda, -H - 3, H + 5, (B, T, L), seed=3)
    mask = _ints(cuda, 0, 2, (B, T, L), seed=4)
    reset_launch_counts()
    got = vmem_gather_pool_kernel(hot, pos, mask)
    assert launch_counts()["vmem_gather_pool"] == 1
    want = vmem_gather_pool_plain(hot, pos, mask)
    torch.cuda.synchronize()
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("dtype", sorted(DT))
def test_vmem_gather_pool_multi_tile(cuda, dtype):
    """A hot table larger than one block's shared memory: the kernel sums
    tile by tile (the same terms, grouped by tile), through f32 scratch."""
    D = 256
    H = 3 * vmem_tile_rows(D * torch.empty((), dtype=DT[dtype]).element_size()) // 2
    hot = _table(cuda, H, D, dtype, seed=5)
    pos = _ints(cuda, 0, H, (6, 7, 45), seed=6)
    mask = _ints(cuda, 0, 2, (6, 7, 45), seed=7)
    got = vmem_gather_pool_kernel(hot, pos, mask)
    want = vmem_gather_pool_plain(hot, pos, mask)
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == "float32" else 5e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_vmem_tile_rows_is_the_cards_opt_in_shared_memory(cuda):
    # 232,448 bytes on an H100 where torch does not report it
    optin = getattr(torch.cuda.get_device_properties(0), "shared_memory_per_block_optin", 232448)
    assert vmem_tile_rows(512) == optin // 512
    assert 1 < -(-1024 // vmem_tile_rows(128 * 4))       # 1024 x 128 f32 takes several tiles
    assert -(-256 // vmem_tile_rows(128 * 4)) == 1       # the main path's hot table: one


def test_embedding_kernels_refuse_what_they_do_not_take(cuda):
    t = torch.zeros((4, 8), device=cuda)
    i3 = torch.zeros((1, 2, 3), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="devices|on cpu|cuda"):
        embedding_bag_kernel(t, i3.cpu())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        vmem_gather_pool_kernel(t.half(), i3, i3)
    with pytest.raises(ValueError, match="exceeds"):
        vmem_gather_pool_kernel(torch.zeros((2, 1 << 17), device=cuda), i3, i3)


@pytest.mark.parametrize("pinned", [False, True])
def test_dlrm_forward_on_the_card_equals_cpu(cuda, pinned):
    from repro_torch.data import DLRMDataConfig, dlrm_batch
    from repro_torch.kernels import ops
    from repro_torch.models import DLRM, smoke_config

    cfg = smoke_config()
    on_cpu = DLRM(cfg, device="cpu")
    on_card = DLRM(cfg, device=cuda)
    on_card.load_state_dict(on_cpu.state_dict())
    batch = dlrm_batch(DLRMDataConfig(cfg.num_tables, cfg.rows_per_table,
                                      cfg.lookups_per_table, batch_size=8, zipf_s=1.1), 0)
    args = [torch.from_numpy(batch[k]) for k in ("dense", "sparse")]
    kw_cpu, kw_card = {}, {}
    if pinned:
        hot_ids = np.unique(batch["sparse"][:, 0].reshape(-1))[:12].astype(np.int64)
        pos, mask = ops.split_hot_cold(batch["sparse"], hot_ids, cfg.rows_per_table)
        for kw, model in ((kw_cpu, on_cpu), (kw_card, on_card)):
            dev = model.tables.device
            kw["pinned"] = {"hot_table": ops.embedding_gather(model.tables,
                                                              torch.from_numpy(hot_ids).to(dev)),
                            "positions": torch.from_numpy(pos).to(dev),
                            "mask": torch.from_numpy(mask).to(dev)}
    want = on_cpu(*args, **kw_cpu)
    reset_launch_counts()
    got = on_card(*[a.to(cuda) for a in args], **kw_card)
    counts = launch_counts()
    expect = {"vmem_gather_pool": 1, "embedding_gather": 1} if pinned else {"embedding_bag": 1}
    assert counts == {k: expect.get(k, 0) for k in counts}
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# K6, K7, K8 (the LM kernels), at the reference's tolerances
# ---------------------------------------------------------------------------

LM_TOL = {"float32": dict(atol=2e-5, rtol=2e-5), "bfloat16": dict(atol=3e-2, rtol=0.0)}


def _randn(cuda, shape, dtype, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return torch.randn(shape, generator=g, device=cuda).to(DT[dtype])


@pytest.mark.parametrize("dtype", sorted(DT))
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,Hq,Hkv,S,d", [
    (2, 32, 32, 256, 80),      # Zamba2's heads
    (2, 8, 2, 300, 64),        # GQA, ragged S
    (1, 4, 1, 200, 128),       # MQA
    (1, 2, 2, 77, 256),        # the widest head
    (1, 3, 3, 1, 16),          # one position
    (1, 2, 2, 129, 80),        # a q tile that straddles S
    (1, 4, 1, 1000, 80),       # a ragged last TMA box
    (1, 3, 3, 200, 72),        # d padded to the wgmma depth (a multiple of 16)
])
def test_flash_attention_kernel_equals_plain(cuda, B, Hq, Hkv, S, d, causal, dtype):
    from repro_torch.kernels.flash_attention import flash_attention_kernel, flash_attention_plain

    q = _randn(cuda, (B, Hq, S, d), dtype, 1)
    k = _randn(cuda, (B, Hkv, S, d), dtype, 2)
    v = _randn(cuda, (B, S, Hkv, d), dtype, 3).transpose(1, 2)   # a strided view, as in prefill
    reset_launch_counts()
    got = flash_attention_kernel(q, k, v, causal=causal)
    assert launch_counts()["flash_attention"] == 1
    want = flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert got.shape == q.shape and got.dtype == q.dtype
    torch.testing.assert_close(got.float(), want.float(), **LM_TOL[dtype])


@pytest.mark.parametrize("dtype", sorted(DT))
@pytest.mark.parametrize("B,Hq,Hkv,S,Sk,d,causal", [
    (8, 8, 8, 64, 1500, 64, False),    # Whisper-base's cross-attention of a prompt
    (8, 8, 8, 1500, 1500, 64, False),  # its encoder, ragged
    (2, 8, 8, 1, 1500, 64, False),     # one query row
    (1, 4, 2, 100, 129, 64, False),    # Sk one past a tile
    (1, 4, 2, 130, 64, 80, False),     # Sk shorter than Sq
    (2, 16, 16, 300, 300, 192, True),  # MLA's q/k width (DeepSeek-V2)
    (2, 16, 16, 300, 300, 192, False),
    (1, 56, 8, 200, 200, 128, True),   # arctic's group of 7
    (1, 48, 1, 200, 200, 128, True),   # granite's MQA, a group of 48
])
def test_flash_attention_other_key_lengths_and_widths(cuda, B, Hq, Hkv, S, Sk, d, causal, dtype):
    from repro_torch.kernels.flash_attention import flash_attention_kernel, flash_attention_plain

    q = _randn(cuda, (B, Hq, S, d), dtype, 1)
    k = _randn(cuda, (B, Hkv, Sk, d), dtype, 2)
    v = _randn(cuda, (B, Sk, Hkv, d), dtype, 3).transpose(1, 2)
    reset_launch_counts()
    got = flash_attention_kernel(q, k, v, causal=causal)
    assert launch_counts()["flash_attention"] == 1
    want = flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), **LM_TOL[dtype])


@pytest.mark.parametrize("layout", ["views", "odd-strides"])
@pytest.mark.parametrize("Hq,Hkv", [(8, 2), (4, 1)])
@pytest.mark.parametrize("causal,Sk", [(True, 131), (False, 131), (False, 77)])
@pytest.mark.parametrize("d", [16, 64, 80, 128, 192, 256])
def test_flash_attention_f32_route_holds_2e5(cuda, d, causal, Sk, Hq, Hkv, layout):
    """K6's f32 route (3xTF32 on the tensor cores) against the plain version
    at the reference's 2e-5: every tile width (d 16 to 256), causal and
    not, Sk != S, GQA 4:1 and MQA, S = 131 (no multiple of any tile), v a
    transposed view; with odd strides (k a slice of a row of d + 3) the
    copies fall back to 4 bytes."""
    from repro_torch.kernels.flash_attention import flash_attention_kernel, flash_attention_plain

    S = 131
    q = _randn(cuda, (2, Hq, S, d), "float32", 1)
    k = _randn(cuda, (2, Hkv, Sk, d + (3 if layout == "odd-strides" else 0)), "float32", 2)
    k = k[..., :d]
    v = _randn(cuda, (2, Sk, Hkv, d), "float32", 3).transpose(1, 2)
    reset_launch_counts()
    got = flash_attention_kernel(q, k, v, causal=causal)
    assert flash_attention_kernel.routes == {"wgmma": 0, "tf32": 1}
    want = flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert got.shape == q.shape and got.dtype == torch.float32
    torch.testing.assert_close(got, want, **LM_TOL["float32"])


@pytest.mark.parametrize("dtype", sorted(DT))
def test_mla_attention_pads_v_for_the_kernel(cuda, dtype):
    """ops.flash_attention with dv 128 < dq 192: K6 on v padded with zeros,
    the output sliced back, equal to the plain version on the unpadded v."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import (
        flash_attention_bf16p_plain, flash_attention_plain)

    q, k = (_randn(cuda, (2, 16, 256, 192), dtype, i) for i in (1, 2))
    v = _randn(cuda, (2, 16, 256, 128), dtype, 3)
    reset_launch_counts()
    got = ops.flash_attention(q, k, v, causal=True)
    assert launch_counts()["flash_attention"] == 1 and got.shape == (2, 16, 256, 128)
    plain = flash_attention_bf16p_plain if dtype == "bfloat16" else flash_attention_plain
    torch.testing.assert_close(got.float(), plain(q, k, v, causal=True).float(),
                               **LM_TOL[dtype])


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_attention_routes_by_dtype(cuda, dtype):
    """bf16 goes to the wgmma kernel, f32 to the 3xTF32 one."""
    from repro_torch.kernels.flash_attention import flash_attention_kernel

    q, k, v = (_randn(cuda, (1, 2, 128, 64), dtype, i) for i in range(3))
    reset_launch_counts()
    flash_attention_kernel(q, k, v)
    route = "wgmma" if dtype == "bfloat16" else "tf32"
    assert flash_attention_kernel.routes == {"wgmma": 0, "tf32": 0, route: 1}
    assert launch_counts()["flash_attention"] == 1


def test_flash_attention_copies_strides_tma_cannot_read(cuda):
    """A k whose s-stride (84 elements, 168 bytes) breaks TMA's 16-byte rule
    is copied by the wrapper; the tensor-core route still runs."""
    from repro_torch.kernels.flash_attention import flash_attention_kernel, flash_attention_plain

    B, H, S, d = 2, 4, 300, 80
    q = _randn(cuda, (B, H, S, d), "bfloat16", 1)
    k = _randn(cuda, (B, H, S, d + 4), "bfloat16", 2)[..., :d]
    v = _randn(cuda, (B, S, H, d), "bfloat16", 3).transpose(1, 2)
    assert k.stride(2) * k.element_size() % 16 != 0
    reset_launch_counts()
    got = flash_attention_kernel(q, k, v, causal=True)
    assert flash_attention_kernel.routes["wgmma"] == 1
    want = flash_attention_plain(q, k, v, causal=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **LM_TOL["bfloat16"])


@pytest.mark.parametrize("dtype", sorted(DT))
@pytest.mark.parametrize("B,Hq,Hkv,S_max,d,valid", [
    (2, 32, 32, 1064, 80, 1056),   # Zamba2's last decode step
    (2, 32, 32, 1064, 80, CHUNK),  # the cache ends at a chunk's end
    (2, 32, 32, 1064, 80, CHUNK + 1),  # one position into the second chunk
    (2, 32, 32, 1064, 80, 1),      # one chunk of one row, the rest empty
    (2, 8, 2, 300, 64, 1),
    (2, 8, 2, 300, 64, 100),       # mid-tile
    (2, 4, 1, 1000, 128, 1000),    # full cache, MQA
    (1, 32, 4, 77, 80, 77),
    (1, 16, 1, 64, 256, 64),       # 16 heads of 256 on one kv head
    (2, 48, 1, 1064, 128, 1056),   # granite's MQA: 48 heads of 128 on one kv head
    (2, 56, 8, 1064, 128, 1056),   # arctic's group of 7
    (8, 8, 8, 1500, 64, 1500),     # Whisper-base's cross-attention of one token
])
def test_decode_attention_kernel_equals_plain(cuda, B, Hq, Hkv, S_max, d, valid, dtype):
    from repro_torch.kernels.decode_attention import decode_attention_kernel, decode_attention_plain

    q = _randn(cuda, (B, Hq, d), dtype, 1)
    k = _randn(cuda, (B, Hkv, S_max, d), dtype, 2)
    v = _randn(cuda, (B, Hkv, S_max, d), dtype, 3)
    reset_launch_counts()
    got = decode_attention_kernel(q, k, v, valid)
    assert launch_counts()["decode_attention"] == 1
    want = decode_attention_plain(q, k, v, valid)
    torch.cuda.synchronize()
    tol = LM_TOL[dtype] if dtype == "float32" else dict(atol=4e-2, rtol=0.0)
    torch.testing.assert_close(got.float(), want.float(), **tol)
    # the cache past valid_len is never read
    k[:, :, valid:] = float("nan")
    v[:, :, valid:] = float("nan")
    assert torch.equal(decode_attention_kernel(q, k, v, valid), got)


@pytest.mark.parametrize("dtype", sorted(DT))
@pytest.mark.parametrize("B,H,S,P,N,chunk", [
    (2, 8, 1024, 64, 64, 128),     # Zamba2's SSD shape, fewer heads
    (2, 4, 300, 32, 128, 128),     # N = 128 (chunk: f32 64, bf16 128), ragged
    (1, 3, 100, 16, 16, 16),
    (2, 8, 200, 64, 64, 64),       # ragged last chunk
    (1, 2, 5, 64, 64, 128),        # shorter than one chunk
])
def test_mamba2_ssd_kernel_equals_plain(cuda, B, H, S, P, N, chunk, dtype):
    from repro_torch.kernels.mamba2_ssd import mamba2_ssd_kernel, mamba2_ssd_plain

    xbc = _randn(cuda, (B, S, H * P + 2 * N), dtype, 1)
    x = xbc[..., :H * P].reshape(B, S, H, P).transpose(1, 2)      # as the Mamba2 block hands it
    dt = torch.nn.functional.softplus(_randn(cuda, (B, S, H), "float32", 2)).transpose(1, 2)
    adt = -torch.linspace(1.0, 16.0, H, device=cuda)[None, :, None] * dt
    Bm, C = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
    reset_launch_counts()
    got = mamba2_ssd_kernel(x, adt, dt, Bm, C, chunk=chunk)
    assert launch_counts()["mamba2_ssd"] == 1
    route = "mma" if dtype == "bfloat16" else "tf32"
    assert mamba2_ssd_kernel.routes == {"mma": 0, "tf32": 0, route: 1}
    want = mamba2_ssd_plain(x, adt, dt, Bm, C, chunk)
    torch.cuda.synchronize()
    assert got.shape == x.shape and got.dtype == x.dtype
    # bf16: both round the same f32 value once, so at most one bf16 step apart
    rtol = 2e-3 if dtype == "float32" else 2.0 ** -7
    torch.testing.assert_close(got.float(), want.float(), atol=2e-4, rtol=rtol)


def test_mamba2_ssd_smem_matches_its_python_twin(cuda):
    from repro_torch.kernels import mamba2_ssd as m

    fn = m.load_library("mamba2_ssd").mamba2_ssd_smem_bytes
    fn.restype = ctypes.c_int64
    for Q, ps, N in ((64, 64, 64), (128, 64, 64), (32, 64, 128), (16, 16, 16), (112, 32, 128)):
        assert fn(Q, ps, N) == m.smem_bytes(Q, ps, N)


def _ssd_views(cuda, B, H, S, P, N, dtype, pad=0, seed=1):
    """x, adt, dt, B, C as the Mamba2 block hands them (x a transpose of a
    slice of one projection, B and C column slices of it, dt (B, S, H) in
    memory); ``pad`` extra leading columns shift every view."""
    xbc = _randn(cuda, (B, S, pad + H * P + 2 * N), dtype, seed)[..., pad:]
    x = xbc[..., :H * P].reshape(B, S, H, P).transpose(1, 2)
    dt = torch.nn.functional.softplus(_randn(cuda, (B, S, H), "float32", seed + 1)).transpose(1, 2)
    adt = -torch.linspace(1.0, 16.0, H, device=cuda)[None, :, None] * dt
    return x, adt, dt, xbc[..., H * P:H * P + N], xbc[..., H * P + N:]


def _ssd_check(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    torch.testing.assert_close(got.float(), want.float(), atol=2e-4, rtol=2.0 ** -7)


@pytest.mark.parametrize("ps", [16, 32, 64])
@pytest.mark.parametrize("P", [16, 32, 48, 64])
def test_mamba2_ssd_bf16_p_slices(cuda, monkeypatch, P, ps):
    """Every P-slice width against every head dim: P_SLICE as the wrapper
    runs it (64) and as scripts/ssd_ablation.py sets it (32, 16)."""
    from repro_torch.kernels import mamba2_ssd as m

    monkeypatch.setattr(m, "P_SLICE", ps)
    args = _ssd_views(cuda, 2, 3, 300, P, 64, "bfloat16")
    reset_launch_counts()
    got = m.mamba2_ssd_kernel(*args, chunk=128)
    assert m.mamba2_ssd_kernel.routes == {"mma": 1, "tf32": 0}
    _ssd_check(got, m.mamba2_ssd_plain(*args, 128))


@pytest.mark.parametrize("B,H,S,P,N,chunk,pad", [
    (8, 80, 1024, 64, 64, 128, 0),   # Zamba2-2.7B's prefill, all 80 heads
    (2, 4, 300, 32, 128, 128, 0),    # N = 128 at a chunk of 128, ragged
    (1, 3, 100, 16, 16, 16, 0),
    (2, 2, 257, 32, 32, 100, 0),     # a chunk that is no multiple of 16
    (1, 2, 5, 64, 64, 128, 0),       # S < Q
    (2, 3, 200, 64, 64, 64, 4),      # rows 8 bytes off 16: the wrapper copies them
    (1, 2, 130, 24, 40, 128, 0),     # P and N padded to 32 and 64
])
def test_mamba2_ssd_bf16_route_edges(cuda, B, H, S, P, N, chunk, pad):
    from repro_torch.kernels.mamba2_ssd import mamba2_ssd_kernel, mamba2_ssd_plain

    args = _ssd_views(cuda, B, H, S, P, N, "bfloat16", pad)
    reset_launch_counts()
    got = mamba2_ssd_kernel(*args, chunk=chunk)
    assert launch_counts()["mamba2_ssd"] == 1
    assert mamba2_ssd_kernel.routes == {"mma": 1, "tf32": 0}
    _ssd_check(got, mamba2_ssd_plain(*args, chunk))


@pytest.mark.parametrize("S,Q", [(1024, 128), (300, 128), (257, 100), (5, 5)])
def test_mamba2_ssd_cumsum_prepass_is_the_in_order_sum(cuda, S, Q):
    """The bf16 route's pre-pass equals its plain twin (the in-order chunk
    cumsum) bit for bit, and copies dt."""
    from repro_torch.kernels import mamba2_ssd as m

    _, adt, dt, _, _ = _ssd_views(cuda, 2, 5, S, 16, 16, "bfloat16")
    cum = torch.empty((2, 5, S), device=cuda)
    dto = torch.empty_like(cum)
    fn = m._fn("mamba2_ssd_cumsum_launch")
    strides = (ctypes.c_int64 * 6)(*adt.stride(), *dt.stride())
    err = fn(adt.data_ptr(), dt.data_ptr(), strides, 2, 5, S, Q, cum.data_ptr(), dto.data_ptr(),
             torch.cuda.current_stream().cuda_stream)
    assert err == 0
    torch.cuda.synchronize()
    assert torch.equal(cum.view(torch.int32), m.chunk_cumsum_plain(adt, Q).view(torch.int32))
    assert torch.equal(dto, dt)


def test_mamba2_ssd_mma_smem_matches_its_python_twin(cuda):
    from repro_torch.kernels import mamba2_ssd as m

    fn = m.load_library("mamba2_ssd").mamba2_ssd_mma_smem_bytes
    fn.restype = ctypes.c_int64
    for Q, ps, N in ((128, 32, 64), (128, 64, 128), (16, 16, 16), (112, 16, 32)):
        assert fn(Q, ps, N) == m.mma_smem_bytes(Q, ps, N)


def test_mamba2_ssd_two_blocks_per_sm_at_zamba2(cuda):
    from repro_torch.kernels.mamba2_ssd import blocks_per_sm, kernel_chunk

    assert blocks_per_sm(128, 64, 64) >= 2
    assert blocks_per_sm(kernel_chunk(128, 1024, 64, 64), 64, 64, torch.float32) >= 2


def _tf32_check(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype == torch.float32
    torch.testing.assert_close(got, want, atol=2e-4, rtol=2e-3)


@pytest.mark.parametrize("ps", [16, 32, 64])
@pytest.mark.parametrize("P", [16, 32, 48, 64])
def test_mamba2_ssd_tf32_p_slices(cuda, monkeypatch, P, ps):
    """The f32 route at every P-slice width against every head dim:
    P_SLICE as the wrapper runs it (64) and as scripts/ssd_ablation.py sets
    it (32, 16); the chunk, and the plain version's, follow it."""
    from repro_torch.kernels import mamba2_ssd as m

    monkeypatch.setattr(m, "P_SLICE", ps)
    args = _ssd_views(cuda, 2, 3, 300, P, 64, "float32")
    reset_launch_counts()
    got = m.mamba2_ssd_kernel(*args, chunk=128)
    assert m.mamba2_ssd_kernel.routes == {"mma": 0, "tf32": 1}
    _tf32_check(got, m.mamba2_ssd_plain(*args, 128))


@pytest.mark.parametrize("B,H,S,P,N,chunk,pad", [
    (8, 80, 1024, 64, 64, 128, 0),   # Zamba2-2.7B's prefill, all 80 heads (chunk 64)
    (2, 4, 300, 32, 128, 128, 0),    # N = 128, ragged
    (1, 3, 100, 16, 16, 16, 0),
    (2, 2, 257, 32, 32, 100, 0),     # a chunk that is no multiple of 16
    (1, 2, 5, 64, 64, 128, 0),       # S < Q
    (1, 2, 130, 64, 64, 128, 0),     # one row past the kernel's chunks
    (2, 3, 200, 64, 64, 64, 1),      # rows 4 bytes off 16: the wrapper copies them
    (2, 3, 200, 64, 64, 64, 2),      # rows 8 bytes off 16
    (1, 2, 130, 24, 40, 128, 0),     # P and N padded to 32 and 64
    (1, 2, 64, 64, 64, 1, 0),        # a chunk of one step
])
def test_mamba2_ssd_tf32_route_edges(cuda, B, H, S, P, N, chunk, pad):
    from repro_torch.kernels.mamba2_ssd import mamba2_ssd_kernel, mamba2_ssd_plain

    args = _ssd_views(cuda, B, H, S, P, N, "float32", pad)
    reset_launch_counts()
    got = mamba2_ssd_kernel(*args, chunk=chunk)
    assert launch_counts()["mamba2_ssd"] == 1
    assert mamba2_ssd_kernel.routes == {"mma": 0, "tf32": 1}
    _tf32_check(got, mamba2_ssd_plain(*args, chunk))


def test_mamba2_ssd_tf32_large_decays(cuda):
    """adt up to -16 a step takes the chunk's cumsum near -1,000, where a
    tree-order sum parts from the in-order one: the pre-pass adds in order,
    as the plain version does, so the f32 route holds its tolerance."""
    from repro_torch.kernels.mamba2_ssd import kernel_chunk, mamba2_ssd_kernel, mamba2_ssd_plain

    x, _, dt, Bm, C = _ssd_views(cuda, 2, 4, 512, 64, 64, "float32")
    dt = torch.full_like(dt, 1.0)
    adt = -torch.linspace(14.0, 16.0, 4, device=cuda)[None, :, None] * dt
    Q = kernel_chunk(128, 512, 64, 64)
    assert float(adt[..., :Q].sum(-1).min()) < -900.0
    got = mamba2_ssd_kernel(x, adt, dt, Bm, C, chunk=128)
    _tf32_check(got, mamba2_ssd_plain(x, adt, dt, Bm, C, 128))


@pytest.mark.parametrize("dtype", sorted(DT))
def test_mamba2_ssd_prepass_once_per_call(cuda, dtype):
    """Each route is the pre-pass and its scan, one launch of each a call,
    under one count."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.mamba2_ssd import mamba2_ssd_kernel

    args = _ssd_views(cuda, 2, 4, 300, 64, 64, dtype)
    mamba2_ssd_kernel(*args)
    torch.cuda.synchronize()
    reset_launch_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        mamba2_ssd_kernel(*args)
        mamba2_ssd_kernel(*args)
        torch.cuda.synchronize()
    scan = "ssd_mma_kernel" if dtype == "bfloat16" else "ssd_tf32_kernel"
    counts = {k: sum(ev.count for ev in prof.key_averages() if k in ev.key)
              for k in ("ssd_cumsum_kernel", "ssd_mma_kernel", "ssd_tf32_kernel")}
    assert counts == {k: 2 if k in ("ssd_cumsum_kernel", scan) else 0 for k in counts}
    assert launch_counts()["mamba2_ssd"] == 2


def test_lm_kernels_refuse_what_they_do_not_take(cuda):
    from repro_torch.kernels.decode_attention import decode_attention_kernel
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.mamba2_ssd import mamba2_ssd_kernel

    q = torch.zeros((1, 3, 8, 16), device=cuda)
    kv = torch.zeros((1, 2, 8, 16), device=cuda)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        flash_attention_kernel(q, kv, kv)
    wide = torch.zeros((1, 1, 8, 264), device=cuda)
    with pytest.raises(ValueError, match="> 256"):
        flash_attention_kernel(wide, wide, wide)
    with pytest.raises(ValueError, match="tensors on"):
        flash_attention_kernel(kv, kv.cpu(), kv)
    with pytest.raises(ValueError, match="valid_len must be a host int"):
        decode_attention_kernel(torch.zeros((1, 2, 16), device=cuda), kv, kv,
                                torch.tensor(3, device=cuda))
    big = torch.zeros((1, 1, 4, 256), device=cuda)
    with pytest.raises(ValueError, match="exceed a block's shared memory"):
        decode_attention_kernel(torch.zeros((1, 128, 256), device=cuda), big, big, 4)
    with pytest.raises(ValueError, match="causal attention needs Sk == S"):
        flash_attention_kernel(q, torch.zeros((1, 3, 9, 16), device=cuda),
                               torch.zeros((1, 3, 9, 16), device=cuda))
    x = torch.zeros((1, 2, 8, 128), device=cuda)
    a = torch.zeros((1, 2, 8), device=cuda)
    bc = torch.zeros((1, 8, 16), device=cuda)
    with pytest.raises(ValueError, match="head dim 128 > 64"):
        mamba2_ssd_kernel(x, a, a, bc, bc)


@pytest.mark.parametrize("arch", ["zamba2_2p7b", "stablelm_3b", "mamba2_130m",
                                  "deepseek_v2_lite_16b", "arctic_480b", "chameleon_34b",
                                  "granite_34b"])
def test_smoke_lm_serving_on_the_card_equals_cpu(cuda, arch):
    """f32, teacher-forced: the CPU engine generates, both engines are fed
    its tokens, and their logits agree at 2e-4 / 2e-3."""
    from repro_torch.data import LMDataConfig, lm_batch
    from repro_torch.models import family_module, get_smoke_config
    from repro_torch.serving import ServeConfig, ServingEngine, init_cache

    cfg = get_smoke_config(arch).replace(dtype="float32")
    mod = family_module(cfg)
    on_cpu = mod.init_lm(cfg, device="cpu")
    on_card = mod.init_lm(cfg, device=cuda)
    on_card.load_state_dict(on_cpu.state_dict())
    scfg = ServeConfig(batch=2, max_seq=80)
    prompts = lm_batch(LMDataConfig(vocab=cfg.vocab, seq_len=64, global_batch=2), 0)["tokens"]
    engines = {"cpu": ServingEngine(cfg, on_cpu, scfg), "cuda": ServingEngine(cfg, on_card, scfg)}
    forced = engines["cpu"].generate(prompts, max_new_tokens=4)
    logits = {}
    with torch.inference_mode():
        for where, eng in engines.items():
            caches = init_cache(cfg, scfg, device=where)
            reset_launch_counts()
            out, caches = eng.prefill(eng.params, torch.from_numpy(prompts).to(where), caches)
            counts = launch_counts()
            got = [out.cpu()]
            for i in range(forced.shape[1]):
                tok = torch.from_numpy(forced[:, i:i + 1]).to(where)
                out, caches = eng.step(eng.params, tok, 64 + i, caches)
                got.append(out.cpu())
            logits[where] = got
            if where == "cuda":
                attn = cfg.n_layers // cfg.hybrid.attn_every if cfg.hybrid else cfg.n_layers
                expect = {"embedding_gather": 1,
                          "mamba2_ssd": cfg.n_layers if cfg.ssm else 0,
                          "flash_attention": attn if cfg.n_heads else 0}
                assert counts == {k: expect.get(k, 0) for k in counts}
    for a, b in zip(logits["cuda"], logits["cpu"]):
        torch.testing.assert_close(a, b, atol=2e-4, rtol=2e-3)


def test_smoke_whisper_serving_on_the_card_equals_cpu(cuda):
    """f32, teacher-forced with the encoder's output: K6 for the encoder,
    the prompt's self- and cross-attention (Sk = S_enc), K7 for a step's."""
    import numpy as np
    from repro_torch.models import get_smoke_config, whisper
    from repro_torch.serving import ServeConfig, ServingEngine, init_cache

    cfg = get_smoke_config("whisper_base").replace(dtype="float32")
    on_cpu = whisper.init_model(cfg, device="cpu")
    on_card = whisper.init_model(cfg, device=cuda)
    on_card.load_state_dict(on_cpu.state_dict())
    scfg = ServeConfig(batch=2, max_seq=40)
    frames = torch.randn((2, cfg.encdec.encoder_seq, cfg.d_model),
                         generator=torch.Generator().manual_seed(0))
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (2, 24), dtype=np.int32)
    logits = {}
    for where, params in (("cpu", on_cpu), ("cuda", on_card)):
        eng = ServingEngine(cfg, params, scfg)
        with torch.inference_mode():
            reset_launch_counts()
            enc = whisper.encode(params, frames.to(where), cfg)
            enc_counts = launch_counts()
            if where == "cpu":
                forced = eng.generate(prompts, max_new_tokens=4, enc_out=enc)
            kv = whisper.cross_kv(params, enc, cfg)
            caches = init_cache(cfg, scfg, device=where)
            reset_launch_counts()
            out, caches = eng.prefill(params, torch.from_numpy(prompts).to(where), caches, kv)
            pre_counts = launch_counts()
            got = [out.cpu()]
            reset_launch_counts()
            for i in range(forced.shape[1]):
                tok = torch.from_numpy(forced[:, i:i + 1]).to(where)
                out, caches = eng.step(params, tok, 24 + i, caches, kv)
                got.append(out.cpu())
            step_counts = launch_counts()
        logits[where] = got
        if where == "cuda":
            L, n = cfg.n_layers, forced.shape[1]
            assert enc_counts["flash_attention"] == cfg.encdec.encoder_layers
            assert pre_counts == {k: {"flash_attention": 2 * L, "embedding_gather": 1}.get(k, 0)
                                  for k in pre_counts}
            assert step_counts == {k: {"decode_attention": 2 * L * n, "embedding_gather": n}.get(
                k, 0) for k in step_counts}
    for a, b in zip(logits["cuda"], logits["cpu"]):
        torch.testing.assert_close(a, b, atol=2e-4, rtol=2e-3)


def test_multi_token_cached_attention_refuses_the_card(cuda):
    """No kernel covers several new tokens against a cache: such a step runs
    the reference's plain full-cache attention on the card too, launches no
    kernel, and equals the same step on the CPU (f32, 2e-5)."""
    from repro_torch.models import get_smoke_config
    from repro_torch.models import layers as TL

    cfg = get_smoke_config("stablelm_3b").replace(dtype="float32")
    D, Hq, Hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.attn_head_dim
    g = torch.Generator().manual_seed(0)
    p = {k: torch.randn(shape, generator=g) / 8 for k, shape in (
        ("wq", (D, Hq * dh)), ("wk", (D, Hkv * dh)), ("wv", (D, Hkv * dh)), ("wo", (Hq * dh, D)))}
    cache = torch.randn((2, 2, Hkv, 10, dh), generator=g)
    x = torch.randn((2, 3, D), generator=g)
    out = {}
    for where in ("cpu", cuda):
        reset_launch_counts()
        got, _ = TL.attention({k: v.to(where) for k, v in p.items()}, x.to(where), cfg,
                              kv_cache=tuple(cache.to(where).clone()), cache_index=4)
        assert not any(launch_counts().values())
        out[str(where)] = got.cpu()
    torch.testing.assert_close(out[str(cuda)], out["cpu"], atol=2e-5, rtol=2e-5)


def test_scan_kernels_launch_from_threads_on_their_own_streams(cuda):
    """Shard threads launch at once, each on a stream of its own: every
    launch equals the plain version and every launch is counted."""
    import threading

    rows = [_rows(cuda, 16, 16, seed=s) for s in range(4)]
    want = [cache_scan_plain(*r, 16, 16, "lru") for r in rows]
    got, errors = [None] * 4, []
    start = threading.Barrier(4)
    reset_launch_counts()

    def worker(i):
        try:
            start.wait()
            stream = torch.cuda.Stream(cuda)
            with torch.cuda.stream(stream):
                for _ in range(10):
                    got[i] = cache_scan_groups(*rows[i], 16, 16, "lru")
            stream.synchronize()
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    assert launch_counts()["cache_scan"] == 40
    for g, w in zip(got, want):
        assert all(torch.equal(a, b) for a, b in zip(g, w))


def test_sweep_on_the_card_equals_cpu_sharded_and_not(cuda):
    """The DSE sweep on the card (unsharded, and two shard threads on the
    one card) equals the same sweep on the CPU, bitwise."""
    import dataclasses

    from repro_torch.core import TranslationConfig, dlrm_rmc2_small, sweep, tpuv6e

    wl = dlrm_rmc2_small(num_tables=2, rows_per_table=2000, dim=128, lookups=4, batch_size=8,
                         num_batches=2)
    axes = dict(policies=("spm", "lru", "srrip", "fifo", "pinning"),
                capacities=(1 << 16, 1 << 17), ways=(4, 8), zipf_s=0.9, seed=0,
                translations=(None, TranslationConfig(entries=16, ways=4, l2_entries=64,
                                                      replacement="fifo")))

    def records(sr):
        return [(e.config, dataclasses.asdict(e.result)) for e in sr.entries]

    want = records(sweep(wl, tpuv6e(), device="cpu", **axes))
    reset_launch_counts()
    assert records(sweep(wl, tpuv6e(), **axes)) == want
    counts = launch_counts()
    assert counts["dram_scan"] >= 1 and counts["rrip_scan"] >= 1
    sharded = sweep(wl, tpuv6e(), devices=2, **axes)
    assert sharded.sharded and sharded.device_count == 1
    assert records(sharded) == want


# ---------------------------------------------------------------------------
# The multi-core cluster and NUMA placements
# ---------------------------------------------------------------------------

def _cluster(topo, sharding, aff, plc):
    return lambda hw: hw.with_cluster(4, topo, sharding).with_placement(aff, plc)


@pytest.mark.parametrize("policy,backend,kernel,change", [
    ("lru", "pallas", "cache_scan", _cluster("private", "batch", "symmetric", "interleave")),
    ("lru", "stack_pallas", "stack_distance",
     _cluster("private", "table_hash", "per_core", "table_rank")),
    ("srrip", "stack", "rrip_scan", _cluster("private", "batch", "per_table", "hot_replicate")),
    ("fifo", "pallas", "cache_scan", _cluster("shared", "batch", "per_core", "interleave")),
    ("spm", "stack", None, _cluster("private", "table_hash", "per_core", "table_rank")),
], ids=["lru-K1-private", "lru-K2-table_rank", "srrip-D2-hot_replicate", "fifo-K1-shared",
        "spm-table_rank"])
def test_cluster_simulate_on_the_card_equals_cpu(cuda, policy, backend, kernel, change):
    """A 4-core cluster on the card equals the CPU; D1 once per simulate, the
    on-chip kernel once per shard bucket (private) or on the whole stream
    (shared), as the host computes them."""
    import dataclasses

    from repro_torch.core import dlrm_rmc2_small, simulate, tpuv6e
    from repro_torch.core.engine import build_embedding_traces
    from repro_torch.core.memory.cache import bucket_rows
    from repro_torch.core.memory.rrip import row_plan
    from repro_torch.core.memory.system import EmbeddingTrace, lane_geometry
    from repro_torch.core.trace import shard_trace

    wl = dlrm_rmc2_small(num_tables=6, rows_per_table=2000, batch_size=8, num_batches=2)
    hw = change(tpuv6e().with_policy(policy, capacity_bytes=1 << 16).with_cache_backend(backend))
    et = build_embedding_traces(wl)[0]
    lane = lane_geometry(hw, et.spec)
    streams = ([et.vec_ids] if hw.topology.value == "shared" else
               [EmbeddingTrace.from_concat(et.spec, s.concat).vec_ids
                for s in shard_trace(et.concat, 4, hw.lookup_sharding.value) if len(s)])
    if kernel == "rrip_scan":
        want = sum(2 if t.chunked else 1 for v in streams
                   for _, t in row_plan(v, lane.num_sets, lane.ways, policy)[2])
    else:
        want = sum(len(list(bucket_rows([v], [lane]))) for v in streams)
    reset_launch_counts()
    on_card = simulate(wl, hw)
    counts = launch_counts()
    assert counts["dram_scan"] == 1, counts
    for name in ("cache_scan", "stack_distance", "rrip_scan"):
        assert counts[name] == (want if name == kernel else 0), counts
    assert dataclasses.asdict(on_card) == dataclasses.asdict(simulate(wl, hw, device="cpu"))


@pytest.mark.parametrize("num_sources", [2, 4])
def test_contended_dram_sources_on_the_card_equal_cpu(cuda, num_sources):
    """D1 with several sources: results and the per-source finish matrix on
    the card (device and host aggregates) equal the CPU's, bitwise."""
    import dataclasses

    from repro_torch.core import tpuv6e
    from repro_torch.core.memory.dram import DramModel, simulate_dram_contended

    rng = np.random.default_rng(num_sources)
    base = rng.integers(0, 300_000, size=4000).astype(np.int64) * 8
    lines = (base[:, None] + np.arange(8)[None, :]).reshape(-1)
    seg = np.sort(rng.integers(0, 3, size=lines.size))
    src = np.repeat(rng.integers(0, num_sources, size=base.size), 8)
    dm = DramModel.from_hardware(tpuv6e())
    want = simulate_dram_contended(lines, seg, src, 3, num_sources, dm, device="cpu")
    for aggregate in ("device", "host"):
        reset_launch_counts()
        got = simulate_dram_contended(lines, seg, src, 3, num_sources, dm, aggregate=aggregate)
        assert launch_counts()["dram_scan"] == 1
        assert [dataclasses.asdict(r) for r in got[0]] == [dataclasses.asdict(r) for r in want[0]]
        assert np.array_equal(got[1], want[1])


def test_cluster_sweep_on_the_card_equals_cpu(cuda):
    import dataclasses

    from repro_torch.core import dlrm_rmc2_small, sweep, tpuv6e

    wl = dlrm_rmc2_small(num_tables=6, rows_per_table=1500, dim=128, lookups=3, batch_size=6,
                         num_batches=2)
    axes = dict(policies=("spm", "lru"), capacities=(1 << 16,), ways=(4,), zipf_s=1.0, seed=0,
                num_cores=(1, 2), topologies=("private", "shared"),
                channel_affinities=("symmetric", "per_core", "per_table"),
                placements=("interleave", "table_rank", "hot_replicate"))

    def records(sr):
        return [(e.config, dataclasses.asdict(e.result)) for e in sr.entries]

    want = records(sweep(wl, tpuv6e(), device="cpu", **axes))
    assert records(sweep(wl, tpuv6e(), **axes)) == want
    assert records(sweep(wl, tpuv6e(), devices=2, **axes)) == want


# ---------------------------------------------------------------------------
# The serving simulator: the smallest inputs it gives the scans, and its runs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,L", [(1, 0), (0, 7), (1, 1), (3, 1), (2, 2)])
def test_scan_kernels_zero_length_and_one_lookup(cuda, B, L):
    """K1, K2, D1 and D2 on the smallest inputs (a degraded serving batch can
    leave no lookup, or one): equal to their plain versions, bitwise; an
    input with no step launches nothing (a zero-size grid is a launch
    error), an input with one step launches once."""
    from repro_torch.kernels.rrip_scan import PLAIN, rrip_scan_rows

    rng = np.random.default_rng(B * 10 + L)
    sets = torch.from_numpy(rng.integers(0, 3, size=(B, L)).astype(np.int32)).to(cuda)
    tags = torch.from_numpy(rng.integers(-1, 9, size=(B, L)).astype(np.int32)).to(cuda)
    valid = torch.ones((B, L), dtype=torch.bool, device=cuda)
    steps = B * L
    for policy in ("lru", "srrip", "fifo"):
        reset_launch_counts()
        got = cache_scan_groups(sets, tags, valid, 3, 2, policy)
        assert launch_counts()["cache_scan"] == (1 if steps else 0)
        assert all(torch.equal(a, b) for a, b in zip(
            got, cache_scan_plain(sets, tags, valid, 3, 2, policy)))
    reset_launch_counts()
    got = stack_distance_groups(sets, tags, valid, 3, 2)
    assert launch_counts()["stack_distance"] == (1 if steps else 0)
    assert all(torch.equal(a, b) for a, b in zip(got, stack_distance_plain(sets, tags, valid, 3, 2)))
    for policy in ("fifo", "srrip"):
        reset_launch_counts()
        got = rrip_scan_rows(tags, valid, 2, policy)
        assert launch_counts()["rrip_scan"] == (1 if steps else 0)
        assert torch.equal(got, PLAIN[policy](tags, valid, 2))
    # D1: R rows of Lc chunks (R = B segments x channels, Lc = L chunks).
    arrays = (rng.integers(0, 8, size=(B, L)).astype(np.int32),
              rng.integers(0, 3, size=(B, L)).astype(np.int32),
              rng.integers(1, 9, size=(B, L)).astype(np.int32), np.ones((B, L), bool))
    args = [torch.from_numpy(a).to(cuda) for a in arrays]
    reset_launch_counts()
    got = dram_scan_chunked(*args, 8, 8, 44.0, 22.0, 0.6016)
    assert launch_counts()["dram_scan"] == (1 if B else 0)
    want = dram_scan_plain(*args, 8, 8, 44.0, 22.0, 0.6016)
    for a, b in zip(got[0] + got[1], want[0] + want[1]):
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b)


SERVING_SPEC = dict(num_tables=4, rows_per_table=1000, dim=32, lookups_per_sample=4,
                    dtype_bytes=4)


def _serving_scenarios():
    from repro_torch.core import TrafficConfig
    from repro_torch.serving import RobustnessPolicy, ServingScenario

    out = [ServingScenario(name="steady", traffic=TrafficConfig(
               pattern="poisson", mean_gap_cycles=700.0, num_requests=48, seed=11)),
           ServingScenario(name="storm", traffic=TrafficConfig(
               pattern="bursty", mean_gap_cycles=40.0, num_requests=80, seed=23, burst_len=10),
               policy=RobustnessPolicy(admission_watermark=12, deadline_cycles=25_000,
                                       max_retries=2, retry_backoff_cycles=2_000.0,
                                       degrade_mode="hot_rows_only", degrade_watermark=2,
                                       hot_fraction=0.2))]
    # One table and one lookup a request, a request a batch, every batch
    # degraded: batches of no lookup (the first ones) and of one.
    for mode, seed in (("hot_rows_only", 0), ("cache_bypass", 1)):
        out.append(ServingScenario(name=f"edge_{mode}", traffic=TrafficConfig(
            pattern="poisson", mean_gap_cycles=700.0, num_requests=12, seed=seed,
            tables_per_request=1, lookups_per_table=1), policy=RobustnessPolicy(
            degrade_mode=mode, degrade_watermark=0, hot_fraction=0.001,
            bypass_keep_tables=0.25), batch_slots=1))
    return out


@pytest.mark.parametrize("policy,backend,kernel", [
    ("lru", "pallas", "cache_scan"), ("lru", "stack_pallas", "stack_distance"),
    ("srrip", "stack", "rrip_scan"), ("fifo", "stack", "rrip_scan"), ("spm", "stack", None)])
def test_serving_on_the_card_equals_cpu(cuda, policy, backend, kernel):
    """A small serving run on the card equals the same run on the CPU,
    bitwise, for every scenario (all-off, a closed loop with every policy,
    batches with no lookup and with one); D1 launches once per priced
    stream that holds a miss, the on-chip kernel only where the path runs
    it."""
    from repro_torch.core import EmbeddingOpSpec, tpuv6e
    from repro_torch.core.memory.system import memory_system_for
    from repro_torch.serving import simulate_serving

    spec = EmbeddingOpSpec(**SERVING_SPEC)
    hw = tpuv6e().with_policy(policy).with_cache_backend(backend)
    for sc in _serving_scenarios():
        reset_launch_counts()
        on_card = simulate_serving(memory_system_for(hw, cuda), spec, sc)
        counts = launch_counts()
        priced = 1 if sc.policy.all_off else on_card.num_batches
        assert 0 < counts["dram_scan"] <= priced, (sc.name, counts)
        for name in ("cache_scan", "stack_distance", "rrip_scan"):
            assert (counts[name] > 0) <= (name == kernel), (sc.name, counts)
        if kernel and sc.name in ("steady", "storm"):
            assert counts[kernel] > 0, (sc.name, counts)
        on_cpu = simulate_serving(memory_system_for(hw, "cpu"), spec, sc)
        assert on_card.diff(on_cpu) == {}, sc.name


def test_serving_sweep_on_the_card_sharded_equals_cpu(cuda):
    """A serving-scenario sweep on the card, unsharded and as two shard
    threads on the one card, equals the CPU's, bitwise."""
    import dataclasses

    from repro_torch.core import EmbeddingOpSpec, Workload, sweep, tpuv6e

    wl = Workload(name="serve_wl", embedding_ops=(EmbeddingOpSpec(**SERVING_SPEC),))
    axes = dict(policies=("spm", "lru", "srrip"), capacities=(1 << 20,), ways=(8,),
                scenarios=_serving_scenarios()[:2])

    def records(sr):
        return [(e.config, e.result.summary(), e.result.latency_cycles.tolist(),
                 [dataclasses.asdict(s) for s in e.result.batch_stats]) for e in sr.entries]

    want = records(sweep(wl, tpuv6e(), device="cpu", **axes))
    assert records(sweep(wl, tpuv6e(), **axes)) == want
    sharded = sweep(wl, tpuv6e(), devices=2, **axes)
    assert sharded.sharded and sharded.device_count == 1
    assert records(sharded) == want


@pytest.mark.parametrize("arch", ["stablelm_3b", "deepseek_v2_lite_16b", "mamba2_130m",
                                  "zamba2_2p7b", "chameleon_34b", "granite_34b",
                                  "whisper_base"])
def test_smoke_train_step_on_the_card_equals_cpu(cuda, arch):
    """One f32 train step from one state on the card and on the CPU: the
    loss at rtol 1e-5, the grad norm at 1e-4, every gradient leaf at 1e-4
    of its largest magnitude, the updated parameters within 2 x lr of each
    other (Adam's first step moves an element by +-lr by its gradient's
    sign, which two sums of a gradient near zero may differ on). The train
    step runs the plain route: no kernel launches."""
    from repro_torch import tree as T
    from repro_torch.data import LMDataConfig, lm_batch
    from repro_torch.models import get_smoke_config
    from repro_torch.training import TrainConfig, build_loss_fn, build_train_step, init_state
    from repro_torch.training.optimizer import lr_schedule
    from repro_torch.training.train_step import value_and_grad

    cfg = get_smoke_config(arch).replace(dtype="float32")
    tc = TrainConfig(loss_chunk=16)
    cpu_state = init_state(0, cfg, tc, device="cpu")
    states = {"cpu": cpu_state,
              "cuda": T.unflatten(cpu_state, [t.to(cuda) for t in T.leaves(cpu_state)])}
    b = lm_batch(LMDataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4), 0)
    if cfg.family == "audio":
        b["frames"] = (np.random.default_rng(0).standard_normal(
            (4, cfg.encdec.encoder_seq, cfg.d_model)) * 0.5).astype(np.float32)
    got = {}
    reset_launch_counts()
    for where, st in states.items():
        batch = {k: torch.from_numpy(v).to(st["step"].device) for k, v in b.items()}
        _, grads = value_and_grad(build_loss_fn(cfg, tc), st["params"], batch)
        st, m = build_train_step(cfg, tc)(st, batch)
        got[where] = (float(m["loss"]), float(m["grad_norm"]),
                      [g.cpu() for g in T.leaves(grads)], [p.cpu() for p in T.leaves(st["params"])])
    assert not any(launch_counts().values())
    (l_c, n_c, g_c, p_c), (l_g, n_g, g_g, p_g) = got["cpu"], got["cuda"]
    assert abs(l_g - l_c) <= 1e-5 * abs(l_c) and abs(n_g - n_c) <= 1e-4 * n_c
    for x, y in zip(g_c, g_g):
        torch.testing.assert_close(y, x, rtol=1e-4, atol=1e-4 * float(x.abs().max()))
    lr1 = float(lr_schedule(tc.adamw, torch.tensor(1)))
    for x, y in zip(p_c, p_g):
        torch.testing.assert_close(y, x, rtol=1e-6, atol=2 * lr1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["stablelm_3b", "zamba2_2p7b"])
def test_cached_step_of_several_tokens_on_the_card_equals_cpu(cuda, arch, dtype):
    """After a prefill of 24, a step of 4 new tokens (the plain full-cache
    attention and sequential SSD steps, K4 its one launch) on the card
    against the CPU: f32 2e-4 / 2e-3, bf16 8e-2."""
    from repro_torch.data import LMDataConfig, lm_batch
    from repro_torch.models import family_module, get_smoke_config
    from repro_torch.models import transformer as TT

    cfg = get_smoke_config(arch).replace(dtype=dtype)
    mod = family_module(cfg)
    on_cpu = mod.init_lm(cfg, device="cpu")
    on_card = mod.init_lm(cfg, device=cuda)
    on_card.load_state_dict(on_cpu.state_dict())
    toks = lm_batch(LMDataConfig(vocab=cfg.vocab, seq_len=28, global_batch=2), 1)["tokens"]
    out = {}
    with torch.inference_mode():
        for where, params in (("cpu", on_cpu), ("cuda", on_card)):
            tt = torch.from_numpy(toks).to(params["embed"]["table"].device)
            if cfg.family == "hybrid":
                _, caches = mod.prefill_with_state(params, tt[:, :24], cfg, max_seq=40)
            else:
                caches = TT.init_kv_cache(cfg, 2, 40, device=tt.device)
                _, caches = TT.prefill(params, tt[:, :24], caches, cfg)
            reset_launch_counts()
            logits, _ = mod.decode_step(params, tt[:, 24:], 24, caches, cfg)
            counts = launch_counts()
            want = {"embedding_gather": 1} if where == "cuda" else {}
            assert counts == {k: want.get(k, 0) for k in counts}
            out[where] = logits.cpu()
    assert out["cuda"].shape == (2, 4, cfg.vocab)
    tol = dict(atol=2e-4, rtol=2e-3) if dtype == "float32" else dict(atol=8e-2, rtol=0.0)
    torch.testing.assert_close(out["cuda"].float(), out["cpu"].float(), **tol)
