"""D2's plain versions and the compressed SRRIP/FIFO engines of the PyTorch
port, held bitwise against the JAX package on the CPU.

The references are the JAX package's ``lax.scan`` row scans
(``repro.core.memory.rrip._fifo_scan_rows`` / ``_srrip_scan_rows``), its
many-stream engines (``classify_*_many``), its sequential cache engine and
the ChampSim-semantics ``GoldenCache``. Inputs are made with numpy from a
seed and handed to both packages.
"""
import functools

import numpy as np
import pytest
import torch

from repro.core.memory import cache as rcache
from repro.core.memory import rrip as rrrip
from repro.core.memory.golden import GoldenCache
from repro_torch.core.memory import cache as tcache
from repro_torch.core.memory import rrip as trrip
from repro_torch.kernels import rrip_scan as d2
from repro_torch.kernels.rrip_scan import (
    fifo_scan_rows_plain, rrip_scan_chunked_plain, rrip_scan_rows, srrip_scan_rows_plain)

REF_SCAN = {"fifo": rrrip._fifo_scan_rows, "srrip": rrrip._srrip_scan_rows}
PLAIN = {"fifo": fifo_scan_rows_plain, "srrip": srrip_scan_rows_plain}
POLICIES = ["fifo", "srrip"]


def _rows(seed, B, L, ways, space=None):
    """Random per-set rows: tags from a small space (so ways refill and
    evict), a ragged valid prefix per row padded with the pad tag -2, a few
    invalid positions inside it, and some valid tags of -1 (they match the
    empty ways in the reference)."""
    rng = np.random.default_rng(seed)
    space = space or 2 * ways + 2
    tags = rng.integers(0, space, size=(B, L)).astype(np.int32)
    tags[rng.random((B, L)) < 0.03] = -1
    lens = rng.integers(0, L + 1, size=B)
    valid = (np.arange(L)[None, :] < lens[:, None]) & (rng.random((B, L)) < 0.95)
    tags[~valid] = -2
    return tags, valid


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("ways", [1, 3, 4, 16, 64])
def test_plain_row_scan_equals_jax_scan(policy, ways):
    tags, valid = _rows(ways, 12, 96, ways)
    want = np.asarray(REF_SCAN[policy](tags, valid, ways))
    got = PLAIN[policy](torch.from_numpy(tags), torch.from_numpy(valid), ways)
    np.testing.assert_array_equal(got.numpy(), want)
    # on CPU tensors the wrapper is the plain version
    got = rrip_scan_rows(torch.from_numpy(tags), torch.from_numpy(valid), ways, policy)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("case", ["one_access", "all_invalid", "one_tag", "cyclic_over_ways"])
def test_plain_row_scan_edge_rows(policy, case):
    """Rows of one valid access, padding rows (as the row-count floor adds),
    one tag repeated, and a cycle of ways + 1 tags (every access misses
    once warm, and SRRIP ages on each)."""
    ways, B, L = 4, 8, 40
    tags = np.full((B, L), -2, np.int32)
    valid = np.zeros((B, L), bool)
    if case == "one_access":
        tags[:, 0], valid[:, 0] = np.arange(B), True
    elif case == "one_tag":
        tags[:], valid[:] = 7, True
    elif case == "cyclic_over_ways":
        tags[:] = np.arange(L)[None, :] % (ways + 1) + np.arange(B)[:, None]
        valid[:] = True
    want = np.asarray(REF_SCAN[policy](tags, valid, ways))
    got = PLAIN[policy](torch.from_numpy(tags), torch.from_numpy(valid), ways)
    np.testing.assert_array_equal(got.numpy(), want)


def test_row_scan_wrapper_validates_inputs():
    t = torch.zeros((2, 8), dtype=torch.int32)
    v = torch.ones((2, 8), dtype=torch.bool)
    with pytest.raises(ValueError, match="unknown policy"):
        rrip_scan_rows(t, v, 2, "lru")
    with pytest.raises(ValueError, match="ways must be >= 1"):
        rrip_scan_rows(t, v, 0, "fifo")
    with pytest.raises(ValueError, match="shape"):
        rrip_scan_rows(t, v[:, :4], 2, "fifo")
    with pytest.raises(TypeError, match="int32"):
        rrip_scan_rows(t.long(), v, 2, "srrip")


def _streams():
    rng = np.random.default_rng(11)
    return {
        "reuse": rng.integers(0, 300, size=3000),
        "zipf": rng.zipf(1.2, size=2500) % 5000,
        "runs": np.repeat(rng.integers(0, 400, size=600), rng.integers(1, 5, size=600)),
        "empty": np.zeros(0, np.int64),
        "one": np.array([17]),
    }


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("stream", ["reuse", "zipf", "runs", "empty", "one"])
def test_classify_many_equals_jax_package(policy, stream):
    lines = _streams()[stream]
    geoms = [(8, 4), (8, 16), (32, 3), (1, 1), (64, 2), (5, 7)]
    want = rrrip.classify_analytic_many([lines] * len(geoms), geoms, policy)
    got = trrip.classify_analytic_many([lines] * len(geoms), geoms, policy, device="cpu")
    for (h1, e1), (h2, e2) in zip(got, want):
        np.testing.assert_array_equal(h1, h2)
        assert e1 == e2


@pytest.mark.parametrize("policy", POLICIES)
def test_classify_many_shares_one_presort_per_stream_and_sets(policy):
    """Every ways value of one (stream, num_sets) classifies from one
    presort: the pass counter moves by one for four geometries."""
    lines = _streams()["reuse"]
    geoms = [(8, 2), (8, 4), (8, 16), (8, 5)]
    fn = trrip.classify_fifo_many if policy == "fifo" else trrip.classify_srrip_many
    before = trrip.analytic_pass_count()
    got = fn([lines] * len(geoms), geoms, device="cpu")
    assert trrip.analytic_pass_count() - before == 1
    for (h, ev), (S, W) in zip(got, geoms):
        g = GoldenCache(rcache.CacheGeometry(S, W, 64), policy)
        np.testing.assert_array_equal(h, g.run(lines))
        assert ev == g.num_evictions


def test_classify_analytic_rejects_other_policies():
    with pytest.raises(ValueError, match="no analytic engine"):
        trrip.classify_analytic_many([np.arange(4)], [(2, 2)], "lru", device="cpu")
    with pytest.raises(ValueError, match="int32"):
        trrip.classify_fifo_many([np.array([-1, 3])], [(2, 2)], device="cpu")


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("backend", ["stack", "stack_pallas"])
@pytest.mark.parametrize("sets,ways,space", [(4, 2, 60), (40, 4, 3000), (85, 3, 5000)])
def test_srrip_fifo_stack_backends_equal_jax_package(policy, backend, sets, ways, space):
    """The cache engine's analytic route against the reference's own
    ``stack`` engine and its sequential ``scan`` engine."""
    lines = np.random.default_rng(sets).integers(0, space, size=1500)
    rgeom = rcache.CacheGeometry(sets, ways, 64)
    ours = tcache.simulate_cache(lines, tcache.CacheGeometry(sets, ways, 64), policy,
                                 backend=backend, device="cpu")
    for ref_backend in ("stack", "scan"):
        ref = rcache.simulate_cache(lines, rgeom, policy, backend=ref_backend)
        np.testing.assert_array_equal(ours.hits, ref.hits)
        assert ours.num_evictions == ref.num_evictions


def test_bucket_rows_groups_by_ways_and_length():
    """``pack_rows``'s row tables: one group (one call of D2) per distinct
    ways, its rows tiling a contiguous slice of the flat buffer, each row a
    per-set segment padded to a multiple of 16 with invalid steps, longest
    first; every kept access in exactly one slot."""
    from repro_torch.kernels.rrip_scan import RowTable

    lines = _streams()["zipf"]
    pre = [trrip._Presort(lines, 8, 2), trrip._Presort(lines, 64, 2),
           trrip._Presort(lines, 5, 2)]
    tags, valid, groups, elem_pos = trrip.pack_rows(pre, [4, 16, 4])
    assert tags.shape == valid.shape and (tags[~valid] == -2).all()
    assert [t.ways for _, t in groups] == [4, 16]
    assert [t.rows for _, t in groups] == [8 + 5, 64]
    seen = np.zeros(tags.size, int)
    for base, table in groups:
        assert isinstance(table, RowTable) and not table.chunked
        assert (table.length % 16 == 0).all() and (np.diff(table.off) == table.length[:-1]).all()
        kept = np.add.reduceat(valid[base:base + table.total].astype(int), table.off)
        assert (np.diff(kept) <= 0).all() and (kept > table.length - 16).all()
        seen[base:base + table.total] += 1
    assert (seen == 1).all()
    for p, pos in zip(pre, elem_pos):
        assert pos.size == p.kept_tag.size and np.unique(pos).size == pos.size
        np.testing.assert_array_equal(tags[pos], p.kept_tag)
        assert valid[pos].all()
    assert not trrip.pack_rows([trrip._Presort(np.zeros(0, np.int64), 4, 1)], [2])[2]


# ---------------------------------------------------------------------------
# D2's chunked route (speculate every chunk from a warm-up, then fix up)
# ---------------------------------------------------------------------------

CHUNKED_WAYS = [1, 3, 4, 8, 16, 33, 64]


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("ways", CHUNKED_WAYS)
@pytest.mark.parametrize("warmup", [16, 0])
def test_chunked_plain_equals_serial_and_jax_scan(policy, ways, warmup):
    """Rows of 150 steps in chunks of 32 (a ragged last chunk, and ragged
    valid lengths: all-padding chunks and an all-padding row), valid tags of
    -1: bitwise the serial plain version and the reference's row scan, and
    the wrapper's CPU route with the same count of re-runs."""
    tags, valid = _rows(100 + ways, 9, 150, ways)
    valid[4] = False
    tags[4] = -2
    want = np.asarray(REF_SCAN[policy](tags, valid, ways))
    t, v = torch.from_numpy(tags), torch.from_numpy(valid)
    np.testing.assert_array_equal(PLAIN[policy](t, v, ways).numpy(), want)
    got, reruns = rrip_scan_chunked_plain(t, v, ways, policy, chunk=32, warmup=warmup)
    np.testing.assert_array_equal(got.numpy(), want)
    count = torch.full((1,), -1, dtype=torch.int32)
    got = rrip_scan_rows(t, v, ways, policy, reruns=count, chunk=32, warmup=warmup, long_row=64)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(count) == reruns
    if warmup == 0 and ways > 1:
        assert reruns > 0   # the fix-up ran


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("ways", [2, 4, 8])
def test_chunked_plain_reruns_on_high_hit_rate_rows(policy, ways):
    """Rows over ways + 1 tags mostly hit: a warm-up of 8 steps cannot
    rebuild the state a chunk starts from, so chunks run again, and the
    result stays exact."""
    rng = np.random.default_rng(ways)
    tags = rng.integers(0, ways + 1, size=(6, 400)).astype(np.int32)
    valid = np.ones_like(tags, bool)
    want = np.asarray(REF_SCAN[policy](tags, valid, ways))
    got, reruns = rrip_scan_chunked_plain(torch.from_numpy(tags), torch.from_numpy(valid),
                                          ways, policy, chunk=48, warmup=8)
    np.testing.assert_array_equal(got.numpy(), want)
    assert reruns > 0


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("ways", [1, 4, 16])
def test_chunked_route_one_set_equals_jax_package(policy, ways, monkeypatch):
    """A one-set geometry makes the whole stream one row: with its row
    tables built with a small ``long_row`` and ``chunk``, classification
    takes the chunked route on the CPU and still equals the reference's
    engine and ``GoldenCache``."""
    monkeypatch.setattr(trrip, "RowTable", functools.partial(d2.RowTable, chunk=32, long_row=64))
    for stream in ("reuse", "zipf", "runs"):
        lines = _streams()[stream]
        tags, valid, groups = trrip.row_plan(lines, 1, ways, policy)
        assert groups[0][1].chunked and groups[0][1].rows == 1
        want = rrrip.classify_analytic_many([lines], [(1, ways)], policy)[0]
        got = trrip.classify_analytic_many([lines], [(1, ways)], policy, device="cpu")[0]
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
        g = GoldenCache(rcache.CacheGeometry(1, ways, 64), policy)
        np.testing.assert_array_equal(got[0], g.run(lines))


def _fifo(ring, head):
    return d2._Fifo(torch.tensor([ring], dtype=torch.int32), torch.tensor([head], dtype=torch.int32))


def _srrip(tags, keys, A, nf):
    return d2._Srrip(torch.tensor([tags], dtype=torch.int32), torch.tensor([keys], dtype=torch.int32),
                     torch.tensor([A], dtype=torch.int32), torch.tensor([nf], dtype=torch.int32))


def test_canonical_states_compare_rotations_and_shifts():
    """A FIFO ring compares as read from its head (rotations with aligned
    heads are one state); an SRRIP state by tags, nf and key - A of its
    filled ways (a constant added to A and every key is the same state);
    and equal canonical states give equal hits on any continuation."""
    same = [(_fifo([5, 6, 7, 8], 1), _fifo([8, 5, 6, 7], 2)),
            (_fifo([5, 6, -1, -1], 2), _fifo([-1, -1, 5, 6], 0)),
            (_srrip([3, 9, 4], [0, -2, 1], 2, 3), _srrip([3, 9, 4], [40, 38, 41], 42, 3)),
            (_srrip([3, 9, -1], [0, -2, 7], 2, 2), _srrip([3, 9, -1], [10, 8, -5], 12, 2))]
    differ = [(_fifo([5, 6, 7, 8], 1), _fifo([5, 6, 7, 8], 2)),
              (_srrip([3, 9, 4], [0, -2, 1], 2, 3), _srrip([3, 9, 4], [0, -2, 2], 2, 3)),
              (_srrip([3, 9, -1], [0, -2, 0], 2, 2), _srrip([3, 9, -1], [0, -2, 0], 2, 3))]
    for a, b in same:
        assert torch.equal(a.canonical(), b.canonical())
    for a, b in differ:
        assert not torch.equal(a.canonical(), b.canonical())
    rng = np.random.default_rng(0)
    for a, b in same:
        for _ in range(200):
            tag = torch.tensor([int(rng.integers(-1, 12))], dtype=torch.int32)
            v = torch.tensor([bool(rng.random() < 0.9)])
            assert torch.equal(a.step(tag, v), b.step(tag, v))
        assert torch.equal(a.canonical(), b.canonical())


def test_row_table_routes_and_refusals():
    from repro_torch.kernels.rrip_scan import RowTable, rrip_scan_flat

    t = RowTable([32, 0, 48], [16, 32, 0], 4, chunk=16, warmup=8, long_row=32)
    assert (t.rows, t.total, t.max_len, t.chunked) == (3, 48, 32, True)
    assert t.virtual_rows == 3 and t.blocks == 1 and t.max_steps == 32
    assert list(t.host) == [32, 0, 48, 16, 32, 0, 0, 1, 3, 3]
    short = RowTable([0, 100], [100, 50], 2)
    assert not short.chunked and short.virtual_rows == 2 and short.max_steps == 100
    # the default warm-up: 4 steps a way, at least 16
    assert [RowTable([0], [16], w).warmup for w in (1, 4, 8, 16, 64)] == [16, 16, 32, 64, 256]
    with pytest.raises(ValueError, match="tile"):
        RowTable([0, 10], [16, 16], 2)
    with pytest.raises(ValueError, match="multiple of 16"):
        RowTable([0], [16], 2, chunk=24)
    with pytest.raises(ValueError, match="ways must be >= 1"):
        RowTable([0], [16], 0)
    tags = torch.zeros(40, dtype=torch.int32)
    with pytest.raises(ValueError, match="table's 48 steps"):
        rrip_scan_flat(tags, tags.bool(), t, "fifo")
