"""D2's plain versions and the compressed SRRIP/FIFO engines of the PyTorch
port, held bitwise against the JAX package on the CPU.

The references are the JAX package's ``lax.scan`` row scans
(``repro.core.memory.rrip._fifo_scan_rows`` / ``_srrip_scan_rows``), its
many-stream engines (``classify_*_many``), its sequential cache engine and
the ChampSim-semantics ``GoldenCache``. Inputs are made with numpy from a
seed and handed to both packages.
"""
import numpy as np
import pytest
import torch

from repro.core.memory import cache as rcache
from repro.core.memory import rrip as rrrip
from repro.core.memory.golden import GoldenCache
from repro_torch.core.memory import cache as tcache
from repro_torch.core.memory import rrip as trrip
from repro_torch.kernels.rrip_scan import (
    fifo_scan_rows_plain, rrip_scan_rows, srrip_scan_rows_plain)

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
    """One launch per (ways, pow-2 length) bucket, rows padded to a power of
    two (floor 8) with invalid rows, every kept access in exactly one slot."""
    lines = _streams()["zipf"]
    pre = [trrip._Presort(lines, 8, 2), trrip._Presort(lines, 64, 2)]
    buckets, elem_pos, total = trrip.bucket_rows(pre, [4, 16])
    seen = np.zeros(total, int)
    for e0, B, tags, valid, ways in buckets:
        Bp, Lb = tags.shape
        assert ways in (4, 16) and Lb >= 8 and Lb & (Lb - 1) == 0
        assert Bp >= max(B, 8) and Bp & (Bp - 1) == 0 and not valid[B:].any()
        assert (tags[~valid] == -2).all()
        seen[e0:e0 + B * Lb] += 1
    assert (seen <= 1).all()
    for p, pos in zip(pre, elem_pos):
        assert pos.size == p.kept_tag.size and np.unique(pos).size == pos.size
