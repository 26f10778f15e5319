"""K1 (cache scan) and K2 (stack distance) plain versions in the PyTorch port,
held bitwise against the JAX package.

The JAX package's Pallas K1/K2 cannot run on the installed jax (``pl.load`` /
``pl.store`` are gone from ``jax.experimental.pallas``), so the references
here are the parts of the JAX package that do run: the ``lax.scan`` engine
``repro.core.memory.cache._simulate_many``, the ChampSim-semantics
``GoldenCache``, and the numpy stack-distance pass
``repro.core.memory.stack.stack_distances_np``.
"""
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.core.memory import cache as rcache
from repro.core.memory import stack as rstack
from repro.core.memory.golden import GoldenCache
from repro_torch.core.memory import cache as tcache
from repro_torch.core.memory import stack as tstack
from repro_torch.kernels.cache_scan import (
    cache_scan_by_set_plain, cache_scan_groups, cache_scan_plain)
from repro_torch.kernels.stack_distance import (
    stack_distance_by_set_plain, stack_distance_groups, stack_distance_plain)

POLICIES = ["lru", "srrip", "fifo"]
# The issue's edge geometries plus those of tests/test_cache_pallas.py.
EDGE = [(1, 1), (1, 4), (3, 2), (7, 5), (16, 7), (16, 16), (4, 32), (2, 33), (2, 64)]
PALLAS_TEST_GEOMS = [(1, 1, 6), (1, 4, 30), (3, 2, 50), (7, 5, 200), (32, 16, 4000)]
CPU = torch.device("cpu")


def _rows(rng, B, L, S, W, pad_from):
    sets = rng.integers(0, S, size=(B, L)).astype(np.int32)
    tags = rng.integers(0, S * W * 2 + 1, size=(B, L)).astype(np.int32)
    valid = rng.random((B, L)) < 0.9
    valid[:, pad_from:] = False
    return sets, tags, valid


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("engine", ["k1_wrapper", "k1_plain"])
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("sets,ways", [(1, 1), (3, 2), (7, 5), (2, 33)])
def test_cache_scan_plain_equals_jax_scan_engine(engine, policy, sets, ways):
    """K1's wrapper on CPU tensors and its plain version (also the port's
    ``scan`` backend), on the padded ``(B, L)`` rows one launch receives,
    vs the JAX scan engine."""
    rng = np.random.default_rng(sets * 100 + ways)
    s, t, v = _rows(rng, 3, 128, sets, ways, pad_from=100)
    run = cache_scan_groups if engine == "k1_wrapper" else cache_scan_plain
    h, e = run(*_t(s, t, v), sets, ways, policy)
    rh, re_ = rcache._simulate_many(s, t, v, sets, ways, policy)
    np.testing.assert_array_equal(h.numpy(), np.asarray(rh))
    np.testing.assert_array_equal(e.numpy(), np.asarray(re_))


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("sets,ways", EDGE)
def test_cache_scan_plain_equals_golden_on_edge_geometries(policy, sets, ways):
    """One row per (sets, ways), no padding: the row IS a whole cache."""
    rng = np.random.default_rng(7 * sets + ways)
    lines = rng.integers(0, sets * ways * 3 + 1, size=200)
    s = (lines % sets).astype(np.int32)[None, :]
    t = lines.astype(np.int32)[None, :]
    v = np.ones_like(s, dtype=bool)
    h, e = cache_scan_groups(*_t(s, t, v), sets, ways, policy)
    gold = GoldenCache(rcache.CacheGeometry(sets, ways, 64), policy)
    np.testing.assert_array_equal(h.numpy()[0], gold.run(lines))
    assert int(e.sum()) == gold.num_evictions


def _assert_by_set_equals_references(s, t, v, sets, ways, policy):
    """K1's decomposition equals K1's plain version and the JAX scan engine."""
    h, e = cache_scan_by_set_plain(*_t(s, t, v), sets, ways, policy)
    hp, ep = cache_scan_plain(*_t(s, t, v), sets, ways, policy)
    assert torch.equal(h, hp) and torch.equal(e, ep)
    rh, re_ = rcache._simulate_many(s, t, v, sets, ways, policy)
    np.testing.assert_array_equal(h.numpy(), np.asarray(rh))
    np.testing.assert_array_equal(e.numpy(), np.asarray(re_))


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("sets,ways", EDGE)
def test_cache_scan_by_set_equals_plain_jax_and_golden(policy, sets, ways):
    """The kernel's decomposition on the CPU: each row split into its
    per-set sequences (row positions as timestamps), each walked alone, as
    K1's lane teams walk them. Padded rows against the plain version and
    the JAX scan engine; an unpadded row against ``GoldenCache``."""
    rng = np.random.default_rng(13 * sets + ways)
    _assert_by_set_equals_references(*_rows(rng, 3, 160, sets, ways, pad_from=130),
                                     sets, ways, policy)
    lines = rng.integers(0, sets * ways * 3 + 1, size=200)
    s = (lines % sets).astype(np.int32)[None, :]
    h, e = cache_scan_by_set_plain(*_t(s, lines.astype(np.int32)[None, :],
                                       np.ones_like(s, dtype=bool)), sets, ways, policy)
    gold = GoldenCache(rcache.CacheGeometry(sets, ways, 64), policy)
    np.testing.assert_array_equal(h.numpy()[0], gold.run(lines))
    assert int(e.sum()) == gold.num_evictions


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("case", ["one_set", "few_sets"])
def test_cache_scan_by_set_longest_chain_and_few_sets(policy, case):
    """A row whose every access falls in one set (the longest chain a team
    can walk) beside ordinary rows, at tpuv6e()'s 16 x 16 set groups; and a
    group of 5 sets, fewer than 16."""
    rng = np.random.default_rng(29)
    sets, ways = (16, 16) if case == "one_set" else (5, 4)
    s, t, v = _rows(rng, 4, 256, sets, ways, pad_from=200)
    if case == "one_set":
        s[0] = 9
        t[0] = rng.integers(0, 3 * ways, size=256)
    _assert_by_set_equals_references(s, t, v, sets, ways, policy)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("sets,ways,space", PALLAS_TEST_GEOMS)
def test_port_pallas_backend_equals_golden(policy, sets, ways, space):
    rng = np.random.default_rng(0)
    lines = rng.integers(0, space, size=300)
    geom = tcache.CacheGeometry(num_sets=sets, ways=ways, line_bytes=64)
    ours = tcache.simulate_cache(lines, geom, policy, backend="pallas", device="cpu")
    gold = GoldenCache(rcache.CacheGeometry(sets, ways, 64), policy)
    np.testing.assert_array_equal(ours.hits, gold.run(lines))
    assert (ours.num_hits, ours.num_misses, ours.num_evictions) == (
        gold.num_hits, gold.num_misses, gold.num_evictions)


@settings(max_examples=15, deadline=None)
@given(
    policy=st.sampled_from(POLICIES),
    sets=st.sampled_from([1, 2, 3, 5, 8, 33]),
    ways=st.sampled_from([1, 2, 4, 7]),
    n=st.integers(20, 150),
    space=st.integers(4, 600),
    seed=st.integers(0, 2**31 - 1),
)
def test_port_pallas_backend_property(policy, sets, ways, n, space, seed):
    lines = np.random.default_rng(seed).integers(0, space, size=n)
    geom = tcache.CacheGeometry(num_sets=sets, ways=ways, line_bytes=64)
    ours = tcache.simulate_cache(lines, geom, policy, backend="pallas", device="cpu")
    gold = GoldenCache(rcache.CacheGeometry(sets, ways, 64), policy)
    np.testing.assert_array_equal(ours.hits, gold.run(lines))
    assert ours.num_evictions == gold.num_evictions


@pytest.mark.parametrize("sets,ways", EDGE)
def test_stack_distance_plain_equals_numpy_stack_pass(sets, ways):
    """K2's capped distance is min(stack distance, ways); cold = ways."""
    rng = np.random.default_rng(11 * sets + ways)
    lines = rng.integers(0, sets * ways * 3 + 1, size=250)
    s = (lines % sets).astype(np.int32)[None, :]
    t = lines.astype(np.int32)[None, :]
    v = np.ones_like(s, dtype=bool)
    d, e = stack_distance_groups(*_t(s, t, v), sets, ways)
    dist, distinct_before = rstack.stack_distances_np(lines, sets)
    np.testing.assert_array_equal(d.numpy()[0], np.minimum(dist, ways))
    miss = dist >= ways
    np.testing.assert_array_equal(e.numpy()[0], miss & (distinct_before >= ways))
    gold = GoldenCache(rcache.CacheGeometry(sets, ways, 64), "lru")
    np.testing.assert_array_equal(d.numpy()[0] < ways, gold.run(lines))


def _assert_stack_by_set_equals_plain(s, t, v, sets, ways):
    """K2's decomposition equals K2's plain version (the reference's
    recency-list scan)."""
    d, e = stack_distance_by_set_plain(*_t(s, t, v), sets, ways)
    dp, ep = stack_distance_plain(*_t(s, t, v), sets, ways)
    assert torch.equal(d, dp) and torch.equal(e, ep)
    return d, e


@pytest.mark.parametrize("sets,ways", EDGE)
def test_stack_distance_by_set_equals_plain_numpy_and_golden(sets, ways):
    """The kernel's decomposition on the CPU: each row split into its
    per-set sequences, each list held as a permutation of ranks, as K2's
    lane teams hold it. Padded rows with sets out of range against the
    plain version; an unpadded row against the numpy stack pass and
    ``GoldenCache``."""
    rng = np.random.default_rng(17 * sets + ways)
    s, t, v = _rows(rng, 3, 160, sets, ways, pad_from=130)
    s[:, ::9] = -1
    s[:, 4::13] = sets
    d, e = _assert_stack_by_set_equals_plain(s, t, v, sets, ways)
    assert (d.numpy()[s < 0] == ways).all() and not e.numpy()[s >= sets].any()
    lines = rng.integers(0, sets * ways * 3 + 1, size=250)
    s1 = (lines % sets).astype(np.int32)[None, :]
    d, e = stack_distance_by_set_plain(*_t(s1, lines.astype(np.int32)[None, :],
                                           np.ones_like(s1, dtype=bool)), sets, ways)
    dist, distinct_before = rstack.stack_distances_np(lines, sets)
    np.testing.assert_array_equal(d.numpy()[0], np.minimum(dist, ways))
    np.testing.assert_array_equal(e.numpy()[0], (dist >= ways) & (distinct_before >= ways))
    gold = GoldenCache(rcache.CacheGeometry(sets, ways, 64), "lru")
    np.testing.assert_array_equal(d.numpy()[0] < ways, gold.run(lines))
    assert int(e.sum()) == gold.num_evictions


@pytest.mark.parametrize("case", ["one_set", "tag_minus_one", "out_of_range", "two_tiles"])
@pytest.mark.parametrize("sets,ways", [(16, 16), (2, 64), (3, 2)])
def test_stack_distance_by_set_edge_rows(case, sets, ways):
    """A row whose every access falls in one set (the longest chain a team
    walks), valid tags of -1 into empty ways (the reference sums every
    position that holds -1, so a distance can pass ``ways``), rows of sets
    out of range (padding) and a row longer than the kernel's 1,024-position
    tile, each beside ordinary rows."""
    rng = np.random.default_rng(31 + ways)
    L = 1100 if case == "two_tiles" else 200
    s, t, v = _rows(rng, 4, L, sets, ways, pad_from=L - 30)
    if case == "one_set":
        s[0] = sets - 1
        t[0] = rng.integers(0, 3 * ways, size=L)
    elif case == "tag_minus_one":
        t[:, :5] = -1
        t[:, 50:54] = -1
    elif case == "out_of_range":
        s[1] = rng.integers(-3, sets + 3, size=L)
        s[2] = sets
    d, e = _assert_stack_by_set_equals_plain(s, t, v, sets, ways)
    if case == "tag_minus_one" and ways > 2:
        assert int(d.max()) > ways
    if case in ("one_set", "two_tiles"):
        h, _ = rcache._simulate_many(s, t, v, sets, ways, "lru")
        np.testing.assert_array_equal(d.numpy() < ways, np.asarray(h))


def test_stack_distance_plain_padding_reports_ways_and_no_evict():
    rng = np.random.default_rng(3)
    s, t, v = _rows(rng, 4, 96, 3, 2, pad_from=60)
    d, e = stack_distance_groups(*_t(s, t, v), 3, 2)
    assert (d.numpy()[~v] == 2).all() and not e.numpy()[~v].any()
    h, _ = rcache._simulate_many(s, t, v, 3, 2, "lru")
    np.testing.assert_array_equal(d.numpy() < 2, np.asarray(h))


@pytest.mark.parametrize("backend", ["scan", "pallas", "stack", "stack_pallas"])
@pytest.mark.parametrize("sets,ways,space", [(40, 4, 3000), (16, 16, 900), (85, 3, 5000)])
def test_port_lru_backends_equal_jax_scan_through_set_groups(backend, sets, ways, space):
    """Geometries above 16 sets split into set groups and length buckets."""
    rng = np.random.default_rng(sets)
    lines = rng.integers(0, space, size=1500)
    rgeom = rcache.CacheGeometry(sets, ways, 64)
    ref = rcache.simulate_cache(lines, rgeom, "lru", backend="scan")
    ours = tcache.simulate_cache(lines, tcache.CacheGeometry(sets, ways, 64), "lru",
                                 backend=backend, device="cpu")
    np.testing.assert_array_equal(ours.hits, ref.hits)
    assert ours.num_evictions == ref.num_evictions


@pytest.mark.parametrize("policy", ["srrip", "fifo"])
def test_port_srrip_fifo_equal_jax_scan_through_set_groups(policy):
    rng = np.random.default_rng(5)
    lines = rng.integers(0, 4000, size=1500)
    ref = rcache.simulate_cache(lines, rcache.CacheGeometry(40, 4, 64), policy, backend="scan")
    geom = tcache.CacheGeometry(40, 4, 64)
    for backend in ("scan", "pallas"):
        ours = tcache.simulate_cache(lines, geom, policy, backend=backend, device="cpu")
        np.testing.assert_array_equal(ours.hits, ref.hits)
        assert ours.num_evictions == ref.num_evictions


@pytest.mark.parametrize("policy", ["srrip", "fifo"])
@pytest.mark.parametrize("backend", ["stack", "stack_pallas"])
def test_srrip_fifo_stack_backends_equal_golden(policy, backend):
    """srrip/fifo under the stack variants run the compressed per-set
    engines (``memory/rrip.py``, row scans on D2's plain version here)."""
    lines = np.random.default_rng(9).integers(0, 40, size=600)
    geom = tcache.CacheGeometry(4, 2, 64)
    ours = tcache.simulate_cache(lines, geom, policy, backend=backend, device="cpu")
    golden = GoldenCache(rcache.CacheGeometry(4, 2, 64), policy)
    np.testing.assert_array_equal(ours.hits, golden.run(lines))
    assert ours.num_evictions == golden.num_evictions
    assert ours.num_misses == golden.num_misses


@pytest.mark.parametrize("n,space,sets", [(1, 5, 1), (300, 50, 3), (5000, 2000, 16), (20000, 3000, 33)])
def test_torch_stack_pass_equals_numpy_twin(n, space, sets):
    lines = np.random.default_rng(n).integers(0, space, size=n)
    want = rstack.stack_distances_np(lines, sets)
    got = tstack.stack_distances_torch(lines, sets, CPU)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tstack.stack_distances_np(lines, sets), want):
        np.testing.assert_array_equal(a, b)


def test_classify_lru_stack_many_equals_reference():
    rng = np.random.default_rng(2)
    lines = rng.integers(0, 5000, size=4000)
    geoms = [(8, 4), (8, 16), (32, 2), (1, 64)]
    ref = rstack.classify_lru_stack_many(
        [lines] * len(geoms), [rcache.CacheGeometry(s, w, 64) for s, w in geoms], engine="np")
    ours = tstack.classify_lru_stack_many(
        [lines] * len(geoms), [tcache.CacheGeometry(s, w, 64) for s, w in geoms], CPU)
    for (h1, e1), (h2, e2) in zip(ours, ref):
        np.testing.assert_array_equal(h1, h2)
        assert e1 == e2


def test_cache_wrappers_validate_inputs():
    s = torch.zeros((2, 8), dtype=torch.int32)
    v = torch.ones((2, 8), dtype=torch.bool)
    with pytest.raises(TypeError, match="int32"):
        cache_scan_groups(s.long(), s, v, 1, 1, "lru")
    with pytest.raises(ValueError, match="shape"):
        stack_distance_groups(s, s[:, :4], v, 1, 1)
    with pytest.raises(ValueError, match="unknown policy"):
        cache_scan_groups(s, s, v, 1, 1, "lfu")
