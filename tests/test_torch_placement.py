"""The NUMA placement layer of the PyTorch port (``PlacementMap``,
``profile_hot_vectors``, the channel-affinity and placement axes of
``simulate`` and ``sweep``, on the CPU) against the JAX package's, bitwise:
every case of ``tests/test_placement.py`` that reaches them. The transform is
host numpy in both packages; every placed address, group, DRAM finish matrix
and ``SimResult`` must be the reference's.

Small sizes: 6 tables x 4,000 rows for the address transforms, 6 tables x
1,500 rows, batch 6, 2 batches for ``simulate`` and ``sweep``.
"""
import importlib
from dataclasses import replace

import numpy as np
import pytest
from differential import assert_bitwise_equal_results
from test_torch_multicore import etraces, pair, sim_results, simulate_pair, stats
from test_torch_sweep import plain, same_sweep

import repro.core as R
import repro_torch.core as T
from repro.core.memory import dram as rdram
from repro.core import trace as rtrace
from repro.core.workload import EmbeddingOpSpec as RSpec
from repro_torch.core.memory import dram as tdram
from repro_torch.core import trace as ttrace
from repro_torch.core.workload import EmbeddingOpSpec as TSpec

SPEC = dict(num_tables=6, rows_per_table=4000, dim=128, lookups_per_sample=6, dtype_bytes=4)
WL = dict(num_tables=6, rows_per_table=1500, dim=128, lookups=3, batch_size=6, num_batches=2)
AFFINITIES = ("symmetric", "per_core", "per_table")
PLACEMENTS = ("interleave", "table_rank", "hot_replicate")


def pmaps(hw_change, spec=SPEC, hot_vecs=None, base=None):
    """The ``PlacementMap`` of ``hw_change(tpuv6e())`` in each package:
    ``(reference, port)``."""
    out = []
    for pkg, dram, tr, Spec in ((R, rdram, rtrace, RSpec), (T, tdram, ttrace, TSpec)):
        hw = hw_change(base(pkg) if base else pkg.tpuv6e())
        out.append(tr.PlacementMap.from_model(dram.DramModel.from_hardware(hw), hw,
                                              Spec(**spec), hot_vecs=hot_vecs))
    return tuple(out)


def vector_lines(rng, nv, spec=SPEC, lpv=8):
    base = rng.integers(0, spec["num_tables"] * TSpec(**spec).table_bytes // 512,
                        size=nv).astype(np.int64) * lpv
    return (base[:, None] + np.arange(lpv)[None, :]).reshape(-1)


def one_rank(pkg):
    base = pkg.tpuv6e()
    return replace(base, offchip=replace(base.offchip, banks_per_channel=1))


def contended(lines, seg, src, num_segments, num_sources):
    """``dram_timing_contended`` in both packages, asserted bitwise equal."""
    ours = tdram.dram_timing_contended(lines, seg, src, num_segments, num_sources,
                                       tdram.DramModel.from_hardware(T.tpuv6e()), device="cpu")
    ref = rdram.dram_timing_contended(lines, seg, src, num_segments, num_sources,
                                      rdram.DramModel.from_hardware(R.tpuv6e()))
    assert_bitwise_equal_results([plain(r) for r in ours[0]], [plain(r) for r in ref[0]])
    np.testing.assert_array_equal(ours[1], ref[1])
    return ours


# --------------------------------------------------------------------------
# The degenerate configuration is the identity
# --------------------------------------------------------------------------

def test_symmetric_interleave_map_is_identity(rng):
    pm_r, pm_t = pmaps(lambda hw: hw)
    assert pm_t.is_identity and pm_r.is_identity
    lines = vector_lines(rng, 3000)
    placed = pm_t.place(lines, rng.integers(0, 4, size=lines.size))
    assert placed is lines or np.array_equal(placed, lines)
    et_t = etraces(SPEC, (4,))[1]
    assert T.MemorySystem.from_hardware(T.tpuv6e(), "cpu").placement_map(et_t) is None


@pytest.mark.parametrize("policy", ["fifo", "lru", "pinning", "spm", "srrip"])
@pytest.mark.parametrize("cores,topo", [(1, "private"), (2, "private"), (2, "shared")])
def test_symmetric_interleave_equals_jax_package_per_policy(cores, topo, policy):
    et_r, et_t = etraces(SPEC, (6, 9))
    hw_r, hw_t = pair(lambda hw: hw.with_cluster(cores, topo), policy)
    ours = simulate_pair(hw_r, hw_t.with_placement("symmetric", "interleave"), et_r, et_t)
    default = T.memory_system_for(hw_t, "cpu").simulate_embedding(et_t)
    assert_bitwise_equal_results(stats(ours), stats(default))


@pytest.mark.parametrize("backend", ["scan", "pallas", "stack", "stack_pallas"])
def test_symmetric_interleave_equals_jax_package_per_backend(backend):
    wl = dict(num_tables=2, rows_per_table=300, batch_size=2, num_batches=2)
    ours = sim_results(wl, lambda hw: hw.with_placement("symmetric", "interleave"),
                       zipf_s=0.9, capacity=1 << 14, backend=backend)
    hw = T.tpuv6e().with_policy("lru", capacity_bytes=1 << 14).with_cache_backend(backend)
    assert not ours.diff(T.simulate(T.dlrm_rmc2_small(**wl), hw, seed=0, zipf_s=0.9,
                                    device="cpu"))


# --------------------------------------------------------------------------
# The transform: total, affine, injective, and the reference's bit for bit
# --------------------------------------------------------------------------

@pytest.mark.parametrize("placement", PLACEMENTS)
@pytest.mark.parametrize("affinity", AFFINITIES)
@pytest.mark.parametrize("cores", [1, 2, 4, 8, 16])
def test_place_equals_jax_package(cores, affinity, placement):
    rng = np.random.default_rng(cores * 31 + len(affinity) * 7 + len(placement))
    lines = vector_lines(rng, 500)
    src = rng.integers(0, cores, size=lines.size).astype(np.int64)
    hot = None
    if placement == "hot_replicate":
        vecs = (lines * 64) // TSpec(**SPEC).vector_bytes
        hot = ttrace.profile_hot_vectors(vecs)
        np.testing.assert_array_equal(hot, rtrace.profile_hot_vectors(vecs))
    pm_r, pm_t = pmaps(lambda hw: hw.with_cluster(cores, "private", "table_hash")
                       .with_placement(affinity, placement), hot_vecs=hot)
    assert (pm_t.group_size, pm_t.effective_placement, pm_t.is_identity, pm_t._table_span,
            pm_t._hot_q_base) == (pm_r.group_size, pm_r.effective_placement,
                                  pm_r.is_identity, pm_r._table_span, pm_r._hot_q_base)
    group = pm_t.group_of(lines, src)
    np.testing.assert_array_equal(group, pm_r.group_of(lines, src))
    placed = pm_t.place(lines, src)
    np.testing.assert_array_equal(placed, pm_r.place(lines, src))
    np.testing.assert_array_equal(pm_t.table_of(lines), pm_r.table_of(lines))
    np.testing.assert_array_equal(pm_t.rank_of_table(np.arange(7)),
                                  pm_r.rank_of_table(np.arange(7)))
    # total, on the request's affine channels, injective per source
    dm = tdram.DramModel.from_hardware(T.tpuv6e())
    ch, _bk, _row = dm.decompose(placed)
    assert placed.shape == lines.shape and np.all(placed >= 0)
    for g in range(pm_t.num_groups):
        np.testing.assert_array_equal(pm_t.affine_channels(g), pm_r.affine_channels(g))
        m = group == g
        assert set(np.unique(ch[m]).tolist()) <= set(pm_t.affine_channels(g).tolist())
    for c in range(cores):
        m = src == c
        assert np.unique(placed[m]).size == np.unique(lines[m]).size
    # the sibling memo: a shared ``cache`` gives the same addresses
    cache = {}
    np.testing.assert_array_equal(pm_t.place(lines, src, cache=cache), placed)
    np.testing.assert_array_equal(pm_t.place(lines, src, cache=cache), placed)


def test_profile_hot_vectors_equals_jax_package(rng):
    vecs = rng.zipf(1.2, size=20_000) % 50_000
    for frac in (0.05, 0.01, 0.5):
        np.testing.assert_array_equal(ttrace.profile_hot_vectors(vecs, frac),
                                      rtrace.profile_hot_vectors(vecs, frac))
    assert ttrace.HOT_REPLICATE_FRACTION == rtrace.HOT_REPLICATE_FRACTION
    assert ttrace.profile_hot_vectors(np.zeros(0, dtype=np.int64)).size == 0
    et_r, et_t = etraces(SPEC, (6, 9))
    np.testing.assert_array_equal(et_t.hot_vec_ids, et_r.hot_vec_ids)


@pytest.mark.parametrize("cores", [2, 4])
def test_symmetric_per_source_finish_equals_jax_package(cores):
    """Under symmetric affinity the source tags only attribute: per-segment
    results equal the one-source call's, and the finish matrix is the
    reference's."""
    rng = np.random.default_rng(cores)
    lines = vector_lines(rng, 400)
    seg = np.sort(rng.integers(0, 2, size=lines.size))
    src = rng.integers(0, cores, size=lines.size)
    res, fin = contended(lines, seg, src, 2, cores)
    one, fin1 = contended(lines, seg, np.zeros(lines.size, dtype=np.int64), 2, 1)
    assert_bitwise_equal_results([plain(r) for r in res], [plain(r) for r in one])
    for s in range(2):
        assert fin[s].max() == res[s].finish_cycle == fin1[s, 0]


@pytest.mark.parametrize("cores", [2, 4, 8])
def test_per_core_contended_equals_jax_package_and_private_groups(cores):
    """per_core affinity isolates the cores' channel groups: the contended
    call equals each core's stream timed alone, and the reference."""
    rng = np.random.default_rng(100 + cores)
    pm_r, pm_t = pmaps(lambda hw: hw.with_cluster(cores, "private", "table_hash")
                       .with_placement("per_core", "interleave"))
    nv = 600
    lines = vector_lines(rng, nv)
    seg = np.repeat(np.sort(rng.integers(0, 2, size=nv)), 8)
    src = np.repeat(rng.integers(0, cores, size=nv), 8)
    placed = pm_t.place(lines, src)
    np.testing.assert_array_equal(placed, pm_r.place(lines, src))
    res, fin = contended(placed, seg, src, 2, cores)
    tm = tdram.DramModel.from_hardware(T.tpuv6e())
    alone = [tdram.dram_timing_segmented(placed[src == c], seg[src == c], 2, tm, device="cpu")
             for c in range(cores)]
    for s in range(2):
        for c in range(cores):
            want = alone[c][s].finish_cycle if np.any((src == c) & (seg == s)) else 0.0
            assert fin[s, c] == want, (s, c)
        assert res[s].row_hits == sum(a[s].row_hits for a in alone)
        assert res[s].finish_cycle == max(a[s].finish_cycle for a in alone)


# --------------------------------------------------------------------------
# Sweep axes and memo keys
# --------------------------------------------------------------------------

PLACEMENT_AXES = dict(policies=("spm", "lru"), capacities=(1 << 16,), ways=(4,), zipf_s=1.0,
                      seed=0, channel_affinities=AFFINITIES, placements=PLACEMENTS)


def test_sweep_placement_axes_equal_jax_package():
    base_r = R.tpuv6e().with_cluster(2, "private", "table_hash")
    base_t = T.tpuv6e().with_cluster(2, "private", "table_hash")
    ours = T.sweep(T.dlrm_rmc2_small(**WL), base_t, device="cpu", **PLACEMENT_AXES)
    same_sweep(ours, R.sweep(R.dlrm_rmc2_small(**WL), base_r, **PLACEMENT_AXES),
               "placement axes")
    assert ours.num_configs == 18
    by_aff = {e.config.channel_affinity: e.result.embedding_cycles for e in ours.entries
              if e.config.policy == "spm" and e.config.placement == "interleave"}
    assert by_aff["symmetric"] != by_aff["per_core"]
    e = next(e for e in ours.entries if e.config.placement == "hot_replicate"
             and e.config.channel_affinity == "per_core" and e.config.policy == "lru")
    hw = base_t.with_policy("lru", capacity_bytes=1 << 16, ways=4).with_placement(
        "per_core", "hot_replicate")
    assert not e.result.diff(T.simulate(T.dlrm_rmc2_small(**WL), hw, seed=0, zipf_s=1.0,
                                        device="cpu"))


def test_single_core_affinity_collapses_as_in_the_jax_package():
    axes = dict(policies=("lru",), capacities=(1 << 16,), ways=(4,), zipf_s=1.0, seed=0,
                channel_affinities=AFFINITIES, placements=("interleave", "table_rank"))
    ours = T.sweep(T.dlrm_rmc2_small(**WL), T.tpuv6e(), device="cpu", **axes)
    same_sweep(ours, R.sweep(R.dlrm_rmc2_small(**WL), R.tpuv6e(), **axes), "one-core affinities")
    assert ours.distinct_memo_keys == 2
    by = {(e.config.channel_affinity, e.config.placement): e.result for e in ours.entries}
    for plc in ("interleave", "table_rank"):
        for aff in ("per_core", "per_table"):
            assert not by[(aff, plc)].diff(by[("symmetric", plc)])


@pytest.mark.parametrize("batch_scans", [True, False])
def test_single_core_table_rank_sweep_equals_jax_package(batch_scans):
    axes = dict(policies=("lru",), capacities=(1 << 16, 1 << 17, 1 << 18), ways=(4,),
                zipf_s=1.0, seed=0, batch_scans=batch_scans)
    ours = T.sweep(T.dlrm_rmc2_small(**WL), T.tpuv6e().with_placement("symmetric", "table_rank"),
                   device="cpu", **axes)
    ref = R.sweep(R.dlrm_rmc2_small(**WL), R.tpuv6e().with_placement("symmetric", "table_rank"),
                  **{**axes, "batch_scans": True})
    same_sweep(ours, ref, f"table_rank, batch_scans={batch_scans}")
    assert all(e.config.placement == "table_rank" for e in ours.entries)


def test_effective_placement_degeneracy_equals_jax_package(rng):
    spec1 = dict(SPEC, num_tables=1)
    pm_r, pm_t = pmaps(lambda hw: hw.with_placement("symmetric", "table_rank"), spec1,
                       base=one_rank)
    assert pm_t.effective_placement == pm_r.effective_placement == "interleave"
    assert pm_t.is_identity
    lines = rng.integers(0, TSpec(**spec1).table_bytes // 64, size=4000).astype(np.int64)
    assert np.array_equal(pm_t.place(lines), lines)
    src = rng.integers(0, 2, size=lines.size).astype(np.int64)
    grouped = lambda plc: (lambda hw: hw.with_cluster(2, "private", "table_hash")
                           .with_placement("per_core", plc))
    tr_r, tr_t = pmaps(grouped("table_rank"), spec1, base=one_rank)
    _, il_t = pmaps(grouped("interleave"), spec1, base=one_rank)
    assert tr_t.effective_placement == "interleave" and not tr_t.is_identity
    np.testing.assert_array_equal(tr_t.place(lines, src), il_t.place(lines, src))
    np.testing.assert_array_equal(tr_t.place(lines, src), tr_r.place(lines, src))
    for change, spec, base, hot, want in (
            (lambda hw: hw.with_placement("symmetric", "table_rank"), SPEC, one_rank, None,
             "table_rank"),
            (lambda hw: hw.with_placement("symmetric", "table_rank"), spec1, None, None,
             "table_rank"),
            (lambda hw: hw.with_placement("symmetric", "hot_replicate"), spec1, None,
             np.zeros(0, dtype=np.int64), "table_rank")):
        r, t = pmaps(change, spec, hot, base)
        assert t.effective_placement == r.effective_placement == want


def test_degenerate_table_rank_collapses_onto_the_base_entry(monkeypatch):
    """One rank and one table: table_rank keys onto the interleave entry —
    one DRAM request for both grid points, as in the reference."""
    sweep_mod = importlib.import_module("repro_torch.core.sweep")
    calls = []
    orig = sweep_mod.dram_timing_many
    monkeypatch.setattr(sweep_mod, "dram_timing_many",
                        lambda reqs, batch=True, device="cuda":
                        calls.append(len(reqs)) or orig(reqs, batch=batch, device=device))
    wl = dict(WL, num_tables=1)
    axes = dict(policies=("lru",), capacities=(1 << 16,), ways=(4,), zipf_s=1.0, seed=0,
                placements=("interleave", "table_rank"))
    ours = T.sweep(T.dlrm_rmc2_small(**wl), one_rank(T), device="cpu", **axes)
    same_sweep(ours, R.sweep(R.dlrm_rmc2_small(**wl), one_rank(R), **axes), "degenerate")
    assert ours.num_configs == 2 and sum(calls) == 1


def test_placement_siblings_share_classification(monkeypatch):
    """Grid points that differ only in (affinity, placement) classify once
    per class key (``classify_for_pending`` → ``pending_from``)."""
    counts = {}
    for pkg, mod in ((R, "repro.core.memory.system"), (T, "repro_torch.core.memory.system")):
        cls = importlib.import_module(mod).MultiCoreMemorySystem
        orig = cls.classify_for_pending
        counts[pkg.__name__] = 0

        def spy(self, *a, _orig=orig, _name=pkg.__name__, **k):
            counts[_name] += 1
            return _orig(self, *a, **k)

        monkeypatch.setattr(cls, "classify_for_pending", spy)
    base = lambda pkg: pkg.tpuv6e().with_cluster(2, "private", "table_hash")
    ours = T.sweep(T.dlrm_rmc2_small(**WL), base(T), device="cpu", **PLACEMENT_AXES)
    ref = R.sweep(R.dlrm_rmc2_small(**WL), base(R), **PLACEMENT_AXES)
    same_sweep(ours, ref, "placement siblings")
    assert counts == {"repro.core": 2, "repro_torch.core": 2}


def test_dram_timing_many_placement_edge_cases_equal_jax_package(rng):
    """Batched ``dram_timing_many`` over placed requests: one busy channel
    group of 16, one-line and one-vector requests, an all-hot trace."""
    reqs = {"r": [], "t": []}
    hw16 = lambda hw: hw.with_cluster(16, "private", "table_hash").with_placement(
        "per_core", "interleave")
    pm_r, pm_t = pmaps(hw16)
    lines = vector_lines(rng, 300)
    src = np.zeros(lines.size, dtype=np.int64)
    seg = np.sort(rng.integers(0, 2, size=lines.size))
    one = vector_lines(rng, 1)[:1]
    vec = vector_lines(rng, 1)
    lines_h = vector_lines(rng, 400)
    all_vecs = np.unique((lines_h * 64) // TSpec(**SPEC).vector_bytes)
    hot_r, hot_t = pmaps(lambda hw: hw16(hw).with_placement("per_core", "hot_replicate"),
                         hot_vecs=all_vecs)
    src_h = rng.integers(0, 16, size=lines_h.size).astype(np.int64)
    seg_h = np.sort(rng.integers(0, 2, size=lines_h.size))
    for k, dram, pm, hot, pkg in (("r", rdram, pm_r, hot_r, R), ("t", tdram, pm_t, hot_t, T)):
        dm = dram.DramModel.from_hardware(hw16(pkg.tpuv6e()))
        z1, zv = np.zeros(1, dtype=np.int64), np.zeros(vec.size, dtype=np.int64)
        reqs[k] = [dram.DramRequest(pm.place(lines, src), seg, src, 2, 16, dm),
                   dram.DramRequest(one, z1, z1, 1, 1, dm),
                   dram.DramRequest(vec, zv, zv, 1, 1, dm),
                   dram.DramRequest(hot.place(lines_h, src_h), seg_h, src_h, 2, 16, dm)]
    ours = tdram.dram_timing_many(reqs["t"], batch=True, device="cpu")
    unbatched = tdram.dram_timing_many(reqs["t"], batch=False, device="cpu")
    ref = rdram.dram_timing_many(reqs["r"], batch=True)
    for (ob, of), (ub, uf), (rb, rf) in zip(ours, unbatched, ref):
        assert_bitwise_equal_results([plain(r) for r in ob], [plain(r) for r in rb])
        assert_bitwise_equal_results([plain(r) for r in ob], [plain(r) for r in ub])
        np.testing.assert_array_equal(of, rf)
        np.testing.assert_array_equal(of, uf)


def test_hot_replicate_equals_jax_package_and_conserves_accesses():
    wl = dict(num_tables=6, rows_per_table=4000, dim=128, lookups=6, batch_size=12,
              num_batches=2)
    cluster = lambda hw: hw.with_cluster(2, "private", "table_hash")
    a = sim_results(wl, lambda hw: cluster(hw).with_placement("per_core", "hot_replicate"),
                    zipf_s=1.05)
    ref = sim_results(wl, cluster, zipf_s=1.05)
    assert (a.cache_hits, a.cache_misses, a.offchip_reads) == (
        ref.cache_hits, ref.cache_misses, ref.offchip_reads)
    assert (a.batches[0].dram_row_hits + a.batches[0].dram_row_misses
            == ref.batches[0].dram_row_hits + ref.batches[0].dram_row_misses)


def test_per_core_affinity_reduces_contention_as_in_the_jax_package():
    wl = dict(num_tables=6, rows_per_table=20000, dim=128, lookups=8, batch_size=32,
              num_batches=2)
    cluster = lambda hw: hw.with_cluster(2, "private", "table_hash")
    sym = sim_results(wl, cluster, zipf_s=1.05, policy="spm")
    pc = sim_results(wl, lambda hw: cluster(hw).with_placement("per_core", "interleave"),
                     zipf_s=1.05, policy="spm")
    assert pc.embedding_cycles < sym.embedding_cycles


# --------------------------------------------------------------------------
# Validation
# --------------------------------------------------------------------------

def test_table_rank_never_shares_a_row_across_tables():
    spec = dict(num_tables=8, rows_per_table=4001, dim=128, lookups_per_sample=4, dtype_bytes=4)
    pm_r, pm = pmaps(lambda hw: hw.with_cluster(16, "private", "table_hash")
                     .with_placement("per_core", "table_rank"), spec)
    dm = tdram.DramModel.from_hardware(T.tpuv6e())
    lpv = TSpec(**spec).vector_bytes // 64
    rows = np.arange(spec["rows_per_table"] * spec["num_tables"], dtype=np.int64)
    lines = (rows[:, None] * lpv + np.arange(lpv)[None, :]).reshape(-1)
    src = ttrace.table_core_of(pm.table_of(lines), 16).astype(np.int64)
    placed = pm.place(lines, src)
    np.testing.assert_array_equal(placed, pm_r.place(lines, src))
    ch, bk, row = dm.decompose(placed)
    key = (ch.astype(np.int64) * dm.banks_per_channel + bk) * (2**32) + row
    t = pm.table_of(lines)
    order = np.argsort(key, kind="stable")
    same_row = key[order][1:] == key[order][:-1]
    assert np.all(t[order][1:][same_row] == t[order][:-1][same_row])


def test_per_core_group_needs_source_tags():
    _, pm = pmaps(lambda hw: hw.with_cluster(4, "private", "table_hash")
                  .with_placement("per_core", "table_rank"))
    with pytest.raises(ValueError, match="source-core"):
        pm.group_of(np.arange(10, dtype=np.int64), None)


def test_uneven_channel_split_rejected():
    wl = T.dlrm_rmc2_small(num_tables=3, rows_per_table=500, lookups=2, batch_size=4)
    hw = T.tpuv6e().with_cluster(3, "private", "table_hash").with_placement(
        "per_core", "interleave")
    with pytest.raises(ValueError, match="divisible"):
        T.simulate(wl, hw, seed=0, device="cpu")
