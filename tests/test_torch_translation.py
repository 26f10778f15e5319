"""Address translation (``memory/tlb.py``) and the many-configuration
embedding engines of the PyTorch port, held bitwise against the JAX package
on the CPU: the TLB classifiers, the translation charge with and without an
L2, the saturation test, ``simulate`` with translation on for every policy,
and ``classify_embedding_many`` / ``simulate_embedding_many`` against a
per-system loop and against the reference.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch
from differential import assert_bitwise_equal_results

import repro.core as R
from repro.core.engine import build_embedding_traces as r_build
from repro.core.memory import system as rsystem
from repro.core.memory import tlb as rtlb
import repro_torch.core as T
from repro_torch.convert import workload_from_dict
from repro_torch.core.engine import build_embedding_traces as t_build
from repro_torch.core.memory import rrip as trrip
from repro_torch.core.memory import system as tsystem
from repro_torch.core.memory import tlb as ttlb
from repro_torch.core.memory.stack import distance_pass_count
from repro_torch.kernels import rrip_scan as d2

CAP = 1 << 14
POLICIES = ["spm", "lru", "srrip", "fifo", "pinning"]


def _page_streams():
    rng = np.random.default_rng(7)
    return {
        "reuse": rng.integers(0, 40, size=300),
        "sparse": rng.integers(0, 5000, size=400),
        "sequential": np.arange(64).repeat(3),
        "degenerate": np.zeros(10, dtype=np.int64),
        "skewed": rng.zipf(1.3, size=500) % 900,
        "empty": np.zeros(0, dtype=np.int64),
    }


def _configs(replacement):
    return [
        R.TranslationConfig(entries=16, ways=4, replacement=replacement),
        R.TranslationConfig(entries=16, ways=4, l2_entries=256, l2_ways=8,
                            l2_latency_cycles=8, replacement=replacement),
        R.TranslationConfig(entries=64, ways=4, page_bytes=1 << 16, walk_latency_cycles=250,
                            l2_entries=1024, replacement=replacement),
    ]


def _port_cfg(cfg):
    return T.TranslationConfig(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("replacement", ["lru", "fifo"])
@pytest.mark.parametrize("num_sets,ways", [(1, 4), (4, 4), (16, 2), (8, 1), (1, 64), (3, 5)])
def test_classify_tlb_equals_golden_and_jax_package(replacement, num_sets, ways):
    for name, pages in _page_streams().items():
        want = rtlb.golden_tlb_hits(pages, num_sets, ways, replacement)
        np.testing.assert_array_equal(
            ttlb.golden_tlb_hits(pages, num_sets, ways, replacement), want, err_msg=name)
        np.testing.assert_array_equal(
            rtlb.classify_tlb(pages, num_sets, ways, replacement, engine="np"), want)
        got = ttlb.classify_tlb(pages, num_sets, ways, replacement, device="cpu")
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("num_sets,ways", [(1, 4), (4, 4), (16, 2), (8, 1), (1, 64), (3, 5)])
def test_classify_tlb_fifo_chunked_route_equals_golden_and_jax_package(num_sets, ways,
                                                                        monkeypatch):
    """A FIFO TLB's rows on D2's chunked route (row tables built with a
    small ``long_row`` and ``chunk``, as the full-size TLB's rows take it on
    the card), one-set geometries included: the whole stream is one row,
    cut into chunks."""
    monkeypatch.setattr(trrip, "RowTable", functools.partial(d2.RowTable, chunk=16, long_row=32))
    for name, pages in _page_streams().items():
        want = rtlb.golden_tlb_hits(pages, num_sets, ways, "fifo")
        np.testing.assert_array_equal(
            rtlb.classify_tlb(pages, num_sets, ways, "fifo", engine="np"), want)
        got = ttlb.classify_tlb(pages, num_sets, ways, "fifo", device="cpu")
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("cfg_index", [0, 1, 2])
@pytest.mark.parametrize("warmup", [16, 0])
def test_charge_translation_fifo_chunked_route_equals_jax_package(cfg_index, warmup,
                                                                  monkeypatch):
    """The translation charge with both TLB levels on the chunked route,
    with a warm-up and without (every chunk after a row's first re-run)."""
    monkeypatch.setattr(trrip, "RowTable", functools.partial(
        d2.RowTable, chunk=32, warmup=warmup, long_row=64))
    rng = np.random.default_rng(11 + cfg_index)
    lines = rng.integers(0, 40000, size=2000)
    batch = np.sort(rng.integers(0, 3, size=2000))
    cfg = _configs("fifo")[cfg_index]
    want = rtlb.charge_translation(lines, batch, 3, 128, cfg, engine="np")
    got = ttlb.charge_translation(lines, batch, 3, 128, _port_cfg(cfg), device="cpu")
    assert_bitwise_equal_results(dataclasses.asdict(got), dataclasses.asdict(want))


def test_classify_tlb_lru_counts_one_distance_pass_and_rejects_bad_input():
    before = distance_pass_count()
    ttlb.classify_tlb(np.arange(50) % 7, 2, 2, "lru", device="cpu")
    assert distance_pass_count() - before == 1
    with pytest.raises(ValueError, match="replacement"):
        ttlb.classify_tlb(np.arange(4), 2, 2, "rrip", device="cpu")
    with pytest.raises(ValueError, match="int32"):
        ttlb.classify_tlb(np.array([2**31]), 2, 2, "lru", device="cpu")
    with pytest.raises(ValueError, match="span"):
        ttlb.tlb_pages(np.arange(4), 256, 128)


@pytest.mark.parametrize("line_bytes,page_bytes", [(128, 4096), (64, 4096), (512, 1 << 20),
                                                   (96, 4096)])
def test_tlb_pages_equals_jax_package(line_bytes, page_bytes):
    lines = np.random.default_rng(1).integers(0, 1 << 30, size=1000)
    np.testing.assert_array_equal(ttlb.tlb_pages(lines, line_bytes, page_bytes),
                                  rtlb.tlb_pages(lines, line_bytes, page_bytes))


@pytest.mark.parametrize("replacement", ["lru", "fifo"])
@pytest.mark.parametrize("cfg_index", [0, 1, 2])
def test_charge_translation_equals_jax_package(replacement, cfg_index):
    """With and without an L2 (which observes only the L1 misses)."""
    rng = np.random.default_rng(3 + cfg_index)
    lines = rng.integers(0, 40000, size=2000)
    batch = np.sort(rng.integers(0, 3, size=2000))
    cfg = _configs(replacement)[cfg_index]
    want = rtlb.charge_translation(lines, batch, 3, 128, cfg, engine="np")
    got = ttlb.charge_translation(lines, batch, 3, 128, _port_cfg(cfg), device="cpu")
    assert_bitwise_equal_results(dataclasses.asdict(got), dataclasses.asdict(want))
    assert np.array_equal(got.hits + got.misses, np.bincount(batch, minlength=3))


def test_charge_cache_lookup_memoizes_by_config():
    rng = np.random.default_rng(5)
    lines, batch = rng.integers(0, 9000, size=500), np.zeros(500, np.int64)
    cache = {}
    cfg = _port_cfg(_configs("fifo")[1])
    first = ttlb.charge_cache_lookup(cache, lines, batch, 1, 128, cfg, device="cpu")
    again = ttlb.charge_cache_lookup(cache, lines[:10], batch[:10], 1, 128, cfg, device="cpu")
    assert again is first and list(cache) == [cfg.key]


@pytest.mark.parametrize("pages,entries,ways", [
    (np.arange(16), 8, 2), (np.arange(4), 8, 2), (np.zeros(0, np.int64), 8, 2),
    (np.arange(0, 64, 4), 16, 4), (np.arange(0, 64, 4), 64, 16), (np.array([5, 5, 9]), 1, 1),
])
def test_translation_saturated_equals_jax_package(pages, entries, ways):
    rcfg = R.TranslationConfig(entries=entries, ways=ways)
    assert ttlb.translation_saturated(pages, _port_cfg(rcfg)) == \
        rtlb.translation_saturated(pages, rcfg)


def _workloads():
    wl = R.dlrm_rmc2_small(num_tables=2, rows_per_table=300, batch_size=2, num_batches=2)
    return wl, workload_from_dict(dataclasses.asdict(wl))


@pytest.mark.parametrize("l2", [0, 128])
@pytest.mark.parametrize("replacement", ["lru", "fifo"])
@pytest.mark.parametrize("policy", POLICIES)
def test_simulate_with_translation_equals_jax_package(policy, replacement, l2):
    wl_r, wl_t = _workloads()
    tr = dict(entries=16, ways=4, l2_entries=l2, replacement=replacement)
    ref = R.simulate(wl_r, R.tpuv6e().with_policy(policy, capacity_bytes=CAP).with_translation(**tr))
    ours = T.simulate(wl_t, T.tpuv6e().with_policy(policy, capacity_bytes=CAP)
                      .with_translation(**tr), device="cpu")
    assert ours.tlb_walks > 0 and ours.translation_cycles > 0
    assert_bitwise_equal_results(dataclasses.asdict(ours), dataclasses.asdict(ref))
    assert_bitwise_equal_results(ours.summary(), ref.summary())


@pytest.mark.parametrize("backend", ["scan", "pallas", "stack_pallas"])
def test_simulate_with_translation_every_backend(backend):
    """Translation charges the classified miss stream, whatever engine
    classified it: every backend reads the same."""
    _, wl_t = _workloads()
    hw = T.tpuv6e().with_policy("srrip", capacity_bytes=CAP).with_translation(
        entries=32, ways=4, l2_entries=64, replacement="fifo")
    want = T.simulate(wl_t, hw, device="cpu")
    got = T.simulate(wl_t, hw.with_cache_backend(backend), device="cpu")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def _systems(policy, geometries, translation=None):
    """Port and reference MemorySystems of one policy over several
    (capacity, ways) geometries."""
    out = []
    for cap, ways in geometries:
        hw = R.tpuv6e().with_policy(policy, capacity_bytes=cap, ways=ways)
        if translation:
            hw = hw.with_translation(**translation)
        from repro_torch.convert import hardware_from_dict
        out.append((rsystem.MemorySystem.from_hardware(hw),
                    tsystem.MemorySystem.from_hardware(hardware_from_dict(dataclasses.asdict(hw)),
                                                       "cpu")))
    return out


GEOMS = [(CAP, 16), (CAP, 4), (4 * CAP, 16), (CAP // 2, 3)]


@pytest.mark.parametrize("translation", [None, dict(entries=16, ways=4, replacement="fifo")])
@pytest.mark.parametrize("policy", ["lru", "srrip", "fifo", "spm", "pinning"])
def test_simulate_embedding_many_equals_loop_and_jax_package(policy, translation):
    wl_r, wl_t = _workloads()
    et_r, et_t = r_build(wl_r, seed=4)[0], t_build(wl_t, seed=4)[0]
    pairs = _systems(policy, GEOMS, translation)
    ours = tsystem.simulate_embedding_many([p[1] for p in pairs], et_t)
    loop = [p[1].simulate_embedding(et_t) for p in pairs]
    ref = rsystem.simulate_embedding_many([p[0] for p in pairs], et_r)
    as_dicts = lambda runs: [[dataclasses.asdict(s) for s in run] for run in runs]  # noqa: E731
    assert as_dicts(ours) == as_dicts(loop)
    assert_bitwise_equal_results(as_dicts(ours), as_dicts(ref))
    cls = tsystem.classify_embedding_many([p[1] for p in pairs], et_t)
    for cs, (_, ms) in zip(cls, pairs):
        single = ms.classify_embedding(et_t)
        np.testing.assert_array_equal(cs.miss_lines, single.miss_lines)
        np.testing.assert_array_equal(cs.hit_lines, single.hit_lines)


def test_prepare_embedding_many_and_pending_from_equal_prepare_embedding():
    _, wl_t = _workloads()
    et = t_build(wl_t, seed=2)[0]
    systems = [p[1] for p in _systems("fifo", GEOMS, dict(entries=16, ways=2, l2_entries=32))]
    for ms, pend in zip(systems, tsystem.prepare_embedding_many(systems, et)):
        one = ms.prepare_embedding(et)
        via = ms.pending_from(et, ms.classify_for_pending(et))
        for p in (pend, via):
            for f in ("lines", "seg", "src"):
                np.testing.assert_array_equal(getattr(p.request, f), getattr(one.request, f))
    assert tsystem.classify_embedding_many([], et) == []
    assert tsystem.simulate_embedding_many([], et) == []


def test_many_engines_refuse_mixed_policies_devices_and_mixes():
    _, wl_t = _workloads()
    et = t_build(wl_t)[0]
    hw = T.tpuv6e().with_policy("lru", capacity_bytes=CAP)
    lru = tsystem.MemorySystem.from_hardware(hw, "cpu")
    with pytest.raises(ValueError, match="one shared policy"):
        tsystem.classify_embedding_many(
            [lru, tsystem.MemorySystem.from_hardware(hw.with_policy("fifo"), "cpu")], et)
    other = dataclasses.replace(lru, device=torch.device("cuda"))
    with pytest.raises(ValueError, match="one shared device"):
        tsystem.classify_embedding_many([lru, other], et)
    mixed = tsystem.MemorySystem.from_hardware(hw.with_policy_mix({1: "pinning"}), "cpu")
    with pytest.raises(ValueError, match="policy-mix"):
        tsystem.classify_embedding_many([mixed], et)


@pytest.mark.parametrize("line_bytes,page_bytes", [(64, 4096), (512, 4096), (64, 1 << 16)])
def test_embedding_trace_footprints_equal_jax_package(line_bytes, page_bytes):
    wl_r, wl_t = _workloads()
    et_r, et_t = r_build(wl_r, seed=1)[0], t_build(wl_t, seed=1)[0]
    assert et_t.unique_line_count(line_bytes) == et_r.unique_line_count(line_bytes)
    np.testing.assert_array_equal(et_t.unique_pages(line_bytes, page_bytes),
                                  et_r.unique_pages(line_bytes, page_bytes))
    assert et_t.unique_pages(line_bytes, page_bytes) is et_t.unique_pages(line_bytes, page_bytes)


@pytest.mark.parametrize("policy", ["lru", "fifo"])
def test_run_many_equals_run_across_backends(policy):
    """``MemoryPolicy.run_many`` groups contexts by backend into one
    ``classify_streams`` call each; the outcomes are per-pair ``run``'s."""
    from repro_torch.core.memory.cache import CacheGeometry
    from repro_torch.core.memory.policies import PolicyContext, get_policy

    rng = np.random.default_rng(8)
    streams = [rng.integers(0, 3000, size=n) for n in (800, 500, 0, 1200)]
    ctxs = [PolicyContext(geometry=CacheGeometry(s, w, 64), capacity_units=s * w,
                          pinned_lines=None, backend=b, device=torch.device("cpu"))
            for (s, w), b in zip([(16, 4), (8, 8), (4, 2), (40, 3)],
                                 ["stack", "pallas", "stack", "scan"])]
    pol = get_policy(policy)
    for got, s, c in zip(pol.run_many(streams, ctxs), streams, ctxs):
        want = pol.run(s, c)
        np.testing.assert_array_equal(got.hits, want.hits)
        np.testing.assert_array_equal(got.miss_lines, want.miss_lines)
        assert got.onchip_writes == want.onchip_writes
