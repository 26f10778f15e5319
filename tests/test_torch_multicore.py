"""The multi-core cluster of the PyTorch port (``MultiCoreMemorySystem``,
``shard_lookup_cores``, ``shard_trace``, ``memory_system_for``, on the CPU)
against the JAX package's, bitwise: every case of ``tests/test_multicore.py``
that reaches them, the per-batch ``EmbeddingBatchStats`` compared with their
``per_core`` detail. Also the cluster sweep, a cluster journal crossing
between the packages, the LM workload mapper and the CLI's ``--workload lm``.

Small sizes: 3 tables x 3,000 rows (the reference test's spec), 2-6 cores.
Where the port runs a Pallas backend (``pallas``, ``stack_pallas``) the
reference runs its ``scan``/``stack`` engine: the JAX package's Pallas
kernels do not run on the installed jax, and every backend is bit-exact.

The helpers here (``SPEC``, ``etraces``, ``stats``, ``pair``) serve
``test_torch_placement.py`` too.
"""
import dataclasses

import numpy as np
import pytest
from differential import assert_bitwise_equal_results
from test_torch_sweep import plain, same_sweep
from test_torch_sweep_scale import _KillAfter

import repro.core as R
import repro_torch.core as T
from repro.core.memory import dram as rdram
from repro.core.memory.system import EmbeddingTrace as REmbeddingTrace
from repro.core import trace as rtrace
from repro.core.workload import EmbeddingOpSpec as RSpec
from repro_torch.core.memory import dram as tdram
from repro_torch.core.memory.system import EmbeddingTrace as TEmbeddingTrace
from repro_torch.core import trace as ttrace
from repro_torch.core.workload import EmbeddingOpSpec as TSpec

SPEC = dict(num_tables=3, rows_per_table=3000, dim=128, lookups_per_sample=6, dtype_bytes=4)
POLICIES = ("fifo", "lru", "pinning", "spm", "srrip")


def etraces(spec=SPEC, batch_sizes=(8, 8), seed=0, zipf_s=1.0):
    """The same seeded ``EmbeddingTrace`` built by each package:
    ``(reference, port)``."""
    out = []
    for Spec, tr, ET in ((RSpec, rtrace, REmbeddingTrace), (TSpec, ttrace, TEmbeddingTrace)):
        sp = Spec(**spec)
        traces = []
        for bi, bsz in enumerate(batch_sizes):
            it = tr.generate_zipf_trace(bsz * sp.num_tables * sp.lookups_per_sample,
                                        sp.rows_per_table, zipf_s, seed=seed + bi)
            traces.append(tr.expand_trace(it, sp, bsz, seed=seed + bi))
        out.append(ET(sp, traces))
    return tuple(out)


def stats(batch_stats):
    """Per-batch ``EmbeddingBatchStats`` as plain values, ``per_core`` included."""
    return [plain(s) for s in batch_stats]


def ref_backend(backend):
    return {"pallas": "scan", "stack_pallas": "stack"}.get(backend, backend)


def pair(change, policy="lru", capacity=1 << 17, backend="stack", **onchip):
    """``change(pkg.tpuv6e().with_policy(...))`` built in each package:
    ``(reference hw, port hw)``; the reference on ``ref_backend(backend)``."""
    return tuple(
        change(pkg.tpuv6e().with_policy(policy, capacity_bytes=capacity, **onchip)
               .with_cache_backend(b))
        for pkg, b in ((R, ref_backend(backend)), (T, backend)))


def simulate_pair(hw_r, hw_t, et_r, et_t):
    """``memory_system_for(hw).simulate_embedding(et)`` in both packages,
    asserted bitwise equal; returns the port's stats."""
    ours = T.memory_system_for(hw_t, "cpu").simulate_embedding(et_t)
    assert_bitwise_equal_results(stats(ours), stats(R.memory_system_for(hw_r)
                                                     .simulate_embedding(et_r)))
    return ours


def sim_results(wl_kw, change, seed=0, zipf_s=1.0, **pair_kw):
    """``simulate`` of one DLRM workload in both packages, asserted bitwise
    equal field by field; returns the port's ``SimResult``."""
    hw_r, hw_t = pair(change, **pair_kw)
    ref = R.simulate(R.dlrm_rmc2_small(**wl_kw), hw_r, seed=seed, zipf_s=zipf_s)
    ours = T.simulate(T.dlrm_rmc2_small(**wl_kw), hw_t, seed=seed, zipf_s=zipf_s, device="cpu")
    assert_bitwise_equal_results(plain(ours), plain(ref))
    assert_bitwise_equal_results(ours.summary(), ref.summary())
    return ours


# --------------------------------------------------------------------------
# The degenerate cluster (one core, private) is the single-core path
# --------------------------------------------------------------------------

@pytest.mark.parametrize("policy", POLICIES)
def test_degenerate_cluster_equals_jax_package_per_policy(policy):
    et_r, et_t = etraces()
    hw_r, hw_t = pair(lambda hw: hw, policy, 1 << 18)
    ours = T.MultiCoreMemorySystem.from_hardware(hw_t, "cpu").simulate_embedding(et_t)
    ref = R.MultiCoreMemorySystem.from_hardware(hw_r).simulate_embedding(et_r)
    assert_bitwise_equal_results(stats(ours), stats(ref))
    single = T.MemorySystem.from_hardware(hw_t, "cpu").simulate_embedding(et_t)
    assert_bitwise_equal_results(stats(ours), stats(single))
    assert isinstance(T.memory_system_for(hw_t, "cpu"), T.MemorySystem)
    assert T.MultiCoreMemorySystem.from_hardware(hw_t, "cpu").device.type == "cpu"


@pytest.mark.parametrize("policy", POLICIES)
def test_degenerate_cluster_full_simulate_equals_jax_package(policy):
    wl = dict(num_tables=2, rows_per_table=2000, dim=128, lookups=4, batch_size=8,
              num_batches=2)
    ours = sim_results(wl, lambda hw: hw.with_cluster(1, "private"), policy=policy)
    plain_run = T.simulate(T.dlrm_rmc2_small(**wl), T.tpuv6e().with_policy(
        policy, capacity_bytes=1 << 17), seed=0, zipf_s=1.0, device="cpu")
    assert not ours.diff(plain_run)


# --------------------------------------------------------------------------
# Lookup sharding (host numpy, as in the reference)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["batch", "table_hash"])
@pytest.mark.parametrize("num_cores", [1, 2, 3, 5, 8])
def test_shard_trace_equals_jax_package(num_cores, mode):
    et_r, et_t = etraces(batch_sizes=(5, 11, 2), seed=3)
    np.testing.assert_array_equal(ttrace.shard_lookup_cores(et_t.concat, num_cores, mode),
                                  rtrace.shard_lookup_cores(et_r.concat, num_cores, mode))
    ours = ttrace.shard_trace(et_t.concat, num_cores, mode)
    ref = rtrace.shard_trace(et_r.concat, num_cores, mode)
    assert len(ours) == len(ref) == num_cores
    per_batch = np.zeros(et_t.concat.num_batches, dtype=np.int64)
    for o, r in zip(ours, ref):
        assert o.core_id == r.core_id
        assert_bitwise_equal_results(plain(o), plain(r), f"core {o.core_id}")
        per_batch += o.concat.lookups_per_batch
        np.testing.assert_array_equal(et_t.concat.row_ids[o.lookup_index], o.concat.row_ids)
    np.testing.assert_array_equal(per_batch, et_t.concat.lookups_per_batch)


def test_table_hash_keeps_the_64_bit_constant():
    """``table_core_of`` hashes with the 64-bit Knuth constant: table ids past
    2**15 (where a 32-bit product would wrap) map as the reference maps them."""
    tables = np.concatenate([np.arange(4096), np.arange(1 << 15, (1 << 15) + 4096),
                             [2**31 - 1, 2**40 + 7]]).astype(np.int64)
    for n in (1, 2, 3, 4, 7, 16):
        np.testing.assert_array_equal(ttrace.table_core_of(tables, n),
                                      rtrace.table_core_of(tables, n))
    assert ttrace._TABLE_HASH_MULT == rtrace._TABLE_HASH_MULT == 2654435761
    with pytest.raises(ValueError, match="num_cores"):
        ttrace.shard_lookup_cores(etraces()[1].concat, 0)
    with pytest.raises(ValueError, match="sharding mode"):
        ttrace.shard_lookup_cores(etraces()[1].concat, 2, "round_robin")


def test_div_fast_equals_floor_division():
    x = np.arange(0, 1 << 20, 37, dtype=np.int64)
    for d in (1, 2, 3, 8, 12, 64, 1000):
        assert np.array_equal(ttrace._div_fast(x, d), x // d)
        q, r = ttrace._divmod_fast(x, d)
        assert np.array_equal(q, x // d) and np.array_equal(r, x % d)


# --------------------------------------------------------------------------
# Clusters: both topologies, both sharding modes, every policy
# --------------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["spm", "lru", "pinning", "srrip"])
@pytest.mark.parametrize("mode", ["batch", "table_hash"])
@pytest.mark.parametrize("topo", ["private", "shared"])
def test_cluster_equals_jax_package(topo, mode, policy):
    """The reference's conservation law (accesses invariant under the core
    count, topology and sharding) on the port's own numbers, after both
    packages agree bitwise, per_core detail included."""
    et_r, et_t = etraces(batch_sizes=(6, 9), seed=1)
    hw_r, hw_t = pair(lambda hw: hw.with_cluster(3, topo, mode), policy)
    ours = simulate_pair(hw_r, hw_t, et_r, et_t)
    single = T.MemorySystem.from_hardware(
        T.tpuv6e().with_policy(policy, capacity_bytes=1 << 17), "cpu").simulate_embedding(et_t)
    assert ([s.cache_hits + s.cache_misses for s in ours]
            == [s.cache_hits + s.cache_misses for s in single])
    assert [s.onchip_reads for s in ours] == [s.onchip_reads for s in single]
    assert all(len(s.per_core) == 3 for s in ours)
    if topo == "shared":
        # one LLC observes the interleaved stream: it classifies as one core
        assert [s.cache_hits for s in ours] == [s.cache_hits for s in single]


@pytest.mark.parametrize("backend", ["scan", "pallas", "stack", "stack_pallas"])
@pytest.mark.parametrize("topo", ["private", "shared"])
def test_cluster_backends_equal_jax_package(topo, backend):
    et_r, et_t = etraces(batch_sizes=(6, 9), seed=2)
    hw_r, hw_t = pair(lambda hw: hw.with_cluster(4, topo, "batch"), "lru", 1 << 16, backend)
    simulate_pair(hw_r, hw_t, et_r, et_t)


def test_heterogeneous_batches_survive_sharding_in_stats():
    batch_sizes = (5, 11, 2)
    et_r, et_t = etraces(batch_sizes=batch_sizes)
    hw_r, hw_t = pair(lambda hw: hw.with_cluster(3, "private", "batch"), "spm")
    ours = simulate_pair(hw_r, hw_t, et_r, et_t)
    lpv = et_t.spec.vector_bytes // 64
    for s, bsz in zip(ours, batch_sizes):
        n_lookups = bsz * SPEC["num_tables"] * SPEC["lookups_per_sample"]
        assert s.onchip_reads == s.offchip_reads == s.cache_misses == n_lookups * lpv
        assert sum(pc.lookups for pc in s.per_core) == n_lookups


def test_four_core_spm_dram_equals_jax_package():
    """All-miss SPM on 4 cores: the slowest core bounds the batch, and the
    shared stream takes the single-core DRAM time."""
    et_r, et_t = etraces(batch_sizes=(16,))
    hw_r, hw_t = pair(lambda hw: hw.with_cluster(4, "private", "batch"), "spm")
    s = simulate_pair(hw_r, hw_t, et_r, et_t)[0]
    assert s.dram_cycles == max(pc.dram_finish_cycles for pc in s.per_core)
    single = T.MemorySystem.from_hardware(T.tpuv6e().with_policy("spm"), "cpu")
    assert s.dram_cycles == single.simulate_embedding(et_t)[0].dram_cycles


@pytest.mark.parametrize("aggregate", ["device", "host"])
@pytest.mark.parametrize("num_sources", [2, 4])
def test_contended_dram_sources_equal_jax_package(num_sources, aggregate):
    """D1's multi-source route: the per-source finish matrix from the run
    boundaries that fold ``src``, against the reference's."""
    rng = np.random.default_rng(num_sources)
    base = rng.integers(0, 200_000, size=1200).astype(np.int64) * 8
    lines = (base[:, None] + np.arange(8)[None, :]).reshape(-1)
    seg = np.sort(rng.integers(0, 3, size=lines.size))
    src = np.repeat(rng.integers(0, num_sources, size=base.size), 8)
    rm, tm = rdram.DramModel.from_hardware(R.tpuv6e()), tdram.DramModel.from_hardware(T.tpuv6e())
    ours, fin = tdram.simulate_dram_contended(lines, seg, src, 3, num_sources, tm,
                                              aggregate=aggregate, device="cpu")
    ref, rfin = rdram.simulate_dram_contended(lines, seg, src, 3, num_sources, rm,
                                              aggregate=aggregate)
    assert_bitwise_equal_results([dataclasses.asdict(r) for r in ours],
                                 [dataclasses.asdict(r) for r in ref])
    np.testing.assert_array_equal(fin, rfin)
    assert np.all(fin.max(axis=1) == [r.finish_cycle for r in ours])


# --------------------------------------------------------------------------
# Policy mixes and translation on a cluster
# --------------------------------------------------------------------------

@pytest.mark.parametrize("topo", ["private", "shared"])
def test_policy_mix_on_a_cluster_equals_jax_package(topo):
    et_r, et_t = etraces()
    hw_r, hw_t = pair(lambda hw: hw.with_policy_mix({0: "pinning"}).with_cluster(2, topo),
                      "lru", 1 << 18)
    ours = simulate_pair(hw_r, hw_t, et_r, et_t)
    assert sum(s.cache_hits for s in ours) > 0
    assert ours[0].onchip_writes > ours[0].cache_misses   # the pinned preload


@pytest.mark.parametrize("tlb", ["fifo_l2", "lru"])
@pytest.mark.parametrize("topo", ["private", "shared"])
def test_translation_on_a_cluster_equals_jax_package(topo, tlb):
    """The central MMU translates the merged virtual miss stream."""
    kw = (dict(entries=16, ways=4, replacement="fifo", l2_entries=64) if tlb == "fifo_l2"
          else dict(entries=16, ways=4, replacement="lru"))
    et_r, et_t = etraces(batch_sizes=(6, 9), seed=4)
    hw_r, hw_t = pair(lambda hw: hw.with_cluster(4, topo, "table_hash")
                      .with_translation(**kw), "srrip", 1 << 16)
    ours = simulate_pair(hw_r, hw_t, et_r, et_t)
    assert all(s.tlb_walks > 0 for s in ours)
    assert all(s.cycles >= s.dram_cycles + s.translation_cycles for s in ours)


def test_simulate_on_a_cluster_equals_jax_package():
    wl = dict(num_tables=4, rows_per_table=1500, dim=128, lookups=3, batch_size=6,
              num_batches=2)
    ours = sim_results(wl, lambda hw: hw.with_cluster(4, "private", "table_hash"),
                       policy="lru", capacity=1 << 16, backend="pallas")
    assert ours.num_cores == 4 and ours.topology == "private"


def test_prepare_and_pending_from_split_equals_simulate():
    """``classify_for_pending`` + ``pending_from`` (the sweep's path) is the
    cluster's ``simulate_embedding``."""
    et_r, et_t = etraces()
    hw_r, hw_t = pair(lambda hw: hw.with_cluster(2, "private", "table_hash")
                      .with_placement("per_core", "table_rank"))
    ms = T.memory_system_for(hw_t, "cpu")
    clas = ms.classify_for_pending(et_t)
    p = ms.pending_from(et_t, clas)
    got = p.finalize(*tdram.dram_timing_single(p.request, "cpu"))
    assert_bitwise_equal_results(stats(got), stats(ms.simulate_embedding(et_t)))
    rms = R.memory_system_for(hw_r)
    rp = rms.pending_from(et_r, rms.classify_for_pending(et_r))
    np.testing.assert_array_equal(p.request.lines, rp.request.lines)
    np.testing.assert_array_equal(p.request.src, rp.request.src)
    assert p.request.num_sources == rp.request.num_sources == 2


# --------------------------------------------------------------------------
# The sweep's cluster axes and a cluster journal
# --------------------------------------------------------------------------

CLUSTER_WL = dict(num_tables=2, rows_per_table=1500, dim=128, lookups=3, batch_size=6,
                  num_batches=2)
CLUSTER_AXES = dict(policies=("spm", "lru"), capacities=(1 << 16,), ways=(4,), zipf_s=0.9,
                    seed=0, num_cores=(1, 2), topologies=("private", "shared"))


@pytest.fixture(scope="module")
def cluster_ref():
    return R.sweep(R.dlrm_rmc2_small(**CLUSTER_WL), R.tpuv6e(), **CLUSTER_AXES)


def test_sweep_cluster_axes_equal_jax_package(cluster_ref):
    ours = T.sweep(T.dlrm_rmc2_small(**CLUSTER_WL), T.tpuv6e(), device="cpu", **CLUSTER_AXES)
    assert ours.num_configs == 8
    same_sweep(ours, cluster_ref, "cluster axes")
    for e in ours.entries[:4]:
        c = e.config
        hw = T.tpuv6e().with_policy(c.policy, capacity_bytes=c.capacity_bytes, ways=c.ways) \
            .with_cluster(c.num_cores, c.topology)
        want = T.simulate(T.dlrm_rmc2_small(**CLUSTER_WL), hw, seed=0, zipf_s=c.zipf_s,
                          device="cpu")
        assert not e.result.diff(want), c.label


def test_sweep_cluster_axes_unbatched_equal_jax_package(cluster_ref):
    ours = T.sweep(T.dlrm_rmc2_small(**CLUSTER_WL), T.tpuv6e(), device="cpu",
                   batch_scans=False, batch_dram=False, **CLUSTER_AXES)
    same_sweep(ours, cluster_ref, "cluster axes, unbatched")


def test_sharded_cluster_sweep_equals_jax_package(cluster_ref):
    ours = T.sweep(T.dlrm_rmc2_small(**CLUSTER_WL), T.tpuv6e(), device="cpu", devices=3,
                   **CLUSTER_AXES)
    same_sweep(ours, cluster_ref, "cluster axes on 3 shards")


@pytest.mark.parametrize("writer", ["jax_package", "port"])
def test_cluster_journal_resumes_in_the_other_package(cluster_ref, tmp_path, writer):
    """A journal holding cluster entries (their ``per_core`` detail) written
    by either package resumes in the other, bitwise."""
    path = str(tmp_path / "cluster.ckpt")
    wl_r, wl_t = R.dlrm_rmc2_small(**CLUSTER_WL), T.dlrm_rmc2_small(**CLUSTER_WL)
    if writer == "port":
        ck = _KillAfter(path, cadence=2, rounds=2)
        with pytest.raises(KeyboardInterrupt):
            T.sweep(wl_t, T.tpuv6e(), device="cpu", checkpoint=ck, **CLUSTER_AXES)
        ck.close()
        resumed = R.sweep(wl_r, R.tpuv6e(), checkpoint=path, **CLUSTER_AXES)
        assert_bitwise_equal_results(cluster_ref, resumed, "port journal resumed by the reference")
        assert 0 < resumed.resumed_keys < resumed.distinct_memo_keys
    else:
        R.sweep(wl_r, R.tpuv6e(), checkpoint=path, **CLUSTER_AXES)
        resumed = T.sweep(wl_t, T.tpuv6e(), device="cpu", checkpoint=path, **CLUSTER_AXES)
        same_sweep(resumed, cluster_ref, "reference journal resumed by the port")
        assert resumed.resumed_keys == resumed.distinct_memo_keys
    assert b'"per_core"' in open(path, "rb").read()


# --------------------------------------------------------------------------
# The LM workload mapper and the CLI's second workload
# --------------------------------------------------------------------------

LM_ARCHS = ("zamba2_2p7b", "command_r_plus_104b", "stablelm_3b", "mamba2_130m")
LM_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


@pytest.mark.parametrize("shape", LM_SHAPES)
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_workload_equals_jax_package(arch, shape):
    from repro.core.lm_mapper import lm_workload as r_lm
    from repro.models import SHAPES_BY_NAME as R_SHAPES, get_config as r_config
    from repro_torch.core.lm_mapper import lm_workload as t_lm
    from repro_torch.models import SHAPES_BY_NAME as T_SHAPES, get_config as t_config

    assert set(T_SHAPES) == set(R_SHAPES) == set(LM_SHAPES)
    ours = t_lm(t_config(arch), T_SHAPES[shape], num_batches=2)
    ref = r_lm(r_config(arch), R_SHAPES[shape], num_batches=2)
    assert plain(ours) == plain(ref)
    assert ours.embedding_ops[0].rows_per_table == t_config(arch).vocab


def test_cli_lm_workload_on_cpu_equals_jax_package(capsys):
    from repro_torch.launch.simulate import main

    main(["--workload", "lm", "--arch", "mamba2_130m", "--shape", "decode_32k",
          "--policy", "lru", "--device", "cpu", "--json"])
    import json

    ours = json.loads(capsys.readouterr().out)
    from repro.core.lm_mapper import lm_workload as r_lm
    from repro.models import SHAPES_BY_NAME, get_config

    ref = R.simulate(r_lm(get_config("mamba2_130m"), SHAPES_BY_NAME["decode_32k"]),
                     R.tpuv6e().with_policy("lru"), zipf_s=1.0)
    assert ours == json.loads(ref.to_json())


def test_cli_lm_rejects_unported_architecture():
    from repro_torch.launch.simulate import main

    with pytest.raises(NotImplementedError, match="does not run"):
        main(["--workload", "lm", "--arch", "granite_34b", "--device", "cpu"])
