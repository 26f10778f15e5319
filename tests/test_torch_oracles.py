"""The reference oracles of the PyTorch port and its device-side helpers,
against the JAX package's, on the CPU.

* ``core.memory.golden.GoldenCache`` (the ChampSim-semantics sequential
  cache) for lru/srrip/fifo on edge geometries: per-access hits and the
  hit/miss/eviction counters equal the JAX package's copy;
* ``core.memory.golden_dram.golden_dram`` (the straight-line FR-FCFS DRAM
  model) on the port's ``DramModel``: the whole ``DramResult`` equal;
* ``core.oracle.oracle_run`` (the closed-form TPUv6e proxy) on
  ``dlrm_rmc2_small`` and the LM workloads of the ported architectures;
* the three device-side helpers — ``translate_device``,
  ``shard_lookup_cores_device`` and ``MemoryPolicy.classify_device`` —
  against the numpy versions and the JAX package's ``_jnp`` versions, with
  the cases of ``tests/test_device_pipeline.py``, and the table hash on
  every int32 table id range against ``table_core_of``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro.core.memory import dram as rdram
from repro.core.memory.cache import CacheGeometry as RGeometry
from repro.core.memory.golden import GoldenCache as RGolden
from repro.core.memory.golden_dram import golden_dram as r_golden_dram
from repro.core.memory.policies import PolicyContext as RContext
from repro.core.memory.policies import get_policy as r_policy
from repro.core.oracle import oracle_run as r_oracle
from repro.core.trace import (
    ConcatTrace as RConcat,
    expand_trace as r_expand,
    generate_zipf_trace as r_zipf,
    shard_lookup_cores_jnp,
    translate_jnp,
)
from repro_torch.core.memory import GoldenCache as TGolden
from repro_torch.core.memory import dram as tdram
from repro_torch.core.memory.cache import MAX_RRPV
from repro_torch.core.memory.cache import CacheGeometry as TGeometry
from repro_torch.core.memory.golden_dram import golden_dram as t_golden_dram
from repro_torch.core.memory.policies import PolicyContext as TContext
from repro_torch.core.memory.policies import get_policy as t_policy
from repro_torch.core.oracle import OracleResult, oracle_run as t_oracle
from repro_torch.core.trace import (
    ConcatTrace as TConcat,
    FullTrace,
    expand_trace as t_expand,
    generate_zipf_trace as t_zipf,
    shard_lookup_cores,
    shard_lookup_cores_device,
    table_core_of,
    translate,
    translate_device,
)

CPU = torch.device("cpu")


# --------------------------------------------------------------------------
# GoldenCache
# --------------------------------------------------------------------------

EDGE = [(1, 1), (1, 4), (3, 2), (7, 5), (16, 16), (2, 64)]


@pytest.mark.parametrize("sets,ways", EDGE)
@pytest.mark.parametrize("policy", ["lru", "srrip", "fifo"])
def test_golden_cache_equals_jax_package(policy, sets, ways):
    rng = np.random.default_rng(sets * 131 + ways)
    lines = rng.integers(0, sets * ways * 3 + 1, size=600)
    port = TGolden(TGeometry(sets, ways, 64), policy)
    ref = RGolden(RGeometry(sets, ways, 64), policy)
    np.testing.assert_array_equal(port.run(lines), ref.run(lines))
    assert (port.num_hits, port.num_misses, port.num_evictions) == (
        ref.num_hits, ref.num_misses, ref.num_evictions)
    assert port.tags == ref.tags and port.meta == ref.meta and port.t == ref.t
    assert port.num_hits + port.num_misses == lines.size


def test_golden_cache_semantics():
    """The ChampSim rules on a hand-checked stream: SRRIP fills at
    MAX_RRPV - 1 and ages every way until one reaches MAX_RRPV; FIFO hits
    leave the fill order alone; LRU promotes on a hit."""
    assert MAX_RRPV == 3
    stream = np.array([0, 1, 0, 2, 0, 3])           # one set of two ways
    hits = {p: TGolden(TGeometry(1, 2, 64), p).run(stream).tolist()
            for p in ("lru", "fifo", "srrip")}
    assert hits["lru"] == [False, False, True, False, True, False]
    assert hits["fifo"] == [False, False, True, False, False, False]
    assert hits["srrip"] == [False, False, True, False, True, False]
    g = TGolden(TGeometry(1, 2, 64), "srrip")
    g.run(np.array([5]))
    assert g.meta[0] == [MAX_RRPV - 1, MAX_RRPV]


# --------------------------------------------------------------------------
# golden_dram
# --------------------------------------------------------------------------

def _models(pkg_dram, pkg):
    hw = pkg.tpuv6e()
    return [pkg_dram.DramModel.from_hardware(h) for h in (
        hw,
        hw.replace(offchip=dataclasses.replace(hw.offchip, interleave_bytes=64)),
        hw.replace(offchip=dataclasses.replace(hw.offchip, channels=3, banks_per_channel=5)))]


@pytest.mark.parametrize("which", [0, 1, 2], ids=["tpuv6e", "fine_interleave", "odd_geometry"])
@pytest.mark.parametrize("n", [0, 1, 7, 3000])
def test_golden_dram_equals_jax_package(which, n):
    rng = np.random.default_rng(n + which)
    lines = np.sort(rng.integers(0, 200_000, size=n)) if which == 2 else rng.integers(
        0, 1_000_000, size=n)
    port = t_golden_dram(lines, _models(tdram, T)[which])
    ref = r_golden_dram(lines, _models(rdram, R)[which])
    assert type(port) is tdram.DramResult
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.accesses == n and port.row_hits + port.row_misses == n


# --------------------------------------------------------------------------
# oracle_run
# --------------------------------------------------------------------------

def _same_oracle(port, ref):
    assert isinstance(port, OracleResult)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.total_cycles == ref.total_cycles


@pytest.mark.parametrize("kw", [dict(), dict(num_tables=4, rows_per_table=50_000, batch_size=16,
                                             num_batches=3)], ids=["full_width", "small"])
def test_oracle_run_dlrm_equals_jax_package(kw):
    _same_oracle(t_oracle(T.dlrm_rmc2_small(**kw), T.tpuv6e()),
                 r_oracle(R.dlrm_rmc2_small(**kw), R.tpuv6e()))
    hw = dict(capacity_bytes=1 << 20)
    _same_oracle(t_oracle(T.dlrm_rmc2_small(**kw), T.tpuv6e().with_onchip(**hw)),
                 r_oracle(R.dlrm_rmc2_small(**kw), R.tpuv6e().with_onchip(**hw)))


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", ["zamba2_2p7b", "stablelm_3b", "mamba2_130m"])
def test_oracle_run_lm_workload_equals_jax_package(arch, shape):
    from repro.core.lm_mapper import lm_workload as r_lm
    from repro.models import SHAPES_BY_NAME as R_SHAPES, get_config as r_config
    from repro_torch.core.lm_mapper import lm_workload as t_lm
    from repro_torch.models import SHAPES_BY_NAME as T_SHAPES, get_config as t_config

    port = t_oracle(t_lm(t_config(arch), T_SHAPES[shape], num_batches=2), T.tpuv6e())
    ref = r_oracle(r_lm(r_config(arch), R_SHAPES[shape], num_batches=2), R.tpuv6e())
    _same_oracle(port, ref)
    assert port.matrix_cycles > 0 and port.offchip_accesses > 0


# --------------------------------------------------------------------------
# The device-side helpers (the cases of tests/test_device_pipeline.py)
# --------------------------------------------------------------------------

SPEC_KW = dict(num_tables=5, rows_per_table=700, dim=64, lookups_per_sample=3, dtype_bytes=4)


def _concat(pkg, zipf, expand, Concat, batches=(4, 7)):
    spec = pkg.EmbeddingOpSpec(**SPEC_KW)
    traces = []
    for i, b in enumerate(batches):
        it = zipf(b * spec.num_tables * spec.lookups_per_sample, spec.rows_per_table, 0.9,
                  seed=i)
        traces.append(expand(it, spec, b, seed=i))
    return spec, Concat.from_traces(traces)


@pytest.fixture(scope="module")
def concats():
    return (_concat(T, t_zipf, t_expand, TConcat), _concat(R, r_zipf, r_expand, RConcat))


@pytest.mark.parametrize("line_bytes", [64, 128, 96])
def test_translate_device_matches_numpy_and_jnp(concats, line_bytes):
    (spec, concat), (rspec, rconcat) = concats
    got = translate_device(torch.from_numpy(concat.table_ids), torch.from_numpy(concat.row_ids),
                           spec, line_bytes)
    assert got.dtype == torch.int32 and got.device == CPU
    want = translate(concat, spec, line_bytes).lines
    np.testing.assert_array_equal(got.numpy(), want)
    ref = np.asarray(translate_jnp(jnp.asarray(rconcat.table_ids), jnp.asarray(rconcat.row_ids),
                                   rspec, line_bytes))
    assert ref.dtype == got.numpy().dtype
    np.testing.assert_array_equal(got.numpy(), ref)
    based = translate_device(torch.from_numpy(concat.table_ids),
                             torch.from_numpy(concat.row_ids), spec, line_bytes,
                             base_address=1 << 20)
    np.testing.assert_array_equal(based.numpy(),
                                  translate(concat, spec, line_bytes, 1 << 20).lines)


def test_translate_device_keeps_the_int32_limit():
    """A spec of 2**31 bytes or more raises, as ``translate_jnp`` does; the
    widest one under the limit translates exactly."""
    big = T.dlrm_rmc2_small().embedding_ops[0]                 # 30.72 GB
    ids = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="int32 byte addresses"):
        translate_device(ids, ids, big, 64)
    rbig = R.dlrm_rmc2_small().embedding_ops[0]
    with pytest.raises(ValueError, match="int32 byte addresses"):
        translate_jnp(jnp.zeros(4, jnp.int32), jnp.zeros(4, jnp.int32), rbig, 64)
    # 4 tables x 1,048,575 rows x 512 bytes: 2**31 - 2048 bytes, the last row
    # of the last table translates to the last lines under the limit.
    kw = dict(num_tables=4, rows_per_table=(1 << 20) - 1, dim=128, lookups_per_sample=1,
              dtype_bytes=4)
    spec = T.EmbeddingOpSpec(**kw)
    assert spec.num_tables * spec.table_bytes < np.iinfo(np.int32).max
    t = np.array([0, 3, 3, 1], dtype=np.int32)
    r = np.array([0, spec.rows_per_table - 1, 12345, 999_999], dtype=np.int64)
    got = translate_device(torch.from_numpy(t), torch.from_numpy(r), spec, 64).numpy()
    want = translate(FullTrace(t, r, 4, 4, 1), spec, 64).lines
    np.testing.assert_array_equal(got, want)
    ref = np.asarray(translate_jnp(jnp.asarray(t), jnp.asarray(r.astype(np.int32)),
                                   R.EmbeddingOpSpec(**kw), 64))
    np.testing.assert_array_equal(got, ref)
    assert int(got.max()) == ((1 << 31) - 2048) // 64 - 1


@pytest.mark.parametrize("mode", ["batch", "table_hash"])
@pytest.mark.parametrize("cores", [1, 2, 3, 8])
def test_shard_lookup_cores_device_matches_numpy_and_jnp(concats, mode, cores):
    (spec, concat), (_, rconcat) = concats
    got = shard_lookup_cores_device(concat, cores, mode, device="cpu")
    assert got.dtype == torch.int32 and got.device == CPU
    np.testing.assert_array_equal(got.numpy(), shard_lookup_cores(concat, cores, mode))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(shard_lookup_cores_jnp(rconcat, cores, mode)))


@pytest.mark.parametrize("cores", [2, 3, 4, 8, 1000])
def test_table_hash_device_exact_for_every_int32_id(cores):
    """The int64 product is exact for any int32 id: equal to the uint64
    ``table_core_of`` across the range, past the 2**15 where the JAX version
    leaves the device."""
    rng = np.random.default_rng(cores)
    ids = np.concatenate([np.arange(0, 70_000), (1 << 15) + np.arange(-3, 4),
                          rng.integers(0, np.iinfo(np.int32).max, size=20_000),
                          [np.iinfo(np.int32).max - 1, np.iinfo(np.int32).max]]).astype(np.int32)
    concat = TConcat(table_ids=ids, row_ids=np.zeros(ids.size, np.int64),
                     boundaries=np.array([0, ids.size]), batch_sizes=(ids.size,),
                     num_tables=int(ids.max()) + 1, lookups_per_sample=1)
    got = shard_lookup_cores_device(concat, cores, "table_hash", device="cpu")
    np.testing.assert_array_equal(got.numpy(), table_core_of(ids, cores))


def test_shard_lookup_cores_device_rejects_like_numpy(concats):
    (_, concat), _ = concats
    with pytest.raises(ValueError, match="num_cores"):
        shard_lookup_cores_device(concat, 0, device="cpu")
    with pytest.raises(ValueError, match="unknown sharding mode"):
        shard_lookup_cores_device(concat, 2, "round_robin", device="cpu")


def test_shard_lookup_cores_device_raises_without_a_card(concats, monkeypatch):
    (_, concat), _ = concats
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        shard_lookup_cores_device(concat, 2)


@pytest.mark.parametrize("name", ["spm", "pinning", "lru"])
@pytest.mark.parametrize("capacity", [1 << 10, 1 << 16])
def test_policy_classify_device_matches_numpy_and_jnp(name, capacity):
    rng = np.random.default_rng(capacity)
    lines = rng.integers(0, 5000, size=2000).astype(np.int64)
    tpol, rpol = t_policy(name), r_policy(name)
    ctx = tpol.prepare(lines, TContext.from_hardware(
        T.tpuv6e().with_onchip(capacity_bytes=capacity), device="cpu"))
    rctx = rpol.prepare(lines, RContext.from_hardware(
        R.tpuv6e().with_onchip(capacity_bytes=capacity)))
    got = tpol.classify_device(torch.from_numpy(lines), ctx)
    assert got.dtype == torch.bool and got.device == CPU and got.shape == (lines.size,)
    np.testing.assert_array_equal(got.numpy(), tpol.classify(lines, ctx))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(rpol.classify_jnp(jnp.asarray(lines), rctx)))
    # int32 lines, as translate_device gives them, classify the same
    got32 = tpol.classify_device(torch.from_numpy(lines.astype(np.int32)), ctx)
    np.testing.assert_array_equal(got32.numpy(), got.numpy())


def test_pinning_classify_device_with_nothing_pinned():
    lines = torch.arange(10)
    ctx = dataclasses.replace(TContext.from_hardware(T.tpuv6e(), device="cpu"),
                              pinned_lines=np.zeros(0, np.int64))
    got = t_policy("pinning").classify_device(lines, ctx)
    assert got.dtype == torch.bool and not got.any() and got.shape == (10,)
