"""``simulate`` in the PyTorch port (``device="cpu"``) against the JAX
package, bitwise, for every policy/backend pair of the slice, at a small
size: 2 tables x 300 rows, batch 2, 2 batches, 16 KiB of on-chip memory.

Where the JAX backend is a Pallas one (``pallas``, ``stack_pallas``) the
reference runs the JAX ``scan`` engine instead: the Pallas kernels cannot
run on the installed jax, and every JAX backend is bit-exact with ``scan``.
srrip and fifo resolve ``stack_pallas`` to ``stack`` in both packages, so
there the reference runs its own ``stack`` engine.
"""
import dataclasses
import enum

import numpy as np
import pytest
from differential import assert_bitwise_equal_results

import repro.core as R
from repro.core.memory.system import MemorySystem as RMemorySystem
from repro.core.engine import build_embedding_traces as r_build
import repro_torch.core as T
from repro_torch.convert import hardware_from_dict, workload_from_dict
from repro_torch.core.engine import build_embedding_traces as t_build
from repro_torch.core.memory.system import MemorySystem as TMemorySystem

POLICIES = ["spm", "lru", "srrip", "fifo", "pinning"]
BACKENDS = ["scan", "pallas", "stack", "stack_pallas"]
CAP = 1 << 14


def _workloads():
    wl = R.dlrm_rmc2_small(num_tables=2, rows_per_table=300, batch_size=2, num_batches=2)
    return wl, workload_from_dict(dataclasses.asdict(wl))


def _ref_backend(policy, backend):
    if backend == "stack_pallas" and policy in ("srrip", "fifo"):
        return "stack"
    if backend in ("pallas", "stack_pallas"):
        return "scan"
    return backend


def _plain(x):
    """asdict output with enum members as their values."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_plain(v) for v in x)
    if isinstance(x, enum.Enum):
        return x.value
    return x


def _assert_same(ours, ref):
    assert_bitwise_equal_results(dataclasses.asdict(ours), dataclasses.asdict(ref))
    assert_bitwise_equal_results(ours.summary(), ref.summary())


_REF = {}


def _reference(policy, backend, **onchip):
    key = (policy, _ref_backend(policy, backend), tuple(sorted(onchip.items())))
    if key not in _REF:
        wl, _ = _workloads()
        hw = R.tpuv6e().with_policy(policy, capacity_bytes=CAP, **onchip).with_cache_backend(key[1])
        _REF[key] = R.simulate(wl, hw)
    return _REF[key]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("policy", POLICIES)
def test_simulate_equals_jax_package(policy, backend):
    _, wl = _workloads()
    hw = T.tpuv6e().with_policy(policy, capacity_bytes=CAP).with_cache_backend(backend)
    _assert_same(T.simulate(wl, hw, device="cpu"), _reference(policy, backend))


@pytest.mark.parametrize("policy,backend", [("lru", "pallas"), ("srrip", "pallas"),
                                            ("fifo", "scan"), ("lru", "stack_pallas")])
def test_simulate_line_granular_geometry_equals_jax_package(policy, backend):
    """ways=3 leaves 85 sets: no exact lane split, so the line-granular
    stream runs, split into set groups of 16."""
    _, wl = _workloads()
    hw = T.tpuv6e().with_policy(policy, capacity_bytes=CAP, ways=3).with_cache_backend(backend)
    _assert_same(T.simulate(wl, hw, device="cpu"), _reference(policy, backend, ways=3))


@pytest.mark.parametrize("policy", ["lru", "srrip", "pinning"])
def test_simulate_embedding_line_path_equals_jax_package(policy):
    """``allow_lane=False`` forces the line-granular path in both packages."""
    wl_r, wl_t = _workloads()
    backend = "pallas" if policy != "pinning" else "stack"
    hw_r = R.tpuv6e().with_policy(policy, capacity_bytes=CAP).with_cache_backend(
        _ref_backend(policy, backend))
    hw_t = T.tpuv6e().with_policy(policy, capacity_bytes=CAP).with_cache_backend(backend)
    ref = RMemorySystem.from_hardware(hw_r).simulate_embedding(
        r_build(wl_r, seed=3)[0], allow_lane=False)
    ours = TMemorySystem.from_hardware(hw_t, "cpu").simulate_embedding(
        t_build(wl_t, seed=3)[0], allow_lane=False)
    assert_bitwise_equal_results([dataclasses.asdict(s) for s in ours],
                                 [dataclasses.asdict(s) for s in ref])


def test_simulate_policy_mix_and_index_trace_equal_jax_package():
    wl_r, wl_t = _workloads()
    it = np.random.default_rng(0).integers(0, 300, size=500)
    hw_r = R.tpuv6e().with_policy("lru", capacity_bytes=CAP).with_cache_backend("scan") \
        .with_policy_mix({1: "pinning"})
    hw_t = hardware_from_dict(dataclasses.asdict(hw_r)).with_cache_backend("pallas")
    ref = R.simulate(wl_r, hw_r, index_trace=it, seed=5, zipf_s=1.1)
    _assert_same(T.simulate(wl_t, hw_t, index_trace=it, seed=5, zipf_s=1.1, device="cpu"), ref)


def test_convert_round_trip():
    wl_r, wl_t = _workloads()
    assert _plain(dataclasses.asdict(wl_t)) == _plain(dataclasses.asdict(wl_r))
    hw_r = (R.tpuv6e().with_policy("srrip", ways=8).with_cache_backend("pallas")
            .with_policy_mix({0: "lru"}).with_cluster(1, "private", "table_hash")
            .with_translation(entries=32, ways=4))
    hw_t = hardware_from_dict(dataclasses.asdict(hw_r))
    assert _plain(dataclasses.asdict(hw_t)) == _plain(dataclasses.asdict(hw_r))
    assert hardware_from_dict(dataclasses.asdict(hw_t)) == hw_t
    assert workload_from_dict(dataclasses.asdict(wl_t)) == wl_t


@pytest.mark.parametrize("change,match", [
    (lambda hw: hw.with_cluster(2), "MultiCoreMemorySystem"),
    (lambda hw: hw.with_cluster(1, "shared"), "MultiCoreMemorySystem"),
])
def test_outside_the_slice_raises_not_implemented(change, match):
    _, wl = _workloads()
    with pytest.raises(NotImplementedError, match=match):
        T.simulate(wl, change(T.tpuv6e().with_policy("lru", capacity_bytes=CAP)), device="cpu")


def test_non_identity_placement_raises_and_identity_runs():
    _, wl = _workloads()
    hw = T.tpuv6e().with_policy("spm", capacity_bytes=CAP)
    with pytest.raises(NotImplementedError, match="placement"):
        T.simulate(wl, hw.with_placement("per_table", "table_rank"), device="cpu")
    # per_table on one core is one channel group: the identity placement.
    ours = T.simulate(wl, hw.with_placement("per_table", "interleave"), device="cpu")
    _assert_same(ours, _reference("spm", "stack"))


def test_cli_runs_on_cpu(capsys):
    from repro_torch.launch.simulate import main

    main(["--device", "cpu", "--tables", "2", "--rows", "300", "--batch", "2",
          "--policy", "lru", "--cache-backend", "pallas"])
    out = capsys.readouterr().out
    assert "total_cycles" in out and "cache_hits" in out


@pytest.mark.parametrize("policy", ["spm", "lru", "pinning"])
def test_run_policy_on_a_line_trace_equals_jax_package(policy):
    from repro.core.memory.policies import run_policy as r_run
    from repro.core.trace import translate as r_translate
    from repro_torch.core.memory.policies import run_policy as t_run
    from repro_torch.core.trace import translate as t_translate

    wl_r, wl_t = _workloads()
    r_at = r_translate(r_build(wl_r)[0].concat, wl_r.embedding_ops[0], 64)
    t_at = t_translate(t_build(wl_t)[0].concat, wl_t.embedding_ops[0], 64)
    np.testing.assert_array_equal(t_at.lines, r_at.lines)
    hw_r = R.tpuv6e().with_policy(policy, capacity_bytes=CAP).with_cache_backend("scan")
    hw_t = T.tpuv6e().with_policy(policy, capacity_bytes=CAP).with_cache_backend("pallas")
    ref, ours = r_run(r_at, hw_r), t_run(t_at, hw_t, device="cpu")
    assert_bitwise_equal_results(_plain(dataclasses.asdict(ours)), _plain(dataclasses.asdict(ref)))
