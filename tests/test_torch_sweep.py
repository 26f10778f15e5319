"""The DSE sweep of the PyTorch port (``repro_torch.core.sweep``, on the CPU)
against the JAX package's, bitwise: the axis grid of ``tests/test_sweep.py``
with ``fifo`` and a translation axis (None, a FIFO TLB with an L2, an LRU
TLB) added, ``grid_configs`` and ``configs=`` lists, the memo-key collapses,
and the JSON record. Small size: 2 tables x 2,000 rows, batch 8, 2 batches.

The helpers here (``WORKLOAD``, ``grid``, ``same_sweep``) serve the other
port sweep tests too (``test_torch_sweep_scale.py``, ``test_torch_faults.py``).
"""
import dataclasses
import enum
import json

import pytest
import torch
from differential import assert_bitwise_equal_results

import repro.core as R
import repro_torch.core as T

WORKLOAD = dict(num_tables=2, rows_per_table=2000, dim=128, lookups=4, batch_size=8,
                num_batches=2)
POLICIES = ("spm", "lru", "srrip", "fifo", "pinning")
CAPACITIES = (1 << 16, 1 << 17, 1 << 18)
WAYS = (4, 8)
TLB = dict(entries=16, ways=4, l2_entries=64)


def translations(pkg):
    """The translation axis: off, a FIFO TLB with an L2, an LRU TLB."""
    return (None, pkg.TranslationConfig(replacement="fifo", **TLB),
            pkg.TranslationConfig(entries=16, ways=4, replacement="lru"))


def grid(pkg):
    return dict(policies=POLICIES, capacities=CAPACITIES, ways=WAYS, zipf_s=0.9, seed=0,
                translations=translations(pkg))


def plain(x):
    """``dataclasses.asdict`` of ``x`` with enum members as their values, so
    the two packages' records compare field by field."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        x = dataclasses.asdict(x)
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(plain(v) for v in x)
    if isinstance(x, enum.Enum):
        return x.value
    return x


def records(sr):
    """Each entry's config, result and memo key, as plain values."""
    return [(plain(e.config), plain(e.result), e.memo_key) for e in sr.entries]


def same_sweep(port, ref, label=""):
    """The port's ``SweepResult`` equals the reference's, bitwise: every
    entry's config, ``SimResult`` and memo key, and the count of memo keys."""
    assert_bitwise_equal_results(records(port), records(ref), label)
    assert port.distinct_memo_keys == ref.distinct_memo_keys, label


@pytest.fixture(scope="module")
def wls():
    return R.dlrm_rmc2_small(**WORKLOAD), T.dlrm_rmc2_small(**WORKLOAD)


@pytest.fixture(scope="module")
def ref_grid(wls):
    return R.sweep(wls[0], R.tpuv6e(), **grid(R))


@pytest.fixture(scope="module")
def port_grid(wls):
    return T.sweep(wls[1], T.tpuv6e(), device="cpu", **grid(T))


def test_grid_sweep_equals_jax_package(port_grid, ref_grid):
    assert port_grid.num_configs == len(POLICIES) * len(CAPACITIES) * len(WAYS) * 3
    same_sweep(port_grid, ref_grid, "axis grid with fifo and translations")
    assert (port_grid.device_count, port_grid.sharded, port_grid.resumed_keys) == (1, False, 0)


@pytest.mark.parametrize("pick", [0, 17, 40, 77, 89])
def test_grid_entries_equal_independent_simulate(port_grid, wls, pick):
    e = port_grid.entries[pick]
    c = e.config
    hw = T.tpuv6e().with_policy(T.OnChipPolicy(c.policy), capacity_bytes=c.capacity_bytes,
                                ways=c.ways).with_translation(c.translation)
    want = T.simulate(wls[1], hw, seed=0, zipf_s=c.zipf_s, device="cpu")
    assert not e.result.diff(want), (c.label, e.result.diff(want))


def test_grid_configs_equal_and_drive_the_same_sweep(port_grid, ref_grid, wls):
    axes = dict(policies=POLICIES, capacities=CAPACITIES, ways=WAYS, zipf_s=0.9)
    cfgs = T.grid_configs(wls[1], T.tpuv6e(), translations=translations(T), **axes)
    ref_cfgs = R.grid_configs(wls[0], R.tpuv6e(), translations=translations(R), **axes)
    assert [plain(c) for c in cfgs] == [plain(c) for c in ref_cfgs]
    assert [e.config for e in port_grid.entries] == cfgs
    assert [c.label for c in cfgs] == [c.label for c in ref_cfgs]
    same_sweep(T.sweep(wls[1], T.tpuv6e(), configs=cfgs, seed=0, device="cpu"), ref_grid,
               "configs= path")


def test_configs_order_is_kept(port_grid, ref_grid, wls):
    picks = (17, 3, 11, 3, 0, 88)
    port = T.sweep(wls[1], T.tpuv6e(), configs=[port_grid.entries[i].config for i in picks],
                   seed=0, device="cpu")
    ref = R.sweep(wls[0], R.tpuv6e(), configs=[ref_grid.entries[i].config for i in picks],
                  seed=0)
    same_sweep(port, ref, "configs= subset")
    assert [e.config for e in port.entries] == [port_grid.entries[i].config for i in picks]


def _collapse_grid(pkg, case):
    if case == "spm":
        return dict(policies=("spm",), capacities=CAPACITIES, ways=WAYS)
    if case == "pinning_saturation":
        return dict(policies=("pinning",), capacities=(1 << 12, 4 << 20, 16 << 20), ways=WAYS)
    if case == "pinning_below_footprint":
        return dict(policies=("pinning",), capacities=(1 << 12, 1 << 13), ways=(4,))
    sat = [pkg.TranslationConfig(entries=n, ways=n, page_bytes=1 << 20)
           for n in (1 << 16, 1 << 17)]
    return dict(policies=("spm", "lru"), capacities=(1 << 17,), ways=(8,),
                translations=(None, pkg.TranslationConfig(**TLB), *sat))


@pytest.mark.parametrize("case,keys", [("spm", 1), ("pinning_saturation", 2),
                                       ("pinning_below_footprint", 2),
                                       ("tlb_saturation", 6)])
def test_memo_key_collapses_equal_jax_package(wls, case, keys):
    port = T.sweep(wls[1], T.tpuv6e(), zipf_s=0.9, seed=0, device="cpu",
                   **_collapse_grid(T, case))
    ref = R.sweep(wls[0], R.tpuv6e(), zipf_s=0.9, seed=0, **_collapse_grid(R, case))
    same_sweep(port, ref, case)
    assert port.distinct_memo_keys == keys
    assert len({e.memo_key for e in port.entries}) == keys
    if case == "pinning_saturation":
        assert any("cap_saturated" in e.memo_key for e in port.entries)
    if case == "tlb_saturation":
        assert any(any(isinstance(k, tuple) and k and k[0] == "tlb_sat" for k in e.memo_key)
                   for e in port.entries)


def _payload(sr):
    payload = json.loads(sr.to_json())
    del payload["wall_seconds"]
    return payload


def test_to_json_equals_jax_package_apart_from_wall_time(port_grid, ref_grid, tmp_path):
    assert _payload(port_grid) == _payload(ref_grid)
    p = tmp_path / "sweep.json"
    port_grid.to_json(str(p))
    assert json.loads(p.read_text())["num_configs"] == port_grid.num_configs


def test_helpers_equal_jax_package(port_grid, ref_grid):
    assert port_grid.rows() == ref_grid.rows()
    assert port_grid.speedup_over("spm") == ref_grid.speedup_over("spm")
    for metric, minimize in (("total_cycles", True), ("energy_pj", True),
                             ("total_cycles", False)):
        assert (port_grid.best(metric, minimize).config.label
                == ref_grid.best(metric, minimize).config.label)


def test_zipf_axis_equals_jax_package(wls):
    axes = dict(policies=("spm", "lru"), capacities=(1 << 17,), ways=(8,), zipf_s=(0.7, 1.1),
                seed=0)
    same_sweep(T.sweep(wls[1], T.tpuv6e(), device="cpu", **axes),
               R.sweep(wls[0], R.tpuv6e(), **axes), "zipf axis")


def test_one_core_affinities_run_as_in_the_jax_package(wls):
    axes = dict(policies=("spm", "lru"), capacities=(1 << 16,), ways=(4,), zipf_s=0.9, seed=0,
                channel_affinities=("per_core", "symmetric"))
    same_sweep(T.sweep(wls[1], T.tpuv6e(), device="cpu", **axes),
               R.sweep(wls[0], R.tpuv6e(), **axes), "one-core affinities")


@pytest.mark.parametrize("axes", [dict(num_cores=(1, 2)), dict(topologies=("private", "shared")),
                                  dict(placements=("interleave", "table_rank"))],
                         ids=["num_cores", "shared_topology", "table_rank"])
def test_unported_axes_raise(wls, axes):
    """Once raising, now ported: cluster and placement axes equal the JAX
    package's sweep, memo keys included."""
    kw = dict(policies=("spm", "lru"), capacities=(1 << 16,), ways=(4,), zipf_s=0.9, seed=0,
              **axes)
    same_sweep(T.sweep(wls[1], T.tpuv6e(), device="cpu", **kw),
               R.sweep(wls[0], R.tpuv6e(), **kw), str(axes))


def test_scenarios_raise_not_implemented(wls):
    with pytest.raises(NotImplementedError, match="serving"):
        T.sweep(wls[1], T.tpuv6e(), scenarios=[object()], device="cpu")


def test_rejects_unknown_policy_and_workload(wls):
    with pytest.raises(ValueError, match="unregistered"):
        T.sweep(wls[1], T.tpuv6e(), policies=("spm", "mru"), device="cpu")
    cfg = T.SweepConfig(policy="spm", capacity_bytes=1 << 16, ways=4, workload="nope",
                       zipf_s=0.9)
    with pytest.raises(ValueError, match="unknown workload"):
        T.sweep(wls[1], T.tpuv6e(), configs=[cfg], device="cpu")


def test_sweep_and_search_raise_without_a_card(wls, monkeypatch):
    from repro_torch.distributed.sweep_shard import resolve_shard_plan

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    axes = dict(policies=("spm",), capacities=(1 << 16,), ways=(4,))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.sweep(wls[1], T.tpuv6e(), **axes)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.search(wls[1], T.tpuv6e(), **axes)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_shard_plan(2)
    assert T.sweep(wls[1], T.tpuv6e(), device="cpu", **axes).num_configs == 1
