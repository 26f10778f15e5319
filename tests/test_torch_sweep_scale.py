"""The scaling layer of the port's DSE sweep against the JAX package's, on the
CPU: sharded evaluation (``devices=4``), the class-key partition, the
checkpoint journal (resume, kill-and-resume, a torn tail, a corrupt CRC),
journals that cross between the packages, the fingerprint, and the
successive-halving search — each bitwise equal to the reference's sweep.
"""
import dataclasses
import os

import pytest
import torch
from differential import assert_bitwise_equal_results
from test_torch_sweep import WORKLOAD, grid, same_sweep

import repro.core as R
import repro_torch.core as T
from repro.core.energy import EnergyTable as REnergyTable
from repro.core.sweep import _fingerprint as r_fingerprint
from repro.core.sweep import _slices_from_axes as r_slices
from repro.core.sweep import _resolve_axes as r_axes
from repro.core.sweep_ckpt import fingerprint_digest as r_digest
from repro.distributed.sweep_shard import partition_by_class_key as r_partition
from repro_torch.core.energy import EnergyTable as TEnergyTable
from repro_torch.core.sweep import _fingerprint as t_fingerprint
from repro_torch.core.sweep import _slices_from_axes as t_slices
from repro_torch.core.sweep import _resolve_axes as t_axes
from repro_torch.core.sweep_ckpt import fingerprint_digest as t_digest
from repro_torch.distributed.sweep_shard import (
    ShardPlan,
    partition_by_class_key as t_partition,
    resolve_shard_plan,
    shard_key_totals,
)

SEARCH_AXES = dict(policies=("spm", "lru", "srrip", "pinning"),
                   capacities=(1 << 16, 1 << 17, 1 << 18), ways=(4, 8), zipf_s=0.9, seed=0)


@pytest.fixture(scope="module")
def wls():
    return R.dlrm_rmc2_small(**WORKLOAD), T.dlrm_rmc2_small(**WORKLOAD)


@pytest.fixture(scope="module")
def ref_grid(wls):
    return R.sweep(wls[0], R.tpuv6e(), **grid(R))


def port_sweep(wls, **kw):
    return T.sweep(wls[1], T.tpuv6e(), device="cpu", **grid(T), **kw)


# --------------------------------------------------------------------------
# Sharding
# --------------------------------------------------------------------------

def test_sharded_sweep_equals_unsharded(wls, ref_grid):
    got = port_sweep(wls, devices=4)
    same_sweep(got, ref_grid, "devices=4")
    assert got.sharded and got.device_count == 1
    assert not got.telemetry.any_faults


@pytest.mark.parametrize("num_shards", [1, 3, 4])
def test_partition_by_class_key_gives_the_same_shards(num_shards):
    items = {("k", i, p): (None, ("ck", i % 3)) for i in range(9) for p in ("a", "b")}
    items.update({("z", i): (None, ("solo", i)) for i in range(5)})
    parts = t_partition(items, num_shards)
    assert parts == r_partition(items, num_shards)
    for ck in {v[1] for v in items.values()}:
        assert sum(any(v[1] == ck for v in p.values()) for p in parts) == 1


def test_shard_plan_devices_are_indexed():
    plan = resolve_shard_plan(3, "cpu")
    assert plan.devices == (torch.device("cpu"),) * 3
    assert (plan.num_shards, plan.distinct_devices) == (3, 1)
    plan = resolve_shard_plan([torch.device("cpu"), "cpu"])
    assert plan.distinct_devices == 1
    with pytest.raises(ValueError):
        resolve_shard_plan(0, "cpu")
    with pytest.raises(ValueError):
        resolve_shard_plan([], "cpu")


def test_shard_key_totals_sum_over_devices():
    # cpu and cpu:0 are two torch devices: the subtotals go through tensors.
    two = ShardPlan(devices=(torch.device("cpu"), torch.device("cpu", 0), torch.device("cpu")))
    assert two.distinct_devices == 2
    assert shard_key_totals([3, 4, 5], two) == 12
    assert shard_key_totals([0, 4, 0], two) == 4
    assert shard_key_totals([2, 2], resolve_shard_plan(2, "cpu")) == 4


# --------------------------------------------------------------------------
# The checkpoint journal
# --------------------------------------------------------------------------

class _KillAfter(T.SweepCheckpoint):
    """Simulated preemption: die after N journal rounds."""

    def __init__(self, path, cadence, rounds):
        super().__init__(path, cadence=cadence)
        self._rounds = rounds

    def record(self, slice_id, results):
        if self._rounds <= 0:
            raise KeyboardInterrupt("simulated preemption")
        self._rounds -= 1
        super().record(slice_id, results)


def _journal(wls, path, damage):
    """Leave the journal at ``path`` as ``damage`` says; returns how many
    memo keys a resume should restore at most (None: all)."""
    if damage == "kill":
        ck = _KillAfter(path, cadence=4, rounds=2)
        with pytest.raises(KeyboardInterrupt):
            port_sweep(wls, checkpoint=ck)
        ck.close()
        return 8
    port_sweep(wls, checkpoint=path)
    lines = open(path, "rb").read().splitlines(keepends=True)
    if damage == "truncated":
        open(path, "wb").write(b"".join(lines[:-2]) + lines[-2][: len(lines[-2]) // 2])
        return len(lines) - 3
    if damage == "crc":
        mid = len(lines) // 2
        bad = bytearray(lines[mid])
        bad[10] ^= 0xFF
        open(path, "wb").write(b"".join(lines[:mid]) + bytes(bad) + b"".join(lines[mid + 1:]))
        return mid - 1
    return None


@pytest.mark.parametrize("damage", ["none", "kill", "truncated", "crc"])
def test_journal_resume_equals_jax_package(wls, ref_grid, tmp_path, damage):
    path = str(tmp_path / "sweep.ckpt")
    most = _journal(wls, path, damage)
    resumed = port_sweep(wls, checkpoint=path)
    same_sweep(resumed, ref_grid, f"resume after {damage}")
    if most is None:
        assert resumed.resumed_keys == resumed.distinct_memo_keys
    else:
        assert 0 < resumed.resumed_keys <= most < resumed.distinct_memo_keys
    again = port_sweep(wls, checkpoint=path)
    assert again.resumed_keys == again.distinct_memo_keys
    same_sweep(again, ref_grid, f"second resume after {damage}")
    assert not os.path.exists(path + ".lock")


@pytest.mark.parametrize("writer", ["jax_package", "port"])
def test_journal_resumes_in_the_other_package(wls, ref_grid, tmp_path, writer):
    path = str(tmp_path / "cross.ckpt")
    ck = _KillAfter(path, cadence=4, rounds=2) if writer == "port" else None
    if writer == "port":
        with pytest.raises(KeyboardInterrupt):
            port_sweep(wls, checkpoint=ck)
        ck.close()
        resumed = R.sweep(wls[0], R.tpuv6e(), checkpoint=path, **grid(R))
        assert_bitwise_equal_results(ref_grid, resumed, "port journal resumed by the reference")
        assert resumed.resumed_keys == 8
    else:
        R.sweep(wls[0], R.tpuv6e(), checkpoint=path, **grid(R))
        resumed = port_sweep(wls, checkpoint=path)
        same_sweep(resumed, ref_grid, "reference journal resumed by the port")
        assert resumed.resumed_keys == resumed.distinct_memo_keys


def test_fingerprint_mismatch_raises(wls, tmp_path):
    path = str(tmp_path / "fp.ckpt")
    port_sweep(wls, checkpoint=path)
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        T.sweep(wls[1], T.tpuv6e(), device="cpu", checkpoint=path, **{**grid(T), "seed": 1})


def _fingerprints(wls):
    """The journal fingerprint of one sweep spec, from each package."""
    out = []
    for pkg, wl, axes_fn, slices_fn, fp, energy in (
            (R, wls[0], r_axes, r_slices, r_fingerprint, REnergyTable),
            (T, wls[1], t_axes, t_slices, t_fingerprint, TEnergyTable)):
        g = grid(pkg)
        hw = pkg.tpuv6e()
        axes = axes_fn(hw, g["policies"], g["capacities"], g["ways"], None, None, None, None,
                       g["translations"])
        out.append(fp((wl,), hw, 0, slices_fn((wl,), (0.9,), axes), None, energy()))
    return out


def test_fingerprint_equals_jax_package(wls):
    ref, port = _fingerprints(wls)
    differ = sorted(k for k in ref if ref[k] != port.get(k))
    assert not differ, f"fingerprint fields differ between the packages: {differ}"
    assert set(ref) == set(port)
    assert r_digest(ref) == t_digest(port)
    assert t_digest({"a": (1, 2), "b": "x"}) == t_digest({"b": "x", "a": [1, 2]})
    assert t_digest({"a": (1, 3), "b": "x"}) == r_digest({"a": (1, 3), "b": "x"})


def test_checkpoint_frame_roundtrip():
    rec = {"kind": "key", "k": "x", "stats": [[{"cycles": 1.25}]]}
    framed = T.SweepCheckpoint._frame(rec)
    assert framed == R.SweepCheckpoint._frame(rec)
    assert T.SweepCheckpoint._parse_line(framed) == rec
    assert T.SweepCheckpoint._parse_line(framed[:-1]) is None
    bad = bytearray(framed)
    bad[2] ^= 0x01
    assert T.SweepCheckpoint._parse_line(bytes(bad)) is None


# --------------------------------------------------------------------------
# Search
# --------------------------------------------------------------------------

def test_search_equals_jax_package(wls):
    port = T.search(wls[1], T.tpuv6e(), device="cpu", **SEARCH_AXES)
    ref = R.search(wls[0], R.tpuv6e(), **SEARCH_AXES)
    assert port.front_labels() == ref.front_labels()
    assert port.full_evals == ref.full_evals
    assert port.low_fidelity_evals == ref.low_fidelity_evals
    assert [dataclasses.astuple(r)[:4] for r in port.rungs] == \
        [dataclasses.astuple(r)[:4] for r in ref.rungs]
    assert_bitwise_equal_results([dataclasses.asdict(e.result) for e in port.pareto],
                                 [dataclasses.asdict(e.result) for e in ref.pareto], "front")
    assert_bitwise_equal_results([dataclasses.asdict(e.result) for e in port.population],
                                 [dataclasses.asdict(e.result) for e in ref.population],
                                 "survivors")


def test_search_sharded_and_checkpointed_rungs_resume(wls, tmp_path):
    d = str(tmp_path / "rungs")
    first = T.search(wls[1], T.tpuv6e(), device="cpu", devices=2, checkpoint_dir=d,
                     **SEARCH_AXES)
    assert os.listdir(d)
    again = T.search(wls[1], T.tpuv6e(), device="cpu", checkpoint_dir=d, **SEARCH_AXES)
    assert first.front_labels() == again.front_labels()
    for a, b in zip(first.population, again.population):
        assert a.config == b.config and not a.result.diff(b.result)
