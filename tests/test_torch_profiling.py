"""The port's span system (``repro_torch.core.profiling``) on the CPU: a
shared no-op while nothing records, exclusive wall time under
``collect()``, record-function ranges only under ``torch.profiler``, and
the DLRM forward's spans in a profiler trace."""
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import dlrm_rmc2_small, profiling, simulate, tpuv6e
from repro_torch.kernels import ops
from repro_torch.models import DLRM, smoke_config

LAYERS = ("dlrm.bottom_mlp", "dlrm.embedding", "dlrm.interact", "dlrm.top_mlp")


def _no_range(monkeypatch):
    """Make any record-function range the span system opens fail the test."""
    def refuse(name):
        raise AssertionError(f"a range {name!r} opened")
    monkeypatch.setattr(profiling, "_RecordFunctionFast", refuse)


def test_off_a_stage_is_the_shared_no_op_and_records_nothing(monkeypatch):
    _no_range(monkeypatch)
    first = profiling.stage("a")
    assert first is profiling.stage("b")
    with first:
        with profiling.stage("c"):
            pass
    assert not profiling.is_active()
    with profiling.collect() as prof:
        pass
    assert prof.breakdown() == {}


def test_collect_nesting_is_exclusive():
    with profiling.collect() as prof:
        with profiling.stage("outer"):
            time.sleep(0.02)
            with profiling.stage("inner"):
                time.sleep(0.1)
    got = prof.breakdown()
    assert list(got) == ["inner", "outer"]
    assert got["inner"] >= 0.1
    assert 0.02 <= got["outer"] < 0.1                # the inner stage's time left out
    assert prof.breakdown(total_seconds=1.0)["other"] == pytest.approx(1.0 - sum(got.values()))


def test_collect_alone_opens_no_range(monkeypatch):
    _no_range(monkeypatch)
    with profiling.collect() as prof:
        assert profiling.is_active()
        with profiling.stage("outer"):
            with profiling.stage("inner"):
                pass
    assert set(prof.breakdown()) == {"outer", "inner"}
    assert not profiling.is_active()


def test_the_simulator_stages_read_as_before():
    wl = dlrm_rmc2_small(num_tables=2, rows_per_table=400, batch_size=4, num_batches=2)
    hw = tpuv6e().with_policy("lru", capacity_bytes=1 << 15)
    with profiling.collect() as prof:
        simulate(wl, hw.with_cache_backend("scan"), seed=0, zipf_s=0.9, device="cpu")
    got = prof.breakdown()
    for name in ("trace_gen", "classify", "cache_scan", "dram", "host_sync"):
        assert got.get(name, -1.0) >= 0.0, got


def _inputs(cfg, batch=4, seed=0):
    g = torch.Generator().manual_seed(seed)
    dense = torch.randn((batch, cfg.dense_features), generator=g)
    sparse = torch.randint(0, cfg.rows_per_table, (batch, cfg.num_tables, cfg.lookups_per_table),
                           generator=g, dtype=torch.int32)
    return dense, sparse


def _pinned(model, sparse, cfg):
    hot_ids = np.arange(0, cfg.num_tables * cfg.rows_per_table, 7, dtype=np.int64)
    pos, mask = ops.split_hot_cold(sparse.numpy(), hot_ids, cfg.rows_per_table)
    return {"hot_table": ops.embedding_gather(model.tables, torch.from_numpy(hot_ids)),
            "positions": torch.from_numpy(pos), "mask": torch.from_numpy(mask)}


@pytest.mark.parametrize("path", ["plain", "pinned"])
def test_the_dlrm_forward_spans_under_the_profiler(path):
    cfg = smoke_config()
    model = DLRM(cfg, device="cpu")
    dense, sparse = _inputs(cfg)
    pinned = _pinned(model, sparse, cfg) if path == "pinned" else None
    calls = 3
    with torch.inference_mode():
        want = model(dense, sparse, pinned)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            assert not profiling.is_active()
            got = [model(dense, sparse, pinned) for _ in range(calls)]
    assert all(torch.equal(g, want) for g in got)
    spans = sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                    for e in prof.profiler.kineto_results.events()
                    if e.name().startswith("dlrm.")), key=lambda s: s[1])
    roots = [s for s in spans if s[0] == "dlrm.forward"]
    assert len(roots) == calls
    for _, a, b in roots:
        inside = [s for s in spans if s[0] != "dlrm.forward" and a <= s[1] and s[2] <= b]
        assert [s[0] for s in inside] == list(LAYERS)
    assert len(spans) == calls * (1 + len(LAYERS))


def test_collect_and_the_profiler_both_record():
    with profiling.collect() as prof:
        with profile(activities=[ProfilerActivity.CPU]) as trace:
            with profiling.stage("both"):
                time.sleep(0.01)
    assert prof.breakdown()["both"] >= 0.01
    assert [e.name() for e in trace.profiler.kineto_results.events()].count("both") == 1
