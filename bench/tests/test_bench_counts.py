"""The operation and byte counts of the metric readers against hand counts
at small shapes, and the device trace's busy and idle arithmetic."""
import pytest
import torch

from bench.harness.devtrace import WINDOW_SPAN, DeviceTrace
from bench.harness.peaks import H100_SXM
from bench.metrics import (bag_roofline, rank_dense_ms, rank_device_idle, rank_dispatch_ms,
                           rank_mfu)
from bench.tests import small


def test_bag_bytes_count_each_distinct_row_once():
    # B 2, T 2, L 3; table 0 rows {1, 5}, table 1 rows {1, 2, 3}: 5 distinct rows
    sparse = torch.tensor([[[1, 1, 5], [2, 2, 2]], [[5, 1, 1], [1, 3, 2]]], dtype=torch.int32)
    assert bag_roofline.distinct_rows(sparse, rows_per_table=10) == 5
    # 5 rows x 4 dims x 4 B + 12 int32 indices + 2 x 2 bags x 4 dims x 4 B
    assert bag_roofline.batch_bytes(sparse, 10, dim=4, elem=4) == 80 + 48 + 64


def test_dlrm_flops_by_hand():
    c = dict(small.DLRM)
    # bottom 13-64-32, n = 5 vectors (10 pairs), top (10 + 32)-32-16-1
    mlp = 13 * 64 + 64 * 32 + 42 * 32 + 32 * 16 + 16
    want = 2 * 3 * mlp + 2 * 3 * 10 * 32 + 3 * 4 * 8 * 32
    assert rank_mfu.batch_flops(c, 3) == want
    assert rank_mfu.weight_bytes(c) == 4 * (13 * 64 + 64 + 64 * 32 + 32 + 42 * 32 + 32
                                            + 32 * 16 + 16 + 16 + 1)


def _trace(device, host=()):
    return DeviceTrace(sorted(device, key=lambda e: e[1]),
                       sorted([(WINDOW_SPAN, 0, 100)] + list(host), key=lambda e: e[1]))


def test_device_trace_busy_gaps_and_labels():
    t = _trace([("k1", 10, 30), ("k2", 20, 40), ("bag_kernel<float>", 60, 70), ("late", 95, 120)],
               host=[("aten::mm", 0, 12), ("python_step", 40, 59), ("aten::copy_", 45, 50)])
    assert t.window_s == 100e-9
    assert t.busy_s == pytest.approx(45e-9)             # 10..40, 60..70, 95..100
    assert t.gaps == [(0, 10), (40, 60), (70, 95)]
    idle = t.idle_by_host()
    assert idle["aten::mm"] == pytest.approx(10e-9)
    assert idle["aten::copy_"] == pytest.approx(20e-9)  # the midpoint 50 is inside it
    assert t.seconds(lambda n: "bag_kernel" in n) == pytest.approx(10e-9)
    bd = t.breakdown()
    assert bd["device_ops"][0][0] == "k1" and len(bd["idle_gaps"]) <= 10


class _Run:
    def __init__(self, trace, records, config, session=None):
        self.trace, self.records, self.config, self.session = trace, records, config, session
        self.peaks = H100_SXM


def test_device_idle_reads_the_gaps_share():
    t = _trace([("bag_kernel", 0, 50), ("gemm", 50, 60), ("elementwise", 60, 80)])
    assert rank_device_idle.read(_Run(t, [{"items": 1}], {})) == pytest.approx(20.0)


def test_dispatch_is_the_mean_host_time_a_batch():
    rec = [{"items": 4, "dispatch_s": 3e-4}, {"items": 4, "dispatch_s": 5e-4}]
    assert rank_dispatch_ms.read(_Run(None, rec, {})) == pytest.approx(0.4)
    assert rank_dispatch_ms.read(_Run(None, [{"items": 4}], {})) is None


def test_dlrm_readers_on_a_synthetic_trace():
    class S:
        inputs = {"sparse": torch.tensor([[[[1, 1]]], [[[2, 3]]]], dtype=torch.int32)}
    c = dict(small.DLRM, num_tables=1, lookups_per_table=2, dim=4)
    rec = [{"pool": 0, "items": 1}, {"pool": 1, "items": 1}, {"pool": 0, "items": 1}]
    t = _trace([("void bag_kernel<float, true, 16>", 0, 10), ("gemm", 10, 16),
                ("bag_kernel", 20, 30), ("bag_kernel", 40, 50)])
    run = _Run(t, rec, c, S())
    per = [1 * 16 + 8 + 16, 2 * 16 + 8 + 16, 1 * 16 + 8 + 16]
    assert bag_roofline.record_bytes(run) == per
    assert bag_roofline.read(run) == pytest.approx(100 * sum(per) / 3.35e12 / 30e-9)
    assert rank_dense_ms.read(run) == pytest.approx(1e3 * 6e-9 / 3)
    assert 0 < rank_mfu.read(run) < 100
