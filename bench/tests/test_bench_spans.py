"""The readers of the program's spans against hand counts on a synthetic
trace, their silence on a trace without spans, and a traced run of a small
cell on the CPU."""
import pytest

from bench.harness.devtrace import WINDOW_SPAN, DeviceTrace
from bench.metrics import rank_forward_host_ms, rank_forward_idle_ms, rank_forward_launches
from bench.run import run_cell
from bench.tests import small

READERS = [rank_forward_host_ms, rank_forward_idle_ms, rank_forward_launches]


class _Run:
    def __init__(self, trace, records):
        self.trace, self.records = trace, records


def _trace(device, host):
    return DeviceTrace(sorted(device, key=lambda e: e[1]),
                       sorted([(WINDOW_SPAN, 0, 1000)] + host, key=lambda e: e[1]))


# Two batches: forwards over 100..300 and 500..700, each with its layers'
# spans; the card busy over 130..260, 320..480 and 560..650.
DEVICE = [("gemm", 130, 260), ("bag_kernel", 320, 480), ("gemm", 560, 650)]
HOST = [("dlrm.forward", 100, 300), ("dlrm.bottom_mlp", 105, 140), ("dlrm.embedding", 145, 200),
        ("dlrm.interact", 205, 280), ("dlrm.top_mlp", 282, 298),
        ("cudaLaunchKernel", 120, 125), ("cudaLaunchKernelExC", 150, 155),
        ("cudaEventRecord", 200, 201), ("cuLaunchKernel", 250, 252),
        ("cudaMemcpyAsync", 310, 315),                        # the scores' copy: outside
        ("dlrm.forward", 500, 700), ("cudaMemsetAsync", 520, 521),
        ("cudaLaunchKernel", 690, 695), ("cudaLaunchKernel", 700, 705)]


def test_readers_by_hand():
    run = _Run(_trace(DEVICE, HOST), [{"items": 4}, {"items": 4}])
    # mean of two spans of 200 ns
    assert rank_forward_host_ms.read(run) == pytest.approx(200e-6)
    # gaps 0..130, 260..320, 480..560, 650..1000 inside the forwards:
    # 100..130 + 260..300 + 500..560 + 650..700 = 180 ns over two batches
    assert rank_forward_idle_ms.read(run) == pytest.approx(90e-6)
    # 120, 150, 250 in the first; 520, 690 in the second; 700 starts at its end
    assert rank_forward_launches.read(run) == pytest.approx(2.5)


def test_idle_inside_the_forward_is_named_by_its_layer():
    idle = _trace(DEVICE, HOST).idle_by_host()
    assert idle["dlrm.top_mlp"] == pytest.approx(60e-9)      # 260..320: 290 is in top_mlp
    assert idle["python, no op recorded"] == pytest.approx(480e-9)   # 0..130, 650..1000


@pytest.mark.parametrize("reader", READERS, ids=lambda r: r.__name__.rsplit(".", 1)[-1])
def test_no_span_no_reading(reader):
    host = [h for h in HOST if not h[0].startswith("dlrm.")]
    assert reader.read(_Run(_trace(DEVICE, host), [{"items": 4}])) is None
    assert reader.read(_Run(None, [{"items": 4}])) is None


def test_a_traced_run_on_the_cpu_reads_the_spans():
    cell = small.RANK_CELL
    result = run_cell(cell, 2**33 + 29, 0.2, True, "cpu", small.overrides(cell))
    m = result["metrics"]
    assert m["rank_forward_host_ms"]["value"] > 0
    assert m["rank_forward_idle_ms"]["value"] > 0            # no device events on the CPU
    assert m["rank_forward_launches"]["value"] == 0          # nor runtime calls
