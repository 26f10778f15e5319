"""The port's CUDA kernels against their plain torch versions, on the card.

Run on a machine with an NVIDIA GPU and nvcc:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_kernels_cuda.py

Without a card every test here skips (the kernels have no CPU mode; their
plain versions are held against the JAX package by the CPU tests).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.cache_scan import cache_scan_groups, cache_scan_plain
from repro_torch.kernels.dram_scan import dram_scan_chunked, dram_scan_plain
from repro_torch.kernels.stack_distance import stack_distance_groups, stack_distance_plain

pytestmark = pytest.mark.cuda

EDGE = [(1, 1), (1, 4), (3, 2), (7, 5), (16, 7), (16, 16), (4, 32), (2, 33), (2, 64)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _rows(cuda, S, W, B=4, L=192, seed=0):
    rng = np.random.default_rng(seed + 31 * S + W)
    valid = rng.random((B, L)) < 0.9
    valid[:, L - 40:] = False
    arrays = (rng.integers(0, S, size=(B, L)).astype(np.int32),
              rng.integers(0, S * W * 2 + 1, size=(B, L)).astype(np.int32), valid)
    return [torch.from_numpy(a).to(cuda) for a in arrays]


@pytest.mark.parametrize("policy", ["lru", "srrip", "fifo"])
@pytest.mark.parametrize("sets,ways", EDGE)
def test_cache_scan_kernel_equals_plain(cuda, policy, sets, ways):
    rows = _rows(cuda, sets, ways)
    reset_launch_counts()
    got = cache_scan_groups(*rows, sets, ways, policy)
    assert launch_counts()["cache_scan"] == 1
    want = cache_scan_plain(*rows, sets, ways, policy)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("sets,ways", EDGE)
def test_stack_distance_kernel_equals_plain(cuda, sets, ways):
    rows = _rows(cuda, sets, ways)
    reset_launch_counts()
    got = stack_distance_groups(*rows, sets, ways)
    assert launch_counts()["stack_distance"] == 1
    want = stack_distance_plain(*rows, sets, ways)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("banks,k_max", [(8, 8), (4, 3), (16, 1)])
def test_dram_scan_kernel_equals_plain_bitwise(cuda, banks, k_max):
    rng = np.random.default_rng(banks)
    R, Lc = 40, 160
    arrays = (rng.integers(0, banks, size=(R, Lc)).astype(np.int32),
              rng.integers(0, 3, size=(R, Lc)).astype(np.int32),
              rng.integers(1, k_max + 1, size=(R, Lc)).astype(np.int32),
              rng.random((R, Lc)) < 0.8)
    args = [torch.from_numpy(a).to(cuda) for a in arrays]
    reset_launch_counts()
    got = dram_scan_chunked(*args, banks, k_max, 44.0, 22.0, 0.6016)
    assert launch_counts()["dram_scan"] == 1
    want = dram_scan_plain(*args, banks, k_max, 44.0, 22.0, 0.6016)
    for a, b in zip(got[0] + got[1], want[0] + want[1]):
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b)


def test_kernels_refuse_what_they_do_not_take(cuda):
    s = torch.zeros((2, 8), dtype=torch.int32, device=cuda)
    v = torch.ones((2, 8), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="49152 bytes"):
        cache_scan_groups(s, s, v, 16, 4096, "lru")
    with pytest.raises(ValueError, match="contiguous"):
        cache_scan_groups(s.t().contiguous().t(), s, v, 1, 1, "lru")
    with pytest.raises(ValueError, match="devices|on cpu|cuda"):
        stack_distance_groups(s, s.cpu(), v, 1, 1)


@pytest.mark.parametrize("policy,backend,kernel", [
    ("lru", "pallas", "cache_scan"), ("srrip", "pallas", "cache_scan"),
    ("fifo", "pallas", "cache_scan"), ("lru", "stack_pallas", "stack_distance"),
    ("lru", "stack", None), ("spm", "stack", None), ("srrip", "scan", None),
])
def test_simulate_on_the_card_equals_cpu(cuda, policy, backend, kernel):
    import dataclasses

    from repro_torch.core import dlrm_rmc2_small, simulate, tpuv6e

    wl = dlrm_rmc2_small(num_tables=2, rows_per_table=300, batch_size=2, num_batches=2)
    hw = tpuv6e().with_policy(policy, capacity_bytes=1 << 14, ways=3).with_cache_backend(backend)
    reset_launch_counts()
    on_card = simulate(wl, hw)
    counts = launch_counts()
    assert counts["dram_scan"] == 1
    for name in ("cache_scan", "stack_distance"):
        assert (counts[name] > 0) == (name == kernel), counts
    assert dataclasses.asdict(on_card) == dataclasses.asdict(simulate(wl, hw, device="cpu"))
