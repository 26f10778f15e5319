"""The check that decides ``correct``: a run at a small size on the CPU,
past the harness's look for a card, with the cell's own limits. A sound
run is correct; a run with its timed path broken underneath is not, for
each fault the cell can have; and the control (the reference at the next
precision down, in the program's place) fails the limits."""
import pytest
import torch

from bench.control import readings
from bench.harness import manifest as mf
from bench.run import run_cell
from bench.tests import small

SEED = 2**33 + 17


def _half_batch_dlrm(monkeypatch):
    from repro_torch.models.dlrm import DLRM
    forward = DLRM.forward

    def half(self, dense, sparse, pinned=None):
        n = dense.shape[0] // 2
        out = forward(self, dense[:n], sparse[:n])
        return torch.cat([out, out.mean().expand(dense.shape[0] - n)])
    monkeypatch.setattr(DLRM, "forward", half)


def _answer_altered_dlrm(monkeypatch):
    from repro_torch.kernels import ops
    bag = ops.embedding_bag

    def altered(table, indices, rows_per_table):
        out = bag(table, indices, rows_per_table)
        out[0, 0] = 0.0                      # one bag's sum lost
        return out
    monkeypatch.setattr(ops, "embedding_bag", altered)


def _stale_scores_dlrm(monkeypatch):
    from repro_torch.models.dlrm import DLRM
    forward = DLRM.forward
    last = []

    def stale(self, dense, sparse, pinned=None):
        out = forward(self, dense, sparse)
        last.append(out)
        return last[-2] if len(last) > 1 else out   # the previous batch's scores
    monkeypatch.setattr(DLRM, "forward", stale)


def _lookups_dropped_dlrm(monkeypatch):
    from repro_torch.kernels import ops
    bag = ops.embedding_bag

    def dropped(table, indices, rows_per_table):
        return bag(table, indices[:, :, : indices.shape[2] // 2].contiguous(), rows_per_table)
    monkeypatch.setattr(ops, "embedding_bag", dropped)


FAULTS = {"half_batch": _half_batch_dlrm, "answer_altered": _answer_altered_dlrm,
          "stale_scores": _stale_scores_dlrm, "lookups_dropped": _lookups_dropped_dlrm}
CASES = [(cell, f) for cell in small.CELLS if small.family_of(cell) == "dlrm" for f in FAULTS]


@pytest.mark.parametrize("cell", small.CELLS)
def test_a_sound_run_is_correct(cell):
    result = run_cell(cell, SEED, 0.2, False, "cpu", small.overrides(cell))
    assert result["correct"], result["compared"]
    assert list(result)[-1] == "compared"
    assert result["attempted"] > 0 and result["failed"] == 0
    names = {m["name"] for m in mf.metrics_for(mf.load(), cell, "end_to_end")}
    assert set(result["metrics"]) == names


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    result = run_cell(cell, SEED, 0.2, False, "cpu", small.overrides(cell))
    assert not result["correct"], result["compared"]


@pytest.mark.parametrize("cell", small.CELLS)
def test_the_control_fails_the_limits(cell):
    limits = mf.load_check(cell)["limits"]
    for seed in (SEED, SEED + 1, SEED + 2):
        out = readings(cell, seed, True, "cpu", small.overrides(cell))
        assert all(v <= limits[k] for k, v in out["program"].items()), out
        assert any(v > limits[k] for k, v in out["control"].items()), out
