"""The traffic: the on-device Zipf sampler against the simulator's
``generate_zipf_trace``, and the ranking kind's inputs reproducible from
the seed."""
import numpy as np
import torch

from bench.harness import traffic
from bench.kinds import ranking
from repro_torch.core.trace import REUSE_LEVELS, dominance_fraction, generate_zipf_trace

SMALL = {"num_tables": 3, "rows_per_table": 5000, "lookups_per_table": 6, "dense_features": 13}
MIX = {"kind": "ranking", "batch": 16, "pool_batches": 2, "zipf_s": 1.1}


def test_zipf_ranks_follow_generate_zipf_trace():
    R, n, s = 20_000, 400_000, REUSE_LEVELS["reuse_high"]
    g = torch.Generator().manual_seed(1)
    ours = traffic.zipf_ranks(n, traffic.zipf_cdf(R, s, "cpu"), g).numpy()
    theirs = generate_zipf_trace(n, R, s, seed=1, shuffle_ids=False)
    a, b = np.bincount(ours, minlength=R), np.bincount(theirs, minlength=R)
    # the hottest ranks: counts agree within five standard deviations
    for r in range(20):
        assert abs(a[r] - b[r]) <= 5 * np.sqrt(b[r]) + 5, r
    top = lambda c: c[:R // 100].sum() / n
    assert abs(top(a) - top(b)) < 0.01
    assert abs(dominance_fraction(ours, R) - dominance_fraction(theirs, R)) < 0.01
    assert ours.min() >= 0 and ours.max() < R


def test_reuse_high_keeps_the_papers_dominance():
    # the calibration's geometry: 1M lookups over 1M rows, ~4% of the rows
    # seen carry 80% of the lookups (the simulator's tests pin it)
    R = 1_000_000
    g = torch.Generator().manual_seed(2)
    ranks = traffic.zipf_ranks(R, traffic.zipf_cdf(R, REUSE_LEVELS["reuse_high"], "cpu"), g)
    ours = dominance_fraction(ranks.numpy(), R)
    theirs = dominance_fraction(generate_zipf_trace(R, R, REUSE_LEVELS["reuse_high"], seed=2), R)
    assert 0.03 < ours < 0.05 and abs(ours - theirs) < 0.003


def test_ranking_inputs_are_reproducible_from_the_seed():
    a = ranking.generate(MIX, SMALL, 2**40 + 3, "cpu")
    b = ranking.generate(MIX, SMALL, 2**40 + 3, "cpu")
    c = ranking.generate(MIX, SMALL, 2**40 + 4, "cpu")
    assert torch.equal(a["sparse"], b["sparse"]) and torch.equal(a["dense"], b["dense"])
    assert not torch.equal(a["sparse"], c["sparse"])
    assert a["sparse"].shape == (2, 16, 3, 6) and a["sparse"].dtype == torch.int32
    assert int(a["sparse"].min()) >= 0 and int(a["sparse"].max()) < SMALL["rows_per_table"]


def test_each_table_keeps_one_rank_to_row_permutation():
    out = ranking.generate(dict(MIX, zipf_s=3.0), SMALL, 9, "cpu")
    perm = out["perm"]
    for t in range(SMALL["num_tables"]):
        assert torch.equal(perm[t].sort().values, torch.arange(SMALL["rows_per_table"],
                                                              dtype=torch.int32))
        # at s = 3 most lookups hit rank 0: the same row in every pool batch
        rows = out["sparse"][:, :, t].reshape(-1)
        assert (rows == perm[t, 0]).float().mean() > 0.7
