"""The plain references against the port's plain CPU route at a small size."""
import torch

from bench.families import dlrm
from bench.kinds import ranking
from bench.reference import dlrm as dlrm_ref
from bench.reference.precision import round_tf32
from bench.tests import small


def test_dlrm_reference_matches_the_port():
    s = ranking.Session(dlrm, small.DLRM, small.RANKING, {}, 7, "cpu")
    for b in range(small.RANKING["pool_batches"]):
        dense, sparse = s.inputs["dense"][b], s.inputs["sparse"][b]
        with torch.inference_mode():
            port = s.model(dense, sparse)
        ref = dlrm_ref.scores(s.weights, dense, sparse, s.config, block=16)
        torch.testing.assert_close(port, ref, rtol=1e-5, atol=1e-5)


def test_lower_precisions_round_as_stated():
    x = torch.tensor([1.0 + 2**-11, 1.0 + 2**-10 + 2**-11, -3.0, 1e-3])
    t = round_tf32(x)
    assert t[0] == 1.0 + 2**-10 and t[1] == 1.0 + 2**-9 and t[2] == -3.0
    bits = t.view(torch.int32) & 0x1FFF
    assert int(bits.abs().sum()) == 0
