"""bag_roofline: K3 (``bag_kernel``, ``kernels/embedding_bag.py``) against
its roofline, in percent: the least time of the bytes the window's batches
need at the chip's HBM bandwidth, over K3's device time in the trace.

A batch needs each distinct row it looks up read once (``D`` elements),
its indices read once (int32) and its bags written once: rows looked up
more than once come from the cache, and the count is of these inputs, not
the most they could need. K3 does no arithmetic worth a bound (one add a
looked-up element)."""
import torch

K3 = "bag_kernel"


def distinct_rows(sparse: torch.Tensor, rows_per_table: int) -> int:
    """Distinct (table, row) pairs among a batch's lookups (B, T, L)."""
    T = sparse.shape[1]
    offsets = torch.arange(T, device=sparse.device, dtype=torch.int64)[None, :, None]
    return int(torch.unique(sparse.long() + offsets * rows_per_table).numel())


def batch_bytes(sparse: torch.Tensor, rows_per_table: int, dim: int, elem: int) -> int:
    B, T, L = sparse.shape
    return distinct_rows(sparse, rows_per_table) * dim * elem + B * T * L * 4 + B * T * dim * elem


def record_bytes(run) -> list:
    """Bytes K3 needs for each batch of the run, in order (a pool batch's
    count is made once)."""
    c = run.config
    elem = 4 if c["dtype"] == "float32" else 2
    per = {}
    for r in run.records:
        b = r["pool"]
        if b not in per:
            per[b] = batch_bytes(run.session.inputs["sparse"][b], c["rows_per_table"], c["dim"], elem)
    return [per[r["pool"]] for r in run.records]


def read(run):
    if run.trace is None or run.peaks is None:
        return None
    t = run.trace.seconds(lambda n: K3 in n)
    if t <= 0:
        return None
    return 100.0 * sum(record_bytes(run)) / run.peaks["hbm_bytes_per_s"] / t
