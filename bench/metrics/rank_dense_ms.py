"""rank_dense_ms: device time per batch of everything but K3 (the MLPs,
the interaction, the index arithmetic of ``kernels/ops.py``, the copy of
the scores), in milliseconds, from the trace."""
from bench.metrics.bag_roofline import K3


def read(run):
    if run.trace is None or not run.records:
        return None
    t = run.trace.seconds(lambda n: K3 not in n)
    if t <= 0:
        return None
    return 1e3 * t / len(run.records)
