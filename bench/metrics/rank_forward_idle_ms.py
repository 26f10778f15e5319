"""rank_forward_idle_ms: how long the card sat idle each batch while the host
was inside ``DLRM.forward``, in milliseconds: the traced window's idle gaps
(no kernel, copy or fill on the device) intersected with its
``dlrm.forward`` spans, summed, over the window's batches. The rest of the
idle time falls in the benchmark's loop (waiting on the oldest batch's
event, Python between batches)."""
from bench.harness.spans import spans


def idle_ns(forward, gaps) -> int:
    """The summed intersection of two sorted lists of disjoint intervals."""
    total, i, j = 0, 0, 0
    while i < len(forward) and j < len(gaps):
        lo = max(forward[i][0], gaps[j][0])
        hi = min(forward[i][1], gaps[j][1])
        if hi > lo:
            total += hi - lo
        if forward[i][1] < gaps[j][1]:
            i += 1
        else:
            j += 1
    return total


def read(run):
    forward = spans(run)
    if not forward or not run.records:
        return None
    return idle_ns(forward, run.trace.gaps) / 1e6 / len(run.records)
