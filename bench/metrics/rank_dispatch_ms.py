"""rank_dispatch_ms: the host's time to enqueue a batch, in milliseconds:
``DLRM.forward``'s operators and the scores' copy, from the start of the
call until every launch is queued, summed over the window's batches on the
host's clock and divided by their number. With two batches in flight the
card hides it; it is the host's share of a batch's latency in a loop with
one. Read in the traced run, so it includes the profiler's cost per
operator."""


def read(run):
    if not run.records or "dispatch_s" not in run.records[0]:
        return None
    return 1e3 * sum(r["dispatch_s"] for r in run.records) / len(run.records)
