"""rank_forward_host_ms: the host's time inside ``DLRM.forward`` a batch, in
milliseconds: the mean duration of the traced window's ``dlrm.forward``
spans. The program's own dispatch of a batch, without the benchmark's copy
of the scores and its events (which ``rank_dispatch_ms`` also holds); read
under the profiler, so it includes the profiler's cost per operator."""
from bench.harness.spans import spans


def read(run):
    forward = spans(run)
    if not forward:
        return None
    return sum(b - a for a, b in forward) / len(forward) / 1e6
