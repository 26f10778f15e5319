"""rank_p95_ms: the 95th percentile (nearest rank) over every batch of the
window of its latency, from when the host starts its forward until its
scores are in host memory, waiting behind the batch ahead of it included;
on the device's clock (an event on an idle stream at the start, one after
the scores' copy): a batch takes a few milliseconds, under the host
clock's error."""
from bench.harness.util import percentile


def read(run):
    return percentile([r["latency_ms"] for r in run.records], 95)
