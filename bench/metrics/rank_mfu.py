"""rank_mfu: the whole ranking step's share of the chip's peaks, in
percent: for each batch of the trace its least time, the larger of its
operations at the f32 peak (the card runs these products in f32) and its
bytes at the HBM bandwidth, summed over the batches, over the traced window's seconds.

Operations of a batch of B: the bottom MLP's and top MLP's products (2 a
multiply-add), the interaction's n(n-1)/2 dot products of D (n = T + 1),
and the bags' B T L D adds. Bytes: K3's (``bag_roofline``), the dense
features read, the scores written, the MLP weights read once."""
from bench.metrics.bag_roofline import record_bytes


def batch_flops(c: dict, B: int) -> int:
    dims_b = [c["dense_features"], *c["bottom_mlp"]]
    n = c["num_tables"] + 1
    dims_t = [n * (n - 1) // 2 + c["bottom_mlp"][-1], *c["top_mlp"]]
    mlp = sum(a * b for a, b in zip(dims_b, dims_b[1:])) + sum(a * b for a, b in zip(dims_t, dims_t[1:]))
    return 2 * B * mlp + 2 * B * (n * (n - 1) // 2) * c["dim"] \
        + B * c["num_tables"] * c["lookups_per_table"] * c["dim"]


def weight_bytes(c: dict) -> int:
    dims_b = [c["dense_features"], *c["bottom_mlp"]]
    n = c["num_tables"] + 1
    dims_t = [n * (n - 1) // 2 + c["bottom_mlp"][-1], *c["top_mlp"]]
    return 4 * sum(a * b + b for d in (dims_b, dims_t) for a, b in zip(d, d[1:]))


def read(run):
    if run.trace is None or run.peaks is None or not run.records:
        return None
    c, p = run.config, run.peaks
    B = run.records[0]["items"]
    flop_s = batch_flops(c, B) / p["f32_flops"]
    other = B * c["dense_features"] * 4 + B * 4 + weight_bytes(c)
    least = sum(max(flop_s, (k3 + other) / p["hbm_bytes_per_s"]) for k3 in record_bytes(run))
    return 100.0 * least / run.trace.window_s
