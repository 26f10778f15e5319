"""Small configurations of the cells, for the CPU tests: the same families,
kinds, mixes and checks at a size a test run holds."""
from bench.harness import manifest as mf

DLRM = {"family": "dlrm", "name": "small", "num_tables": 4, "rows_per_table": 1000, "dim": 32,
        "lookups_per_table": 8, "dense_features": 13, "bottom_mlp": [64, 32],
        "top_mlp": [32, 16, 1], "dtype": "float32", "reduced": []}
RANKING = {"kind": "ranking", "batch": 64, "pool_batches": 5, "zipf_s": 1.1, "in_flight": 2}
RANK_CELL = "rmc2_rank_reuse_high"
SMALL_CONFIGS = {"dlrm": DLRM}
CELLS = [w["name"] for w in mf.load()["workloads"]]


def family_of(cell: str) -> str:
    bench = mf.load()
    return mf.load_config(bench, mf.workload(bench, cell)["config"])["family"]


def overrides(cell: str) -> dict:
    """The cell at a small size: its family's small configuration, and its
    own mix with the batch and the pool cut."""
    w = mf.workload(mf.load(), cell)
    config = SMALL_CONFIGS[family_of(cell)]
    mix = dict(mf.load_traffic(w["traffic"]), batch=RANKING["batch"],
               pool_batches=RANKING["pool_batches"])
    return {"config": config, "mix": mix}
