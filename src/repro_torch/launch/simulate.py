"""EONSim CLI on PyTorch — run the simulator on a workload.

    PYTHONPATH=src python -m repro_torch.launch.simulate --device cuda \
        --tables 60 --rows 1000000 --batch 32 --policy lru --cache-backend pallas
    PYTHONPATH=src python -m repro_torch.launch.simulate --workload lm \
        --arch command_r_plus_104b --shape decode_32k --policy pinning

``--arch`` takes every architecture of ``models.ARCH_IDS``.

``--device`` defaults to ``cuda`` and fails when there is no card; pass
``--device cpu`` to run the kernels' plain versions on the CPU.
"""
from __future__ import annotations

import argparse

from repro_torch.core import CACHE_BACKENDS, OnChipPolicy, dlrm_rmc2_small, simulate, tpuv6e
from repro_torch.core.lm_mapper import lm_workload
from repro_torch.core.trace import REUSE_LEVELS
from repro_torch.models import SHAPES_BY_NAME, get_config


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="dlrm", choices=["dlrm", "lm"])
    ap.add_argument("--policy", default="spm",
                    choices=[p.value for p in OnChipPolicy])
    ap.add_argument("--cache-backend", default="stack", choices=CACHE_BACKENDS)
    ap.add_argument("--tables", type=int, default=60)
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--lookups", type=int, default=120)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--num-batches", type=int, default=1)
    ap.add_argument("--zipf", type=float, default=REUSE_LEVELS["reuse_mid"])
    ap.add_argument("--arch", default="stablelm_3b")
    ap.add_argument("--shape", default="decode_32k")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    hw = tpuv6e().with_policy(OnChipPolicy(args.policy)).with_cache_backend(
        args.cache_backend)
    if args.workload == "dlrm":
        wl = dlrm_rmc2_small(
            num_tables=args.tables, rows_per_table=args.rows,
            lookups=args.lookups, batch_size=args.batch,
            num_batches=args.num_batches,
        )
    else:
        cfg = get_config(args.arch)
        wl = lm_workload(cfg, SHAPES_BY_NAME[args.shape], num_batches=args.num_batches)
    res = simulate(wl, hw, zipf_s=args.zipf, device=args.device)
    if args.json:
        print(res.to_json())
    else:
        for k, v in res.summary().items():
            print(f"{k:20s} {v}")


if __name__ == "__main__":
    main()
