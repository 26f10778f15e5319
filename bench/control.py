"""Readings that a cell's limits are set from, on the card at the cell's size.

    python3 bench/control.py --workload <cell> --seeds 1 2 3 ... [--control-seeds 3] [--out F]

For each seed: the cell's set-up, a short window at the cell's own load
(the session's ``cover_steps``: each pool batch of a ranking mix once),
then the numbers the cell compares, read for the program (the lower
reading's runs) and, on the first ``--control-seeds`` seeds, for the
control: the plain reference put in the program's place at the next
precision down from the configuration's (the check file's ``control``:
TF32 for f32). One JSON line a seed. The benchmark's own runs never run
this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1]), str(Path(__file__).resolve().parents[1] / "src")]

from bench.run import pin_environment  # noqa: E402


def readings(workload: str, seed: int, control: bool, device: str = "cuda",
             overrides: dict = None) -> dict:
    import torch
    from bench.harness import manifest as mf
    from bench.reference.precision import no_tf32
    overrides = overrides or {}
    bench = mf.load()
    cell = mf.workload(bench, workload)
    config = overrides.get("config") or mf.load_config(bench, cell["config"])
    mix = overrides.get("mix") or mf.load_traffic(cell["traffic"])
    check = overrides.get("check") or mf.load_check(workload)
    no_tf32()
    t0 = time.perf_counter()
    session = mf.kind(mix).Session(mf.family(config), config, mix, check, seed, device)
    for i in range(session.cover_steps):
        session.step(i)
    session.drain()
    session.free_program()
    out = {"seed": seed, "program": session.compared()}
    if control:
        out["control"] = session.compared(check["control"])
    out["seconds"] = time.perf_counter() - t0
    del session
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--out")
    ap.add_argument("--config-set", nargs="*", default=[], metavar="KEY=JSON",
                    help="change a key of the cell's configuration (a witness run, such as "
                         "the program in f32)")
    args = ap.parse_args(argv)
    pin_environment()
    import torch
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 3
    overrides = {}
    if args.config_set:
        from bench.harness import manifest as mf
        bench = mf.load()
        config = mf.load_config(bench, mf.workload(bench, args.workload)["config"])
        for item in args.config_set:
            key, _, value = item.partition("=")
            config[key] = json.loads(value)
        overrides["config"] = config
    for k, seed in enumerate(args.seeds):
        line = json.dumps(dict(readings(args.workload, seed, k < args.control_seeds, "cuda",
                                        overrides),
                               workload=args.workload, config_set=args.config_set,
                               kind=torch.cuda.get_device_name()))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
