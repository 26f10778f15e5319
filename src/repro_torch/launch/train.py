"""Training launcher with checkpoint/restart, failure detection and the
straggler policy (a port of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm_3b --smoke \\
        --steps 50 --checkpoint-dir /tmp/ckpt --resume auto [--device cpu]

Runs on the card unless ``--device cpu``. Batches are ``lm_batch`` of the
step, so a resumed run sees the batches a straight run would. SIGTERM
checkpoints and exits at the end of the step it arrives in: the step
updates the state in place, so only a step's end holds a whole state.
"""
from __future__ import annotations

import argparse
import signal
import time

import torch

from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
from repro_torch.data import LMDataConfig, lm_batch
from repro_torch.device import resolve_device
from repro_torch.models import get_config, get_smoke_config
from repro_torch.models.layers import model_dtype
from repro_torch.runtime import FailureDetector, FaultConfig, StragglerPolicy
from repro_torch.training import (
    AdamWConfig,
    CompressionConfig,
    TrainConfig,
    build_train_step,
    init_state,
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm_3b")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress", default="none", choices=["none", "int8", "topk"])
    ap.add_argument("--quantize-opt", action="store_true")
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--save-every", type=int, default=20)
    ap.add_argument("--resume", default="none", choices=["none", "auto"])
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    tcfg = TrainConfig(
        adamw=AdamWConfig(lr=args.lr, warmup_steps=10, total_steps=args.steps,
                          quantize_state=args.quantize_opt),
        compression=CompressionConfig(kind=args.compress),
        microbatches=args.microbatches,
        loss_chunk=min(512, args.seq),
    )

    state = init_state(0, cfg, tcfg, device=dev)
    step_fn = build_train_step(cfg, tcfg)
    dcfg = LMDataConfig(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch)

    mgr = None
    start = 0
    if args.checkpoint_dir:
        mgr = CheckpointManager(CheckpointConfig(directory=args.checkpoint_dir))
        if args.resume == "auto" and mgr.latest_step() is not None:
            start, _, state = mgr.restore(target_tree=state)
            print(f"resumed from step {start}", flush=True)

    detector = FailureDetector(["host0"], FaultConfig())
    straggler = StragglerPolicy()
    preempted = []

    def _on_sigterm(signum, frame):  # preemption: checkpoint at the step's end, then exit
        preempted.append(signum)

    signal.signal(signal.SIGTERM, _on_sigterm)

    t_last = time.time()
    for i in range(start, args.steps):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in lm_batch(dcfg, i).items()}
        if cfg.family == "audio":
            # the stub frontend's frames: zeros, in the model's dtype (bf16
            # in every shipped config, as the reference's)
            batch["frames"] = torch.zeros((args.batch, cfg.encdec.encoder_seq, cfg.d_model),
                                          dtype=model_dtype(cfg), device=dev)
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])            # waits for the step
        detector.heartbeat("host0")
        dt = time.time() - t_last
        t_last = time.time()
        straggler.observe({"host0": dt})
        if i % args.log_every == 0 or i == args.steps - 1:
            print(
                f"step {i:5d} loss={loss:.4f} "
                f"lr={float(metrics['lr']):.2e} gnorm={float(metrics['grad_norm']):.2f} "
                f"{dt*1e3:.0f} ms", flush=True
            )
        if mgr is not None and (i + 1) % args.save_every == 0:
            mgr.save(i + 1, state)
        if preempted:
            if mgr is not None:
                mgr.save(int(state["step"]), state)
                mgr.wait()
            print(f"preempted: saved step {int(state['step'])}", flush=True)
            raise SystemExit(0)
    if mgr is not None:
        mgr.save(args.steps, state)
        mgr.wait()
    print("done", flush=True)


if __name__ == "__main__":
    main()
