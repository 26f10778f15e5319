"""Serving launcher on PyTorch: batched greedy decoding of an LM.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2_2p7b \
        --batch 8 --prompt-len 1024 --new-tokens 32

Every architecture of ``models.ARCH_IDS`` serves; the audio family
(whisper) first encodes zero frames of the encoder's length, as the JAX
package's launcher does. ``--device`` defaults to ``cuda`` and fails when
there is no card; pass ``--device cpu --smoke`` to run a reduced model on
the CPU through the kernels' plain versions.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.models import family_module, get_config, get_smoke_config
from repro_torch.models.layers import model_dtype
from repro_torch.serving import ServeConfig, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm_3b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    mod = family_module(cfg)
    init = mod.init_model if cfg.family == "audio" else mod.init_lm
    params = init(cfg, device=args.device)
    scfg = ServeConfig(batch=args.batch, max_seq=args.prompt_len + args.new_tokens + 8)
    engine = ServingEngine(cfg, params, scfg)

    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab, size=(args.batch, args.prompt_len), dtype=np.int32
    )
    enc_out = None
    if cfg.family == "audio":
        frames = torch.zeros((args.batch, cfg.encdec.encoder_seq, cfg.d_model),
                             dtype=model_dtype(cfg), device=engine.device)
        with torch.inference_mode():
            enc_out = mod.encode(params, frames, cfg)
    t0 = time.time()
    out = engine.generate(prompts, max_new_tokens=args.new_tokens, enc_out=enc_out)
    dt = time.time() - t0
    total = args.batch * args.new_tokens
    print(f"generated {out.shape} in {dt:.2f}s -> {total/dt:.1f} tok/s")
    print(out[:, :8])


if __name__ == "__main__":
    main()
