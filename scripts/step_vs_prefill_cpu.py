#!/usr/bin/env python3
"""Decode step against prefill, in the JAX package and in the port, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/step_vs_prefill_cpu.py [--depth 54] [--width 1]
        [--prompt 64] [--seed 0]

Zamba2-2.7B (``configs/zamba2_2p7b``) at ``--depth`` Mamba2 layers (54, the
full depth, by default) with its widths divided by ``--width`` (1, the full
width, by default: d_model, the attention heads, d_ff and the shared
block's d_ff are divided; the head dims, the state dim N and the vocab are
kept), batch 1, prompt ``--prompt`` tokens from ``lm_batch``. The weights
are drawn with numpy from ``--seed`` after the reference's initialisers
(normal / sqrt(fan in); the embedding at 0.02 and the depthwise conv at 0.5;
norms and the skip ones; ``a_log`` log(linspace(1, 16)); biases zero),
handed to the JAX package as its parameter tree and to the port through
``convert.lm_params_from_jax``.

For each package and each dtype (bf16, the model's, and f32) it runs the
prefill of the prompt's first P - 1 tokens, then one decode step with token
P - 1 at position P - 1, against the prefill of all P tokens, and prints the
max abs difference of the two last-position logits, the largest logit, and
whether their argmax agrees. The JAX functions are compiled with XLA's
excess precision off, so bf16 rounds where the reference's code says (as
the port's parity tests compile them), and run on both of the reference's
routes: ``plain`` (``use_pallas=False``: the prefill's SSD is the exact
sequential recurrence, the decode step's own arithmetic) and ``pallas``
(its kernels in interpret mode: the prefill's SSD is chunked, as the
port's is on either device). Last, one JSON line with every number.

A full-width run holds both packages' weights (2.4 G parameters each) in
f32 and bf16; narrower widths scale that by about 1 / width^2.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def shrink(cfg, depth: int, width: int):
    """``cfg`` at ``depth`` layers with its widths divided by ``width``."""
    if any(n % width for n in (cfg.d_model, cfg.n_heads, cfg.d_ff, cfg.hybrid.shared_d_ff)):
        raise SystemExit(f"--width {width} does not divide the model's widths")
    return cfg.replace(
        n_layers=depth, d_model=cfg.d_model // width, n_heads=cfg.n_heads // width,
        n_kv_heads=cfg.n_kv_heads // width, d_ff=cfg.d_ff // width,
        hybrid=type(cfg.hybrid)(attn_every=cfg.hybrid.attn_every,
                                shared_d_ff=cfg.hybrid.shared_d_ff // width))


def numpy_weights(shapes: dict, seed: int) -> dict:
    """A nested dict of f32 numpy arrays for the dotted ``shapes``, drawn
    after the reference's initialisers (stacked layers lead the shape)."""
    rng = np.random.default_rng(seed)
    tree: dict = {}
    for name in sorted(shapes):
        shape = tuple(shapes[name])
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("scale", "d_skip"):
            arr = np.ones(shape, np.float32)
        elif leaf in ("conv_b", "dt_bias", "bias"):
            arr = np.zeros(shape, np.float32)
        elif leaf == "a_log":
            arr = np.broadcast_to(np.log(np.linspace(1.0, 16.0, shape[-1], dtype=np.float32)),
                                  shape).copy()
        else:
            scale = {"table": 0.02, "conv_w": 0.5}.get(leaf, 1.0 / np.sqrt(shape[-2]))
            arr = (rng.standard_normal(shape, dtype=np.float32) * np.float32(scale))
        node = tree
        parts = name.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return tree


def jax_run(jcfg, weights, prompt, use_pallas: bool):
    """(step logits, prefill logits) of the JAX package, last position."""
    import jax
    import jax.numpy as jnp
    from repro.models import family_module
    from repro.serving import ServeConfig, build_prefill, build_serve_step, init_cache

    ref = jax.eval_shape(lambda: family_module(jcfg).init_lm(jax.random.PRNGKey(0), jcfg))
    params = jax.tree_util.tree_map(lambda s, w: jnp.asarray(w, dtype=s.dtype), ref, weights)
    scfg = ServeConfig(batch=1, max_seq=prompt.shape[1] + 8, use_pallas=use_pallas)

    def compile_(fn, *args):
        return jax.jit(fn).lower(*args).compile(
            compiler_options={"xla_allow_excess_precision": False})

    full_tok, head_tok = jnp.asarray(prompt), jnp.asarray(prompt[:, :-1])
    prefill = build_prefill(jcfg, scfg)
    full, _ = compile_(prefill, params, full_tok, init_cache(jcfg, scfg))(
        params, full_tok, init_cache(jcfg, scfg))
    _, caches = compile_(prefill, params, head_tok, init_cache(jcfg, scfg))(
        params, head_tok, init_cache(jcfg, scfg))
    tok, pos = jnp.asarray(prompt[:, -1:]), jnp.int32(prompt.shape[1] - 1)
    step, _ = compile_(build_serve_step(jcfg, scfg), params, tok, pos, caches)(
        params, tok, pos, caches)
    return np.asarray(step[:, -1], np.float32), np.asarray(full[:, -1], np.float32)


def torch_run(cfg, weights, prompt):
    """(step logits, prefill logits) of the port, last position."""
    import torch
    from repro_torch.convert import lm_params_from_jax
    from repro_torch.models import family_module
    from repro_torch.serving import ServeConfig, ServingEngine, init_cache

    params = family_module(cfg).init_lm(cfg, device="cpu")
    params.load_state_dict(lm_params_from_jax(weights, cfg))
    scfg = ServeConfig(batch=1, max_seq=prompt.shape[1] + 8)
    engine = ServingEngine(cfg, params, scfg)
    tokens = torch.from_numpy(prompt)
    with torch.inference_mode():
        full, _ = engine.prefill(params, tokens, init_cache(cfg, scfg, device="cpu"))
        _, caches = engine.prefill(params, tokens[:, :-1], init_cache(cfg, scfg, device="cpu"))
        step, _ = engine.step(params, tokens[:, -1:], prompt.shape[1] - 1, caches)
    return step[:, -1].float().numpy(), full[:, -1].float().numpy()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--depth", type=int, default=54)
    ap.add_argument("--width", type=int, default=1)
    ap.add_argument("--prompt", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    from repro.models import get_config as jget_config
    from repro_torch.convert import _flatten
    from repro_torch.data import LMDataConfig, lm_batch
    from repro_torch.models import family_module, get_config

    results = []
    for dtype in ("bfloat16", "float32"):
        cfg = shrink(get_config("zamba2_2p7b"), args.depth, args.width).replace(dtype=dtype)
        jcfg = shrink(jget_config("zamba2_2p7b"), args.depth, args.width).replace(dtype=dtype)
        meta = family_module(cfg).init_params(cfg, generator=None, device=torch.device("meta"))
        weights = numpy_weights({k: v.shape for k, v in _flatten(meta).items()}, args.seed)
        prompt = lm_batch(LMDataConfig(vocab=cfg.vocab, seq_len=args.prompt, global_batch=1),
                          0)["tokens"]
        for package, route, run in (
                ("jax", "plain", lambda: jax_run(jcfg, weights, prompt, False)),
                ("jax", "pallas", lambda: jax_run(jcfg, weights, prompt, True)),
                ("torch", "chunked", lambda: torch_run(cfg, weights, prompt))):
            step, full = run()
            row = dict(package=package, route=route, dtype=dtype, depth=args.depth,
                       d_model=cfg.d_model,
                       prompt=args.prompt, max_abs_diff=float(np.abs(step - full).max()),
                       max_logit=float(np.abs(full).max()),
                       argmax_agrees=bool(step.argmax(-1)[0] == full.argmax(-1)[0]))
            results.append(row)
            print(f"{package} ({route}) {dtype}: depth {args.depth}, d_model {cfg.d_model}, prompt "
                  f"{args.prompt}: decode step at {args.prompt - 1} vs the prefill's last "
                  f"logits: max abs diff {row['max_abs_diff']!r} (logits up to "
                  f"{row['max_logit']!r}), argmax agrees: {row['argmax_agrees']}", flush=True)
    print(json.dumps({"step_vs_prefill": results}), flush=True)


if __name__ == "__main__":
    main()
