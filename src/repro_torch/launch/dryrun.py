"""Multi-pod dry run: trace every (architecture x input-shape) cell on the
production meshes and record per-device memory, FLOPs, bytes and
collective bytes. A port of ``repro/launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --device cpu
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch stablelm_3b --shape train_4k --mesh pod

The reference lowers and compiles each cell with GSPMD over 512 placeholder
CPU devices. Here a cell runs once, eagerly, on DTensors over the (16, 16)
or (2, 16, 16) production mesh: ``run_cell`` starts a fake default process
group of the mesh's size (rank 0) for the cell's duration, builds the
train state or the serving params and caches at full width as fake tensors
(``FakeTensorMode``: shapes, no memory), lays each leaf out by the sharding
rules (``param_specs`` and the cell's specs), and runs the train step or
the serve step under ``set_mesh`` (so the models' sharding hints act) and
``implicit_replication`` (the models make plain tensors: positions, rope
tables). ``launch.hlo_analysis`` counts what rank 0 does. The models run
the reference's plain route (``use_pallas=False``, as its cells do), so no
kernel is launched; the fake tensors are on the mesh's device (``--device``:
the card, or ``cpu``), which must exist.

A record has the reference's keys. ``memory``: ``argument_bytes`` and
``output_bytes`` are the local bytes of rank 0's inputs and outputs (the
port updates the state and caches in place, so its outputs are its inputs'
tensors, counted again as the reference counts its new buffers; a decode
cell's ``cache_index`` is a host int, which the reference passes as a
4-byte scalar), ``temp_bytes`` the peak of rank 0's live intermediates.
``hlo`` holds ``hlo_analysis``'s per-device counts. Keys with no
counterpart are null: ``compile_s`` (nothing compiles: ``lower_s`` is the
time to build and lay out the cell's inputs, ``trace_s`` the counted call),
``memory.generated_code_bytes`` (no code is generated), ``xla_cost`` (no
compiler's cost analysis runs) and ``hlo.hlo_chars`` (no HLO text exists;
``hlo.ops`` counts the dispatched ops instead). Records go to
``results/dryrun_torch/{arch}__{shape}__{mesh}.json``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Dict

import numpy as np
import torch

from .. import tree as T
from ..device import resolve_device
from ..distributed.sharding import (
    P,
    batch_spec,
    greedy_spec,
    mesh_axes,
    param_specs,
    placements,
    set_mesh,
)
from ..models import ARCH_IDS, SHAPES_BY_NAME, family_module, get_config, param_count, shapes_for
from ..models.config import ArchConfig, ShapeConfig
from ..serving import ServeConfig, build_prefill, build_serve_step, init_cache
from ..training import AdamWConfig, TrainConfig, build_train_step, init_state
from . import hlo_analysis
from .mesh import make_production_mesh

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "results",
                           "dryrun_torch")


# --------------------------------------------------------------------------
# per-cell configuration
# --------------------------------------------------------------------------

def _dp_degree(mesh) -> int:
    axes = mesh_axes(mesh)
    return axes.get("data", 1) * axes.get("pod", 1)


def pick_microbatches(B: int, S: int, dp: int, target_tokens: int = 4096) -> int:
    """Smallest microbatch count whose per-device-per-microbatch token count
    is <= target, with (B/mb) still divisible by the DP degree."""
    tokens_per_dev = B * S // dp
    cands = [m for m in range(1, B + 1) if B % m == 0 and (B // m) % dp == 0]
    for m in sorted(cands):
        if tokens_per_dev // m <= target_tokens:
            return m
    return max(cands) if cands else 1


def train_config(cfg: ArchConfig, shape: ShapeConfig, mesh) -> TrainConfig:
    dp = _dp_degree(mesh)
    mb = pick_microbatches(shape.global_batch, shape.seq_len, dp)
    quant = param_count(cfg) > 2e11      # 8-bit moments for the 480B arch
    return TrainConfig(
        adamw=AdamWConfig(quantize_state=quant),
        microbatches=mb,
        remat=True,
        loss_chunk=512,
    )


def _arch_for_mesh(cfg: ArchConfig, mesh) -> ArchConfig:
    """Align MoE dispatch groups with the DP degree of the target mesh."""
    if cfg.moe is not None:
        dp = _dp_degree(mesh)
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, dispatch_groups=dp))
    return cfg


# --------------------------------------------------------------------------
# input specs (meta-tensor stand-ins: shape and dtype, no memory)
# --------------------------------------------------------------------------

def sds(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Model-input stand-ins for one cell (tokens/labels for training, the
    request batch + caches for serving)."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        out = {"tokens": sds((B, S), torch.int32), "labels": sds((B, S), torch.int32)}
        if cfg.family == "audio":
            out["frames"] = sds((B, cfg.encdec.encoder_seq, cfg.d_model), torch.bfloat16)
        return out
    if shape.kind == "prefill":
        out = {"tokens": sds((B, S), torch.int32)}
        if cfg.family == "audio":
            out["enc_out"] = sds((B, cfg.encdec.encoder_seq, cfg.d_model), torch.bfloat16)
        return out
    # decode: one new token against a cache of S
    out = {"tokens": sds((B, 1), torch.int32), "cache_index": sds((), torch.int32)}
    if cfg.family == "audio":
        out["enc_out"] = sds((B, cfg.encdec.encoder_seq, cfg.d_model), torch.bfloat16)
    return out


def _dp_name(axes: dict):
    return ("pod", "data") if "pod" in axes else "data"


def serve_cache_specs(cfg: ArchConfig, shape: ShapeConfig, mesh, cache_shapes):
    """PartitionSpecs for the family-specific cache tree."""
    dp = _dp_name(mesh_axes(mesh))

    if cfg.family == "ssm":
        ssm_s, conv_s = cache_shapes
        return (
            greedy_spec(ssm_s.shape, mesh, [(1, dp), (2, "model"), (3, "model")]),
            greedy_spec(conv_s.shape, mesh, [(1, dp), (3, "model")]),
        )
    if cfg.family == "hybrid":
        ssm_s, conv_s, (k_s, v_s) = cache_shapes
        kv = greedy_spec(
            k_s.shape, mesh, [(1, dp), (2, "model"), (3, "data"), (4, "model")]
        )
        return (
            greedy_spec(ssm_s.shape, mesh, [(2, dp), (3, "model"), (4, "model")]),
            greedy_spec(conv_s.shape, mesh, [(2, dp), (4, "model")]),
            (kv, kv),
        )
    if cfg.mla is not None:
        lat = cache_shapes
        return greedy_spec(lat.shape, mesh, [(1, dp), (2, "model")])
    # GQA / MQA / audio: (L, B, Hkv, S, dh)
    k_s, v_s = cache_shapes
    kv = greedy_spec(
        k_s.shape, mesh, [(1, dp), (2, "model"), (3, "data"), (4, "model")]
    )
    return (kv, kv)


def _dp_size(axes: dict) -> int:
    dp = _dp_name(axes)
    return int(np.prod([axes[a] for a in (dp if isinstance(dp, tuple) else (dp,))]))


def logits_spec(cfg: ArchConfig, B: int, mesh):
    axes = mesh_axes(mesh)
    dp = _dp_name(axes)
    b_ax = dp if B % _dp_size(axes) == 0 else None
    v_ax = "model" if cfg.vocab % axes["model"] == 0 else None
    return P(b_ax, None, v_ax)


# --------------------------------------------------------------------------
# cell builders: (fn, args); run inside FakeTensorMode
# --------------------------------------------------------------------------

def _is_spec(x) -> bool:
    return isinstance(x, P)


def _lay_out(mesh, tree, specs):
    """Each tensor leaf of ``tree`` as a DTensor laid out by its spec (each
    rank keeping its own shard); other leaves as they are."""
    from torch.distributed.tensor import distribute_tensor

    leaves = T.leaves(tree)
    spec_leaves = T.leaves(specs, is_leaf=_is_spec)
    out = [distribute_tensor(x, mesh, placements(mesh, s), src_data_rank=None)
           if isinstance(x, torch.Tensor) else x for x, s in zip(leaves, spec_leaves)]
    return T.unflatten(tree, out)


def build_train_cell(cfg: ArchConfig, shape: ShapeConfig, mesh, device):
    tcfg = train_config(cfg, shape, mesh)
    step_fn = build_train_step(cfg, tcfg)
    state = init_state(0, cfg, tcfg, device=device)
    state = _lay_out(mesh, state, param_specs(state, mesh))
    bspec = batch_spec(shape, mesh)
    batch = {}
    for k, v in input_specs(cfg, shape).items():
        spec = bspec if v.dim() == 2 else P(bspec[0], None, None)
        batch[k] = _lay_out(mesh, torch.zeros(v.shape, dtype=v.dtype, device=device), spec)
    return step_fn, (state, batch)


def build_serve_cell(cfg: ArchConfig, shape: ShapeConfig, mesh, device):
    B, S = shape.global_batch, shape.seq_len
    scfg = ServeConfig(batch=B, max_seq=S, use_pallas=False)
    mod = family_module(cfg)
    params = mod.init_params(cfg, generator=None, device=device)
    params = _lay_out(mesh, params, param_specs(params, mesh))
    caches = init_cache(cfg, scfg, device=device)
    caches = _lay_out(mesh, caches, serve_cache_specs(cfg, shape, mesh, caches))

    ins = input_specs(cfg, shape)
    axes = mesh_axes(mesh)
    dp = _dp_name(axes) if B % _dp_size(axes) == 0 else None
    tokens = _lay_out(mesh, torch.zeros(ins["tokens"].shape, dtype=torch.int32, device=device),
                      P(dp, None))
    args = [params, tokens, caches]
    if cfg.family == "audio":
        enc = ins["enc_out"]
        args.append(_lay_out(mesh, torch.zeros(enc.shape, dtype=enc.dtype, device=device),
                             P(dp, None, None)))

    if shape.kind == "prefill":
        run = build_prefill(cfg, scfg)
        index = ()
    else:
        # the traced index of the reference: attention reads the whole cache
        run = build_serve_step(cfg, scfg)
        index = (S - 1,)

    def fn(params, tokens, caches, *enc_out):
        extra = (mod.cross_kv(params, enc_out[0], cfg),) if enc_out else ()
        return run(params, tokens, *index, caches, *extra)

    return fn, tuple(args)


# --------------------------------------------------------------------------
# run one cell
# --------------------------------------------------------------------------

def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor

    total = 0
    for x in T.leaves(tree):
        if isinstance(x, DTensor):
            x = x.to_local()
        if isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
    return total


def fake_group(world: int):
    """A fake default process group of ``world`` ranks, this one rank 0."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("run_cell starts a default process group of its own; another is "
                           "running")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


@contextlib.contextmanager
def _gspmd_like():
    """GSPMD reshapes a dimension whatever its sharding (an uneven one is
    padded). DTensor's ``view`` refuses one whose sharding it cannot keep
    (Mamba2's 24 heads over a model axis of 16, Whisper's 8 kv heads), and
    merges two sharded dimensions into a strided shard, whose
    redistributions DTensor plans by a search over every layout of the
    mesh (hours inside one op on the (2, 16, 16) mesh). For the cell's
    duration ``view`` follows ``reshape``'s rule, which redistributes
    first. The merges that matter, batch with heads in attention and the
    SSD recurrence, do not happen: those run on each rank's batch and heads
    (``sharding.heads_local``, ``batch_heads_local``)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._ops import _view_ops

    aten = torch.ops.aten
    prop = DTensor._op_dispatcher.sharding_propagator
    ops = [op for op in (aten.view.default, aten._unsafe_view.default)
           if op in prop.op_strategy_funcs]
    saved = [(op, prop.op_strategy_funcs[op], prop.op_to_schema_info.get(op)) for op in ops]
    for op in ops:
        _view_ops.register_op_strategy_map(op, torch.Tensor.view,
                                           schema_info=_view_ops.RuntimeSchemaInfo(1))
    prop.propagate_op_sharding.cache_clear()
    try:
        yield
    finally:
        for op, func, info in saved:
            prop.op_strategy_funcs[op] = func
            if info is not None:
                prop.op_to_schema_info[op] = info
        prop.propagate_op_sharding.cache_clear()


def trace_cell(cfg: ArchConfig, shape: ShapeConfig, mesh, device) -> Dict[str, Any]:
    """Build one cell on ``mesh`` (over the default process group, which
    the caller started) and count rank 0's share of it: the record's
    ``lower_s``, ``compile_s``, ``trace_s``, ``memory``, ``xla_cost`` and
    ``hlo``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication

    rec: Dict[str, Any] = {}
    t0 = time.time()
    with FakeTensorMode(), set_mesh(mesh), implicit_replication(), _gspmd_like():
        if shape.kind == "train":
            fn, args = build_train_cell(cfg, shape, mesh, device)
        else:
            fn, args = build_serve_cell(cfg, shape, mesh, device)
        rec["lower_s"] = time.time() - t0
        rec["compile_s"] = None
        t1 = time.time()
        with hlo_analysis.Counter() as counter:
            out = fn(*args)
        rec["trace_s"] = time.time() - t1
        rec["memory"] = {
            "argument_bytes": _local_bytes(args),
            "output_bytes": _local_bytes(out),
            "temp_bytes": counter.peak_bytes,
            "generated_code_bytes": None,
        }
    rec["xla_cost"] = None
    hc = counter.cost()
    rec["hlo"] = {
        "flops_per_device": hc.flops,
        "bytes_per_device": hc.bytes,
        "collective_bytes_per_device": hc.collectives,
        "unknown_trip_loops": hc.unknown_trip_loops,
        "hlo_chars": None,
        "ops": counter.ops,
    }
    return rec


def run_cell(arch: str, shape_name: str, mesh_kind: str, save: bool = True,
             force: bool = False, device: str = "cuda") -> Dict[str, Any]:
    import torch.distributed as dist

    out_path = os.path.join(RESULTS_DIR, f"{arch}__{shape_name}__{mesh_kind}.json")
    if save and not force and os.path.exists(out_path):
        with open(out_path) as f:
            return json.load(f)
    dev = resolve_device(device)

    multi = mesh_kind == "multipod"
    axes = {"pod": 2, "data": 16, "model": 16} if multi else {"data": 16, "model": 16}
    n_chips = int(np.prod(list(axes.values())))
    cfg = _arch_for_mesh(get_config(arch), axes)
    shape = SHAPES_BY_NAME[shape_name]

    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "mesh_shape": list(axes.values()), "chips": n_chips,
        "params": param_count(cfg), "active_params": param_count(cfg, True),
        "status": "ok", "device": dev.type,
    }
    t0 = time.time()
    fake_group(n_chips)
    try:
        mesh = make_production_mesh(multi_pod=multi, device_type=dev.type)
        rec.update(trace_cell(cfg, shape, mesh, dev))
        print(f"[{arch}/{shape_name}/{mesh_kind}] memory:", rec["memory"])
    except Exception as e:
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        print(f"[{arch}/{shape_name}/{mesh_kind}] FAILED: {rec['error']}")
    finally:
        dist.destroy_process_group()
    rec["total_s"] = time.time() - t0

    if save:
        os.makedirs(RESULTS_DIR, exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(rec, f, indent=2)
    return rec


_KIND = {"all-gather": "ag", "all-reduce": "ar", "reduce-scatter": "rs", "all-to-all": "a2a",
         "collective-permute": "cp"}


def table(meshes=("pod", "multipod")) -> str:
    """The saved records as a markdown table: a row per cell, each column
    ``pod / multipod`` (or one mesh's)."""
    def g(x):
        return "-" if x is None else f"{x:.4g}"

    rows = ["| arch | shape | status | total s | FLOPs/dev | bytes/dev | collective bytes/dev "
            "| argument, output, temp bytes/dev |", "|" + " --- |" * 8]
    for arch, shape in all_cells():
        recs = []
        for mk in meshes:
            path = os.path.join(RESULTS_DIR, f"{arch}__{shape}__{mk}.json")
            recs.append(json.load(open(path)) if os.path.exists(path) else {"status": "absent"})

        def col(fn):
            return " / ".join(fn(r) if r["status"] == "ok" else r["status"] for r in recs)

        rows.append("| " + " | ".join([
            arch, shape, " / ".join(r["status"] for r in recs),
            col(lambda r: f"{r['total_s']:.1f}"),
            col(lambda r: g(r["hlo"]["flops_per_device"])),
            col(lambda r: g(r["hlo"]["bytes_per_device"])),
            col(lambda r: ", ".join(f"{_KIND[k]} {g(v)}" for k, v in
                                    sorted(r["hlo"]["collective_bytes_per_device"].items()))),
            col(lambda r: ", ".join(g(r["memory"][k]) for k in
                                    ("argument_bytes", "output_bytes", "temp_bytes"))),
        ]) + " |")
    return "\n".join(rows)


def all_cells():
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in shapes_for(cfg):
            yield arch, shape.name


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--table", action="store_true",
                    help="print the saved records of --mesh as a markdown table")
    ap.add_argument("--device", default="cuda",
                    help="the mesh's device type: cuda (default) or cpu")
    args = ap.parse_args(argv)

    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]
    if args.list:
        for a, s in all_cells():
            print(f"{a} {s}")
        return
    if args.table:
        print(table(meshes))
        return

    cells = list(all_cells()) if args.all else [(args.arch, args.shape)]
    n_ok = n_fail = 0
    for arch, shape in cells:
        for mk in meshes:
            rec = run_cell(arch, shape, mk, force=args.force, device=args.device)
            ok = rec["status"] == "ok"
            n_ok += ok
            n_fail += not ok
            print(f"{'OK  ' if ok else 'FAIL'} {arch:24s} {shape:12s} {mk:8s} "
                  f"trace={rec.get('trace_s') or 0:6.1f}s", flush=True)
    print(f"\n{n_ok} ok, {n_fail} failed")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
