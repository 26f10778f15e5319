"""The port's dry run (``repro_torch.launch.dryrun``) and its per-device
cost analysis (``launch.hlo_analysis``) on the CPU, against the JAX
package: the analyzer cases of ``tests/test_distributed.py`` (a loop of
products, folded and unrolled, one device and a quarter of it on each of
four; an all-reduce's operand bytes), the dry run's helpers at full width
on both production meshes, four small cells held against the reference's
own compiled analysis, and the models' sharding hints (wired where the
reference calls them, no-ops without a mesh). Every architecture's smoke
config on the production meshes is in ``test_torch_dryrun_meshes.py``.

Every process group here is a fake one (``torch.testing``'s ``FakeStore``),
started and destroyed by the test that uses it. The JAX package is imported
by the ``ref`` fixture, which skips where JAX is missing (the card's
machine), so the port's own cases run there too.
"""
import functools
import json
import os
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import loops
from repro_torch import tree as T
from repro_torch.distributed import sharding as S
from repro_torch.launch import dryrun, hlo_analysis
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models import (
    ARCH_IDS,
    SHAPES_BY_NAME,
    family_module,
    get_config,
    get_smoke_config,
    shapes_for,
)
from repro_torch.models import hybrid, mamba, transformer, whisper
from repro_torch.models import layers as L
from repro_torch.models.config import ShapeConfig
from repro_torch.serving import ServeConfig, init_cache
from repro_torch.training import init_state

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
MESHES = {"pod": {"data": 16, "model": 16}, "multipod": {"pod": 2, "data": 16, "model": 16}}


def _jmesh(axes):
    """The reference's helpers read only ``axis_names`` and
    ``devices.shape``."""
    return types.SimpleNamespace(axis_names=tuple(axes),
                                 devices=np.empty(tuple(axes.values()), dtype=object))


def _padded(spec, rank):
    spec = tuple(spec)
    return spec + (None,) * (rank - len(spec))


@pytest.fixture(scope="module")
def ref():
    """The JAX package's pieces these tests hold the port against."""
    jax = pytest.importorskip("jax")
    from repro.models import get_config
    from repro.models.config import SHAPES_BY_NAME
    from repro.serving import ServeConfig, init_cache

    # The reference's dry run forces 512 host devices through XLA_FLAGS when
    # it is imported; this worker keeps its own setting.
    flags = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun
    if flags is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = flags
    return types.SimpleNamespace(jax=jax, dryrun=dryrun, get_config=get_config,
                                 SHAPES_BY_NAME=SHAPES_BY_NAME, ServeConfig=ServeConfig,
                                 init_cache=init_cache)


@pytest.fixture
def group():
    """Start a fake default process group of ``n`` ranks (rank 0) on
    demand; destroyed at the end of the test."""
    started = []

    def start(n):
        dryrun.fake_group(n)
        started.append(n)

    yield start
    if started:
        dist.destroy_process_group()


# --------------------------------------------------------------------------
# The analyzer: the cases of tests/test_distributed.py
# --------------------------------------------------------------------------

D = 64
LOOP_FLOPS = 4 * 2 * 8 * D * D


def _folded(x, w):
    for i in loops.trips(4):
        x = x @ w[i]
    return x


def _unrolled(x, w):
    for i in range(4):
        x = x @ w[i]
    return x


@pytest.mark.parametrize("fn", [_folded, _unrolled], ids=["folded", "unrolled"])
def test_analyzer_counts_a_loop_of_products(fn):
    x, w = torch.ones(8, D), torch.ones(4, D, D)
    cost = hlo_analysis.analyze(fn, x, w)
    assert abs(cost.flops - LOOP_FLOPS) / LOOP_FLOPS < 0.05
    assert cost.unknown_trip_loops == 0 and cost.collectives == {}


@pytest.mark.parametrize("fn", [_folded, _unrolled], ids=["folded", "unrolled"])
def test_analyzer_counts_one_device_of_four(group, fn):
    """x sharded on rows over a fake group of 4: each device does a
    quarter of the products, on its first call too (DTensor's sharding
    propagation runs the op once at the global shape; that is not
    counted)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    group(4)
    mesh = make_mesh((4,), ("data",), device_type="cpu")
    x = distribute_tensor(torch.ones(8, D), mesh, [Shard(0)], src_data_rank=None)
    w = distribute_tensor(torch.ones(4, D, D), mesh, [Replicate()], src_data_rank=None)
    for _ in range(2):
        cost = hlo_analysis.analyze(fn, x, w)
        assert abs(cost.flops - LOOP_FLOPS / 4) / (LOOP_FLOPS / 4) < 0.05


def test_analyzer_counts_an_all_reduce(group):
    """x (8, 64) sharded on columns over 4: x x^T is a partial sum of an
    8 x 8 f32 result on each device, whose all-reduce moves 256 bytes."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    group(4)
    mesh = make_mesh((4,), ("data",), device_type="cpu")
    x = distribute_tensor(torch.ones(8, 64), mesh, [Shard(1)], src_data_rank=None)

    def f(a):
        return (a @ a.T).redistribute(mesh, [Replicate()])

    assert hlo_analysis.analyze(f, x).collectives.get("all-reduce", 0) == 8 * 8 * 4
    assert hlo_analysis.collective_bytes(f, x) == {"all-reduce": 256}


def test_folded_backward_runs_under_its_multiplier():
    """A folded loop's autograd nodes carry its multiplier into the
    backward: within 5% of running every trip (the gradient's adds across
    trips are the difference)."""
    w = torch.ones(D, D, requires_grad=True)

    def step(trips):
        ys = [torch.tanh(torch.ones(8, D) @ w) for _ in trips(4)]
        torch.autograd.grad(loops.stacked(ys, 4, 0).sum(), [w])

    folded = hlo_analysis.analyze(step, loops.trips).flops
    every = hlo_analysis.analyze(step, range).flops
    assert abs(folded - every) / every < 0.05


def test_one_counter_at_a_time():
    with hlo_analysis.Counter():
        with pytest.raises(RuntimeError, match="another"):
            hlo_analysis.Counter().__enter__()


# --------------------------------------------------------------------------
# The helpers equal the reference's
# --------------------------------------------------------------------------

def test_pick_microbatches_equals_reference(ref):
    for B in (1, 8, 32, 128, 256, 512):
        for S in (64, 4096, 32768):
            for dp in (1, 2, 16, 32):
                assert dryrun.pick_microbatches(B, S, dp) == ref.dryrun.pick_microbatches(B, S, dp)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_and_specs_equal_reference(ref, arch, mesh):
    """At full width on both production meshes, for every shape:
    ``_arch_for_mesh``, ``train_config``, ``input_specs``,
    ``serve_cache_specs`` (leaf by leaf, padded to the leaf's rank) and
    ``logits_spec`` are the reference's. No device is needed: both read the
    mesh's axis sizes, and the caches are fake tensors / abstract values."""
    jax, jdryrun = ref.jax, ref.dryrun
    axes = MESHES[mesh]
    jm = _jmesh(axes)
    cfg = dryrun._arch_for_mesh(get_config(arch), axes)
    jcfg = jdryrun._arch_for_mesh(ref.get_config(arch), jm)
    assert (cfg.moe is None) == (jcfg.moe is None)
    if cfg.moe is not None:
        assert cfg.moe.dispatch_groups == jcfg.moe.dispatch_groups
    for shape in shapes_for(cfg):
        jshape = ref.SHAPES_BY_NAME[shape.name]
        if shape.kind == "train":
            t, jt = dryrun.train_config(cfg, shape, axes), jdryrun.train_config(jcfg, jshape, jm)
            assert (t.microbatches, t.remat, t.loss_chunk, t.use_pallas) == \
                (jt.microbatches, jt.remat, jt.loss_chunk, jt.use_pallas)
            assert t.adamw.quantize_state == jt.adamw.quantize_state
        ins, jins = dryrun.input_specs(cfg, shape), jdryrun.input_specs(jcfg, jshape)
        assert sorted(ins) == sorted(jins)
        for k in ins:
            assert tuple(ins[k].shape) == tuple(jins[k].shape), k
            assert str(ins[k].dtype).split(".")[-1] == str(jins[k].dtype), k
        assert tuple(dryrun.logits_spec(cfg, shape.global_batch, axes)) == \
            tuple(jdryrun.logits_spec(jcfg, shape.global_batch, jm))
        if shape.kind == "train":
            continue
        with FakeTensorMode():
            caches = init_cache(cfg, ServeConfig(shape.global_batch, shape.seq_len), device=CPU)
        jcaches = jax.eval_shape(functools.partial(
            ref.init_cache, jcfg, ref.ServeConfig(shape.global_batch, shape.seq_len)))
        specs = T.leaves(dryrun.serve_cache_specs(cfg, shape, axes, caches), is_leaf=S._is_spec)
        jspecs = jax.tree_util.tree_leaves(
            jdryrun.serve_cache_specs(jcfg, jshape, jm, jcaches),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        leaves = T.leaves(caches)
        assert len(specs) == len(jspecs) == len(leaves)
        for spec, jspec, leaf in zip(specs, jspecs, leaves):
            assert _padded(spec, leaf.dim()) == _padded(jspec, leaf.dim()), (shape.name, spec)


# --------------------------------------------------------------------------
# Four small cells against the reference's own analysis
# --------------------------------------------------------------------------

SMALL = [("stablelm_3b", "train"), ("stablelm_3b", "decode"), ("mamba2_130m", "prefill"),
         ("deepseek_v2_lite_16b", "train")]

# The reference compiles each cell on 4 forced host devices, on a (2, 2)
# mesh of Auto axes (jax.make_mesh's default, Explicit axes, turns its
# sharding hints into asserts), and reads XLA's memory analysis and its own
# HLO analysis.
_REFERENCE = textwrap.dedent("""
    import json, os
    from repro.launch import dryrun as D
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    from jax.sharding import AxisType
    from repro.launch import hlo_analysis
    from repro.models import get_smoke_config
    from repro.models.config import ShapeConfig

    mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    out = {}
    for arch, kind in %r:
        cfg = D._arch_for_mesh(get_smoke_config(arch), mesh)
        with jax.sharding.set_mesh(mesh):
            build = D.build_train_cell if kind == "train" else D.build_serve_cell
            fn, args, in_sh, out_sh = build(cfg, ShapeConfig("small", 64, 8, kind), mesh)
            compiled = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh).lower(*args).compile()
        ma = compiled.memory_analysis()
        out[arch + "/" + kind] = {"argument_bytes": ma.argument_size_in_bytes,
                                  "output_bytes": ma.output_size_in_bytes,
                                  "flops": hlo_analysis.analyze(compiled.as_text()).flops}
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def reference_cells(ref):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", _REFERENCE % (SMALL,)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


# Per-device FLOPs within these fractions of the reference's. Products
# (dot, convolution) count exactly alike in both analyses; the elementwise
# ops do not, because an aten op and XLA's HLO decompose differently (the
# port's softplus ``logaddexp``, softmax and logsumexp are one op each and
# count no or one FLOP an element; the HLO spells them as several
# elementwise ops, and fuses nothing away from the count). At these smoke
# widths elementwise work is a large share: the most in Mamba2's prefill,
# whose sequential SSD recurrence and gating are elementwise (the port
# counts 11.9% fewer there), a few percent elsewhere.
FLOP_TOL = {"stablelm_3b/train": 0.05, "stablelm_3b/decode": 0.05,
            "mamba2_130m/prefill": 0.15, "deepseek_v2_lite_16b/train": 0.05}


def test_small_cells_match_the_reference_analysis(group, reference_cells):
    group(4)
    mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
    for arch, kind in SMALL:
        key = f"{arch}/{kind}"
        cfg = dryrun._arch_for_mesh(get_smoke_config(arch), mesh)
        shape = ShapeConfig("small", 64, 8, kind)
        rec = dryrun.trace_cell(cfg, shape, mesh, CPU)
        ref = reference_cells[key]
        assert set(rec) >= {"lower_s", "compile_s", "memory", "xla_cost", "hlo"}
        assert set(rec["memory"]) == {"argument_bytes", "output_bytes", "temp_bytes",
                                      "generated_code_bytes"}
        assert set(rec["hlo"]) >= {"flops_per_device", "bytes_per_device",
                                   "collective_bytes_per_device", "unknown_trip_loops",
                                   "hlo_chars"}
        assert rec["hlo"]["unknown_trip_loops"] == 0 and rec["memory"]["temp_bytes"] > 0

        # Argument bytes, leaf for leaf, but for two named differences: a
        # decode step's cache_index is a host int in the port (a 4-byte
        # scalar in the reference), and the reference's SSM prefill ignores
        # its caches argument, which jit prunes (the port writes the
        # prompt's states into them).
        args = rec["memory"]["argument_bytes"]
        if kind == "decode":
            args += 4
        with FakeTensorMode():
            if key == "mamba2_130m/prefill":
                caches = init_cache(cfg, ServeConfig(8, 64), device=CPU)
                args -= dryrun._local_bytes(dryrun._lay_out(
                    mesh, caches, dryrun.serve_cache_specs(cfg, shape, mesh, caches)))
            # XLA's output size includes the output tuple's table, 8 bytes
            # a leaf: a serve step's (logits, caches), a train step's
            # (state, {loss, lr, grad_norm})
            if kind == "train":
                state = init_state(0, cfg, dryrun.train_config(cfg, shape, mesh), device=CPU)
                n_out = len(T.leaves(state)) + 3
            else:
                n_out = 1 + len(T.leaves(init_cache(cfg, ServeConfig(8, 64), device=CPU)))
        assert args == ref["argument_bytes"], key
        assert rec["memory"]["output_bytes"] + 8 * n_out == ref["output_bytes"], key

        flops = rec["hlo"]["flops_per_device"]
        assert abs(flops - ref["flops"]) / ref["flops"] < FLOP_TOL[key], (key, flops, ref["flops"])


def test_run_cell_refuses_a_running_group_and_cuda_without_a_card(group, tmp_path):
    group(4)
    with pytest.raises(RuntimeError, match="process group"):
        dryrun.run_cell("stablelm_3b", "decode_32k", "pod", save=False, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            dryrun.run_cell("stablelm_3b", "decode_32k", "pod", save=False)


# --------------------------------------------------------------------------
# The sharding hints
# --------------------------------------------------------------------------

HINTED = [("stablelm_3b", transformer), ("mamba2_130m", mamba),
          ("deepseek_v2_lite_16b", transformer)]


@pytest.mark.parametrize("arch,mod", HINTED, ids=[a for a, _ in HINTED])
def test_hints_lay_out_the_forward(group, monkeypatch, arch, mod):
    """Under ``set_mesh`` on a (16, 16) fake mesh: the embedding's output
    comes out of ``activation_constraint`` batch-sharded over data
    (``Shard(0)``, whole over model), and ``fsdp_unshard`` hands each
    layer its weights in the TP-only layout (``_leaf_spec`` with no data
    axis: never sharded over data, the 2D products' over model)."""
    from torch.distributed.tensor import Replicate, Shard

    group(256)
    mesh = make_production_mesh(device_type="cpu")
    axes = S.mesh_axes(mesh)
    embedded, layers = [], []
    act, unshard = mod.activation_constraint, mod.fsdp_unshard

    def record_act(x, *a, **k):
        out = act(x, *a, **k)
        embedded.append(out.placements)
        return out

    def record_unshard(p):
        out = unshard(p)
        if "norm" in p or "norm1" in p:
            layers.append(T.flatten_with_paths(out))
        return out

    monkeypatch.setattr(mod, "activation_constraint", record_act)
    monkeypatch.setattr(mod, "fsdp_unshard", record_unshard)
    cfg = dryrun._arch_for_mesh(get_smoke_config(arch), mesh)
    dryrun.trace_cell(cfg, ShapeConfig("small", 16, 32, "prefill"), mesh, CPU)
    assert embedded and embedded[0] == (Shard(0), Replicate())
    assert len(layers) == cfg.n_layers
    for leaves in layers:
        model_sharded = 0
        for name, leaf in leaves:
            want = S.placements(mesh, S._leaf_spec(S._path_names(name), tuple(leaf.shape), axes,
                                                   None, "model")) if leaf.dim() >= 2 else None
            if want is not None:
                assert leaf.placements == want, name
            assert leaf.placements[0] == Replicate(), name     # never over data
            model_sharded += leaf.placements[1] != Replicate()
        assert model_sharded > 0


def _identity_hints(monkeypatch):
    """Every hint replaced by the identity in the modules that call it."""
    same = lambda x, *a, **k: x  # noqa: E731
    for mod in (transformer, mamba, hybrid, whisper):
        monkeypatch.setattr(mod, "activation_constraint", same)
        monkeypatch.setattr(mod, "fsdp_unshard", same)
    for name in ("activation_constraint", "constrain", "shard_attention_q"):
        monkeypatch.setattr(L, name, same)
    monkeypatch.setattr(L, "group_local", lambda fn, *a, **k: fn(*a))
    monkeypatch.setattr(L, "write_slice", lambda *a: False)


@pytest.mark.parametrize("arch", ["stablelm_3b", "deepseek_v2_lite_16b", "mamba2_130m",
                                  "zamba2_2p7b", "whisper_base"])
def test_without_a_mesh_the_hints_change_nothing(monkeypatch, arch):
    """On one device the hinted forward and a cached decode step are bit
    for bit the forward with every hint taken out."""
    cfg = get_smoke_config(arch)
    mod = family_module(cfg)
    gen = torch.Generator().manual_seed(0)
    params = mod.init_params(cfg, generator=gen, device=CPU)
    tokens = torch.randint(0, cfg.vocab, (2, 16), generator=gen, dtype=torch.int32)

    def run():
        if cfg.family == "audio":
            frames = torch.ones(2, 24, cfg.d_model, dtype=L.model_dtype(cfg))
            return (mod.forward(params, tokens, frames, cfg, use_pallas=False),)
        caches = init_cache(cfg, ServeConfig(2, 24, use_pallas=False), device=CPU)
        logits, caches = dryrun.build_prefill(cfg, ServeConfig(2, 24, use_pallas=False))(
            params, tokens, caches)
        step, _ = dryrun.build_serve_step(cfg, ServeConfig(2, 24, use_pallas=False))(
            params, tokens[:, :1], 16, caches)
        return mod.forward(params, tokens, cfg, use_pallas=False), logits, step

    hinted = run()
    _identity_hints(monkeypatch)
    plain = run()
    for a, b in zip(hinted, plain):
        assert torch.equal(a, b)
