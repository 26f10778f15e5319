"""The port's distribution layer on the CPU, against the JAX package: the
sharding rules (every case of ``tests/test_distributed.py``, then leaf by
leaf for every architecture at full width, params and AdamW state with f32
and int8 moments, on both production meshes; batch and cache specs for
every shape), the DTensor placements of a spec (a tuple axis on a
fake-group mesh of 256), the in-model hints, the collective matmul on
groups of 1, 2 and 4 ranks, the production meshes and ``build_mesh``.

A default process group is global to the process, so each test that starts
one destroys it in its fixture; the multi-rank groups meet at a
``FileStore`` under ``tmp_path`` and are joined with a time limit.
"""
import multiprocessing
import types

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as JP

import torch_dist_worker
from repro.distributed import batch_spec as jbatch_spec
from repro.distributed import param_specs as jparam_specs
from repro.distributed.sharding import _path_names as jpath_names
from repro.distributed.sharding import greedy_spec as jgreedy_spec
from repro.distributed.sharding import kv_cache_spec as jkv_cache_spec
from repro.models import family_module as jfamily_module
from repro.models import get_config as jget_config
from repro.models import get_smoke_config as jsmoke
from repro.runtime import plan_elastic as jplan_elastic
from repro.training import AdamWConfig as JAdamWConfig
from repro.training import TrainConfig as JTrainConfig
from repro.training import init_state as jinit_state
from repro_torch import tree as T
from repro_torch.distributed import NamedSharding, batch_spec, kv_cache_spec, param_specs
from repro_torch.distributed import make_sharding, tree_shardings
from repro_torch.distributed.collective_matmul import psum_matmul, ring_matmul
from repro_torch.distributed.sharding import (
    P,
    activation_constraint,
    constrain,
    distribute,
    fsdp_unshard,
    greedy_spec,
    placements,
    set_mesh,
    shard_attention_q,
)
from repro_torch.launch.mesh import make_host_mesh, make_mesh, make_production_mesh
from repro_torch.models import ARCH_IDS, family_module, get_config, get_smoke_config
from repro_torch.models.config import ALL_SHAPES, SHAPES_BY_NAME
from repro_torch.runtime import build_mesh, plan_elastic
from repro_torch.training import optimizer
from repro_torch.training.optimizer import AdamWConfig

KEY = jax.random.PRNGKey(0)
META = torch.device("meta")
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
# A multi-rank group's processes start, meet and finish within this many
# seconds, or the test fails.
JOIN_TIMEOUT_S = 120


def _jmesh(name="16x16"):
    """The reference's spec rules read only ``axis_names`` and
    ``devices.shape`` (as ``tests/test_distributed.py`` fakes them)."""
    shape, names = MESHES[name]
    return types.SimpleNamespace(axis_names=names, devices=np.empty(shape, dtype=object))


def _axes(name="16x16"):
    shape, names = MESHES[name]
    return dict(zip(names, shape))


def _padded(spec, rank):
    spec = tuple(spec)
    return spec + (None,) * (rank - len(spec))


def _jspec_leaves(specs):
    flat = jax.tree_util.tree_flatten_with_path(specs, is_leaf=lambda x: isinstance(x, JP))[0]
    return [("/".join(jpath_names(p)), s) for p, s in flat]


def _assert_same_specs(ours, ref, shapes):
    """Leaf by leaf: the same paths, and the same spec once both are padded
    with None to the leaf's rank."""
    ours = T.flatten_with_paths(ours, is_leaf=lambda x: isinstance(x, P))
    ref = _jspec_leaves(ref)
    assert [n for n, _ in ours] == [n for n, _ in ref]
    rank = {n: len(leaf.shape) for n, leaf in T.flatten_with_paths(shapes)}
    for (name, a), (_, b) in zip(ours, ref):
        assert _padded(a, rank[name]) == _padded(b, rank[name]), name


def _meta_params(cfg):
    return family_module(cfg).init_params(cfg, generator=None, device=META)


# --------------------------------------------------------------------------
# The rules: the cases of tests/test_distributed.py
# --------------------------------------------------------------------------

def test_param_specs_2d_fsdp_tp():
    kw = dict(d_model=256, n_heads=16, n_kv_heads=16, head_dim=16, d_ff=512, vocab=4096)
    cfg = get_smoke_config("stablelm_3b").replace(**kw)
    specs = param_specs(_meta_params(cfg), _axes())
    # stacked layers: leading None then (data, model) for up-proj
    assert specs["layers"]["attn"]["wq"] == P(None, "data", "model")
    assert specs["layers"]["attn"]["wo"] == P(None, "model", "data")
    assert specs["layers"]["mlp"]["wd"] == P(None, "model", "data")
    assert specs["embed"]["table"] == P("model", "data")
    assert specs["head"]["w"] == P("data", "model")
    assert specs["final_norm"]["scale"] == P(None)
    jcfg = jsmoke("stablelm_3b").replace(**kw)
    jshapes = jax.eval_shape(lambda: jfamily_module(jcfg).init_lm(KEY, jcfg))
    _assert_same_specs(specs, jparam_specs(jshapes, _jmesh()), _meta_params(cfg))


def test_param_specs_divisibility_fallback():
    cfg = get_smoke_config("stablelm_3b")  # tiny dims not divisible by 16
    specs = param_specs(_meta_params(cfg), _axes())
    assert all(ax in (None, "data", "model") for ax in specs["layers"]["attn"]["wq"])
    jcfg = jsmoke("stablelm_3b")
    jshapes = jax.eval_shape(lambda: jfamily_module(jcfg).init_lm(KEY, jcfg))
    _assert_same_specs(specs, jparam_specs(jshapes, _jmesh()), _meta_params(cfg))


def test_moe_expert_specs():
    import dataclasses

    cfg = get_smoke_config("arctic_480b").replace(d_model=256, d_ff=512)
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, num_experts=32, d_ff_expert=512))
    specs = param_specs(_meta_params(cfg), _axes())
    assert specs["layers"]["moe"]["wg"] == P(None, "model", "data", None)
    assert specs["layers"]["moe"]["wd"] == P(None, "model", None, "data")
    jcfg = jsmoke("arctic_480b").replace(d_model=256, d_ff=512)
    jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe, num_experts=32, d_ff_expert=512))
    jshapes = jax.eval_shape(lambda: jfamily_module(jcfg).init_lm(KEY, jcfg))
    _assert_same_specs(specs, jparam_specs(jshapes, _jmesh()), _meta_params(cfg))


def test_batch_spec_modes():
    assert batch_spec(SHAPES_BY_NAME["train_4k"], _axes()) == P("data", None)
    # long_500k: batch=1 -> sequence parallelism
    assert batch_spec(SHAPES_BY_NAME["long_500k"], _axes()) == P(None, "data")


def test_greedy_spec():
    s = greedy_spec((24, 128, 80, 64, 64), _axes(), [(1, "data"), (2, "model"), (3, "model")])
    assert s == P(None, "data", "model", None, None)
    s2 = greedy_spec((4, 2, 7, 13), _axes(), [(2, "data"), (3, "model")])
    assert s2 == P(None, None, None, None)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("shape,priorities", [
    ((24, 128, 80, 64, 64), [(1, "data"), (2, "model"), (3, "model")]),
    ((4, 2, 7, 13), [(2, "data"), (3, "model")]),
    ((2, 32, 48, 16), [(1, "pod"), (1, "data"), (3, "model"), (0, "pod"), (9, "data")]),
])
def test_greedy_spec_equals_reference(mesh, shape, priorities):
    ours = greedy_spec(shape, _axes(mesh), priorities)
    assert ours == tuple(jgreedy_spec(shape, _jmesh(mesh), priorities))


# --------------------------------------------------------------------------
# The rules at full width, leaf by leaf
# --------------------------------------------------------------------------

def _port_state(cfg, quantize):
    params = _meta_params(cfg)
    return {"params": params, "opt": optimizer.init(params, AdamWConfig(quantize_state=quantize)),
            "step": torch.zeros((), dtype=torch.int32, device=META)}


@pytest.mark.parametrize("quantize", [False, True], ids=["f32_moments", "int8_moments"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_reference_at_full_width(arch, quantize):
    """Every leaf of the full-width params and AdamW state (the reference's
    shapes from ``jax.eval_shape``, the port's on the meta device) on the
    (16, 16) and (2, 16, 16) production meshes."""
    jcfg = jget_config(arch)
    jstate = jax.eval_shape(lambda: jinit_state(
        KEY, jcfg, JTrainConfig(adamw=JAdamWConfig(quantize_state=quantize))))
    state = _port_state(get_config(arch), quantize)
    if quantize:
        assert any(n.endswith("/1") for n, _ in T.flatten_with_paths(state["opt"]))
    for mesh in MESHES:
        _assert_same_specs(param_specs(state, _axes(mesh)), jparam_specs(jstate, _jmesh(mesh)),
                           state)
        _assert_same_specs(param_specs(state["params"], _axes(mesh), fsdp_over_pod=False),
                           jparam_specs(jstate["params"], _jmesh(mesh), fsdp_over_pod=False),
                           state["params"])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_and_cache_specs_equal_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    for mesh in MESHES:
        for shape in ALL_SHAPES:
            assert batch_spec(shape, _axes(mesh)) == tuple(jbatch_spec(shape, _jmesh(mesh)))
            assert kv_cache_spec(cfg, shape, _axes(mesh)) == \
                tuple(jkv_cache_spec(jcfg, shape, _jmesh(mesh)))


# --------------------------------------------------------------------------
# Specs on a DeviceMesh (the fake process group: no devices, no traffic)
# --------------------------------------------------------------------------

@pytest.fixture
def fake_group(request):
    """A fake default process group of ``request.param = (world, rank)``."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    world, rank = request.param
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world)
    yield rank
    dist.destroy_process_group()


@pytest.fixture
def one_rank_group(tmp_path):
    """A ``gloo`` default process group of one rank."""
    torch_dist_worker.start(0, 1, str(tmp_path / "store"))
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("fake_group", [(256, 37), (256, 200)], indirect=True)
def test_tuple_axis_placements_on_a_fake_mesh_of_256(fake_group):
    """P(("pod", "data"), "model") on a (2, 8, 16) mesh: the first dimension
    sharded over pod, then data (pod the most significant, as JAX lays out
    a tuple axis), the second over model; each rank holds its block."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = make_mesh((2, 8, 16), ("pod", "data", "model"), device_type="cpu")
    spec = P(("pod", "data"), "model")
    assert placements(mesh, spec) == (Shard(0), Shard(0), Shard(1))
    assert placements(mesh, P(None, "data")) == (Replicate(), Shard(1), Replicate())
    x = torch.arange(32 * 64, dtype=torch.float32).reshape(32, 64)
    d = distribute(x, make_sharding(mesh, spec))
    pod, data, model = mesh.get_coordinate()
    assert fake_group == pod * 128 + data * 16 + model
    block = pod * 8 + data
    assert tuple(d.shape) == (32, 64)
    assert torch.equal(d.to_local(), x[2 * block:2 * block + 2, 4 * model:4 * model + 4])
    with pytest.raises(ValueError, match="order"):
        placements(mesh, P(("data", "pod"), None))
    with pytest.raises(ValueError, match="twice"):
        placements(mesh, P("model", "model"))


@pytest.mark.parametrize("fake_group", [(256, 5)], indirect=True)
def test_tree_shardings_of_full_width_specs(fake_group):
    """Every spec of stablelm-3b's full-width params on the (16, 16)
    production mesh becomes placements of the mesh's two dimensions."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = make_production_mesh(device_type="cpu")
    params = _meta_params(get_config("stablelm_3b"))
    shardings = tree_shardings(mesh, param_specs(params, mesh))
    flat = T.flatten_with_paths(shardings)
    assert [n for n, _ in flat] == [n for n, _ in T.flatten_with_paths(params)]
    assert all(isinstance(s, NamedSharding) and len(s.placements) == 2 for _, s in flat)
    got = dict(flat)
    assert got["layers/attn/wq"].placements == (Shard(1), Shard(2))
    assert got["embed/table"].placements == (Shard(1), Shard(0))
    assert got["final_norm/scale"].placements == (Replicate(), Replicate())


@pytest.mark.parametrize("fake_group", [(256, 0)], indirect=True)
def test_hints_redistribute_dtensors_under_a_mesh(fake_group):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    mesh = make_production_mesh(device_type="cpu")
    x = torch.zeros(32, 64, 8)
    d = distribute_tensor(x, mesh, (Replicate(), Replicate()), src_data_rank=None)
    q = distribute_tensor(torch.zeros(16, 32, 128, 8), mesh, (Replicate(), Replicate()),
                          src_data_rank=None)
    w = {"layers": {"attn": {"wq": distribute_tensor(
        torch.zeros(2, 64, 64), mesh, (Replicate(), Replicate()), src_data_rank=None)}}}
    # without a mesh every hint returns its input
    assert activation_constraint(d) is d and shard_attention_q(q) is q
    assert constrain(d, "dp", None, "model") is d and fsdp_unshard(w) is w
    with set_mesh(mesh):
        assert activation_constraint(d).placements == (Shard(0), Replicate())
        assert constrain(d, "dp", None, "model").placements == (Shard(0), Replicate())
        assert constrain(d, None, "dp", None).placements == (Shard(1), Replicate())
        assert shard_attention_q(q).placements == (Shard(0), Shard(1))
        assert fsdp_unshard(w)["layers"]["attn"]["wq"].placements == (Replicate(), Shard(2))
        plain = torch.zeros(4, 4)
        assert activation_constraint(plain) is plain
    assert activation_constraint(d) is d


# --------------------------------------------------------------------------
# Meshes
# --------------------------------------------------------------------------

@pytest.mark.parametrize("fake_group", [(256, 3)], indirect=True)
def test_production_mesh_single_pod(fake_group):
    mesh = make_production_mesh(device_type="cpu")
    assert mesh.mesh_dim_names == ("data", "model") and tuple(mesh.shape) == (16, 16)
    assert tuple(mesh.get_coordinate()) == (0, 3)
    with pytest.raises(ValueError, match="needs 512 ranks"):
        make_production_mesh(multi_pod=True, device_type="cpu")
    host = make_host_mesh(16, device_type="cpu")
    assert host.mesh_dim_names == ("data", "model") and tuple(host.shape) == (16, 16)
    with pytest.raises(ValueError, match="256"):
        make_mesh((4, 4), ("data", "model"), device_type="cpu")


@pytest.mark.parametrize("fake_group", [(512, 300)], indirect=True)
def test_production_mesh_multi_pod(fake_group):
    mesh = make_production_mesh(multi_pod=True, device_type="cpu")
    assert mesh.mesh_dim_names == ("pod", "data", "model")
    assert tuple(mesh.shape) == (2, 16, 16)
    assert tuple(mesh.get_coordinate()) == (1, 2, 12)
    with pytest.raises(ValueError, match="needs 256 ranks"):
        make_production_mesh(device_type="cpu")


def test_meshes_need_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_host_mesh(device_type="cpu")
    with pytest.raises(RuntimeError, match="init_process_group"):
        build_mesh(plan_elastic((16, 16), ("data", "model"), 240), device_type="cpu")


@pytest.mark.parametrize("fake_group", [(256, 7), (256, 250)], indirect=True)
@pytest.mark.parametrize("old,names,surviving", [
    ((16, 16), ("data", "model"), 240), ((16, 16), ("data", "model"), 256),
    ((2, 8, 16), ("pod", "data", "model"), 200),
])
def test_build_mesh_lays_out_the_reference_plan(fake_group, old, names, surviving):
    """The plan equals the reference's; the mesh takes its shape and names
    over the first prod(shape) ranks in order (the reference's
    ``devices[:n].reshape(shape)``); ranks past them are not in it."""
    plan, jplan = plan_elastic(old, names, surviving), jplan_elastic(old, names, surviving)
    assert (plan.mesh_shape, plan.axis_names, plan.dropped_devices) == \
        (jplan.mesh_shape, jplan.axis_names, jplan.dropped_devices)
    mesh = build_mesh(plan, device_type="cpu")
    n = int(np.prod(plan.mesh_shape))
    assert mesh.mesh_dim_names == plan.axis_names and tuple(mesh.shape) == plan.mesh_shape
    assert torch.equal(mesh.mesh, torch.arange(n).reshape(plan.mesh_shape))
    if fake_group < n:
        assert list(mesh.get_coordinate()) == list(np.unravel_index(fake_group, plan.mesh_shape))
    else:
        assert mesh.get_coordinate() is None


# --------------------------------------------------------------------------
# Collective matmul
# --------------------------------------------------------------------------

def test_ring_matmul_matches_psum_on_one_rank(one_rank_group, rng):
    x = torch.from_numpy(rng.standard_normal((8, 16)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((16, 32)).astype(np.float32))
    a, b = ring_matmul(x, w), psum_matmul(x, w)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)
    np.testing.assert_allclose(a.numpy(), (x @ w).numpy(), atol=1e-5)
    x3 = x.reshape(2, 4, 16)
    np.testing.assert_allclose(ring_matmul(x3, w).numpy(), (x3 @ w).numpy(), atol=1e-5)


def test_ring_matmul_refuses_an_output_that_does_not_divide(fake_group_4):
    w = torch.zeros(4, 6)
    with pytest.raises(ValueError, match="does not divide"):
        ring_matmul(torch.zeros(2, 4), w)


@pytest.fixture
def fake_group_4():
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("world", [2, 4])
def test_ring_and_psum_matmul_on_gloo_groups(tmp_path, world):
    """Each of ``world`` processes holds its K-shard of x and w; ring (the
    reference's chunk order over ``batch_isend_irecv``) and psum agree with
    x @ w at the reference's 1e-5 on every rank."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=torch_dist_worker.collective_matmul,
                         args=(r, world, str(tmp_path / "store"), str(tmp_path)))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(JOIN_TIMEOUT_S)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    assert not alive, f"{len(alive)} of {world} ranks still running after {JOIN_TIMEOUT_S} s"
    assert [p.exitcode for p in procs] == [0] * world
    x, w = torch_dist_worker.matmul_inputs(world)
    for r in range(world):
        ring, psum = np.load(tmp_path / f"rank{r}.npy")
        np.testing.assert_allclose(ring, x @ w, atol=1e-5)
        np.testing.assert_allclose(psum, x @ w, atol=1e-5)
