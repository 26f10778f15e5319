"""The port's checkpoint manager and runtime policies, on the CPU.

Every case of ``tests/test_checkpoint_runtime.py`` runs through the port,
``test_elastic_restore_across_topology`` on a one-rank ``gloo`` group and
on a fake group of 256 ranks (the (16, 16) production mesh). Besides:
checkpoints cross between the packages both ways, leaf for leaf (bf16
parameters, int8 moments, error feedback), the reference's also restored
with ``shardings=`` in the port; the port's MessagePack bytes equal
``msgpack.packb``'s (this test may import ``msgpack``; the port may not);
and the launcher's resume after a SIGTERM equals a straight run, bitwise.
A test that starts a default process group destroys it in its fixture.
"""
import os
import signal
import subprocess
import sys
from pathlib import Path

import jax
import msgpack
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.checkpoint import CheckpointConfig as JCheckpointConfig
from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.models import get_smoke_config as jsmoke
from repro.training import AdamWConfig as JAdamWConfig
from repro.training import CompressionConfig as JCompressionConfig
from repro.training import TrainConfig as JTrainConfig
from repro.training import init_state as jinit_state
from repro_torch import tree as T
from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
from repro_torch.checkpoint.messagepack import packb, unpackb
from repro_torch.distributed import PartitionSpec, param_specs, tree_shardings
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.data import LMDataConfig, lm_batch
from repro_torch.models import get_smoke_config
from repro_torch.runtime import (
    FailureDetector,
    FaultConfig,
    StragglerPolicy,
    plan_elastic,
    plan_mesh_shape,
)
from repro_torch.training import (
    AdamWConfig,
    CompressionConfig,
    TrainConfig,
    build_train_step,
    init_state,
)

ROOT = Path(__file__).resolve().parents[1]


def _state():
    cfg = get_smoke_config("stablelm_3b")
    tcfg = TrainConfig(adamw=AdamWConfig(), loss_chunk=16)
    return cfg, tcfg, init_state(0, cfg, tcfg, device="cpu")


def _equal(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
        b.view(torch.int16) if b.dtype == torch.bfloat16 else b)


def test_checkpoint_roundtrip(tmp_path):
    cfg, tcfg, state = _state()
    mgr = CheckpointManager(CheckpointConfig(directory=str(tmp_path), async_save=False))
    mgr.save(7, state, extra={"note": "x"})
    step, extra, restored = mgr.restore(target_tree=state)
    assert step == 7 and extra["note"] == "x"
    for a, b in zip(T.leaves(state), T.leaves(restored)):
        assert _equal(a, b)


def test_checkpoint_async_and_keepn(tmp_path):
    cfg, tcfg, state = _state()
    mgr = CheckpointManager(CheckpointConfig(directory=str(tmp_path), keep=2))
    for s in (1, 2, 3, 4):
        mgr.save(s, state)
        mgr.wait()
    assert mgr.all_steps() == [3, 4]


def test_checkpoint_detects_corruption(tmp_path):
    cfg, tcfg, state = _state()
    mgr = CheckpointManager(CheckpointConfig(directory=str(tmp_path), async_save=False))
    mgr.save(1, state)
    d = os.path.join(str(tmp_path), "step_0000000001")
    victim = [f for f in os.listdir(d) if f.endswith(".npy")][0]
    with open(os.path.join(d, victim), "r+b") as f:
        f.seek(200)
        f.write(b"\xde\xad\xbe\xef")
    with pytest.raises(IOError):
        mgr.restore(target_tree=state)


def test_checkpoint_resume_training(tmp_path):
    """Train 5 steps, checkpoint, train 5 more; restart from ckpt must land
    on the same loss trajectory (restart-safe data pipeline + state)."""
    cfg, tcfg, state = _state()
    step_fn = build_train_step(cfg, tcfg)
    dcfg = LMDataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4, seed=0)
    mgr = CheckpointManager(CheckpointConfig(directory=str(tmp_path), async_save=False))

    def batch(i):
        return {k: torch.from_numpy(v) for k, v in lm_batch(dcfg, i).items()}

    for i in range(5):
        state, _ = step_fn(state, batch(i))
    mgr.save(5, state)
    cont = []
    for i in range(5, 10):
        state, m = step_fn(state, batch(i))
        cont.append(float(m["loss"]))

    _, _, restored = mgr.restore(target_tree=init_state(0, cfg, tcfg, device="cpu"))
    re_losses = []
    for i in range(5, 10):
        restored, m = step_fn(restored, batch(i))
        re_losses.append(float(m["loss"]))
    np.testing.assert_allclose(cont, re_losses, rtol=1e-5)
    assert cont == re_losses                       # and bitwise, on one device


def test_save_snapshots_before_an_in_place_step(tmp_path):
    """``save`` copies the leaves before it returns: the next train step,
    which updates the same tensors in place, does not reach the files."""
    cfg, tcfg, state = _state()
    want = [t.clone() for t in T.leaves(state)]
    mgr = CheckpointManager(CheckpointConfig(directory=str(tmp_path)))
    mgr.save(0, state)
    b = {k: torch.from_numpy(v) for k, v in
         lm_batch(LMDataConfig(vocab=cfg.vocab, seq_len=32, global_batch=2), 0).items()}
    build_train_step(cfg, tcfg)(state, b)
    mgr.wait()
    _, _, restored = mgr.restore(target_tree=state)
    assert all(_equal(a, b) for a, b in zip(T.leaves(restored), want))


def test_restore_refuses_another_tree(tmp_path):
    cfg, tcfg, state = _state()
    mgr = CheckpointManager(CheckpointConfig(directory=str(tmp_path), async_save=False))
    mgr.save(1, state)
    other = dict(state, params=dict(state["params"], extra_leaf=torch.zeros(2)))
    with pytest.raises(ValueError, match="holds leaves"):
        mgr.restore(target_tree=other)
    bad = T.unflatten(state, [t.float() if t.dtype == torch.bfloat16 else t
                              for t in T.leaves(state)])
    with pytest.raises(ValueError, match="checkpoint torch.bfloat16"):
        mgr.restore(target_tree=bad)


def test_async_writer_error_surfaces_on_wait(tmp_path, monkeypatch):
    cfg, tcfg, state = _state()
    mgr = CheckpointManager(CheckpointConfig(directory=str(tmp_path)))

    def boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(np, "save", boom)
    mgr.save(1, state)
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    assert mgr.all_steps() == [] and os.listdir(tmp_path) == []


# --------------------------------------------------------------------------
# fault detection + elastic + straggler
# --------------------------------------------------------------------------

def test_failure_detector_flags_dead_host():
    clock = [0.0]
    det = FailureDetector([f"h{i}" for i in range(8)],
                          FaultConfig(heartbeat_timeout_s=10), clock=lambda: clock[0])
    clock[0] = 5.0
    for i in range(8):
        if i != 3:
            det.heartbeat(f"h{i}")
    clock[0] = 12.0    # h3 last seen at 0 (>10s ago); others at 5 (7s ago)
    dead = det.poll()
    assert dead == {"h3"}
    assert not det.should_halt()
    assert len(det.healthy) == 7


def test_failure_detector_halts_below_quorum():
    clock = [0.0]
    det = FailureDetector(["a", "b", "c", "d"],
                          FaultConfig(heartbeat_timeout_s=1, min_healthy_fraction=0.75),
                          clock=lambda: clock[0])
    det.inject_failure("a")
    det.inject_failure("b")
    det.poll()
    assert det.should_halt()


def test_plan_mesh_shape():
    assert plan_mesh_shape(256, 16) == (16, 16)
    assert plan_mesh_shape(512, 16, pods=2) == (2, 16, 16)
    assert plan_mesh_shape(240, 16) == (15, 16)      # lost a host: shrink data
    assert plan_mesh_shape(8, 16) == (1, 1, 8)       # degenerate: shrink model


def test_plan_elastic_preserves_model_axis():
    plan = plan_elastic((16, 16), ("data", "model"), surviving_devices=240)
    assert plan.mesh_shape == (15, 16)
    assert plan.axis_names == ("data", "model")
    assert plan.dropped_devices == 0
    plan2 = plan_elastic((2, 16, 16), ("pod", "data", "model"), 256 + 240)
    assert plan2.mesh_shape[-1] == 16


@pytest.fixture
def one_rank_group(tmp_path):
    """A ``gloo`` default process group of one rank."""
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    yield
    dist.destroy_process_group()


@pytest.fixture
def fake_group_256():
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=37, world_size=256)
    yield 37
    dist.destroy_process_group()


def _dtensor_leaves(tree):
    from torch.distributed.tensor import DTensor

    leaves = T.leaves(tree)
    assert all(isinstance(t, DTensor) for t in leaves)
    return leaves


def test_elastic_restore_across_topology(tmp_path, one_rank_group):
    """Checkpoint written under one topology restores onto another (the
    elastic-scaling path; a one-rank mesh, shardings still exercised):
    every leaf a DTensor on the mesh, equal to what was saved."""
    cfg, tcfg, state = _state()
    mgr = CheckpointManager(CheckpointConfig(directory=str(tmp_path / "ck"), async_save=False))
    mgr.save(3, state)
    mesh = make_mesh((1, 1), ("data", "model"), device_type="cpu")
    sh = tree_shardings(mesh, param_specs(state, mesh))
    step, _, restored = mgr.restore(target_tree=state, shardings=sh)
    assert step == 3
    leaves = _dtensor_leaves(restored)
    assert leaves[0].device_mesh is mesh
    for a, b in zip(leaves, T.leaves(state)):
        assert _equal(a.full_tensor(), b)
    with pytest.raises(ValueError, match="not both"):
        mgr.restore(target_tree=state, shardings=sh, device="cpu")
    with pytest.raises(ValueError, match="needs target_tree"):
        mgr.restore(shardings=sh)


def test_restore_onto_the_production_mesh(tmp_path, fake_group_256):
    """The smoke state restored onto the (16, 16) mesh of a fake group of
    256: rank 37 holds each leaf's block at its coordinate (2, 5), sharded
    as ``param_specs`` says (the smoke widths mostly replicate)."""
    cfg, tcfg, state = _state()
    mgr = CheckpointManager(CheckpointConfig(directory=str(tmp_path), async_save=False))
    mgr.save(4, state)
    mesh = make_production_mesh(device_type="cpu")
    specs = param_specs(state, mesh)
    _, _, restored = mgr.restore(target_tree=state, shardings=tree_shardings(mesh, specs))
    assert tuple(mesh.get_coordinate()) == (2, 5)
    sharded = 0
    for got, want, spec in zip(_dtensor_leaves(restored), T.leaves(state),
                               T.leaves(specs, is_leaf=lambda x: isinstance(x, PartitionSpec))):
        block = want
        for d, ax in enumerate(spec):
            if ax is not None:
                i, n = {"data": (2, 16), "model": (5, 16)}[ax]
                size = want.shape[d] // n
                block = block.narrow(d, i * size, size)
                sharded += 1
        assert tuple(got.shape) == tuple(want.shape)
        assert _equal(got.to_local(), block.contiguous())
    assert sharded > 0


def test_straggler_policy_rebalances():
    pol = StragglerPolicy(threshold=1.5, window=4)
    rep = None
    for _ in range(4):
        rep = pol.observe({"h0": 1.0, "h1": 1.0, "h2": 1.0, "h3": 2.5})
    assert rep.stragglers == ["h3"]
    assert rep.microbatch_shares["h3"] < 1.0
    assert rep.persistent == ["h3"]


def test_straggler_policy_drop_mode():
    pol = StragglerPolicy(threshold=1.5, window=4, mode="drop")
    for _ in range(4):
        rep = pol.observe({"h0": 1.0, "h1": 1.0, "h2": 1.0, "h3": 3.0})
    assert rep.microbatch_shares["h3"] == 0.0
    assert abs(rep.grad_scale - 4 / 3) < 1e-9


def test_straggler_recovers():
    pol = StragglerPolicy(threshold=1.5, window=3)
    for _ in range(3):
        pol.observe({"h0": 1.0, "h1": 3.0})
    for _ in range(6):
        rep = pol.observe({"h0": 1.0, "h1": 1.0})
    assert rep.stragglers == []
    assert rep.persistent == []


# --------------------------------------------------------------------------
# Across the packages
# --------------------------------------------------------------------------

def _both_states():
    """The reference's smoke state with bf16 params, int8 moments and int8
    error feedback, and the port's state of the same configuration."""
    jcfg, cfg = jsmoke("stablelm_3b"), get_smoke_config("stablelm_3b")
    kw = dict(loss_chunk=16)
    jt = JTrainConfig(adamw=JAdamWConfig(quantize_state=True),
                      compression=JCompressionConfig(kind="int8"), **kw)
    tc = TrainConfig(adamw=AdamWConfig(quantize_state=True),
                     compression=CompressionConfig(kind="int8"), **kw)
    jstate = jinit_state(jax.random.PRNGKey(0), jcfg, jt)
    # non-zero moments and residuals, so every leaf carries its own values
    rng = np.random.default_rng(0)
    jstate = jax.tree_util.tree_map(
        lambda x: x if x.dtype == np.int32 and x.ndim == 0 else
        (np.asarray(rng.integers(-127, 128, x.shape), x.dtype) if x.dtype == np.int8
         else np.asarray(rng.standard_normal(x.shape), x.dtype)), jstate)
    return jstate, init_state(1, cfg, tc, device="cpu")


def _np(x):
    a = np.asarray(x)
    return a.view(np.uint16) if str(a.dtype) == "bfloat16" else a


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    jstate, state = _both_states()
    jm = JCheckpointManager(JCheckpointConfig(directory=str(tmp_path), async_save=False))
    jm.save(5, jstate, extra={"run": "jax", "lr": 1e-3})
    names = [n for n, _ in T.flatten_with_paths(state)]
    assert len(names) == 74 and names[0] == "err/embed/table" and names[-1] == "step"
    assert "opt/mu/layers/attn/wk/1" in names
    step, extra, restored = CheckpointManager(
        CheckpointConfig(directory=str(tmp_path))).restore(target_tree=state)
    assert step == 5 and extra == {"run": "jax", "lr": 1e-3}
    assert isinstance(restored["opt"], type(state["opt"]))
    got = T.flatten_with_paths(restored)
    want = jax.tree_util.tree_leaves(jstate)
    assert len(got) == len(want) == 74
    for (name, a), b in zip(got, want):
        if a.dtype == torch.bfloat16:
            assert np.array_equal(a.view(torch.int16).numpy().view(np.uint16), _np(b)), name
        else:
            assert np.array_equal(a.numpy(), _np(b)), name


def test_reference_checkpoint_restores_with_shardings_in_the_port(tmp_path, one_rank_group):
    """A checkpoint of the JAX package restored with ``shardings=`` from the
    port's ``param_specs``: every leaf a DTensor, bitwise the reference's."""
    jstate, state = _both_states()
    jm = JCheckpointManager(JCheckpointConfig(directory=str(tmp_path / "ck"), async_save=False))
    jm.save(6, jstate)
    mesh = make_mesh((1, 1), ("data", "model"), device_type="cpu")
    step, _, restored = CheckpointManager(CheckpointConfig(directory=str(tmp_path / "ck"))).restore(
        target_tree=state, shardings=tree_shardings(mesh, param_specs(state, mesh)))
    assert step == 6
    got = _dtensor_leaves(restored)
    want = jax.tree_util.tree_leaves(jstate)
    assert len(got) == len(want) == 74
    for a, b in zip(got, want):
        a = a.full_tensor()
        a = a.view(torch.int16).numpy().view(np.uint16) if a.dtype == torch.bfloat16 else a.numpy()
        assert np.array_equal(a, _np(b))


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    jstate, state = _both_states()
    CheckpointManager(CheckpointConfig(directory=str(tmp_path), async_save=False)).save(
        9, state, extra={"run": "torch"})
    jm = JCheckpointManager(JCheckpointConfig(directory=str(tmp_path)))
    step, extra, restored = jm.restore(target_tree=jstate)
    assert step == 9 and extra == {"run": "torch"}
    for (name, a), b in zip(T.flatten_with_paths(state), jax.tree_util.tree_leaves(restored)):
        want = a.view(torch.int16).numpy().view(np.uint16) if a.dtype == torch.bfloat16 \
            else a.numpy()
        assert str(np.asarray(b).dtype) == str(a.dtype).rsplit(".", 1)[1], name
        assert np.array_equal(_np(b), want), name
    raw = jm.restore()
    assert raw["names"] == [n for n, _ in T.flatten_with_paths(state)]


def test_messagepack_bytes_equal_msgpack(tmp_path):
    jstate, _ = _both_states()
    JCheckpointManager(JCheckpointConfig(directory=str(tmp_path), async_save=False)).save(
        3, jstate, extra={"note": "x", "n": -7})
    meta_bytes = (tmp_path / "step_0000000003" / "META.msgpack").read_bytes()
    meta = msgpack.unpackb(meta_bytes)
    assert packb(meta) == meta_bytes
    assert unpackb(meta_bytes) == meta
    edge = {"ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32, 2 ** 63,
                     -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31, -2 ** 31 - 1, -2 ** 63],
            "floats": [0.0, -1.5, 1e-300, float("inf")], "flags": [True, False, None],
            "strs": ["", "a" * 31, "b" * 32, "c" * 255, "d" * 256, "e" * 70000, "ü"],
            "bytes": [b"", b"x" * 300, b"y" * 70000],
            "lists": [list(range(15)), list(range(16)), list(range(70000))],
            "maps": [{str(i): i for i in range(15)}, {str(i): i for i in range(16)},
                     {str(i): i for i in range(70000)}],
            "tuple": (1, "two")}
    assert packb(edge) == msgpack.packb(edge)
    back = unpackb(packb(edge))
    assert back == msgpack.unpackb(msgpack.packb(edge))
    assert unpackb(msgpack.packb(1.5, use_single_float=True)) == 1.5
    with pytest.raises(TypeError):
        packb({"x": object()})
    with pytest.raises(ValueError, match="extra data"):
        unpackb(packb(1) + b"\x00")
    with pytest.raises(ValueError, match="truncated"):
        unpackb(packb("hello")[:-1])


def _launch(args, tmp_path, name):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu", "--smoke",
         "--arch", "stablelm_3b", "--seq", "32", "--batch", "4", "--log-every", "1",
         "--checkpoint-dir", str(tmp_path / name), *args],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def test_launcher_resume_after_sigterm_equals_a_straight_run(tmp_path):
    """A run stopped by SIGTERM after its third step checkpoints at a step's
    end and exits 0; ``--resume auto`` carries it to the end. Its final
    state equals a straight run's, every leaf bitwise."""
    steps = "16"
    straight = _launch(["--steps", steps, "--save-every", "1000"], tmp_path, "straight")
    out, err = straight.communicate(timeout=600)
    assert straight.returncode == 0, err
    killed = _launch(["--steps", steps, "--save-every", "1000"], tmp_path, "resumed")
    lines = []
    for line in killed.stdout:
        lines.append(line)
        if line.startswith("step     2"):
            killed.send_signal(signal.SIGTERM)
            break
    rest, err = killed.communicate(timeout=600)
    assert killed.returncode == 0, err
    saved = CheckpointManager(CheckpointConfig(directory=str(tmp_path / "resumed"))).all_steps()
    assert len(saved) == 1 and 3 <= saved[0] < int(steps), (saved, rest)
    assert f"preempted: saved step {saved[0]}" in rest
    resumed = _launch(["--steps", steps, "--save-every", "1000", "--resume", "auto"],
                      tmp_path, "resumed")
    out, err = resumed.communicate(timeout=600)
    assert resumed.returncode == 0, err
    assert f"resumed from step {saved[0]}" in out
    a = CheckpointManager(CheckpointConfig(directory=str(tmp_path / "straight"))).restore()
    b = CheckpointManager(CheckpointConfig(directory=str(tmp_path / "resumed"))).restore()
    assert a["step"] == b["step"] == int(steps) and a["names"] == b["names"]
    for name, x, y in zip(a["names"], a["leaves"], b["leaves"]):
        assert _equal(x, y), name
