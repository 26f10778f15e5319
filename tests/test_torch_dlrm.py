"""The port's DLRM serve path against the JAX package, on the CPU.

The reference draws its weights with ``jax.random``, which torch cannot
reproduce, so they cross over as numpy arrays through
``convert.dlrm_params_from_jax``. The reference's forward runs its Pallas
embedding kernels in interpret mode (``use_pallas=True``). Logits are held
at the pinned test's tolerance of ``tests/test_kernels.py``, 1e-4: the MLPs
and the interaction run on XLA's CPU matmuls on one side and torch's on the
other.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.dlrm_data import DLRMDataConfig as JDataConfig
from repro.data.dlrm_data import dlrm_batch as j_dlrm_batch
from repro.kernels import ops as jops
from repro.models import dlrm as jdlrm
from repro_torch.convert import dlrm_params_from_jax
from repro_torch.data import DLRMDataConfig, dlrm_batch
from repro_torch.kernels import launch_counts, ops, reset_launch_counts
from repro_torch.models import DLRM, DLRMConfig, bce_loss, interact, smoke_config
from repro_torch.models import dlrm as tdlrm

TOL = 1e-4


def _numpy_tree(params):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), params)


def _port_model(jparams, cfg):
    model = DLRM(cfg, device="cpu")
    model.load_state_dict(dlrm_params_from_jax(_numpy_tree(jparams), cfg))
    return model


def _data_cfg(cfg, batch_size=4, zipf_s=1.1):
    return dict(num_tables=cfg.num_tables, rows_per_table=cfg.rows_per_table,
                lookups_per_table=cfg.lookups_per_table, batch_size=batch_size, zipf_s=zipf_s)


def _pinned(batch, cfg, n_hot):
    glob = (np.arange(cfg.num_tables)[None, :, None] * cfg.rows_per_table
            + batch["sparse"]).reshape(-1)
    uniq, counts = np.unique(glob, return_counts=True)
    hot_ids = np.sort(uniq[np.argsort(-counts)][:n_hot]).astype(np.int64)
    pos, mask = jops.split_hot_cold(batch["sparse"], hot_ids, cfg.rows_per_table)
    return hot_ids, pos, mask


@pytest.mark.parametrize("step", [0, 1, 7])
@pytest.mark.parametrize("shape", [(4, 1000, 8, 4, 1.1), (60, 1_000_000, 120, 2, 1.1),
                                   (3, 50, 5, 16, 0.81)])
def test_dlrm_batch_identical_to_reference(shape, step):
    T, R, L, B, s = shape
    kw = dict(num_tables=T, rows_per_table=R, lookups_per_table=L, batch_size=B, zipf_s=s)
    got = dlrm_batch(DLRMDataConfig(**kw), step)
    want = j_dlrm_batch(JDataConfig(**kw), step)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("pinned,n_hot", [(False, 0), (True, 1), (True, 16), (True, 200)])
@pytest.mark.parametrize("seed", [0, 3])
def test_forward_matches_jax(pinned, n_hot, seed):
    cfg = smoke_config()
    jcfg = jdlrm.DLRMConfig(**dataclasses.asdict(cfg))
    jparams = jdlrm.init(jax.random.PRNGKey(seed), jcfg)
    model = _port_model(jparams, cfg)
    batch = dlrm_batch(DLRMDataConfig(**_data_cfg(cfg), seed=seed), 0)
    dense, sparse = torch.from_numpy(batch["dense"]), torch.from_numpy(batch["sparse"])
    jkw, tkw = {}, {}
    if pinned:
        hot_ids, pos, mask = _pinned(batch, cfg, n_hot)
        jkw["pinned"] = {"hot_table": jparams["tables"][jnp.asarray(hot_ids)],
                         "positions": jnp.asarray(pos), "mask": jnp.asarray(mask)}
        tkw["pinned"] = {"hot_table": ops.embedding_gather(model.tables, torch.from_numpy(hot_ids)),
                         "positions": torch.from_numpy(pos), "mask": torch.from_numpy(mask)}
    reset_launch_counts()
    got = model(dense, sparse, **tkw)
    assert all(n == 0 for n in launch_counts().values())     # plain versions on the CPU
    assert got.shape == (4,) and got.dtype == torch.float32
    want = jdlrm.forward(jparams, jnp.asarray(batch["dense"]), jnp.asarray(batch["sparse"]),
                         jcfg, use_pallas=True, **jkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    if pinned:
        np.testing.assert_allclose(got.numpy(), model(dense, sparse).numpy(), atol=TOL, rtol=TOL)


def test_forward_bf16_matches_jax():
    cfg = dataclasses.replace(smoke_config(), dtype="bfloat16")
    jcfg = jdlrm.DLRMConfig(**dataclasses.asdict(cfg))
    jparams = jdlrm.init(jax.random.PRNGKey(1), jcfg)
    model = _port_model(jparams, cfg)
    assert model.tables.dtype == torch.bfloat16
    batch = dlrm_batch(DLRMDataConfig(**_data_cfg(cfg)), 2)
    got = model(torch.from_numpy(batch["dense"]), torch.from_numpy(batch["sparse"]))
    want = jdlrm.forward(jparams, jnp.asarray(batch["dense"]), jnp.asarray(batch["sparse"]),
                         jcfg, use_pallas=True)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=5e-2, rtol=5e-2)


def test_interact_and_bce_loss_match_jax(rng):
    dense = rng.standard_normal((5, 16)).astype(np.float32)
    emb = rng.standard_normal((5, 7, 16)).astype(np.float32)
    got = interact(torch.from_numpy(dense), torch.from_numpy(emb))
    want = jdlrm.interact(jnp.asarray(dense), jnp.asarray(emb))
    assert got.shape == want.shape == (5, 8 * 7 // 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    logit = rng.standard_normal(9).astype(np.float32) * 4
    label = (rng.random(9) < 0.5).astype(np.float32)
    np.testing.assert_allclose(bce_loss(torch.from_numpy(logit), torch.from_numpy(label)).item(),
                               float(jdlrm.bce_loss(jnp.asarray(logit), jnp.asarray(label))),
                               rtol=1e-6)


def test_parameters_have_the_reference_shapes_and_scales():
    cfg = DLRMConfig(num_tables=3, rows_per_table=4000, dim=32, lookups_per_table=4,
                     bottom_mlp=(64, 32), top_mlp=(16, 1))
    jparams = jdlrm.init(jax.random.PRNGKey(0), jdlrm.DLRMConfig(**dataclasses.asdict(cfg)))
    model = DLRM(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    state = model.state_dict()
    assert set(state) == set(dlrm_params_from_jax(_numpy_tree(jparams), cfg))
    for k, v in dlrm_params_from_jax(_numpy_tree(jparams), cfg).items():
        assert state[k].shape == v.shape and state[k].dtype == v.dtype, k
    assert abs(float(state["tables"].std()) - 0.01) < 5e-4
    for i, w in enumerate(model.bottom_w):
        assert abs(float(w.std()) * np.sqrt(w.shape[0]) - 1.0) < 0.15, i
    assert all(float(b.abs().max()) == 0.0 for b in list(model.bottom_b) + list(model.top_b))
    assert not any(p.requires_grad for p in model.parameters())
    again = DLRM(cfg, device="cpu", generator=torch.Generator().manual_seed(5)).state_dict()
    assert all(torch.equal(state[k], again[k]) for k in state)
    other = DLRM(cfg, device="cpu", generator=torch.Generator().manual_seed(6)).state_dict()
    assert not torch.equal(state["tables"], other["tables"])


def test_the_stacked_table_is_filled_one_table_at_a_time(monkeypatch):
    cfg = DLRMConfig(num_tables=5, rows_per_table=300, dim=16, lookups_per_table=2,
                     bottom_mlp=(16,), top_mlp=(1,))
    sizes = []
    randn = torch.randn

    def recording_randn(*shape, **kw):
        out = randn(*shape, **kw)
        sizes.append(out.numel())
        return out

    monkeypatch.setattr(torch, "randn", recording_randn)
    model = DLRM(cfg, device="cpu")
    assert sizes[:cfg.num_tables] == [cfg.rows_per_table * cfg.dim] * cfg.num_tables
    assert max(sizes) == cfg.rows_per_table * cfg.dim
    R = cfg.rows_per_table
    per_table_std = [float(model.tables[t * R:(t + 1) * R].std()) for t in range(cfg.num_tables)]
    assert all(abs(s - 0.01) < 1e-3 for s in per_table_std)
    assert len(set(per_table_std)) == cfg.num_tables          # a fresh draw per table


def test_dlrm_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DLRM(smoke_config())


def test_config_and_weights_are_validated():
    with pytest.raises(ValueError, match="bottom_mlp"):
        DLRMConfig(dim=64)
    with pytest.raises(ValueError, match="dtype"):
        DLRMConfig(dtype="float16")
    cfg = smoke_config()
    jparams = _numpy_tree(jdlrm.init(jax.random.PRNGKey(0), jdlrm.DLRMConfig(
        **dataclasses.asdict(cfg))))
    with pytest.raises(ValueError, match="tables"):
        dlrm_params_from_jax(jparams, dataclasses.replace(cfg, rows_per_table=999))
    with pytest.raises(ValueError, match="layers"):
        dlrm_params_from_jax(dict(jparams, top=jparams["top"][:1]), cfg)
    assert tdlrm.smoke_config() == cfg
