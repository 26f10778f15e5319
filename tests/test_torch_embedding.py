"""The port's embedding ops and kernels K3-K5 against the JAX package, on the CPU.

The same inputs, made with numpy from a seed, go through the JAX function
(its Pallas kernels in interpret mode, ``use_pallas=True``, and its jnp
path) and the port's counterpart, whose wrappers run their plain torch
versions for CPU tensors. Tolerances are the reference's own
(``tests/test_kernels.py``): 1e-5 for f32 and 5e-2 for bf16 on the sweep,
1e-4 on the pinned path. Where both sides add in the same order the
results are held bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from repro.kernels import embedding_bag as jk
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import embedding_bag as tk
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
SWEEP = [(1, 16, 32, 2, 1), (3, 50, 96, 4, 7), (2, 128, 128, 8, 12), (4, 64, 200, 2, 5)]


def _tol(dtype: str) -> float:
    return 1e-5 if dtype == "float32" else 5e-2


def _table(rng, shape, dtype):
    x = rng.standard_normal(shape).astype(np.float32)
    jd, td = DTYPES[dtype]
    return jnp.asarray(x, dtype=jd), torch.from_numpy(x).to(td)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _assert_close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def _assert_bitwise(got, want):
    np.testing.assert_array_equal(_np(got).view(np.int32), _np(want).view(np.int32))


# ---------------------------------------------------------------------------
# ops (tests/test_kernels.py's shapes)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("T,R,D,B,L", SWEEP)
def test_embedding_bag_matches_jax(T, R, D, B, L, dtype):
    rng = np.random.default_rng(T * 1000 + D)
    jt, tt = _table(rng, (T * R, D), dtype)
    idx = rng.integers(0, R, size=(B, T, L)).astype(np.int32)
    got = tops.embedding_bag(tt, torch.from_numpy(idx), R)
    assert got.dtype == tt.dtype and tuple(got.shape) == (B, T, D)
    pallas = jops.embedding_bag(jt, jnp.asarray(idx), R, use_pallas=True)
    # K3's plain version adds in the Pallas kernel's order: the same bits.
    _assert_bitwise(got, pallas)
    _assert_close(got, jops.embedding_bag(jt, jnp.asarray(idx), R, use_pallas=False), _tol(dtype))


@pytest.mark.parametrize("shape", [(7,), (3, 5), (2, 3, 4)])
def test_embedding_gather_matches_jax(shape, rng):
    jt, tt = _table(rng, (64, 48), "float32")
    idx = rng.integers(0, 64, size=shape).astype(np.int32)
    got = tops.embedding_gather(tt, torch.from_numpy(idx))
    assert tuple(got.shape) == shape + (48,)
    _assert_bitwise(got, jops.embedding_gather(jt, jnp.asarray(idx), use_pallas=True))
    _assert_bitwise(got, jops.embedding_gather(jt, jnp.asarray(idx), use_pallas=False))


def test_split_hot_cold_identical_to_reference(rng):
    idx = rng.integers(0, 100, size=(2, 3, 4))
    hot = np.array([5, 105, 250])           # global ids (t*R + r), R=100
    for hot_ids in (hot, np.array([], dtype=np.int64), np.array([299])):
        got = tops.split_hot_cold(idx, hot_ids, 100)
        want = jops.split_hot_cold(idx, hot_ids, 100)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.int32
            np.testing.assert_array_equal(g, w)


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 10_000), n_hot=st.integers(1, 60), T=st.integers(1, 5))
def test_split_hot_cold_property(seed, n_hot, T):
    r = np.random.default_rng(seed)
    R = 40
    idx = r.integers(0, R, size=(3, T, 6))
    hot_ids = np.sort(r.choice(T * R, size=min(n_hot, T * R), replace=False)).astype(np.int64)
    pos, mask = tops.split_hot_cold(idx, hot_ids, R)
    jpos, jmask = jops.split_hot_cold(idx, hot_ids, R)
    np.testing.assert_array_equal(pos, jpos)
    np.testing.assert_array_equal(mask, jmask)
    glob = np.arange(T)[None, :, None] * R + idx
    assert np.array_equal(mask.astype(bool), np.isin(glob, hot_ids))
    assert np.array_equal(hot_ids[pos][mask == 1], glob[mask == 1])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("T,R,D,B,L,n_hot", [(3, 40, 64, 4, 6, 25), (2, 50, 200, 3, 9, 7),
                                             (1, 16, 32, 2, 1, 16)])
def test_embedding_bag_pinned_matches_jax(T, R, D, B, L, n_hot, dtype):
    rng = np.random.default_rng(R + D)
    jt, tt = _table(rng, (T * R, D), dtype)
    idx = rng.integers(0, R, size=(B, T, L)).astype(np.int32)
    hot_ids = np.sort(rng.choice(T * R, size=n_hot, replace=False)).astype(np.int64)
    pos, mask = tops.split_hot_cold(idx, hot_ids, R)
    hot_t = tops.embedding_gather(tt, torch.from_numpy(hot_ids))
    args = [torch.from_numpy(a) for a in (idx, pos, mask)]
    got = tops.embedding_bag_pinned(tt, hot_t, args[0], args[1], args[2], R)
    assert got.dtype == tt.dtype
    want = jops.embedding_bag_pinned(jt, jt[jnp.asarray(hot_ids)], jnp.asarray(idx),
                                     jnp.asarray(pos), jnp.asarray(mask), R, use_pallas=True)
    tol = 1e-4 if dtype == "float32" else 5e-2
    _assert_close(got, want, tol)
    _assert_close(got, tops.embedding_bag(tt, args[0], R), tol)


# ---------------------------------------------------------------------------
# the kernels' wrappers against the Pallas kernels themselves (D = 128 lanes)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,T,L", [(2, 3, 5), (1, 1, 1), (3, 2, 17)])
def test_bag_kernel_matches_pallas_kernel(B, T, L, dtype, rng):
    R, D = 30, 128
    jt, tt = _table(rng, (T * R, D), dtype)
    flat = rng.integers(0, T * R, size=(B, T, L)).astype(np.int32)
    reset_launch_counts()
    got = tk.embedding_bag_kernel(tt, torch.from_numpy(flat))
    assert launch_counts()["embedding_bag"] == 0          # the CPU runs the plain version
    _assert_bitwise(got, jk.embedding_bag_kernel(jt, jnp.asarray(flat), R, interpret=True))
    _assert_close(got, tref.embedding_bag_ref(tt, torch.from_numpy(flat)), _tol(dtype))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_gather_kernel_matches_pallas_kernel(dtype, rng):
    jt, tt = _table(rng, (70, 128), dtype)
    idx = rng.integers(0, 70, size=(23,)).astype(np.int32)
    got = tk.embedding_gather_kernel(tt, torch.from_numpy(idx))
    _assert_bitwise(got, jk.embedding_gather_kernel(jt, jnp.asarray(idx), interpret=True))
    _assert_bitwise(got, tref.embedding_gather_ref(tt, torch.from_numpy(idx)))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("H,B,T,L", [(1, 2, 2, 3), (25, 4, 3, 6), (64, 2, 1, 11)])
def test_vmem_pool_kernel_matches_pallas_kernel(H, B, T, L, dtype, rng):
    jt, tt = _table(rng, (H, 128), dtype)
    pos = rng.integers(0, H, size=(B, T, L)).astype(np.int32)
    mask = (rng.random((B, T, L)) < 0.6).astype(np.int32)
    got = tk.vmem_gather_pool_kernel(tt, torch.from_numpy(pos), torch.from_numpy(mask))
    want = jk.vmem_gather_pool_kernel(jt, jnp.asarray(pos), jnp.asarray(mask), interpret=True)
    _assert_bitwise(got, want)
    ref = jref.embedding_bag_pinned_ref(jt, jnp.asarray(pos), jnp.asarray(mask))
    _assert_close(got, ref, _tol(dtype))
    _assert_close(tref.embedding_bag_pinned_ref(tt, torch.from_numpy(pos), torch.from_numpy(mask)),
                  ref, _tol(dtype))


def test_out_of_range_indices_clamp_as_the_reference(rng):
    """An index outside the table reads the row the reference's gathers (and
    its Pallas kernels in interpret mode) read: negative ones count from the
    end, and what is still outside is clamped."""
    jt, tt = _table(rng, (20, 128), "float32")
    flat = np.array([[[-3, 0, 19, 25, 7, -1, -40]]], dtype=np.int32)
    _assert_bitwise(tk.embedding_bag_kernel(tt, torch.from_numpy(flat)),
                    jk.embedding_bag_kernel(jt, jnp.asarray(flat), 20, interpret=True))
    _assert_bitwise(tk.embedding_gather_kernel(tt, torch.from_numpy(flat[0, 0])),
                    jk.embedding_gather_kernel(jt, jnp.asarray(flat[0, 0]), interpret=True))
    mask = np.ones_like(flat)
    _assert_bitwise(tk.vmem_gather_pool_kernel(tt, torch.from_numpy(flat), torch.from_numpy(mask)),
                    jk.vmem_gather_pool_kernel(jt, jnp.asarray(flat), jnp.asarray(mask),
                                               interpret=True))


def test_wrappers_refuse_what_they_do_not_take():
    t = torch.zeros((4, 8))
    i3 = torch.zeros((1, 2, 3), dtype=torch.int32)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tk.embedding_bag_kernel(t.half(), i3)
    with pytest.raises(TypeError, match="int32"):
        tk.embedding_gather_kernel(t, torch.zeros(3, dtype=torch.int64))
    with pytest.raises(ValueError, match=r"\(B, T, L\)"):
        tk.embedding_bag_kernel(t, i3[0])
    with pytest.raises(ValueError, match="share one"):
        tk.vmem_gather_pool_kernel(t, i3, i3[..., :2].contiguous())
    with pytest.raises(ValueError, match="rows, D >= 1"):
        tk.vmem_gather_pool_kernel(t[:0], i3, i3)
    with pytest.raises(ValueError, match="contiguous"):
        tk.embedding_gather_kernel(t.t(), torch.zeros(3, dtype=torch.int32))
