"""The port's LM kernel ops (K6 flash attention, K7 decode attention, K8
Mamba2 SSD) against the JAX package, on the CPU.

On the CPU each wrapper runs its plain torch version; the JAX side runs its
Pallas kernels in interpret mode (``use_pallas=True``), or its oracle where
its ops send a shape the kernels do not tile (ragged S or S_max). Inputs
are drawn with numpy and handed to both. Tolerances are the reference's own
(``tests/test_kernels.py``, ``tests/test_decode_kernel.py``): 2e-5 for f32
attention, 3e-2 (prefill) and 4e-2 (decode) for bf16, atol 2e-4 / rtol 2e-3
for the SSD scan.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention_kernel as jdecode_kernel
from repro.kernels.flash_attention import flash_attention_kernel as jflash_kernel
from repro_torch.kernels import launch_counts, ops, ref, reset_launch_counts
from repro_torch.kernels.decode_attention import (
    decode_attention_kernel,
    decode_attention_plain,
    decode_attention_split_plain,
)
from repro_torch.kernels.flash_attention import (
    flash_attention_bf16p_plain,
    flash_attention_kernel,
    flash_attention_plain,
)
from repro_torch.kernels import mamba2_ssd as ssd
from repro_torch.kernels.mamba2_ssd import kernel_chunk, mamba2_ssd_kernel, mamba2_ssd_plain

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(rng, shape, dtype, scale=1.0):
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(x, dtype=JDT[dtype]), torch.from_numpy(x).to(TDT[dtype])


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# --------------------------------------------------------------------------
# K6 flash attention
# --------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,Hq,Hkv,S,d", [
    (1, 2, 2, 128, 32),
    (2, 8, 2, 256, 64),     # GQA
    (1, 4, 1, 384, 64),     # MQA, three 128-blocks
    (2, 4, 4, 256, 128),
    (1, 4, 2, 100, 80),     # ragged S, d = 80 (the reference takes its oracle)
])
def test_flash_attention_matches_jax(B, Hq, Hkv, S, d, causal, rng):
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng, (B, h, S, d), "float32")
                                    for h in (Hq, Hkv, Hkv))
    want = jops.flash_attention(jq, jk, jv, causal=causal, use_pallas=True)
    reset_launch_counts()
    got = ops.flash_attention(tq, tk, tv, causal=causal)
    assert launch_counts()["flash_attention"] == 0      # the CPU runs the plain version
    assert got.shape == (B, Hq, S, d) and got.dtype == torch.float32
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("S,causal", [(128, True), (96, False)])
def test_flash_attention_bf16_matches_jax(S, causal, rng):
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng, (1, 2, S, 64), "bfloat16") for _ in range(3))
    want = jops.flash_attention(jq, jk, jv, causal=causal, use_pallas=True)
    got = ops.flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(want), atol=3e-2)


def test_flash_attention_takes_strided_views(rng):
    """Prefill hands K6 transposes of (B, S, H, d) projections."""
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng, (2, 64, 4, 16), "float32") for _ in range(3))
    tq, tk, tv = (t.transpose(1, 2) for t in (tq, tk, tv))
    jq, jk, jv = (t.transpose(0, 2, 1, 3) for t in (jq, jk, jv))
    want = jops.flash_attention(jq, jk, jv, causal=True, use_pallas=True)
    np.testing.assert_allclose(_f32(ops.flash_attention(tq, tk, tv)), _f32(want), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,d,block", [
    (128, 64, 64),
    (200, 80, 40),     # ragged against the card kernel's 128-row tiles; d = 80
    (72, 16, 24),
])
def test_flash_attention_bf16p_plain_matches_jax(S, d, block, causal, rng):
    """The tensor-core route rounds p to bf16 before p.v, a rounding point the
    reference does not have; its oracle stays inside the reference's bf16
    tolerance against the Pallas kernel (interpret mode)."""
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng, (2, h, S, d), "bfloat16") for h in (4, 2, 2))
    want = jflash_kernel(jq, jk, jv, causal=causal, block_q=block, block_k=block, interpret=True)
    got = flash_attention_bf16p_plain(tq, tk, tv, causal=causal)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 4, S, d)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=3e-2)
    # f32 inputs: the bf16 p alone moves the result by about 2^-9 |v|
    exact = flash_attention_plain(tq.float(), tk.float(), tv.float(), causal=causal)
    rounded = flash_attention_bf16p_plain(tq.float(), tk.float(), tv.float(), causal=causal)
    assert 0 < float((rounded - exact).abs().max()) < 1e-2


# --------------------------------------------------------------------------
# K7 decode attention
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,S,dh,valid", [
    (2, 8, 2, 256, 64, 200),
    (1, 4, 4, 512, 128, 512),     # MHA, full cache
    (3, 6, 1, 128, 64, 1),        # MQA, single valid entry
    (2, 16, 8, 384, 64, 300),     # ragged block
    (2, 4, 4, 1064, 80, 1056),    # Zamba2's cache: S_max % 512 != 0, d = 80
])
def test_decode_attention_matches_jax(B, Hq, Hkv, S, dh, valid, dtype, rng):
    jq, tq = _pair(rng, (B, Hq, dh), dtype)
    jk, tk = _pair(rng, (B, Hkv, S, dh), dtype)
    jv, tv = _pair(rng, (B, Hkv, S, dh), dtype)
    want = jops.decode_attention(jq, jk, jv, jnp.int32(valid), block_k=128, use_pallas=True)
    got = ops.decode_attention(tq, tk, tv, valid)
    assert got.shape == (B, Hq, dh) and got.dtype == TDT[dtype]
    tol = 2e-5 if dtype == "float32" else 4e-2
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)


def _split_cases():
    cases = []
    for S_max, chunk, block in ((192, 256, 64), (192, 64, 64), (200, 48, 40)):
        for valid in sorted({1, chunk, chunk + 1, S_max}):
            if valid <= S_max:
                cases.append((S_max, chunk, block, valid))
    return cases


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S_max,chunk,block,valid", _split_cases())
def test_decode_attention_split_matches_jax(S_max, chunk, block, valid, dtype, rng):
    """The card kernel's split over the cache (1, 3 and 5 chunks, empty chunks
    past valid_len) and its log-sum-exp merge, against the Pallas kernel in
    interpret mode, at the reference's tolerances."""
    B, Hq, Hkv, dh = 2, 4, 2, 32
    jq, tq = _pair(rng, (B, Hq, dh), dtype)
    jk, tk = _pair(rng, (B, Hkv, S_max, dh), dtype)
    jv, tv = _pair(rng, (B, Hkv, S_max, dh), dtype)
    want = jdecode_kernel(jq, jk, jv, jnp.int32(valid), block_k=block, interpret=True)
    got = decode_attention_split_plain(tq, tk, tv, valid, chunk)
    assert got.shape == (B, Hq, dh) and got.dtype == TDT[dtype]
    tol = 2e-5 if dtype == "float32" else 4e-2
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)
    if dtype == "float32":
        np.testing.assert_allclose(_f32(got), _f32(decode_attention_plain(tq, tk, tv, valid)),
                                   atol=2e-6, rtol=2e-5)
    # the cache past valid_len is never read
    tk[:, :, valid:] = float("nan")
    tv[:, :, valid:] = float("nan")
    assert torch.equal(decode_attention_split_plain(tq, tk, tv, valid, chunk), got)


def test_decode_attention_masks_stale_cache(rng):
    """Entries at or past valid_len must not contribute."""
    B, H, S, dh, valid = 1, 2, 64, 32, 10
    jq, tq = _pair(rng, (B, H, dh), "float32")
    jk, tk = _pair(rng, (B, H, S, dh), "float32")
    jv, tv = _pair(rng, (B, H, S, dh), "float32")
    pk, pv = tk.clone(), tv.clone()
    pk[:, :, valid:] = 1e3
    pv[:, :, valid:] = 1e3
    clean = ops.decode_attention(tq, tk, tv, valid)
    poisoned = ops.decode_attention(tq, pk, pv, valid)
    np.testing.assert_allclose(_f32(poisoned), _f32(clean), atol=1e-5)
    want = jops.decode_attention(jq, jk.at[:, :, valid:].set(1e3), jv.at[:, :, valid:].set(1e3),
                                 jnp.int32(valid), block_k=16)
    np.testing.assert_allclose(_f32(poisoned), _f32(want), atol=2e-5, rtol=2e-5)


# --------------------------------------------------------------------------
# K8 Mamba2 SSD
# --------------------------------------------------------------------------

def _ssd_inputs(rng, B, H, S, P, N, dtype="float32"):
    jx, tx = _pair(rng, (B, H, S, P), dtype, 0.5)
    dt = rng.uniform(0.001, 0.1, size=(B, H, S)).astype(np.float32)
    A = -np.exp(rng.standard_normal(H).astype(np.float32))
    adt = (A[None, :, None] * dt).astype(np.float32)
    jb, tb = _pair(rng, (B, S, N), dtype, 0.3)
    jc, tc = _pair(rng, (B, S, N), dtype, 0.3)
    j = (jx, jnp.asarray(adt), jnp.asarray(dt), jb, jc)
    t = (tx, torch.from_numpy(adt), torch.from_numpy(dt), tb, tc)
    return j, t


@pytest.mark.parametrize("B,H,S,P,N,chunk", [
    (1, 2, 64, 16, 32, 16),
    (2, 4, 256, 32, 64, 64),
    (1, 3, 128, 64, 128, 128),    # N = 128: the f32 route's chunk halves to 64
    (2, 2, 100, 16, 16, 32),      # ragged last chunk (the reference takes its oracle)
    (1, 2, 1024, 64, 64, 128),    # Zamba2's SSD shape (narrow heads)
])
def test_mamba2_ssd_matches_jax(B, H, S, P, N, chunk, rng):
    j, t = _ssd_inputs(rng, B, H, S, P, N)
    want = jops.mamba2_ssd(*j, chunk=chunk, use_pallas=True)
    reset_launch_counts()
    got = ops.mamba2_ssd(*t, chunk=chunk)
    assert launch_counts()["mamba2_ssd"] == 0
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-4, rtol=2e-3)
    np.testing.assert_allclose(_f32(got), _f32(ref.mamba2_ssd_ref(*t)), atol=2e-4, rtol=2e-3)


def test_mamba2_ssd_bf16_matches_jax(rng):
    """x, B, C in bf16 with adt, dt in f32, as the Mamba2 block hands them.
    Both round one f32 result to bf16, so they may differ by one bf16 step
    (2^-7 relative) beyond the reference's 2e-4."""
    j, t = _ssd_inputs(rng, 2, 2, 64, 16, 16, "bfloat16")
    want = jops.mamba2_ssd(*j, chunk=32, use_pallas=True)
    got = ops.mamba2_ssd(*t, chunk=32)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-4, rtol=2.0 ** -7)


def test_mamba2_ssd_ref_matches_jax_oracle(rng):
    j, t = _ssd_inputs(rng, 2, 3, 48, 16, 8)
    np.testing.assert_allclose(_f32(ref.mamba2_ssd_ref(*t)), _f32(jref.mamba2_ssd_ref(*j)),
                               atol=1e-5, rtol=1e-4)


def test_mamba2_final_state_matches_jax(rng):
    j, t = _ssd_inputs(rng, 2, 3, 96, 16, 32)
    np.testing.assert_allclose(_f32(ref.mamba2_final_state(*t[:4])),
                               _f32(jref.mamba2_final_state(*j[:4])), atol=1e-5, rtol=1e-4)


def test_mamba2_ssd_chunk_choice():
    # the f32 route (scalar kernel, f32 tiles)
    assert kernel_chunk(128, 1024, 64, 64) == 128      # Zamba2: 182,784 B of shared memory
    assert kernel_chunk(128, 1024, 64, 128) == 64      # N = 128 does not fit at 128
    assert kernel_chunk(128, 40, 64, 64) == 40         # never longer than S
    assert kernel_chunk(16, 1024, 16, 16) == 16
    # the bf16 route keeps bf16 tiles: N = 128 fits a chunk of 128
    bf = torch.bfloat16
    assert kernel_chunk(128, 1024, 64, 64, bf) == 128
    assert kernel_chunk(128, 1024, 64, 128, bf) == 128
    assert kernel_chunk(128, 5, 64, 64, bf) == 5
    assert kernel_chunk(100, 300, 32, 32, bf) == 100


@pytest.mark.parametrize("P,got", [
    (1, 16), (8, 16), (16, 16), (17, 32), (24, 32), (32, 32), (40, 16), (48, 16), (56, 64),
    (64, 64),
])
def test_mamba2_ssd_p_slice_choice(P, got):
    """The head dim padded to 16 runs at ``P_SLICE`` (64) where that divides
    it, else at the widest slice that does."""
    Pp = ssd.mma_widths(P, 64)[0]
    assert ssd.p_slice(Pp) == got
    assert Pp % got == 0


def test_mamba2_ssd_p_slice_follows_the_module_constant(monkeypatch):
    """``p_slice`` reads ``P_SLICE`` when it is called (scripts/ssd_ablation.py
    sets it to time the narrower slices)."""
    monkeypatch.setattr(ssd, "P_SLICE", 32)
    assert (ssd.p_slice(64), ssd.p_slice(32), ssd.p_slice(48)) == (32, 32, 16)
    monkeypatch.setattr(ssd, "P_SLICE", 16)
    assert ssd.p_slice(64) == 16


@pytest.mark.parametrize("P,N,want", [
    (64, 64, (64, 64)), (16, 16, (16, 16)), (20, 100, (32, 128)), (8, 3, (16, 16)),
    (64, 128, (64, 128)), (33, 40, (48, 64)),
])
def test_mamba2_ssd_mma_widths(P, N, want):
    assert ssd.mma_widths(P, N) == want


def test_mamba2_ssd_mma_smem_two_blocks_at_zamba2():
    """The bf16 route's block at Zamba2's shape (chunk 128, N 64, P-slice
    64): two fit one SM's 228 KB (1 KB reserved per block); its tiles are
    bf16, so N = 128 fits one block without halving the chunk."""
    assert ssd.mma_smem_bytes(128, 64, 64) == 93_184
    assert 2 * (ssd.mma_smem_bytes(128, 64, 64) + 1024) <= 228 * 1024
    assert ssd.mma_smem_bytes(100, 32, 64) == ssd.mma_smem_bytes(112, 32, 64)
    assert ssd.mma_smem_bytes(128, 64, 128) <= ssd.SMEM_LIMIT


@pytest.mark.parametrize("Q,ps,N,blocks", [
    (128, 64, 64, 2), (128, 32, 64, 3), (128, 16, 64, 4), (128, 64, 128, 1), (128, 32, 128, 2),
    (16, 16, 16, 35), (5, 64, 64, 5),
])
def test_mamba2_ssd_mma_smem_blocks_per_sm(Q, ps, N, blocks):
    """Blocks of the bf16 route that one SM's 228 KB of shared memory holds
    (1 KB reserved per block); every shape fits the per-block opt-in."""
    assert 228 * 1024 // (ssd.mma_smem_bytes(Q, ps, N) + 1024) == blocks
    assert ssd.mma_smem_bytes(Q, ps, N) <= ssd.SMEM_LIMIT


@pytest.mark.parametrize("S,Q", [(1024, 128), (300, 128), (100, 16), (5, 5), (257, 100)])
def test_chunk_cumsum_plain_is_the_in_order_sum(S, Q, rng):
    """The pre-pass's plain twin equals ``_cumsum_in_order`` chunk by chunk,
    bit for bit (the kernel pre-pass is held to it on the card)."""
    adt = torch.from_numpy(-rng.uniform(0.0, 16.0, size=(2, 3, S)).astype(np.float32))
    got = ssd.chunk_cumsum_plain(adt, Q)
    for c0 in range(0, S, Q):
        want = ssd._cumsum_in_order(adt[..., c0:c0 + Q])
        assert torch.equal(got[..., c0:c0 + Q].view(torch.int32), want.view(torch.int32))


def test_mamba2_ssd_hands_the_copies_readable_tiles():
    """The bf16 route reads rows in 16-byte pieces: views whose rows start on
    16 bytes go as they are, others are copied, and widths it does not take
    are padded with zeros."""
    xbc = torch.randn(2, 300, 4 * 64 + 2 * 64).to(torch.bfloat16)
    x = xbc[..., :256].reshape(2, 300, 4, 64).transpose(1, 2)       # the Mamba2 block's views
    Bm, C = xbc[..., 256:320], xbc[..., 320:]
    assert ssd._mma_ready(x, 64) is x
    assert ssd._mma_ready(Bm, 64) is Bm and ssd._mma_ready(C, 64) is C
    odd = torch.randn(2, 300, 64 + 4).to(torch.bfloat16)[..., 4:]  # rows 8 bytes off
    got = ssd._mma_ready(odd, 64)
    assert got is not odd and got.is_contiguous() and torch.equal(got, odd)
    wide = torch.randn(2, 300, 72).to(torch.bfloat16)[..., :70]    # stride 72, width 70
    got = ssd._mma_ready(wide, 128)
    assert got.shape == (2, 300, 128) and torch.equal(got[..., :70], wide)
    assert not got[..., 70:].any()
    # a length-1 dimension's stride is never stepped over
    one = torch.zeros(1, 8, 4, 64, dtype=torch.bfloat16)[:, :, 1:2]
    assert ssd._strides(one, 3) == [0, 256, 0]
    assert ssd._mma_ready(one.transpose(1, 2), 64) is not None


@pytest.mark.parametrize("N", [16, 128])
def test_mamba2_ssd_bf16_chunk_128_matches_jax(N, rng):
    """bf16 at N = 128 now runs a chunk of 128 (the f32 route halves it):
    still within the reference's tolerance plus one bf16 step."""
    j, t = _ssd_inputs(rng, 1, 2, 256, 32, N, "bfloat16")
    want = jops.mamba2_ssd(*j, chunk=128, use_pallas=True)
    got = ops.mamba2_ssd(*t, chunk=128)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-4, rtol=2.0 ** -7)


def test_mamba2_ssd_plain_is_chunk_invariant(rng):
    """The chunk changes only rounding: any chunk gives the sequential scan."""
    _, t = _ssd_inputs(rng, 1, 2, 90, 16, 16)
    seq = ref.mamba2_ssd_ref(*t)
    for chunk in (1, 7, 32, 128):
        np.testing.assert_allclose(_f32(mamba2_ssd_plain(*t, chunk)), _f32(seq), atol=2e-4,
                                   rtol=2e-3)


# --------------------------------------------------------------------------
# What the wrappers hand the card kernels, and what they refuse
# --------------------------------------------------------------------------

def test_flash_attention_hands_tma_readable_tensors():
    """The tensor-core route reads through TMA: 16-byte strides or a copy."""
    from repro_torch.kernels.flash_attention import _strides, _tma_ready

    v = torch.zeros(2, 300, 4, 80, dtype=torch.bfloat16).transpose(1, 2)   # prefill's views
    assert _tma_ready(v) is v
    k = torch.zeros(2, 4, 300, 84, dtype=torch.bfloat16)[..., :80]        # s-stride 168 bytes
    assert not k.is_contiguous() and _tma_ready(k).is_contiguous()
    assert torch.equal(_tma_ready(k), k)
    # a dim of length 1 gets its contiguous stride, whatever the view says
    one = torch.zeros(1, 8, 4, 80, dtype=torch.bfloat16)[:, :, 1:2]
    assert one.stride()[:3] == (2560, 320, 80) and _strides(one) == [8 * 80, 320, 80]


def test_decode_attention_chunk_halves_until_it_fits():
    from repro_torch.kernels.decode_attention import CHUNK, MIN_CHUNK, SMEM_LIMIT, kernel_chunk

    def smem(G, dh, dtype, chunk):
        return chunk * G * 1000
    assert kernel_chunk(1, 80, torch.bfloat16, smem) == CHUNK
    assert kernel_chunk(SMEM_LIMIT // (1000 * CHUNK // 4), 80, torch.bfloat16, smem) == CHUNK // 4
    assert kernel_chunk(SMEM_LIMIT // (1000 * MIN_CHUNK) + 1, 80, torch.bfloat16, smem) == 0


# --------------------------------------------------------------------------
# What the wrappers refuse
# --------------------------------------------------------------------------

def test_lm_kernels_refuse_what_they_do_not_take(rng):
    q = torch.zeros(1, 3, 8, 16)
    kv = torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        flash_attention_kernel(q, kv, kv)
    big = torch.zeros(1, 1, 8, 264)
    with pytest.raises(ValueError, match="head dim 264 > 256"):
        flash_attention_kernel(big, big, big)
    with pytest.raises(TypeError, match="share float32 or bfloat16"):
        flash_attention_kernel(kv.double(), kv.double(), kv.double())
    with pytest.raises(ValueError, match="multiple of kv heads"):
        decode_attention_kernel(torch.zeros(1, 3, 16), kv, kv, 4)
    with pytest.raises(ValueError, match="valid_len must be a host int"):
        decode_attention_kernel(torch.zeros(1, 2, 16), kv, kv, torch.tensor(4))
    with pytest.raises(ValueError, match="valid_len must be a host int"):
        decode_attention_kernel(torch.zeros(1, 2, 16), kv, kv, 0)
    _, (x, adt, dt, Bm, C) = _ssd_inputs(rng, 1, 2, 16, 16, 8)
    with pytest.raises(ValueError, match="head dim 80 > 64"):
        mamba2_ssd_kernel(torch.zeros(1, 2, 16, 80), adt, dt, Bm, C)
    with pytest.raises(TypeError, match="adt and dt must be float32"):
        mamba2_ssd_kernel(x, adt.double(), dt, Bm, C)
    with pytest.raises(TypeError, match="x, B, C must share"):
        mamba2_ssd_kernel(x, adt, dt, Bm.bfloat16(), C)
    with pytest.raises(ValueError, match="do not agree"):
        mamba2_ssd_kernel(x, adt, dt, Bm[:, :8], C[:, :8])
