"""The port's LM layers and families against the JAX package, on the CPU.

Weights come from the reference's ``init`` functions and cross over as
numpy arrays (``convert.lm_params_from_jax``); tokens are drawn with numpy.
The JAX side runs its Pallas kernels in interpret mode (``use_pallas=True``)
and its families compiled with XLA's excess precision off
(``xla_allow_excess_precision``): by default XLA's CPU fusions keep chains of
bf16 element-wise ops in f32, rounding points the reference's code does not
name, and the random smoke models amplify that difference through their
layers. At the rounding points the code names, the port matches the
reference bit for bit in bf16 on the Zamba2 forward. Tolerances: f32 at
atol 2e-4 / rtol 2e-3 (the reference's SSD tolerance, which catches layout
errors bf16 would hide), bf16 at 8e-2 (``tests/test_serving.py``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import family_module as jfamily
from repro.models import get_smoke_config as jsmoke
from repro.models import layers as JL
from repro.models import registry as jregistry
from repro.models import transformer as JT
from repro_torch.convert import arch_config_from_dict, lm_params_from_jax
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.models import ARCH_IDS, family_module, get_config, get_smoke_config, param_count
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT

KEY = jax.random.PRNGKey(0)
ARCHS = ["zamba2_2p7b", "mamba2_130m", "stablelm_3b", "command_r_plus_104b"]
TOL = {"float32": dict(atol=2e-4, rtol=2e-3), "bfloat16": dict(atol=8e-2, rtol=0)}


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)


def _torch_tree(tree, dtype):
    """A reference layer tree as torch tensors; f32 leaves stay f32."""
    def conv(x):
        t = torch.from_numpy(np.array(x, np.float32))
        return t if x.dtype == jnp.float32 else t.to(dtype)
    return jax.tree_util.tree_map(conv, tree)


def _jax_exact(fn, *args):
    """``fn(*args)`` compiled by XLA with its excess precision off."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def _models(arch, dtype):
    jcfg = jsmoke(arch).replace(dtype=dtype)
    cfg = get_smoke_config(arch).replace(dtype=dtype)
    jmod, tmod = jfamily(jcfg), family_module(cfg)
    jp = jmod.init_lm(KEY, jcfg)
    tp = tmod.init_lm(cfg, device="cpu")
    tp.load_state_dict(lm_params_from_jax(_np_tree(jp), cfg))
    return jcfg, cfg, jmod, tmod, jp, tp


def _close(got, want, dtype):
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL[dtype])


# --------------------------------------------------------------------------
# Configurations
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", jregistry.ARCH_IDS)
def test_param_count_matches_reference(arch):
    jcfg = jregistry.get_config(arch)
    cfg = arch_config_from_dict(dataclasses.asdict(jcfg))
    assert get_config(arch) == cfg
    assert param_count(cfg) == jregistry.param_count(jcfg)
    assert param_count(cfg, active_only=True) == jregistry.param_count(jcfg, active_only=True)


def test_zamba2_full_width():
    cfg = get_config("zamba2-2.7b")
    s = cfg.ssm
    assert (cfg.n_layers, cfg.d_model, s.d_inner(cfg.d_model), s.num_heads(cfg.d_model)) == \
        (54, 2560, 5120, 80)
    assert (s.head_dim, s.state_dim, s.chunk, cfg.n_heads, cfg.n_kv_heads, cfg.attn_head_dim,
            cfg.hybrid.shared_d_ff, cfg.vocab) == (64, 64, 128, 32, 32, 80, 10240, 32000)
    assert param_count(cfg) == 2_422_670_240
    assert tuple(ARCH_IDS) == tuple(jregistry.ARCH_IDS)


@pytest.mark.parametrize("arch", jregistry.ARCH_IDS)
def test_every_architecture_resolves_as_in_the_reference(arch):
    """``get_config``/``get_smoke_config`` equal the reference's, and
    ``family_module`` names the reference's family module."""
    assert get_config(arch) == arch_config_from_dict(dataclasses.asdict(jregistry.get_config(arch)))
    smoke = get_smoke_config(arch)
    assert smoke == arch_config_from_dict(dataclasses.asdict(jsmoke(arch)))
    assert family_module(smoke).__name__.rsplit(".", 1)[1] == \
        jfamily(jsmoke(arch)).__name__.rsplit(".", 1)[1]


def test_converter_checks_every_shape():
    jcfg = jsmoke("zamba2_2p7b")
    cfg = get_smoke_config("zamba2_2p7b")
    tree = _np_tree(jfamily(jcfg).init_lm(KEY, jcfg))
    state = lm_params_from_jax(tree, cfg)
    assert state["groups.mixer.in_xbc"].shape == (2, 2, 64, 128 + 2 * 16)
    assert state["groups.mixer.a_log"].dtype == torch.float32
    assert state["shared.attn.wq"].dtype == torch.bfloat16
    bad = jax.tree_util.tree_map(lambda x: x, tree)
    bad["shared"]["attn"]["wq"] = bad["shared"]["attn"]["wq"][:, :-1]
    with pytest.raises(ValueError, match="shared.attn.wq has shape"):
        lm_params_from_jax(bad, cfg)
    del tree["head"]
    with pytest.raises(ValueError, match="missing \\['head.w'\\]"):
        lm_params_from_jax(tree, cfg)


def test_bf16_goes_through_f32_exactly():
    jcfg = jsmoke("stablelm_3b")
    jp = jfamily(jcfg).init_lm(KEY, jcfg)
    state = lm_params_from_jax(_np_tree(jp), get_smoke_config("stablelm_3b"))
    want = np.asarray(jp["layers"]["attn"]["wq"]).view(np.uint16)
    assert np.array_equal(state["layers.attn.wq"].view(torch.int16).numpy().view(np.uint16), want)


# --------------------------------------------------------------------------
# Layers (eager JAX on both sides: one op at a time)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_and_rope_match(dtype, rng):
    x = rng.standard_normal((2, 4, 10, 16)).astype(np.float32) * 3
    jx, tx = jnp.asarray(x, jnp.dtype(dtype)), torch.from_numpy(x).to(TL.DTYPES[dtype])
    scale = rng.standard_normal(16).astype(np.float32)
    got = TL.rmsnorm({"scale": torch.from_numpy(scale)}, tx, 1e-5)
    want = JL.rmsnorm({"scale": jnp.asarray(scale)}, jx, 1e-5)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-6 if dtype == "float32" else 0,
                               rtol=1e-5 if dtype == "float32" else 0)
    pos = np.arange(7, 17)
    got = TL.apply_rope(tx, torch.from_numpy(pos), 10000.0)
    want = JL.apply_rope(jx, jnp.asarray(pos), 10000.0)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-5 if dtype == "float32" else 1e-2)
    assert got.dtype == tx.dtype


def _attn_setup(rng, dtype="float32", Hq=4, Hkv=2):
    jcfg = jsmoke("stablelm_3b").replace(n_heads=Hq, n_kv_heads=Hkv, dtype=dtype)
    cfg = get_smoke_config("stablelm_3b").replace(n_heads=Hq, n_kv_heads=Hkv, dtype=dtype)
    jp = JL.init_attention(KEY, jcfg, jnp.dtype(dtype))
    return jcfg, cfg, jp, _torch_tree(jp, TL.DTYPES[dtype])


def test_attention_prefill_and_decode_with_cache(rng):
    jcfg, cfg, jp, tp = _attn_setup(rng)
    B, S, S_max, dh = 2, 12, 20, cfg.attn_head_dim
    x = rng.standard_normal((B, S + 1, cfg.d_model)).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    zeros = np.zeros((B, cfg.n_kv_heads, S_max, dh), np.float32)
    jc = (jnp.asarray(zeros), jnp.asarray(zeros))
    tc = (torch.zeros(zeros.shape), torch.zeros(zeros.shape))
    jo, jc = JL.attention(jp, jx[:, :S], jcfg, kv_cache=jc, cache_index=jnp.int32(0),
                          use_pallas=True, prefill=True)
    to, tc = TL.attention(tp, tx[:, :S], cfg, kv_cache=tc, cache_index=0, prefill=True)
    np.testing.assert_allclose(_f32(to), _f32(jo), atol=2e-5, rtol=2e-5)
    for a, b in zip(tc, jc):
        np.testing.assert_allclose(_f32(a), _f32(b), atol=1e-6)
    # one new token through the decode kernel's route
    pos = jnp.arange(S, S + 1)
    jo, jc = JL.attention(jp, jx[:, S:], jcfg, positions=pos, kv_cache=jc,
                          cache_index=jnp.int32(S), use_pallas=True)
    reset_launch_counts()
    to, tc = TL.attention(tp, tx[:, S:], cfg, positions=torch.arange(S, S + 1), kv_cache=tc,
                          cache_index=S)
    assert launch_counts()["decode_attention"] == 0
    np.testing.assert_allclose(_f32(to), _f32(jo), atol=2e-5, rtol=2e-5)
    for a, b in zip(tc, jc):
        np.testing.assert_allclose(_f32(a), _f32(b), atol=1e-6)


def test_attention_no_cache_matches(rng):
    jcfg, cfg, jp, tp = _attn_setup(rng, "bfloat16", Hq=4, Hkv=1)
    x = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    jo, _ = JL.attention(jp, jnp.asarray(x, jnp.bfloat16), jcfg, use_pallas=True)
    to, _ = TL.attention(tp, torch.from_numpy(x).bfloat16(), cfg)
    np.testing.assert_allclose(_f32(to), _f32(jo), atol=3e-2)


def test_cache_write_clamps_like_dynamic_update_slice(rng):
    """Three new tokens at index S_max - 1 move back to S_max - 3, as
    jax.lax.dynamic_update_slice clamps; attention sees cache_index + 3."""
    jcfg, cfg, jp, tp = _attn_setup(rng)
    B, S_max, dh = 2, 10, cfg.attn_head_dim
    cache = rng.standard_normal((B, cfg.n_kv_heads, S_max, dh)).astype(np.float32)
    x = rng.standard_normal((B, 3, cfg.d_model)).astype(np.float32)
    pos = np.arange(S_max - 1, S_max + 2)
    jo, jc = JL.attention(jp, jnp.asarray(x), jcfg, positions=jnp.asarray(pos),
                          kv_cache=(jnp.asarray(cache), jnp.asarray(cache)),
                          cache_index=jnp.int32(S_max - 1), use_pallas=True)
    tc = (torch.from_numpy(cache.copy()), torch.from_numpy(cache.copy()))
    to, tc = TL.attention(tp, torch.from_numpy(x), cfg, positions=torch.from_numpy(pos),
                          kv_cache=tc, cache_index=S_max - 1)
    np.testing.assert_allclose(_f32(to), _f32(jo), atol=2e-5, rtol=2e-5)
    for a, b in zip(tc, jc):
        np.testing.assert_allclose(_f32(a), _f32(b), atol=1e-6)
    assert np.array_equal(_f32(tc[0])[:, :, :S_max - 3], cache[:, :, :S_max - 3])
    t = torch.zeros(1, 1, 5, 2)
    assert TL.write_cache(t, torch.ones(1, 1, 2, 2), 4) == 3
    assert t[0, 0, :, 0].tolist() == [0, 0, 0, 1, 1]
    with pytest.raises(ValueError, match="cannot write 6 positions"):
        TL.write_cache(t, torch.ones(1, 1, 6, 2), 0)


def test_multi_token_cached_step_runs_only_on_the_cpu(rng):
    """Several new tokens against a cache take plain torch attention, which
    no kernel covers: off the CPU (here the meta device) that raises."""
    _, cfg, _, tp = _attn_setup(rng)
    meta = {k: v.to("meta") for k, v in tp.items()}
    cache = (torch.zeros(2, cfg.n_kv_heads, 10, cfg.attn_head_dim, device="meta"),) * 2
    with pytest.raises(NotImplementedError, match="cached step of 3 new tokens"):
        TL.attention(meta, torch.zeros(2, 3, cfg.d_model, device="meta"), cfg,
                     kv_cache=cache, cache_index=4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swiglu_matches(dtype, rng):
    jp = JL.init_swiglu(KEY, 32, 48, jnp.dtype(dtype))
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    got = TL.swiglu(_torch_tree(jp, TL.DTYPES[dtype]), torch.from_numpy(x).to(TL.DTYPES[dtype]))
    want = JL.swiglu(jp, jnp.asarray(x, jnp.dtype(dtype)))
    np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-5 if dtype == "float32" else 1e-2,
                               rtol=1e-5 if dtype == "float32" else 0)


def test_silu_rounds_where_jax_rounds(rng):
    x = rng.standard_normal(4096).astype(np.float32) * 4
    got = TL.silu(torch.from_numpy(x).bfloat16())
    want = jax.nn.silu(jnp.asarray(x, jnp.bfloat16))
    assert np.array_equal(_f32(got), _f32(want))


def test_causal_conv1d_state(rng):
    x = rng.standard_normal((2, 7, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    st = rng.standard_normal((2, 3, 6)).astype(np.float32)
    for state in (None, st):
        jy, jst = JL._causal_conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                    None if state is None else jnp.asarray(state))
        ty, tst = TL._causal_conv1d(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                                    None if state is None else torch.from_numpy(state))
        np.testing.assert_allclose(_f32(ty), _f32(jy), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(_f32(tst), _f32(jst), atol=0)
    # the state is the last W-1 rows of the input before the conv
    assert np.array_equal(_f32(tst), x[:, -3:])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_block_with_and_without_state(dtype, rng):
    jcfg = jsmoke("mamba2_130m").replace(dtype=dtype)
    cfg = get_smoke_config("mamba2_130m").replace(dtype=dtype)
    jp = JL.init_mamba2(KEY, jcfg, jnp.dtype(dtype))
    tp = _torch_tree(jp, TL.DTYPES[dtype])
    x = rng.standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    jx, tx = jnp.asarray(x, jnp.dtype(dtype)), torch.from_numpy(x).to(TL.DTYPES[dtype])
    tol = dict(atol=2e-4, rtol=2e-3) if dtype == "float32" else dict(atol=2e-2, rtol=0)
    # prompt pass (ragged: 37 = 32 + 5) with the closed-form final state
    jy, jst, jcv = _jax_exact(
        lambda p, x: JL.mamba2_block(p, x, jcfg, use_pallas=True, return_final_state=True),
        jp, jx[:, :37])
    ty, tst, tcv = TL.mamba2_block(tp, tx[:, :37], cfg, return_final_state=True)
    for a, b in ((ty, jy), (tst, jst), (tcv, jcv)):
        np.testing.assert_allclose(_f32(a), _f32(b), **tol)
    # then one and three tokens stepping from that state
    step = lambda p, x, st, cv: JL.mamba2_block(p, x, jcfg, ssm_state=st, conv_state=cv)
    for lo, hi in ((37, 38), (37, 40)):
        jy, jst2, jcv2 = _jax_exact(step, jp, jx[:, lo:hi], jst, jcv)
        ty, tst2, tcv2 = TL.mamba2_block(tp, tx[:, lo:hi], cfg, ssm_state=tst, conv_state=tcv)
        for a, b in ((ty, jy), (tst2, jst2), (tcv2, jcv2)):
            np.testing.assert_allclose(_f32(a), _f32(b), **tol)


# --------------------------------------------------------------------------
# Families: forward, prefill + decode
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches(arch, dtype, rng):
    jcfg, cfg, jmod, tmod, jp, tp = _models(arch, dtype)
    toks = rng.integers(0, cfg.vocab, (2, 64)).astype(np.int32)
    want = _jax_exact(lambda p, t: jmod.forward(p, t, jcfg, use_pallas=True), jp, jnp.asarray(toks))
    with torch.inference_mode():
        got = tmod.forward(tp, torch.from_numpy(toks), cfg)
    assert got.shape == (2, 64, cfg.vocab) and got.dtype == TL.DTYPES[dtype]
    _close(got, want, dtype)


def _jax_prefill_decode(jcfg, jmod, jp, toks, max_seq):
    S = toks.shape[1] - 1
    if jcfg.family == "hybrid":
        pre = functools.partial(jmod.prefill_with_state, cfg=jcfg, use_pallas=True,
                                max_seq=max_seq)
        first, caches = _jax_exact(lambda p, t: pre(p, t), jp, toks[:, :S])
    elif jcfg.family == "ssm":
        first, caches = _jax_exact(
            lambda p, t: jmod.prefill_with_state(p, t, jcfg, use_pallas=True), jp, toks[:, :S])
    else:
        caches = JT.init_kv_cache(jcfg, toks.shape[0], max_seq)
        first, caches = _jax_exact(
            lambda p, t, c: JT.prefill(p, t, c, jcfg, use_pallas=True), jp, toks[:, :S], caches)
    last, new = _jax_exact(
        lambda p, t, i, c: jmod.decode_step(p, t, i, c, jcfg, use_pallas=True),
        jp, toks[:, S:], jnp.int32(S), caches)
    return first, caches, last, new


@pytest.mark.parametrize("S", [24, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match(arch, dtype, S, rng):
    jcfg, cfg, jmod, tmod, jp, tp = _models(arch, dtype)
    max_seq = 80
    toks = rng.integers(0, cfg.vocab, (2, S + 1)).astype(np.int32)
    jfirst, jcaches, jlast, _ = _jax_prefill_decode(jcfg, jmod, jp, jnp.asarray(toks), max_seq)
    tt = torch.from_numpy(toks)
    with torch.inference_mode():
        if cfg.family == "hybrid":
            first, caches = tmod.prefill_with_state(tp, tt[:, :S], cfg, max_seq=max_seq)
        elif cfg.family == "ssm":
            first, caches = tmod.prefill_with_state(tp, tt[:, :S], cfg)
        else:
            caches = TT.init_kv_cache(cfg, 2, max_seq, device="cpu")
            first, caches = TT.prefill(tp, tt[:, :S], caches, cfg)
        _close(first, jfirst, dtype)
        for a, b in zip(jax.tree_util.tree_leaves(caches), jax.tree_util.tree_leaves(jcaches)):
            assert tuple(a.shape) == b.shape
            _close(a, b, dtype)
        last, _ = tmod.decode_step(tp, tt[:, S:], S, caches, cfg)
    _close(last, jlast, dtype)


def test_decode_launches_no_kernel_on_the_cpu(rng):
    """The CPU runs the plain versions: the kernels' counts stay at 0."""
    _, cfg, _, tmod, _, tp = _models("zamba2_2p7b", "bfloat16")
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 9)).astype(np.int32))
    reset_launch_counts()
    with torch.inference_mode():
        _, caches = tmod.prefill_with_state(tp, toks[:, :8], cfg, max_seq=16)
        tmod.decode_step(tp, toks[:, 8:], 8, caches, cfg)
    assert not any(launch_counts().values())
