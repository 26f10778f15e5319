"""The port's MoE FFN, MLA attention, GELU MLP and layer norm, and the
transformer families that use them (deepseek_v2_lite_16b: MLA + MoE with
shared experts; arctic_480b: MoE beside a dense residual MLP; chameleon_34b:
the vlm family; granite_34b / granite_20b: MQA + the GELU MLP), against the
JAX package on the CPU.

Weights come from the reference's ``init_*`` functions and cross over as
numpy arrays (``convert.lm_params_from_jax``); inputs are drawn with numpy.
The JAX side runs ``use_pallas=True`` and is compiled with XLA's excess
precision off, as in ``test_torch_lm.py``. Tolerances: f32 at atol 2e-4 /
rtol 2e-3, bf16 at 8e-2 (``tests/test_serving.py``). The MoE layer in bf16
is held bit for bit in all but one element in a thousand (its combine adds
in the reference's order; an expert product's f32 sum, ordered otherwise
than XLA's, can round to the other bf16 neighbour), and those within two
bf16 steps.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_lm import KEY, _close, _f32, _jax_exact, _torch_tree

from repro.kernels import ref as jref
from repro.models import family_module as jfamily
from repro.models import get_smoke_config as jsmoke
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.convert import arch_config_from_dict, lm_params_from_jax
from repro_torch.kernels import launch_counts, ops, reset_launch_counts
from repro_torch.models import family_module, get_config, get_smoke_config
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT

ARCHS = ["deepseek_v2_lite_16b", "arctic_480b", "chameleon_34b", "granite_34b", "granite_20b"]


def _models(arch, dtype):
    jcfg = jsmoke(arch).replace(dtype=dtype)
    cfg = get_smoke_config(arch).replace(dtype=dtype)
    jp = jfamily(jcfg).init_lm(KEY, jcfg)
    tp = family_module(cfg).init_lm(cfg, device="cpu")
    tp.load_state_dict(lm_params_from_jax(
        jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), jp), cfg))
    return jcfg, cfg, jp, tp


# --------------------------------------------------------------------------
# Configurations
# --------------------------------------------------------------------------

def test_deepseek_full_width():
    cfg = get_config("deepseek-v2-lite-16b")
    m, e = cfg.mla, cfg.moe
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, m.kv_lora_rank, m.qk_rope_head_dim,
            m.qk_nope_head_dim, m.v_head_dim) == (27, 2048, 16, 512, 64, 128, 128)
    assert (e.num_experts, e.top_k, e.num_shared_experts, e.d_ff_expert, e.d_ff_shared,
            e.dispatch_groups, e.capacity_factor) == (64, 6, 2, 1408, 2816, 16, 1.25)
    assert cfg.param_count() == 16_210_311_168
    tree = TT.init_params(cfg, generator=None, device=torch.device("meta"))
    assert sum(t.numel() for t in jax.tree_util.tree_leaves(tree)) == cfg.param_count()


def test_converter_keeps_the_router_f32_and_checks_shapes():
    jcfg, cfg = jsmoke("deepseek_v2_lite_16b"), get_smoke_config("deepseek_v2_lite_16b")
    tree = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32),
                                  jfamily(jcfg).init_lm(KEY, jcfg))
    state = lm_params_from_jax(tree, cfg)
    assert state["layers.moe.router"].dtype == torch.float32
    assert state["layers.moe.wg"].dtype == torch.bfloat16
    assert state["layers.moe.wg"].shape == (2, 4, 64, 48)
    assert state["layers.attn.w_dkv"].shape == (2, 64, 32 + 8)
    assert state["layers.moe.shared.wd"].shape == (2, 48, 64)
    tree["layers"]["attn"]["w_uv"] = tree["layers"]["attn"]["w_uv"][..., :-1]
    with pytest.raises(ValueError, match="layers.attn.w_uv has shape"):
        lm_params_from_jax(tree, cfg)
    gtree = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32),
                                   jfamily(jsmoke("granite_34b")).init_lm(KEY, jsmoke("granite_34b")))
    gstate = lm_params_from_jax(gtree, get_smoke_config("granite_34b"))
    assert gstate["layers.mlp.b1"].shape == (2, 128) and gstate["layers.mlp.b1"].dtype == torch.bfloat16


# --------------------------------------------------------------------------
# Layers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches(dtype, rng):
    x = rng.standard_normal((2, 5, 48)).astype(np.float32) * 3 + 1
    p = {"scale": rng.standard_normal(48).astype(np.float32),
         "bias": rng.standard_normal(48).astype(np.float32)}
    tdt = TL.DTYPES[dtype]
    got = TL.layernorm({k: torch.from_numpy(v) for k, v in p.items()},
                       torch.from_numpy(x).to(tdt), 1e-5)
    want = JL.layernorm({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x, jnp.dtype(dtype)))
    assert got.dtype == tdt
    np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-5 if dtype == "float32" else 2e-2,
                               rtol=1e-5 if dtype == "float32" else 1e-2)
    init = TL.init_layernorm(48, device="cpu")
    assert torch.equal(init["scale"], torch.ones(48)) and torch.equal(init["bias"], torch.zeros(48))


def test_gelu_rounds_where_jax_rounds(rng):
    """The tanh approximation (jax.nn.gelu's default), op by op in bf16: at
    least 99.5% of the outputs bit for bit (F.gelu, rounding once, matches
    far fewer)."""
    x = rng.standard_normal(8192).astype(np.float32) * 3
    got = _f32(TL.gelu(torch.from_numpy(x).bfloat16()))
    want = _f32(_jax_exact(jax.nn.gelu, jnp.asarray(x, jnp.bfloat16)))
    assert (got == want).mean() > 0.995
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=1e-2)
    np.testing.assert_allclose(_f32(TL.gelu(torch.from_numpy(x))),
                               _f32(jax.nn.gelu(jnp.asarray(x))), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_mlp_matches(dtype, rng):
    jp = JL.init_gelu_mlp(KEY, 32, 64, jnp.dtype(dtype))
    jp = dict(jp, b1=jnp.asarray(rng.standard_normal(64), jnp.dtype(dtype)),
              b2=jnp.asarray(rng.standard_normal(32), jnp.dtype(dtype)))
    x = rng.standard_normal((2, 7, 32)).astype(np.float32)
    got = TL.gelu_mlp(_torch_tree(jp, TL.DTYPES[dtype]), torch.from_numpy(x).to(TL.DTYPES[dtype]))
    want = _jax_exact(JL.gelu_mlp, jp, jnp.asarray(x, jnp.dtype(dtype)))
    np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-5 if dtype == "float32" else 3e-2,
                               rtol=1e-5 if dtype == "float32" else 0)


def _moe_setup(dtype, dispatch_groups=2, ties=False):
    jcfg = jsmoke("deepseek_v2_lite_16b").replace(dtype=dtype)
    jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe, dispatch_groups=dispatch_groups))
    cfg = arch_config_from_dict(dataclasses.asdict(jcfg))
    jp = JL.init_moe(KEY, jcfg, jnp.dtype(dtype))
    if ties:
        # experts 1, 2 and 3 route alike: every token's top 2 break a tie
        r = jp["router"]
        jp = dict(jp, router=r.at[:, 2].set(r[:, 1]).at[:, 3].set(r[:, 1]))
    return jcfg, cfg, jp, _torch_tree(jp, TL.DTYPES[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["dropless", "drops cf 0.5", "drops cf 0.25", "one group",
                                  "ties", "ties with drops", "decode step"])
def test_moe_matches(case, dtype, rng):
    """The reference's dispatch decides the drops: capacity below the
    assignments (cf < 1), T not a multiple of the groups (G = 1), router
    ties broken toward the lower expert, a decode step of B tokens."""
    cf = {"drops cf 0.5": 0.5, "drops cf 0.25": 0.25, "ties with drops": 0.5}.get(case)
    jcfg, cfg, jp, tp = _moe_setup(dtype, dispatch_groups=3 if case == "one group" else 2,
                                   ties=case.startswith("ties"))
    B, S = (2, 1) if case == "decode step" else (2, 37 if case == "one group" else 40)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    want = _jax_exact(lambda p, x: JL.moe(p, x, jcfg, capacity_factor=cf), jp,
                      jnp.asarray(x, jnp.dtype(dtype)))
    got = TL.moe(tp, torch.from_numpy(x).to(TL.DTYPES[dtype]), cfg, capacity_factor=cf)
    assert got.shape == (B, S, cfg.d_model) and got.dtype == TL.DTYPES[dtype]
    if dtype == "bfloat16":
        assert (_f32(got) == _f32(want)).mean() > 0.999
        np.testing.assert_allclose(_f32(got), _f32(want), atol=8e-2, rtol=2.0 ** -6)
    else:
        _close(got, want, dtype)


def test_moe_drops_as_the_capacity_says(rng):
    """At cf 0.25 the capacity is C = max(1, int(20 * 2 * 0.25) // 4) = 2
    per expert and group, so most assignments are dropped; with no shared
    expert, a token whose assignments all drop gets an exact zero."""
    jcfg, cfg, jp, tp = _moe_setup("float32")
    del tp["shared"]
    x = torch.from_numpy(rng.standard_normal((2, 20, cfg.d_model)).astype(np.float32))
    out = TL.moe(tp, x, cfg, capacity_factor=0.25)
    zero_rows = int((out.abs().sum(-1) == 0).sum())
    assert 0 < zero_rows < 40
    assert int((TL.moe(tp, x, cfg).abs().sum(-1) == 0).sum()) == 0


def test_rank_within_group():
    ids = torch.tensor([[0, 0, 1, 3, 3, 3, 4], [2, 2, 2, 2, 5, 6, 6]])
    assert TL._rank_within_group(ids).tolist() == [[0, 1, 0, 0, 1, 2, 0], [0, 1, 2, 3, 0, 0, 1]]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_prefill_and_absorbed_decode(dtype, rng):
    """Prefill into the latent cache (K6 on padded v), then one and three
    new tokens through the weight-absorbed decode; outputs and cache."""
    jcfg = jsmoke("deepseek_v2_lite_16b").replace(dtype=dtype)
    cfg = get_smoke_config("deepseek_v2_lite_16b").replace(dtype=dtype)
    jp = JL.init_mla(KEY, jcfg, jnp.dtype(dtype))
    tp = _torch_tree(jp, TL.DTYPES[dtype])
    m = cfg.mla
    B, S, S_max = 2, 20, 32
    x = rng.standard_normal((B, S + 4, cfg.d_model)).astype(np.float32)
    jx, tx = jnp.asarray(x, jnp.dtype(dtype)), torch.from_numpy(x).to(TL.DTYPES[dtype])
    jc = jnp.zeros((B, S_max, m.kv_lora_rank + m.qk_rope_head_dim), jnp.dtype(dtype))
    tc = torch.zeros(jc.shape, dtype=TL.DTYPES[dtype])
    jo, jc = _jax_exact(lambda p, x, c: JL.mla_attention(p, x, jcfg, kv_cache=c,
                                                         cache_index=jnp.int32(0),
                                                         use_pallas=True, prefill=True),
                        jp, jx[:, :S], jc)
    reset_launch_counts()
    to, tc = TL.mla_attention(tp, tx[:, :S], cfg, kv_cache=tc, cache_index=0, prefill=True)
    assert not any(launch_counts().values())
    _close(to, jo, dtype)
    _close(tc, jc, dtype)
    for lo, hi in ((S, S + 1), (S + 1, S + 4)):
        pos = np.arange(lo, hi)
        jo, jc = _jax_exact(
            lambda p, x, c, i, pos: JL.mla_attention(p, x, jcfg, positions=pos, kv_cache=c,
                                                     cache_index=i, use_pallas=True),
            jp, jx[:, lo:hi], jc, jnp.int32(lo), jnp.asarray(pos))
        to, tc = TL.mla_attention(tp, tx[:, lo:hi], cfg, positions=torch.from_numpy(pos),
                                  kv_cache=tc, cache_index=lo)
        _close(to, jo, dtype)
        _close(tc, jc, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_without_cache_matches(dtype, rng):
    jcfg = jsmoke("deepseek_v2_lite_16b").replace(dtype=dtype)
    cfg = get_smoke_config("deepseek_v2_lite_16b").replace(dtype=dtype)
    jp = JL.init_mla(KEY, jcfg, jnp.dtype(dtype))
    x = rng.standard_normal((2, 48, cfg.d_model)).astype(np.float32)
    jo, _ = _jax_exact(lambda p, x: JL.mla_attention(p, x, jcfg, use_pallas=True), jp,
                       jnp.asarray(x, jnp.dtype(dtype)))
    to, _ = TL.mla_attention(_torch_tree(jp, TL.DTYPES[dtype]),
                             torch.from_numpy(x).to(TL.DTYPES[dtype]), cfg)
    np.testing.assert_allclose(_f32(to), _f32(jo), atol=1e-5 if dtype == "float32" else 3e-2,
                               rtol=1e-4 if dtype == "float32" else 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_padded_v_attention_equals_the_chunked_oracle(dtype, rng):
    """ops.flash_attention with dv < dq (v padded to dq for K6, the output
    sliced back) against the reference's chunked oracle, causal and not."""
    tdt = TL.DTYPES[dtype]
    q, k = (rng.standard_normal((2, 3, 70, 24)).astype(np.float32) for _ in range(2))
    v = rng.standard_normal((2, 3, 70, 16)).astype(np.float32)
    for causal in (True, False):
        got = ops.flash_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                                  causal=causal)
        want = jref.chunked_attention(*(jnp.asarray(a, jnp.dtype(dtype)) for a in (q, k, v)),
                                      causal=causal, k_block=32)
        assert got.shape == (2, 3, 70, 16)
        np.testing.assert_allclose(_f32(got), _f32(want),
                                   atol=2e-5 if dtype == "float32" else 3e-2,
                                   rtol=2e-5 if dtype == "float32" else 0)
    with pytest.raises(ValueError, match="exceeds q's"):
        ops.flash_attention(torch.zeros(1, 1, 4, 8), torch.zeros(1, 1, 4, 8),
                            torch.zeros(1, 1, 4, 16))


# --------------------------------------------------------------------------
# Families: forward, prefill + decode
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches(arch, dtype, rng):
    jcfg, cfg, jp, tp = _models(arch, dtype)
    toks = rng.integers(0, cfg.vocab, (2, 64)).astype(np.int32)
    want = _jax_exact(lambda p, t: JT.forward(p, t, jcfg, use_pallas=True), jp, jnp.asarray(toks))
    with torch.inference_mode():
        got = TT.forward(tp, torch.from_numpy(toks), cfg)
    assert got.shape == (2, 64, cfg.vocab) and got.dtype == TL.DTYPES[dtype]
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match(arch, dtype, rng):
    """Prefill of 24 tokens and a decode step against the reference's, the
    caches too; then the port's own step against its forward (the
    reference's tests/test_serving.py check, at 8e-2)."""
    jcfg, cfg, jp, tp = _models(arch, dtype)
    S, max_seq = 24, 40
    toks = rng.integers(0, cfg.vocab, (2, S + 1)).astype(np.int32)
    jt = jnp.asarray(toks)
    jcaches = JT.init_kv_cache(jcfg, 2, max_seq)
    jfirst, jcaches = _jax_exact(lambda p, t, c: JT.prefill(p, t, c, jcfg, use_pallas=True),
                                 jp, jt[:, :S], jcaches)
    jlast, _ = _jax_exact(lambda p, t, i, c: JT.decode_step(p, t, i, c, jcfg, use_pallas=True),
                          jp, jt[:, S:], jnp.int32(S), jcaches)
    tt = torch.from_numpy(toks)
    with torch.inference_mode():
        caches = TT.init_kv_cache(cfg, 2, max_seq, device="cpu")
        first, caches = TT.prefill(tp, tt[:, :S], caches, cfg)
        _close(first, jfirst, dtype)
        for a, b in zip(jax.tree_util.tree_leaves(caches), jax.tree_util.tree_leaves(jcaches)):
            assert tuple(a.shape) == b.shape
            _close(a, b, dtype)
        last, _ = TT.decode_step(tp, tt[:, S:], S, caches, cfg)
        _close(last, jlast, dtype)
        full = TT.forward(tp, tt, cfg)
    assert np.abs(_f32(last[:, -1]) - _f32(full[:, -1])).max() < 8e-2


def test_mla_cache_is_the_latent():
    cfg = get_smoke_config("deepseek_v2_lite_16b")
    cache = TT.init_kv_cache(cfg, 3, 16, device="cpu")
    assert cache.shape == (2, 3, 16, 32 + 8) and cache.dtype == torch.bfloat16
    k, v = TT.init_kv_cache(get_smoke_config("granite_34b"), 3, 16, device="cpu")
    assert k.shape == v.shape == (2, 3, 1, 16, 16)
