"""The port's Whisper encoder-decoder (the audio family) against the JAX
package on the CPU: sinusoids, cross-attention (a prompt through K6 with
S_dec queries over S_enc keys, one token through K7), ``encode``,
``cross_kv`` (the cross k, v projected once), ``decode_hidden``,
``forward``, prefill + decode, and the serving engine with ``enc_out``.

Weights come from the reference's ``init_model`` and cross over as numpy
arrays (``convert.lm_params_from_jax``); frames and tokens are drawn with
numpy. The JAX side runs ``use_pallas=True`` and is compiled with XLA's
excess precision off (see ``test_torch_lm.py``). Tolerances: f32 at atol
2e-4 / rtol 2e-3, bf16 at 8e-2 (``tests/test_serving.py``).
"""
import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_lm import KEY, _close, _f32, _jax_exact

from repro.kernels import ref as jref
from repro.models import get_config as jconfig
from repro.models import get_smoke_config as jsmoke
from repro.models import whisper as JW
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServingEngine as JEngine
from repro.serving import build_prefill as jbuild_prefill
from repro.serving import build_serve_step as jbuild_step
from repro_torch.convert import lm_params_from_jax
from repro_torch.kernels import launch_counts, ops, reset_launch_counts
from repro_torch.launch import serve
from repro_torch.models import family_module, get_config, get_smoke_config
from repro_torch.models import layers as TL
from repro_torch.models import whisper as TW
from repro_torch.serving import ServeConfig, ServingEngine, init_cache



def _model(dtype):
    jcfg = jsmoke("whisper_base").replace(dtype=dtype)
    cfg = get_smoke_config("whisper_base").replace(dtype=dtype)
    jp = JW.init_model(KEY, jcfg)
    tp = TW.init_model(cfg, device="cpu")
    tp.load_state_dict(lm_params_from_jax(
        jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), jp), cfg))
    return jcfg, cfg, jp, tp


def _frames(rng, cfg, B=2):
    return rng.standard_normal((B, cfg.encdec.encoder_seq, cfg.d_model)).astype(np.float32)


def _both(x, dtype):
    return jnp.asarray(x, jnp.dtype(dtype)), torch.from_numpy(x).to(TL.DTYPES[dtype])


@pytest.mark.parametrize("smoke", [True, False])
def test_family_and_tree(smoke):
    """The tree's names, shapes and dtypes are the reference's
    ``init_model``'s, at the smoke size and at full width."""
    cfg = get_smoke_config("whisper_base") if smoke else get_config("whisper_base")
    jcfg = jsmoke("whisper_base") if smoke else jconfig("whisper_base")
    assert family_module(cfg) is TW
    tree = TW.init_params(cfg, generator=None, device=torch.device("meta"))
    want = jax.eval_shape(lambda: JW.init_model(KEY, jcfg))
    got = {k: (tuple(v.shape), str(v.dtype).split(".")[1])
           for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert got == {k: (v.shape, str(v.dtype))
                   for k, v in jax.tree_util.tree_flatten_with_path(want)[0]}
    assert tree["pos_dec"].shape == (TW.POS_DEC, cfg.d_model)


@pytest.mark.parametrize("length,channels", [(64, 64), (1500, 512), (7, 16)])
def test_sinusoids_match(length, channels):
    np.testing.assert_allclose(_f32(TW.sinusoids(length, channels)),
                               _f32(JW.sinusoids(length, channels)), atol=2e-4, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S_dec", [1, 5, 64])
def test_cross_attention_matches(S_dec, dtype, rng):
    """One decoded token through K7 (valid_len = S_enc), a prompt through
    K6 (not causal, Sk = S_enc != Sq); the reference's plain oracle."""
    jcfg, cfg, jp, tp = _model(dtype)
    p = jax.tree_util.tree_map(lambda x: x[0], jp["dec_layers"]["cross_attn"])
    tpl = TL.stacked_layers(tp, "dec_layers")[0]["cross_attn"]
    enc = rng.standard_normal((2, cfg.encdec.encoder_seq, cfg.d_model)).astype(np.float32)
    x = rng.standard_normal((2, S_dec, cfg.d_model)).astype(np.float32)
    (je, te), (jx, tx) = _both(enc, dtype), _both(x, dtype)
    want = _jax_exact(lambda p, x, e: JW.cross_attention(p, x, JW.encode_kv(p, e, jcfg), jcfg),
                      p, jx, je)
    got = TW.cross_attention(tpl, tx, TW.encode_kv(tpl, te, cfg), cfg)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-5 if dtype == "float32" else 3e-2,
                               rtol=1e-4 if dtype == "float32" else 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_with_a_longer_key_matches(dtype, rng):
    """K6's plain version with Sk != Sq (not causal) against the reference's
    oracle; causal attention refuses Sk != Sq."""
    q = rng.standard_normal((2, 4, 9, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 2, 150, 16)).astype(np.float32) for _ in range(2))
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dtype) for a in (q, k, v))
    got = ops.flash_attention(tq, tk, tv, causal=False)
    want = jref.flash_attention_ref(jq, jk, jv, causal=False)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-5 if dtype == "float32" else 3e-2,
                               rtol=2e-5 if dtype == "float32" else 0)
    with pytest.raises(ValueError, match="causal attention needs Sk == S"):
        ops.flash_attention(tq, tk, tv, causal=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_matches(dtype, rng):
    jcfg, cfg, jp, tp = _model(dtype)
    jf, tf = _both(_frames(rng, cfg), dtype)
    want = _jax_exact(lambda p, f: JW.encode(p, f, jcfg, use_pallas=True), jp, jf)
    got = TW.encode(tp, tf, cfg)
    assert got.shape == tf.shape and got.dtype == tf.dtype
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_hidden_and_forward_match(dtype, rng):
    jcfg, cfg, jp, tp = _model(dtype)
    jf, tf = _both(_frames(rng, cfg), dtype)
    toks = rng.integers(0, cfg.vocab, (2, 24)).astype(np.int32)
    enc = _jax_exact(lambda p, f: JW.encode(p, f, jcfg, use_pallas=True), jp, jf)
    want_h, _ = _jax_exact(lambda p, t, e: JW.decode_hidden(p, t, e, jcfg, use_pallas=True),
                           jp, jnp.asarray(toks), enc)
    tenc = torch.from_numpy(np.array(enc, np.float32)).to(TL.DTYPES[dtype])
    got_h, _ = TW.decode_hidden(tp, torch.from_numpy(toks), TW.cross_kv(tp, tenc, cfg), cfg)
    _close(got_h, want_h, dtype)
    want = _jax_exact(lambda p, t, f: JW.forward(p, t, f, jcfg, use_pallas=True),
                      jp, jnp.asarray(toks), jf)
    with torch.inference_mode():
        got = TW.forward(tp, torch.from_numpy(toks), tf, cfg)
    assert got.shape == (2, 24, cfg.vocab) and got.dtype == TL.DTYPES[dtype]
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match(dtype, rng):
    """Prefill of 23 tokens and a decode step against the reference's (the
    caches too), with the cross k, v projected once; then the port's own
    step against its forward (tests/test_serving.py's check, at 8e-2)."""
    jcfg, cfg, jp, tp = _model(dtype)
    jf, tf = _both(_frames(rng, cfg), dtype)
    S, max_seq = 23, 64
    toks = rng.integers(0, cfg.vocab, (2, S + 1)).astype(np.int32)
    jt, tt = jnp.asarray(toks), torch.from_numpy(toks)
    jenc = _jax_exact(lambda p, f: JW.encode(p, f, jcfg, use_pallas=True), jp, jf)
    jc = JW.init_kv_cache(jcfg, 2, max_seq)
    jfirst, jc = _jax_exact(lambda p, t, c, e: JW.decode_step(p, t, jnp.int32(0), c, e, jcfg,
                                                              use_pallas=True, prefill=True),
                            jp, jt[:, :S], jc, jenc)
    jlast, _ = _jax_exact(lambda p, t, i, c, e: JW.decode_step(p, t, i, c, e, jcfg,
                                                               use_pallas=True),
                          jp, jt[:, S:], jnp.int32(S), jc, jenc)
    with torch.inference_mode():
        enc = TW.encode(tp, tf, cfg)
        kv = TW.cross_kv(tp, enc, cfg)
        caches = TW.init_kv_cache(cfg, 2, max_seq, device="cpu")
        first, caches = TW.decode_step(tp, tt[:, :S], 0, caches, kv, cfg, prefill=True)
        _close(first, jfirst, dtype)
        for a, b in zip(caches, jc):
            _close(a, b, dtype)
        last, _ = TW.decode_step(tp, tt[:, S:], S, caches, kv, cfg)
        _close(last, jlast, dtype)
        full = TW.forward(tp, tt, tf, cfg)
    assert np.abs(_f32(last[:, -1]) - _f32(full[:, -1])).max() < 8e-2


def test_projecting_the_cross_kv_once_changes_nothing(rng):
    """``cross_kv``, projected once, is the k, v that the reference projects
    in each decoder layer of each step (``encode_kv``), at the bf16
    tolerance: one product, rounded to bf16 as XLA's is, may land on the
    other neighbour when its sum runs in another order."""
    jcfg, cfg, jp, tp = _model("bfloat16")
    jenc, enc = _both(_frames(rng, cfg), "bfloat16")
    with torch.inference_mode():
        got = TW.cross_kv(tp, enc, cfg)
    assert len(got) == cfg.n_layers
    for i, (k, v) in enumerate(got):
        p = jax.tree_util.tree_map(lambda x: x[i], jp["dec_layers"]["cross_attn"])
        jk, jv = _jax_exact(lambda p, e: JW.encode_kv(p, e, jcfg), p, jenc)
        assert k.shape == v.shape == (2, cfg.n_kv_heads, cfg.encdec.encoder_seq,
                                      cfg.attn_head_dim)
        _close(k, jk, "bfloat16")
        _close(v, jv, "bfloat16")


def test_generate_teacher_forced_matches_jax():
    """The JAX engine generates with ``enc_out``; its tokens are fed to both
    engines' prefill and decode steps, whose logits agree at 8e-2 (bf16)."""
    batch, prompt_len, new = 2, 16, 6
    max_seq = prompt_len + new + 8
    jcfg, cfg, jp, tp = _model("bfloat16")
    frames = _frames(np.random.default_rng(1), cfg, batch)
    jenc = JW.encode(jp, jnp.asarray(frames, jnp.bfloat16), jcfg)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (batch, prompt_len),
                                                dtype=np.int32)
    jscfg = JServeConfig(batch=batch, max_seq=max_seq, use_pallas=True)
    forced = JEngine(jcfg, jp, jscfg).generate(prompts, max_new_tokens=new, enc_out=jenc)
    engine = ServingEngine(cfg, tp, ServeConfig(batch=batch, max_seq=max_seq))
    enc = torch.from_numpy(np.array(jenc, np.float32)).bfloat16()
    jcaches = JW.init_kv_cache(jcfg, batch, max_seq)
    jprefill = jax.jit(jbuild_prefill(jcfg, jscfg))
    jstep = jax.jit(jbuild_step(jcfg, jscfg))
    jlogits, jcaches = jprefill(jp, jnp.asarray(prompts), jcaches, jenc)
    kv = TW.cross_kv(tp, enc, cfg)
    with torch.inference_mode():
        caches = init_cache(cfg, engine.scfg, device="cpu")
        logits, caches = engine.prefill(tp, torch.from_numpy(prompts), caches, kv)
        np.testing.assert_allclose(_f32(logits), _f32(jlogits), atol=8e-2)
        for i in range(new):
            tok = forced[:, i:i + 1]
            jlogits, jcaches = jstep(jp, jnp.asarray(tok), jnp.int32(prompt_len + i), jcaches,
                                     jenc)
            logits, caches = engine.step(tp, torch.from_numpy(tok), prompt_len + i, caches, kv)
            np.testing.assert_allclose(_f32(logits), _f32(jlogits), atol=8e-2)
    out = engine.generate(prompts, max_new_tokens=new, enc_out=enc)
    assert out.shape == (batch, new) and np.array_equal(
        out, engine.generate(prompts, max_new_tokens=new, enc_out=enc))


def test_engine_needs_enc_out_for_audio_only():
    _, cfg, _, tp = _model("float32")
    engine = ServingEngine(cfg, tp, ServeConfig(batch=2, max_seq=16))
    with pytest.raises(ValueError, match="enc_out is for the audio family only"):
        engine.generate(np.zeros((2, 4), np.int32), max_new_tokens=2)
    scfg = get_smoke_config("stablelm_3b")
    dense = ServingEngine(scfg, family_module(scfg).init_lm(scfg, device="cpu"),
                          ServeConfig(batch=2, max_seq=16))
    with pytest.raises(ValueError, match="enc_out is for the audio family only"):
        dense.generate(np.zeros((2, 4), np.int32), max_new_tokens=2,
                       enc_out=torch.zeros(2, 4, scfg.d_model))


def test_decode_launches_no_kernel_on_the_cpu(rng):
    _, cfg, _, tp = _model("bfloat16")
    reset_launch_counts()
    with torch.inference_mode():
        TW.forward(tp, torch.zeros((2, 8), dtype=torch.int32),
                   torch.from_numpy(_frames(rng, cfg)).bfloat16(), cfg)
    assert not any(launch_counts().values())


def test_launch_serve_runs_whisper_on_the_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve.main(["--arch", "whisper_base", "--smoke", "--device", "cpu", "--batch", "2",
                    "--prompt-len", "8", "--new-tokens", "4"])
    text = out.getvalue()
    assert "generated (2, 4)" in text and "tok/s" in text
