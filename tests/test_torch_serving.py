"""The port's serving engine against the JAX package's, on the CPU.

Greedy decoding picks the argmax of bf16 logits, where a near-tie can fall
either way between two packages, so the engines are held together
teacher-forced: the JAX engine generates, and its tokens are fed to both
engines' prefill and decode steps, whose logits are compared at 8e-2 (bf16,
``tests/test_serving.py``). The JAX steps run with ``use_pallas=True`` and
are compiled with XLA's excess precision off (see ``test_torch_lm.py``).
Prompts of 64 tokens take the reference's kernel route, 24 its ragged one.
Whisper's engine, which also takes the encoder's output, is held in
``test_torch_whisper.py``.
"""
import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import family_module as jfamily
from repro.models import get_smoke_config as jsmoke
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServingEngine as JEngine
from repro.serving import build_prefill as jbuild_prefill
from repro.serving import build_serve_step as jbuild_step
from repro.serving import init_cache as jinit_cache
from repro_torch.convert import lm_params_from_jax
from repro_torch.data import LMDataConfig, lm_batch
from repro_torch.launch import serve
from repro_torch.models import family_module, get_smoke_config
from repro_torch.serving import ServeConfig, ServingEngine, init_cache

KEY = jax.random.PRNGKey(0)
TOL = 8e-2
NEW = 6


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _compile(fn, *args):
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})


def _engines(arch, batch, max_seq):
    jcfg, cfg = jsmoke(arch), get_smoke_config(arch)
    jp = jfamily(jcfg).init_lm(KEY, jcfg)
    tp = family_module(cfg).init_lm(cfg, device="cpu")
    tp.load_state_dict(lm_params_from_jax(
        jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), jp), cfg))
    jscfg = JServeConfig(batch=batch, max_seq=max_seq, use_pallas=True)
    return (jcfg, jp, jscfg, JEngine(jcfg, jp, jscfg),
            ServingEngine(cfg, tp, ServeConfig(batch=batch, max_seq=max_seq)))


@pytest.mark.parametrize("prompt_len", [64, 24])
@pytest.mark.parametrize("arch", ["zamba2_2p7b", "mamba2_130m", "stablelm_3b",
                                  "deepseek_v2_lite_16b", "arctic_480b", "chameleon_34b",
                                  "granite_34b", "granite_20b"])
def test_generate_teacher_forced_matches_jax(arch, prompt_len):
    batch, max_seq = 2, prompt_len + NEW + 8
    jcfg, jp, jscfg, jengine, engine = _engines(arch, batch, max_seq)
    prompts = lm_batch(LMDataConfig(vocab=jcfg.vocab, seq_len=prompt_len, global_batch=batch),
                       0)["tokens"]
    forced = jengine.generate(prompts, max_new_tokens=NEW)
    assert forced.shape == (batch, NEW)

    jcaches = jinit_cache(jcfg, jscfg)
    jprefill = _compile(jbuild_prefill(jcfg, jscfg), jp, jnp.asarray(prompts), jcaches)
    jlogits, jcaches = jprefill(jp, jnp.asarray(prompts), jcaches)
    tok0 = jnp.asarray(forced[:, :1])
    jstep = _compile(jbuild_step(jcfg, jscfg), jp, tok0, jnp.int32(prompt_len), jcaches)
    with torch.inference_mode():
        caches = init_cache(engine.cfg, engine.scfg, device="cpu")
        logits, caches = engine.prefill(engine.params, torch.from_numpy(prompts), caches)
        np.testing.assert_allclose(_f32(logits), _f32(jlogits), atol=TOL)
        assert int(jnp.argmax(jlogits[0, -1])) == forced[0, 0]
        for i in range(NEW):
            tok = forced[:, i:i + 1]
            jlogits, jcaches = jstep(jp, jnp.asarray(tok), jnp.int32(prompt_len + i), jcaches)
            logits, caches = engine.step(engine.params, torch.from_numpy(tok), prompt_len + i,
                                         caches)
            np.testing.assert_allclose(_f32(logits), _f32(jlogits), atol=TOL)


@pytest.mark.parametrize("arch", ["zamba2_2p7b", "stablelm_3b", "deepseek_v2_lite_16b",
                                  "arctic_480b"])
def test_engine_generates_deterministically(arch):
    cfg = get_smoke_config(arch)
    params = family_module(cfg).init_lm(cfg, device="cpu")
    engine = ServingEngine(cfg, params, ServeConfig(batch=2, max_seq=48))
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (2, 8), dtype=np.int32)
    a = engine.generate(prompts, max_new_tokens=8)
    b = engine.generate(prompts, max_new_tokens=8)
    assert a.shape == (2, 8) and a.dtype == np.int32
    assert np.array_equal(a, b)
    assert a.min() >= 0 and a.max() < cfg.vocab


def test_engine_refuses_what_its_config_does_not_hold():
    cfg = get_smoke_config("mamba2_130m")
    engine = ServingEngine(cfg, family_module(cfg).init_lm(cfg, device="cpu"),
                           ServeConfig(batch=2, max_seq=16))
    with pytest.raises(ValueError, match="batch of 3 prompts"):
        engine.generate(np.zeros((3, 4), np.int32))
    with pytest.raises(ValueError, match="exceed max_seq 16"):
        engine.generate(np.zeros((2, 12), np.int32), max_new_tokens=5)


def test_lm_batch_equals_reference():
    from repro.data.lm import LMDataConfig as JData, lm_batch as jlm_batch

    for step in (0, 3):
        got = lm_batch(LMDataConfig(vocab=32000, seq_len=40, global_batch=3), step)
        want = jlm_batch(JData(vocab=32000, seq_len=40, global_batch=3), step)
        assert all(np.array_equal(got[k], want[k]) for k in ("tokens", "labels"))


def test_launch_serve_runs_on_the_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve.main(["--arch", "zamba2_2p7b", "--smoke", "--device", "cpu", "--batch", "2",
                    "--prompt-len", "24", "--new-tokens", "4"])
    text = out.getvalue()
    assert "generated (2, 4)" in text and "tok/s" in text


def test_launch_serve_needs_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--arch", "mamba2_130m", "--smoke"])
