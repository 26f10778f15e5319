"""The port's training stack against the JAX package, on the CPU.

Every case of ``tests/test_training_stack.py`` runs through the port, and
the port is held to the reference on the same numpy inputs: the losses, the
optimizer's ``apply`` on shared params, grads and moments, the
compressors, the loss and gradients of every family's smoke config
(weights from the reference's ``init`` through ``convert.lm_params_from_jax``),
3-step trajectories, microbatching, and the cached step of several new
tokens. Tolerances: f32 losses rtol 1e-5, f32 gradients 1e-4 of each leaf's
largest magnitude (measured at most 1.4e-5 apart; the sums run in other
orders), bf16 at the reference's 8e-2 against JAX compiled with
``xla_allow_excess_precision`` off (as ``tests/test_torch_lm.py``); the
optimizer exact where its f32 element-wise ops are the same ops, 1e-6
relative where a transcendental (cos, pow, sqrt) or a reduction (the global
norm) may round otherwise.

Parameters are not compared element by element after several Adam steps:
at step 1, m / sqrt(v) turns a gradient near zero into +-lr by its sign
alone.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import LMDataConfig as JLMDataConfig, lm_batch as jlm_batch
from repro.models import family_module as jfamily
from repro.models import get_smoke_config as jsmoke
from repro.models import transformer as JT
from repro.training import AdamWConfig as JAdamWConfig
from repro.training import CompressionConfig as JCompressionConfig
from repro.training import TrainConfig as JTrainConfig
from repro.training import build_loss_fn as jbuild_loss_fn
from repro.training import build_train_step as jbuild_train_step
from repro.training import chunked_softmax_xent as jchunked, full_softmax_xent as jfull
from repro.training import init_state as jinit_state
from repro.training import optimizer as jopt
from repro.training.compression import compress_grads as jcompress
from repro_torch import tree as T
from repro_torch.convert import lm_params_from_jax
from repro_torch.data import LMDataConfig, lm_batch
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.models import family_module, get_smoke_config
from repro_torch.models import transformer as TT
from repro_torch.training import (
    AdamWConfig,
    CompressionConfig,
    TrainConfig,
    build_loss_fn,
    build_train_step,
    chunked_softmax_xent,
    full_softmax_xent,
    init_state,
)
from repro_torch.training import optimizer as opt
from repro_torch.training.compression import compress_grads, init_error
from repro_torch.training.train_step import value_and_grad

KEY = jax.random.PRNGKey(0)
FAMILIES = ["stablelm_3b", "zamba2_2p7b", "mamba2_130m", "deepseek_v2_lite_16b",
            "arctic_480b", "chameleon_34b", "granite_34b", "whisper_base"]


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _nest(flat):
    out = {}
    for name, v in flat.items():
        d = out
        *head, last = name.split(".")
        for h in head:
            d = d.setdefault(h, {})
        d[last] = v
    return out


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)


def _models(arch, dtype="float32"):
    """(jcfg, cfg, reference params, the port's nested dict of the same)."""
    jcfg = jsmoke(arch).replace(dtype=dtype)
    cfg = get_smoke_config(arch).replace(dtype=dtype)
    jm = jfamily(jcfg)
    jp = (jm.init_model if jcfg.family == "audio" else jm.init_lm)(KEY, jcfg)
    return jcfg, cfg, jp, _nest(lm_params_from_jax(_np_tree(jp), cfg))


def _jax_exact(fn, *args):
    """``fn(*args)`` compiled by XLA with its excess precision off."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def _batch(cfg, dtype, B=4, S=32, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "audio":
        b["frames"] = (rng.standard_normal((B, cfg.encdec.encoder_seq, cfg.d_model))
                       * 0.5).astype(np.float32)
    jb = {k: jnp.asarray(v, jnp.dtype(dtype) if k == "frames" else None) for k, v in b.items()}
    tb = {k: torch.from_numpy(v).to(getattr(torch, dtype)) if k == "frames" else
          torch.from_numpy(v) for k, v in b.items()}
    return jb, tb


def _grads_close(tgrads, jgrads, cfg, tol):
    """Each leaf of the port's grads against the reference's, at ``tol`` of
    the leaf's largest magnitude (absolute) and ``tol`` relative."""
    want = {k.replace(".", "/"): v for k, v in lm_params_from_jax(_np_tree(jgrads), cfg).items()}
    got = dict(T.flatten_with_paths(tgrads))
    assert set(got) == set(want)
    for name, g in got.items():
        w = _f32(want[name])
        np.testing.assert_allclose(_f32(g), w, rtol=tol, atol=tol * float(np.abs(w).max()),
                                   err_msg=name)


# --------------------------------------------------------------------------
# The cases of tests/test_training_stack.py, through the port
# --------------------------------------------------------------------------

def test_chunked_ce_equals_full(rng):
    B, S, D, V = 2, 64, 32, 97
    hidden = torch.from_numpy(rng.standard_normal((B, S, D)).astype(np.float32))
    head = torch.from_numpy(rng.standard_normal((D, V)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, V, (B, S)).astype(np.int32))
    full = full_softmax_xent(hidden @ head, labels)
    for chunk in (8, 16, 64):
        c = chunked_softmax_xent(hidden, head, labels, chunk=chunk)
        np.testing.assert_allclose(float(c), float(full), rtol=1e-5)


def _j_state_to_port(jstate, cfg, tcfg):
    """The reference's train state as the port's, leaf for leaf."""
    state = init_state(0, cfg, tcfg, device="cpu")
    leaves = [torch.from_numpy(np.array(x, np.float32)).to(t.dtype) if t.is_floating_point()
              else torch.from_numpy(np.array(x)) for x, t in
              zip(jax.tree_util.tree_leaves(jstate), T.leaves(state))]
    return T.unflatten(state, leaves)


def _jax_tcfg(tcfg):
    return JTrainConfig(adamw=JAdamWConfig(**dataclasses.asdict(tcfg.adamw)),
                        compression=JCompressionConfig(**dataclasses.asdict(tcfg.compression)),
                        loss_chunk=tcfg.loss_chunk, remat=tcfg.remat,
                        use_pallas=tcfg.use_pallas, microbatches=tcfg.microbatches)


def _run(cfg, tcfg, steps=25, seed=0):
    """The reference test's loop through the port, from the reference's
    initial state (torch cannot draw ``jax.random``'s numbers)."""
    jcfg = jsmoke(cfg.name).replace(dtype=cfg.dtype)
    state = _j_state_to_port(jinit_state(jax.random.PRNGKey(seed), jcfg, _jax_tcfg(tcfg)),
                             cfg, tcfg)
    step = build_train_step(cfg, tcfg)
    dcfg = LMDataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8, seed=0)
    out = []
    for i in range(steps):
        b = {k: torch.from_numpy(v) for k, v in lm_batch(dcfg, i).items()}
        state, m = step(state, b)
        out.append(float(m["loss"]))
    return out


def test_loss_decreases():
    cfg = get_smoke_config("stablelm_3b")
    tcfg = TrainConfig(adamw=AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=40),
                       loss_chunk=16)
    out = _run(cfg, tcfg, steps=25)
    assert out[-1] < out[0] - 0.5, out


def test_microbatch_equivalence():
    """grad-accum over 4 microbatches == single batch (same data)."""
    cfg = get_smoke_config("stablelm_3b")
    l1 = _run(cfg, TrainConfig(adamw=AdamWConfig(lr=1e-3), loss_chunk=16, microbatches=1),
              steps=5)
    l4 = _run(cfg, TrainConfig(adamw=AdamWConfig(lr=1e-3), loss_chunk=16, microbatches=4),
              steps=5)
    np.testing.assert_allclose(l1, l4, rtol=2e-2, atol=2e-2)


def test_quantized_optimizer_tracks_fp32():
    cfg = get_smoke_config("stablelm_3b")
    base = _run(cfg, TrainConfig(adamw=AdamWConfig(lr=3e-3), loss_chunk=16), steps=15)
    quant = _run(cfg, TrainConfig(adamw=AdamWConfig(lr=3e-3, quantize_state=True),
                                  loss_chunk=16), steps=15)
    assert quant[-1] < base[0] - 0.25               # it converges
    assert abs(quant[-1] - base[-1]) < 0.3          # and tracks fp32 closely


def test_quantize_roundtrip_accuracy(rng):
    for shape in [(64,), (8, 130), (3, 5, 256)]:
        x = torch.from_numpy((rng.standard_normal(shape) * 3).astype(np.float32))
        q, s = opt._quantize(x)
        assert q.shape == x.shape and q.dtype == torch.int8
        back = opt._dequantize(q, s, x.shape)
        err = float(torch.max(torch.abs(back - x)))
        assert err <= float(torch.max(torch.abs(x))) / 127.0 + 1e-6


def test_lr_schedule_shape():
    c = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    assert float(opt.lr_schedule(c, torch.tensor(0, dtype=torch.int32))) == 0.0
    assert abs(float(opt.lr_schedule(c, torch.tensor(10, dtype=torch.int32))) - 1.0) < 1e-6
    assert float(opt.lr_schedule(c, torch.tensor(100, dtype=torch.int32))) <= 0.1 + 1e-6


def test_int8_compression_with_error_feedback_converges():
    cfg = get_smoke_config("stablelm_3b")
    tc = TrainConfig(adamw=AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=40),
                     compression=CompressionConfig(kind="int8"), loss_chunk=16)
    out = _run(cfg, tc, steps=25)
    assert out[-1] < out[0] - 0.5, out


def test_topk_error_feedback_unbiased_on_quadratic():
    """EF-topk SGD converges on a quadratic where plain topk stalls dims."""
    w = torch.from_numpy(np.linspace(1, 3, 32).astype(np.float32))
    target = torch.zeros(32)
    ccfg = CompressionConfig(kind="topk", topk_density=0.125)
    err = init_error({"w": w})
    params = {"w": w}
    for _ in range(300):
        g = {"w": params["w"] - target}
        g, err, _ = compress_grads(g, err, ccfg)
        params = {"w": params["w"] - 0.05 * g["w"]}
    assert float(torch.abs(params["w"]).max()) < 1e-2


def test_int8_roundtrip_bounds(rng):
    g = {"a": torch.from_numpy((rng.standard_normal((1000,)) * 5).astype(np.float32))}
    out, err, m = compress_grads(g, init_error(g), CompressionConfig(kind="int8"))
    resid = float(torch.abs(out["a"] + err["a"] - g["a"]).max())
    assert resid < 1e-5   # sent + residual == original (error feedback exact)
    assert m["compression_ratio"] > 3.5


# --------------------------------------------------------------------------
# Against the reference, on shared inputs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_losses_match_reference(rng, masked):
    B, S, D, V = 2, 48, 32, 97
    hidden = rng.standard_normal((B, S, D)).astype(np.float32)
    head = rng.standard_normal((D, V)).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) < 0.7).astype(np.float32) if masked else None
    kw_j = {} if mask is None else {"label_mask": jnp.asarray(mask)}
    kw_t = {} if mask is None else {"label_mask": torch.from_numpy(mask)}
    for chunk in (8, 16, 48):
        jl, (jgh, jgw) = jax.value_and_grad(
            lambda h, w: jchunked(h, w, jnp.asarray(labels), chunk=chunk, **kw_j),
            argnums=(0, 1))(jnp.asarray(hidden), jnp.asarray(head))
        th = torch.from_numpy(hidden).requires_grad_()
        tw = torch.from_numpy(head).requires_grad_()
        tl = chunked_softmax_xent(th, tw, torch.from_numpy(labels), chunk=chunk, **kw_t)
        tgh, tgw = torch.autograd.grad(tl, (th, tw))
        np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
        for a, b in ((tgh, jgh), (tgw, jgw)):
            np.testing.assert_allclose(_f32(a), _f32(b), rtol=1e-4,
                                       atol=1e-4 * float(np.abs(_f32(b)).max()))
    logits = hidden @ head
    np.testing.assert_allclose(
        float(full_softmax_xent(torch.from_numpy(logits), torch.from_numpy(labels))),
        float(jfull(jnp.asarray(logits), jnp.asarray(labels))), rtol=1e-5)


def _opt_inputs(rng, quantize, step=4):
    """Params (an f32 and a bf16 leaf, one of 300 columns: two int8 blocks,
    the last ragged), grads and moments after ``step`` steps, as numpy."""
    params = {"a": {"w": rng.standard_normal((6, 300)).astype(np.float32)},
              "b": (rng.standard_normal(40) * 0.1).astype(np.float32)}
    grads = {"a": {"w": (rng.standard_normal((6, 300)) * 0.3).astype(np.float32)},
             "b": (rng.standard_normal(40) * 1e-3).astype(np.float32)}
    grads["a"]["w"][0, :7] = 0.0
    mu = jax.tree_util.tree_map(lambda g: (g * 0.5).astype(np.float32), grads)
    nu = jax.tree_util.tree_map(lambda g: (g * g * 0.7).astype(np.float32), grads)
    return params, grads, mu, nu, step


@pytest.mark.parametrize("quantize", [False, True])
def test_adamw_apply_matches_reference(rng, quantize):
    params, grads, mu, nu, step = _opt_inputs(rng, quantize)
    cfg_kw = dict(lr=1e-2, warmup_steps=3, total_steps=20, quantize_state=quantize)
    jcfg, cfg = JAdamWConfig(**cfg_kw), AdamWConfig(**cfg_kw)
    jp = {"a": {"w": jnp.asarray(params["a"]["w"])},
          "b": jnp.asarray(params["b"], jnp.bfloat16)}
    jg = {"a": {"w": jnp.asarray(grads["a"]["w"])}, "b": jnp.asarray(grads["b"], jnp.bfloat16)}
    jmu = jax.tree_util.tree_map(lambda x: jopt._write_moment(jnp.asarray(x), quantize, "mu"), mu)
    jnu = jax.tree_util.tree_map(lambda x: jopt._write_moment(jnp.asarray(x), quantize, "nu"), nu)
    jstate = jopt.AdamWState(step=jnp.int32(step), mu=jmu, nu=jnu)
    jnew, jst, jm = jopt.apply(jp, jg, jstate, jcfg)

    def tt(x, dtype="float32"):
        return torch.from_numpy(np.asarray(x, np.float32)).to(getattr(torch, dtype))

    def tmoment(m):
        if quantize:
            return torch.from_numpy(np.array(m[0])), torch.from_numpy(np.array(m[1]))
        return torch.from_numpy(np.array(m))

    is_q = lambda x: isinstance(x, tuple)
    tp = {"a": {"w": tt(params["a"]["w"])}, "b": tt(params["b"], "bfloat16")}
    tg = {"a": {"w": tt(grads["a"]["w"])}, "b": tt(grads["b"], "bfloat16")}
    tmu = jax.tree_util.tree_map(tmoment, jmu, is_leaf=is_q)
    tnu = jax.tree_util.tree_map(tmoment, jnu, is_leaf=is_q)
    tstate = opt.AdamWState(step=torch.tensor(step, dtype=torch.int32), mu=tmu, nu=tnu)
    tnew, tst, tm = opt.apply(tp, tg, tstate, cfg)

    assert int(tst.step) == int(jst.step) == step + 1
    np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
    assert tnew is tp                                  # updated in place
    np.testing.assert_allclose(_f32(tnew["a"]["w"]), _f32(jnew["a"]["w"]), rtol=1e-6, atol=1e-7)
    assert tnew["b"].dtype == torch.bfloat16
    # bf16: the f32 results round to the same bf16 but where they sit within
    # 1e-6 of a rounding boundary
    np.testing.assert_allclose(_f32(tnew["b"]), _f32(jnew["b"]), rtol=2 ** -8)
    assert (np.abs(_f32(tnew["b"]) - _f32(jnew["b"])) > 0).mean() < 0.05
    for tmom, jmom, kind in ((tst.mu, jst.mu, "mu"), (tst.nu, jst.nu, "nu")):
        for name, shape in (("a/w", (6, 300)), ("b", (40,))):
            got = tmom["a"]["w"] if name == "a/w" else tmom["b"]
            want = jmom["a"]["w"] if name == "a/w" else jmom["b"]
            if quantize:
                # int8 codes may differ by one where the f32 value sits at a
                # rounding boundary; the scales to 1e-6
                assert np.abs(got[0].numpy().astype(int) - np.asarray(want[0]).astype(int)).max() <= 1
                assert (got[0].numpy() != np.asarray(want[0])).mean() < 0.01
                np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-6)
                np.testing.assert_allclose(_f32(opt._read_moment(got, torch.zeros(shape), True, kind)),
                                           _f32(jopt._read_moment(want, jnp.zeros(shape), True, kind)),
                                           rtol=2e-2, atol=1e-12)
            else:
                np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-6, atol=1e-12)


def test_quantizer_matches_reference(rng):
    for shape in [(64,), (8, 130), (3, 5, 256), (2, 513)]:
        x = (rng.standard_normal(shape) * 3).astype(np.float32)
        x.flat[0] = 0.5 * 3 / 127 * 7          # round-half cases are possible, not forced
        tq, ts = opt._quantize(torch.from_numpy(x))
        jq, js = jopt._quantize(jnp.asarray(x))
        assert np.array_equal(tq.numpy(), np.asarray(jq))
        assert np.array_equal(ts.numpy(), np.asarray(js))
        assert np.array_equal(opt._dequantize(tq, ts, shape).numpy(),
                              np.asarray(jopt._dequantize(jq, js, shape, x.size)))
        assert np.array_equal(opt._broadcast_scale(ts, shape).numpy(),
                              np.asarray(jopt._broadcast_scale(js, shape)))


@pytest.mark.parametrize("kind", ["int8", "topk"])
@pytest.mark.parametrize("feedback", [True, False])
def test_compress_grads_matches_reference(rng, kind, feedback):
    g = {"a": (rng.standard_normal((7, 100)) * 2).astype(np.float32),
         "b": {"c": rng.standard_normal(513).astype(np.float32)}}
    # ties in magnitude: top-k keeps the lower index, as lax.top_k does
    g["a"][0, :40] = 1.5
    g["a"][3, :40] = -1.5
    g["b"]["c"][:20] = 2.5
    e = jax.tree_util.tree_map(lambda x: (x * 0.01).astype(np.float32), g)
    cfg_kw = dict(kind=kind, topk_density=0.05, error_feedback=feedback)
    jg, je, jm = jcompress(jax.tree_util.tree_map(jnp.asarray, g),
                           jax.tree_util.tree_map(jnp.asarray, e), JCompressionConfig(**cfg_kw))
    tg, te, tm = compress_grads(jax.tree_util.tree_map(torch.from_numpy, g),
                                jax.tree_util.tree_map(torch.from_numpy, e),
                                CompressionConfig(**cfg_kw))
    assert tm == jm
    for got, want in ((tg, jg), (te, je)):
        for (name, a), b in zip(T.flatten_with_paths(got), jax.tree_util.tree_leaves(want)):
            assert np.array_equal(a.numpy(), np.asarray(b)), name
    if kind == "topk":
        for (_, a), b in zip(T.flatten_with_paths(tg), jax.tree_util.tree_leaves(jg)):
            assert np.array_equal(a.numpy() != 0, np.asarray(b) != 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Hq,Hkv,S,Sk,dq,dv,k_block,causal", [
    (4, 2, 40, 40, 24, 16, 16, True),       # GQA, MLA's dv < dq, a ragged last block
    (4, 2, 40, 40, 24, 16, 16, False),
    (2, 2, 33, 33, 16, 16, 512, True),      # one block
    (2, 2, 33, 33, 16, 16, 512, False),
    (4, 1, 8, 50, 16, 8, 16, False),        # Sk != S (causal takes Sk == S)
])
def test_chunked_attention_matches_reference(rng, Hq, Hkv, S, Sk, dq, dv, k_block, causal,
                                             dtype):
    """``ref.chunked_attention`` (the route of dv != dq and S > 2048 when
    ``use_pallas=False``) against the reference's, and its gradients: f32 at
    2e-5, bf16 at the reference's 3e-2 (p rounded to bf16 before p.v on both
    sides)."""
    from repro.kernels import ref as jref
    from repro_torch.kernels import ref as tref

    q, k, v = (rng.standard_normal(shape).astype(np.float32) for shape in
               ((2, Hq, S, dq), (2, Hkv, Sk, dq), (2, Hkv, Sk, dv)))
    jt = jnp.dtype(dtype)
    want, jvjp = jax.vjp(lambda q, k, v: jref.chunked_attention(q, k, v, causal=causal,
                                                                k_block=k_block),
                         *(jnp.asarray(x, jt) for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_()
                  for x in (q, k, v))
    got = tref.chunked_attention(tq, tk, tv, causal=causal, k_block=k_block)
    tol = dict(atol=2e-5, rtol=2e-5) if dtype == "float32" else dict(atol=3e-2, rtol=0)
    assert got.dtype == tq.dtype
    np.testing.assert_allclose(_f32(got), _f32(want), **tol)
    cot = rng.standard_normal(got.shape).astype(np.float32)
    jgrads = jvjp(jnp.asarray(cot, jt))
    tgrads = torch.autograd.grad(got, (tq, tk, tv), torch.from_numpy(cot).to(got.dtype))
    for a, b in zip(tgrads, jgrads):
        np.testing.assert_allclose(_f32(a), _f32(b), atol=(1e-4 if dtype == "float32" else 1e-1),
                                   rtol=(1e-4 if dtype == "float32" else 0))


def test_plain_route_of_the_ops_is_the_references():
    """``use_pallas=False``: dv != dq or S > 2048 to ``chunked_attention``,
    else ``flash_attention_ref``; the SSD scan to the sequential recurrence;
    no kernel, on any device."""
    from repro_torch.kernels import ops, ref as tref

    g = torch.Generator().manual_seed(0)
    q, k = torch.randn((1, 2, 2056, 8), generator=g), torch.randn((1, 1, 2056, 8), generator=g)
    reset_launch_counts()
    assert torch.equal(ops.flash_attention(q, k, k, use_pallas=False),
                       tref.chunked_attention(q, k, k))
    assert torch.equal(ops.flash_attention(q[:, :, :64], k[:, :, :64], k[:, :, :64, :4],
                                           use_pallas=False),
                       tref.chunked_attention(q[:, :, :64], k[:, :, :64], k[:, :, :64, :4]))
    assert torch.equal(ops.flash_attention(q[:, :, :64], k[:, :, :64], k[:, :, :64],
                                           use_pallas=False),
                       tref.flash_attention_ref(q[:, :, :64], k[:, :, :64], k[:, :, :64]))
    x, a = torch.randn((1, 2, 16, 4), generator=g), -torch.rand((1, 2, 16), generator=g)
    bc = torch.randn((1, 16, 3), generator=g)
    assert torch.equal(ops.mamba2_ssd(x, a, -a, bc, bc, chunk=8, use_pallas=False),
                       tref.mamba2_ssd_ref(x, a, -a, bc, bc))
    assert not any(launch_counts().values())


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match_reference(arch):
    """Each family's f32 smoke config: the port's loss and gradients of
    ``build_loss_fn`` against ``jax.value_and_grad`` of the reference's, on
    the reference's weights and one batch."""
    jcfg, cfg, jp, tp = _models(arch)
    jb, tb = _batch(cfg, "float32")
    jl, jg = jax.value_and_grad(jbuild_loss_fn(jcfg, JTrainConfig(loss_chunk=16)))(jp, jb)
    reset_launch_counts()
    tl, tg = value_and_grad(build_loss_fn(cfg, TrainConfig(loss_chunk=16)), tp, tb)
    assert not any(launch_counts().values())
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    _grads_close(tg, jg, cfg, 1e-4)


@pytest.mark.parametrize("arch", ["stablelm_3b", "zamba2_2p7b"])
def test_loss_and_grads_match_reference_bf16(arch):
    """bf16 at the reference's 8e-2, JAX without excess precision."""
    jcfg, cfg, jp, tp = _models(arch, "bfloat16")
    jb, tb = _batch(cfg, "bfloat16")
    jl, jg = _jax_exact(jax.value_and_grad(jbuild_loss_fn(jcfg, JTrainConfig(loss_chunk=16))),
                        jp, jb)
    tl, tg = value_and_grad(build_loss_fn(cfg, TrainConfig(loss_chunk=16)), tp, tb)
    assert abs(float(tl) - float(jl)) < 8e-2
    _grads_close(tg, jg, cfg, 8e-2)


@pytest.mark.parametrize("remat", [True, False])
def test_remat_gives_the_same_gradients(remat):
    """Recomputing each layer in the backward changes no number."""
    _, cfg, _, tp = _models("zamba2_2p7b")
    _, tb = _batch(cfg, "float32")
    base_l, base_g = value_and_grad(build_loss_fn(cfg, TrainConfig(loss_chunk=16, remat=False)),
                                    tp, tb)
    tl, tg = value_and_grad(build_loss_fn(cfg, TrainConfig(loss_chunk=16, remat=remat)), tp, tb)
    assert float(tl) == float(base_l)
    for a, b in zip(T.leaves(tg), T.leaves(base_g)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch,micro", [("stablelm_3b", 1), ("zamba2_2p7b", 1),
                                        ("stablelm_3b", 4)])
def test_trajectory_matches_reference(arch, micro):
    """Three steps of the reference's train step and the port's from the
    same state on the same batches: losses at rtol 1e-4 (steps 2 and 3 see
    parameters that may differ by +-lr where a gradient sits near zero), the
    first step's grad norm at 1e-5."""
    jcfg, cfg = jsmoke(arch).replace(dtype="float32"), get_smoke_config(arch).replace(
        dtype="float32")
    kw = dict(loss_chunk=16, microbatches=micro)
    ad = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    jt = JTrainConfig(adamw=JAdamWConfig(**ad), **kw)
    tc = TrainConfig(adamw=AdamWConfig(**ad), **kw)
    jstate = jinit_state(KEY, jcfg, jt)
    state = _j_state_to_port(jstate, cfg, tc)
    jstep, step = jax.jit(jbuild_train_step(jcfg, jt)), build_train_step(cfg, tc)
    dj = JLMDataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8)
    dt = LMDataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8)
    for i in range(3):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in jlm_batch(dj, i).items()})
        state, m = step(state, {k: torch.from_numpy(v) for k, v in lm_batch(dt, i).items()})
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4)
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]), rtol=1e-6)
        if i == 0:
            np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
    assert int(state["step"]) == 3 and int(state["opt"].step) == 3


def test_use_pallas_training_raises_in_both_packages():
    jcfg, cfg = jsmoke("stablelm_3b"), get_smoke_config("stablelm_3b")
    jt = JTrainConfig(use_pallas=True, loss_chunk=16)
    jstate = jinit_state(KEY, jcfg, jt)
    batch = {k: jnp.asarray(v) for k, v in
             jlm_batch(JLMDataConfig(vocab=jcfg.vocab, seq_len=32, global_batch=2), 0).items()}
    with pytest.raises(NotImplementedError):
        jbuild_train_step(jcfg, jt)(jstate, batch)
    with pytest.raises(NotImplementedError, match="no kernel has a backward"):
        build_train_step(cfg, TrainConfig(use_pallas=True))


def test_train_step_updates_the_state_in_place():
    cfg = get_smoke_config("stablelm_3b")
    tcfg = TrainConfig(loss_chunk=16, compression=CompressionConfig(kind="int8"))
    state = init_state(0, cfg, tcfg, device="cpu")
    assert set(state) == {"params", "opt", "step", "err"}
    wq = state["params"]["layers"]["attn"]["wq"]
    before = wq.clone()
    b = {k: torch.from_numpy(v) for k, v in
         lm_batch(LMDataConfig(vocab=cfg.vocab, seq_len=32, global_batch=2), 0).items()}
    new, m = build_train_step(cfg, tcfg)(state, b)
    assert new["params"]["layers"]["attn"]["wq"] is wq and not torch.equal(wq, before)
    assert not wq.requires_grad and int(new["step"]) == 1
    assert set(m) == {"loss", "lr", "grad_norm", "compression_ratio"}


# --------------------------------------------------------------------------
# A cached step of several new tokens (plain torch on every device)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["stablelm_3b", "zamba2_2p7b"])
def test_cached_step_of_several_tokens_matches_reference(arch, dtype, rng):
    """After a prefill of 24, one step of 4 new tokens: the reference's
    full-cache attention (``_decode_attention``) and, for the hybrid, its
    sequential SSD steps, at the serving tolerances (f32 2e-4 / 2e-3, bf16
    8e-2)."""
    jcfg = jsmoke(arch).replace(dtype=dtype)
    cfg = get_smoke_config(arch).replace(dtype=dtype)
    jmod, tmod = jfamily(jcfg), family_module(cfg)
    jp = jmod.init_lm(KEY, jcfg)
    tp = tmod.init_lm(cfg, device="cpu")
    tp.load_state_dict(lm_params_from_jax(_np_tree(jp), cfg))
    S, new, max_seq = 24, 4, 40
    toks = rng.integers(0, cfg.vocab, (2, S + new)).astype(np.int32)
    jt, tt = jnp.asarray(toks), torch.from_numpy(toks)
    if cfg.family == "hybrid":
        _, jc = _jax_exact(lambda p, t: jmod.prefill_with_state(p, t, jcfg, use_pallas=True,
                                                                max_seq=max_seq), jp, jt[:, :S])
    else:
        _, jc = _jax_exact(lambda p, t, c: JT.prefill(p, t, c, jcfg, use_pallas=True), jp,
                           jt[:, :S], JT.init_kv_cache(jcfg, 2, max_seq))
    jlast, _ = _jax_exact(lambda p, t, c: jmod.decode_step(p, t, jnp.int32(S), c, jcfg,
                                                           use_pallas=True), jp, jt[:, S:], jc)
    with torch.inference_mode():
        if cfg.family == "hybrid":
            _, caches = tmod.prefill_with_state(tp, tt[:, :S], cfg, max_seq=max_seq)
        else:
            caches = TT.init_kv_cache(cfg, 2, max_seq, device="cpu")
            _, caches = TT.prefill(tp, tt[:, :S], caches, cfg)
        reset_launch_counts()
        last, _ = tmod.decode_step(tp, tt[:, S:], S, caches, cfg)
    assert last.shape == (2, new, cfg.vocab)
    assert not any(launch_counts().values())
    tol = dict(atol=2e-4, rtol=2e-3) if dtype == "float32" else dict(atol=8e-2, rtol=0)
    np.testing.assert_allclose(_f32(last), _f32(jlast), **tol)
