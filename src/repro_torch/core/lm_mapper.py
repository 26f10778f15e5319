"""Map assigned LM architectures onto EONSim workloads (beyond-paper).

The paper's pipeline consumes (matrix ops in MNK form) + (embedding ops with
index traces). Any of the 10 assigned archs maps onto that interface:

  * the vocab-embedding lookup is EXACTLY the paper's operation — one table,
    ``vocab`` rows, d_model-dim vectors, one lookup per token, CONCAT pooling,
    with a Zipf token distribution (real token streams are Zipfian);
  * every projection / FFN / logits matmul is an MNK matrix op (MoE counts
    top-k active experts at the routed capacity);
  * attention score/AV products are MNK ops with M = tokens, N = seq.

This lets the simulator answer paper-style questions (SPM vs cache vs pinned
on-chip management) for LM token-embedding traffic — the JAX package's
benchmarks/lm_npu_study.py asks them. A copy of ``repro/core/lm_mapper.py``:
``models.get_config`` builds the configurations the port runs, and
``models.config.ArchConfig`` holds every other one as well.
"""
from __future__ import annotations

import math
from typing import List

from ..models.config import ArchConfig, ShapeConfig
from .workload import EmbeddingOpSpec, MatrixOpSpec, VectorOp, Workload


def _attn_matrix_ops(cfg: ArchConfig, tokens: int, seq: int, causal_frac: float = 0.5):
    dh = cfg.attn_head_dim
    ops = []
    if cfg.mla is not None:
        m = cfg.mla
        qd = m.qk_nope_head_dim + m.qk_rope_head_dim
        ops += [
            MatrixOpSpec(tokens, cfg.n_heads * qd, cfg.d_model, "mla_wq"),
            MatrixOpSpec(tokens, m.kv_lora_rank + m.qk_rope_head_dim, cfg.d_model, "mla_dkv"),
            MatrixOpSpec(tokens, cfg.n_heads * m.qk_nope_head_dim, m.kv_lora_rank, "mla_uk"),
            MatrixOpSpec(tokens, cfg.n_heads * m.v_head_dim, m.kv_lora_rank, "mla_uv"),
            MatrixOpSpec(tokens, cfg.d_model, cfg.n_heads * m.v_head_dim, "mla_wo"),
        ]
        score_k = qd
        v_dim = m.v_head_dim
        heads = cfg.n_heads
    else:
        ops += [
            MatrixOpSpec(tokens, cfg.n_heads * dh, cfg.d_model, "wq"),
            MatrixOpSpec(tokens, cfg.n_kv_heads * dh, cfg.d_model, "wk"),
            MatrixOpSpec(tokens, cfg.n_kv_heads * dh, cfg.d_model, "wv"),
            MatrixOpSpec(tokens, cfg.d_model, cfg.n_heads * dh, "wo"),
        ]
        score_k = dh
        v_dim = dh
        heads = cfg.n_heads
    eff = max(int(seq * causal_frac), 1)
    ops += [
        MatrixOpSpec(tokens * heads, eff, score_k, "qk"),
        MatrixOpSpec(tokens * heads, v_dim, eff, "av"),
    ]
    return ops


def _ffn_matrix_ops(cfg: ArchConfig, tokens: int) -> List[MatrixOpSpec]:
    ops = []
    if cfg.moe is not None:
        m = cfg.moe
        routed = tokens * m.top_k
        ops.append(MatrixOpSpec(tokens, m.num_experts, cfg.d_model, "router"))
        for nm in ("moe_wg", "moe_wu"):
            ops.append(MatrixOpSpec(routed, m.d_ff_expert, cfg.d_model, nm))
        ops.append(MatrixOpSpec(routed, cfg.d_model, m.d_ff_expert, "moe_wd"))
        if m.num_shared_experts:
            f = m.d_ff_shared or m.d_ff_expert * m.num_shared_experts
            ops += [
                MatrixOpSpec(tokens, f, cfg.d_model, "sh_wg"),
                MatrixOpSpec(tokens, f, cfg.d_model, "sh_wu"),
                MatrixOpSpec(tokens, cfg.d_model, f, "sh_wd"),
            ]
    if cfg.d_ff:
        mult = 2 if cfg.mlp_type == "gelu" else 3
        names = ["w1", "w2"] if mult == 2 else ["wg", "wu"]
        for nm in names:
            ops.append(MatrixOpSpec(tokens, cfg.d_ff, cfg.d_model, nm))
        ops.append(MatrixOpSpec(tokens, cfg.d_model, cfg.d_ff, "wd"))
    return ops


def _ssm_matrix_ops(cfg: ArchConfig, tokens: int) -> List[MatrixOpSpec]:
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    H = s.num_heads(cfg.d_model)
    N = s.state_dim
    return [
        MatrixOpSpec(tokens, di, cfg.d_model, "in_z"),
        MatrixOpSpec(tokens, di + 2 * N, cfg.d_model, "in_xbc"),
        MatrixOpSpec(tokens, H, cfg.d_model, "in_dt"),
        # SSD state ops ~ 2 * tokens * di * N (outer products + contractions)
        MatrixOpSpec(tokens, N, di, "ssd_state", count=2),
        MatrixOpSpec(tokens, cfg.d_model, di, "out_proj"),
    ]


def lm_workload(cfg: ArchConfig, shape: ShapeConfig, num_batches: int = 1) -> Workload:
    """EONSim workload for one (arch x shape) cell."""
    B = shape.global_batch
    S = shape.seq_len if shape.kind != "decode" else 1
    tokens = B * S
    train_mult = 3 if shape.is_train else 1      # fwd + bwd ~ 2x fwd

    mat: List[MatrixOpSpec] = []
    n_layers = cfg.n_layers
    if cfg.family == "ssm":
        per_layer = _ssm_matrix_ops(cfg, tokens)
    elif cfg.family == "hybrid":
        per_layer = _ssm_matrix_ops(cfg, tokens)
        shared = _attn_matrix_ops(cfg, tokens, shape.seq_len)
        f = cfg.hybrid.shared_d_ff or 4 * cfg.d_model
        shared += [
            MatrixOpSpec(tokens, f, cfg.d_model, "sh_wg"),
            MatrixOpSpec(tokens, f, cfg.d_model, "sh_wu"),
            MatrixOpSpec(tokens, cfg.d_model, f, "sh_wd"),
        ]
        n_apps = cfg.n_layers // cfg.hybrid.attn_every
        mat += [
            MatrixOpSpec(op.m, op.n, op.k, f"shared_{op.name}", count=op.count * n_apps * train_mult)
            for op in shared
        ]
    elif cfg.family == "audio":
        enc_tokens = B * cfg.encdec.encoder_seq
        enc = _attn_matrix_ops(cfg, enc_tokens, cfg.encdec.encoder_seq, 1.0)
        enc += _ffn_matrix_ops(cfg, enc_tokens)
        mat += [
            MatrixOpSpec(op.m, op.n, op.k, f"enc_{op.name}",
                         count=op.count * cfg.encdec.encoder_layers * train_mult)
            for op in enc
        ]
        per_layer = _attn_matrix_ops(cfg, tokens, shape.seq_len) * 2  # self+cross
        per_layer += _ffn_matrix_ops(cfg, tokens)
    else:
        per_layer = _attn_matrix_ops(cfg, tokens, shape.seq_len)
        per_layer += _ffn_matrix_ops(cfg, tokens)

    mat += [
        MatrixOpSpec(op.m, op.n, op.k, op.name, count=op.count * n_layers * train_mult)
        for op in per_layer
    ]
    mat.append(MatrixOpSpec(tokens, cfg.vocab, cfg.d_model, "logits", count=train_mult))

    emb = EmbeddingOpSpec(
        num_tables=1,
        rows_per_table=cfg.vocab,
        dim=cfg.d_model,
        lookups_per_sample=S,
        vector_op=VectorOp.CONCAT,
        dtype_bytes=2,
        name="token_embedding",
    )
    return Workload(
        name=f"{cfg.name}_{shape.name}",
        matrix_ops=tuple(mat),
        embedding_ops=(emb,),
        batch_size=B,
        num_batches=num_batches,
    )
