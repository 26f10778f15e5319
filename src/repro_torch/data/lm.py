"""Deterministic synthetic LM data pipeline (a copy of ``repro/data/lm.py``).

Token streams follow a Zipf unigram distribution with a short Markov
"phrase" structure — enough signal that a real LM's loss falls well below
the unigram entropy (tests assert this), while staying fully offline and
reproducible. Batches are a pure function of (seed, step): restart-safe by
construction (checkpoint stores only the step), and each host can slice its
shard without coordination (SPMD loading).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np


@dataclass(frozen=True)
class LMDataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    zipf_s: float = 1.1
    phrase_len: int = 8        # deterministic continuation run length
    seed: int = 0


def _zipf_cdf(vocab: int, s: float) -> np.ndarray:
    p = 1.0 / np.power(np.arange(1, vocab + 1, dtype=np.float64), s)
    p /= p.sum()
    return np.cumsum(p)


_CDF_CACHE: Dict = {}


def lm_batch(cfg: LMDataConfig, step: int) -> Dict[str, np.ndarray]:
    """Batch for ``step``: tokens (B, S+1) -> inputs/labels are shifted views."""
    key = (cfg.vocab, cfg.zipf_s)
    if key not in _CDF_CACHE:
        _CDF_CACHE[key] = _zipf_cdf(cfg.vocab, cfg.zipf_s)
    cdf = _CDF_CACHE[key]

    rng = np.random.default_rng((cfg.seed, step))
    B, S = cfg.global_batch, cfg.seq_len
    n_phrases = -(-(S + 1) // cfg.phrase_len)
    starts = np.searchsorted(cdf, rng.random((B, n_phrases))).astype(np.int64)
    # phrase structure: token t+1 = (t * 31 + 7) % vocab within a phrase —
    # deterministic continuations a model can learn.
    offs = np.arange(cfg.phrase_len, dtype=np.int64)
    toks = starts[..., None]
    seq = [toks]
    cur = toks
    for _ in range(cfg.phrase_len - 1):
        cur = (cur * 31 + 7) % cfg.vocab
        seq.append(cur)
    full = np.concatenate(seq, axis=-1).reshape(B, -1)[:, : S + 1]
    return {
        "tokens": full[:, :-1].astype(np.int32),
        "labels": full[:, 1:].astype(np.int32),
    }


def lm_batch_iterator(cfg: LMDataConfig, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    step = start_step
    while True:
        yield lm_batch(cfg, step)
        step += 1


def host_shard(batch: Dict[str, np.ndarray], host_id: int, num_hosts: int):
    """Slice this host's rows (SPMD data loading)."""
    out = {}
    for k, v in batch.items():
        per = v.shape[0] // num_hosts
        out[k] = v[host_id * per : (host_id + 1) * per]
    return out
