"""Cross-entropy without materializing (B, S, V) logits (a port of
``repro/training/losses.py``).

The loss runs over sequence chunks; a chunk's logits stay (B, chunk, V) f32
and only its summed token losses survive. Each chunk runs under
``torch.utils.checkpoint`` when autograd records, so the backward keeps one
chunk's logits at a time, not all of them: at stablelm-3b's vocab of 50,304
and a batch of 8 x 1,024 tokens the whole f32 logits would be 1.65 GB.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..distributed.sharding import constrain
from ..models.layers import remat_call


def _gold(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``logits[..., y]``. Under a mesh the logits are a DTensor sharded
    over the vocabulary, whose gather DTensor cannot run on fake tensors
    (the dry run's): there the label's logit is selected and summed over
    the vocabulary, the same value (every other term a zero)."""
    from torch.distributed.tensor import DTensor

    if isinstance(logits, DTensor):
        vocab = torch.arange(logits.shape[-1], device=y.device)
        return torch.where(vocab == y[..., None].long(), logits, 0.0).sum(dim=-1)
    return torch.take_along_dim(logits, y[..., None].long(), dim=-1)[..., 0]


def _chunk_loss(h_c, head_w, y_c, m_c):
    logits = h_c.float() @ head_w.float()
    lse = torch.logsumexp(logits, dim=-1)
    # Under a mesh the token losses, and so the backward from them, stay
    # batch-sharded: a loss's gradient is seeded replicated, and DTensor
    # (unlike GSPMD) keeps that layout through the backward. A no-op
    # without a mesh.
    return (constrain(lse - _gold(logits, y_c), "dp", None) * m_c).sum()


def chunked_softmax_xent(
    hidden: torch.Tensor,       # (B, S, D) final hidden states
    head_w: torch.Tensor,       # (D, V) lm head
    labels: torch.Tensor,       # (B, S) int
    *,
    chunk: int = 512,
    label_mask: Optional[torch.Tensor] = None,   # (B, S) 1 = count this token
) -> torch.Tensor:
    """Mean token loss over the counted tokens, chunk by chunk in sequence
    order as the reference's ``lax.scan`` sums them."""
    B, S, D = hidden.shape
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"sequence length {S} is not a multiple of the chunk {chunk}")
    if label_mask is None:
        m = torch.ones((B, S), dtype=torch.float32, device=hidden.device)
    else:
        m = label_mask.float()
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    count = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for lo in range(0, S, chunk):
        m_c = m[:, lo:lo + chunk]
        total = total + remat_call(_chunk_loss, hidden[:, lo:lo + chunk], head_w,
                                   labels[:, lo:lo + chunk], m_c, remat=True)
        count = count + m_c.sum()
    return total / torch.clamp(count, min=1.0)


def full_softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Reference (small-model) path."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.take_along_dim(lf, labels[..., None].long(), dim=-1)[..., 0]
    return torch.mean(lse - gold)
