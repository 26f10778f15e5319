"""Matrix products at a stated precision, for the plain references and
their controls.

``exact`` is IEEE f32 (TF32 off: ``no_tf32`` sets it). The control rounds
each operand of a product to the next precision down and accumulates in
f32, as the card's tensor cores do: ``tf32`` keeps 10 bits of mantissa
(round to nearest, ties away, as ``cvt.rna.tf32.f32``). Plain torch, the
same on the CPU and the card.
"""
from __future__ import annotations

import torch


def no_tf32() -> None:
    """f32 products in f32 on the card: TF32 off for cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def exact(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a, b)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` with its mantissa rounded to TF32's 10 bits."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(round_tf32(a), round_tf32(b))


PRODUCTS = {"float32": exact, "tf32": tf32}
