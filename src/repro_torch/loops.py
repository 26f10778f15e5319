"""Loops of identical trips.

``trips(n)`` is ``range(n)`` for a loop whose every trip runs the same ops
on tensors of the same shapes: the microbatches of a train step and the
steps of the sequential SSD recurrence. A cost analysis that folds such
loops (``launch.hlo_analysis``, as the dry run runs it) sees one trip and
multiplies that trip's counts, its backward's included, by n: the
counterpart of the reference's analysis, which multiplies a ``while`` body
by its known trip count. Only shapes matter there (the tensors are fake),
so ``stacked`` lets the one traced trip's output stand for every trip.
Without an analysis both are the plain loop and ``torch.stack``.
"""
from __future__ import annotations

from typing import Iterator, List, Optional

import torch

# The analysis that folds loops, while one runs (``launch.hlo_analysis``):
# an object with ``enter(n)`` and ``exit()``.
_folder: Optional[object] = None


def trips(n: int) -> Iterator[int]:
    """``range(n)``; under a folding analysis, the first trip only, with
    its counts multiplied by ``n``."""
    folder = _folder
    if folder is None or n <= 1:
        yield from range(n)
        return
    folder.enter(n)
    try:
        yield 0
    finally:
        folder.exit()


def stacked(ys: List[torch.Tensor], n: int, dim: int) -> torch.Tensor:
    """``torch.stack(ys, dim)`` of a ``trips(n)`` loop's per-trip outputs;
    a folded loop's one output repeated to ``n`` along ``dim`` (a view)."""
    out = torch.stack(ys, dim=dim)
    if len(ys) == n:
        return out
    if len(ys) != 1 or _folder is None:
        raise ValueError(f"{len(ys)} outputs of a loop of {n} trips")
    shape = list(out.shape)
    shape[dim] = n
    return out.expand(shape)
