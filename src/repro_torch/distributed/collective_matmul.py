"""Overlapped collective matmul over a process group (a port of
``repro/distributed/collective_matmul.py``).

Row-parallel TP (``y = all_reduce(x_loc @ w_loc)``) exposes one big
all-reduce after the product. The ring version splits the output into ``n``
chunks and interleaves point-to-point exchanges with per-chunk products:
each hop's send and receive are posted, the next chunk's product (which does
not depend on them) is issued, and only then does the rank wait for the hop,
so the transfer can hide behind the product:

  at step t, rank d sends its partial sum for chunk (d - t) mod n to rank
  d + 1 and folds its own partial for the chunk it receives, (d - t - 1)
  mod n, into it; after n - 1 hops rank d holds the fully reduced chunk
  (d + 1) mod n (reduce-scatter), which a final all-gather reassembles.

Each rank holds its K-shard of ``x`` (..., M, K/n) and of ``w`` (K/n, N);
every rank returns the whole (..., M, N). The products are ``torch.matmul``
(the reference leaves them to XLA, outside any Pallas kernel); the
exchanges are ``dist.batch_isend_irecv``, the gather ``dist.all_gather``.
The reference's ``shard_map_compat`` shim is JAX's own and has no
counterpart here.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def _global(group, rank: int) -> int:
    return rank if group is None else dist.get_global_rank(group, rank)


def _own_chunk(x_loc: torch.Tensor, w_loc: torch.Tensor, c: int, n_chunks: int) -> torch.Tensor:
    nc = w_loc.shape[-1] // n_chunks
    return x_loc @ w_loc[:, c * nc:(c + 1) * nc]


def ring_matmul(x_loc: torch.Tensor, w_loc: torch.Tensor, group=None) -> torch.Tensor:
    """(..., M, N) = x @ w, fully reduced on every rank of ``group`` (the
    default group if None); N must divide by the group's size."""
    n = dist.get_world_size(group)
    idx = dist.get_rank(group)
    if w_loc.shape[-1] % n:
        raise ValueError(f"ring_matmul: N = {w_loc.shape[-1]} does not divide over {n} ranks")
    msg = _own_chunk(x_loc, w_loc, idx, n)
    right, left = _global(group, (idx + 1) % n), _global(group, (idx - 1) % n)
    for t in range(n - 1):
        incoming = torch.empty_like(msg)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, msg, right, group),
            dist.P2POp(dist.irecv, incoming, left, group),
        ])
        own = _own_chunk(x_loc, w_loc, (idx - t - 1) % n, n)  # while the hop is in flight
        for r in reqs:
            r.wait()
        msg = incoming + own
    # rank d now holds the fully reduced chunk (d + 1) % n
    gathered = [torch.empty_like(msg) for _ in range(n)]
    dist.all_gather(gathered, msg, group)
    return torch.cat([gathered[(j - 1) % n] for j in range(n)], dim=-1)


def psum_matmul(x_loc: torch.Tensor, w_loc: torch.Tensor, group=None) -> torch.Tensor:
    """Baseline: local partial product + one all-reduce (no overlap)."""
    y = x_loc @ w_loc
    dist.all_reduce(y, group=group)
    return y
