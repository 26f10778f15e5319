"""K1: the set-associative cache-scan kernel and its plain torch version.

Replaces the Pallas kernel ``_cache_scan_kernel`` of
``repro/kernels/cache_scan.py`` (``HardwareConfig.cache_backend="pallas"``).
Each of the B rows of the ``(B, L)`` inputs is one padded set-group
sub-trace; a row walks its accesses in order against a ``(num_sets, ways)``
tag + metadata state (ChampSim LRU / SRRIP / FIFO) and reports per-access
hit and evict.

``cache_scan_groups`` launches the CUDA kernel (``csrc/cache_scan.cu``) for
CUDA tensors and runs ``cache_scan_plain`` for CPU tensors; there is no
other route. What bounds the kernel on the card and how its design answers
that is noted in the source: each access depends on the last one to its
set, so the bound is latency, not bytes. The kernel walks the sets of a
row in parallel, one team of lanes per set; ``cache_scan_by_set_plain`` is
that decomposition in torch, which the CPU tests hold equal to
``cache_scan_plain`` and the JAX package.

``cache_scan_plain`` is a torch loop over L vectorised over the B rows,
with the same first-match tie-breaks (lowest way index) and padding rules
as the kernel. It is also the ``"scan"`` backend of ``memory/cache.py``
(the reference's ``_simulate_many``), on whatever device the caller picked.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import check_launch, check_rows, count_launch, load_library, on_device

MAX_RRPV = 3  # 2-bit SRRIP

POLICY_IDS = {"lru": 0, "srrip": 1, "fifo": 2}
# What the kernel takes: a block of num_sets teams of `team` lanes (ways
# rounded up to a power of two, at most 32), each lane holding one way, or
# two past 32 ways; timestamps packed beside a 6-bit way index.
MAX_WAYS = 64
MAX_THREADS = 1024
MAX_L = 1 << 25


def team_lanes(ways: int) -> int:
    """Lanes of the team that walks one set: ``ways`` rounded up to a power
    of two, at most 32."""
    return 1 << (min(ways, 32) - 1).bit_length()


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Mask selecting the first True along the last axis."""
    return mask & (torch.cumsum(mask.to(torch.int32), dim=-1) == 1)


def cache_scan_plain(sets, tags, valid, num_sets: int, ways: int, policy: str = "lru"):
    """Plain torch cache scan: ``(hit, evict)`` bool ``(B, L)`` tensors.

    ``t`` (the LRU/FIFO timestamp) is the access index, padding included.
    Padded accesses leave the state untouched and report a miss.
    """
    if policy not in POLICY_IDS:
        raise ValueError(f"unknown policy {policy!r}; options: {sorted(POLICY_IDS)}")
    B, L = sets.shape
    dev = sets.device
    state_tags = torch.full((B, num_sets, ways), -1, dtype=torch.int32, device=dev)
    meta0 = MAX_RRPV if policy == "srrip" else -1
    meta = torch.full((B, num_sets, ways), meta0, dtype=torch.int32, device=dev)
    rows = torch.arange(B, device=dev)
    hits = torch.zeros((B, L), dtype=torch.bool, device=dev)
    evicts = torch.zeros((B, L), dtype=torch.bool, device=dev)
    for i in range(L):
        s = sets[:, i].long()
        tag = tags[:, i].to(torch.int32)[:, None]
        v = valid[:, i]
        row_tags = state_tags[rows, s]
        row_meta = meta[rows, s]
        hit_vec = row_tags == tag
        hit = hit_vec.any(dim=1)
        hit_mask = _first_true(hit_vec)
        if policy == "srrip":
            inc = (MAX_RRPV - row_meta.amax(dim=1)).clamp_min(0)
            aged = row_meta + inc[:, None]
            victim_mask = _first_true(aged == MAX_RRPV)
            new_meta_hit = torch.where(hit_mask, 0, row_meta)
            new_meta_miss = torch.where(victim_mask, MAX_RRPV - 1, aged)
        else:
            # Invalid ways carry -1 < any timestamp, so the first minimum is
            # the first invalid way when one exists (ChampSim behaviour).
            masked = torch.where(row_tags < 0, -1, row_meta)
            victim_mask = _first_true(masked == masked.amin(dim=1, keepdim=True))
            if policy == "lru":
                new_meta_hit = torch.where(hit_mask, i, row_meta)
            else:  # fifo: hits do not touch metadata
                new_meta_hit = row_meta
            new_meta_miss = torch.where(victim_mask, i, row_meta)
        evict = v & ~hit & (victim_mask & (row_tags >= 0)).any(dim=1)
        hit_b = hit[:, None]
        new_meta = torch.where(hit_b, new_meta_hit, new_meta_miss)
        new_tags = torch.where(hit_b, row_tags, torch.where(victim_mask, tag, row_tags))
        upd = v[:, None]
        state_tags[rows, s] = torch.where(upd, new_tags, row_tags)
        meta[rows, s] = torch.where(upd, new_meta, row_meta).to(torch.int32)
        hits[:, i] = hit & v
        evicts[:, i] = evict
    return hits, evicts


def set_sequences(sets, valid, num_sets: int):
    """Each row's per-set sub-sequences, as the kernels' teams walk them.

    Returns ``seq``, ``(B * num_sets, steps)`` int64: team ``b * num_sets +
    s`` holds the flat positions ``b * L + p`` of row b's valid accesses to
    set s, in row order, then -1 (``steps`` = the longest). Invalid and
    out-of-range accesses belong to no team.
    """
    B, L = sets.shape
    dev = sets.device
    s = sets.long()
    ok = valid & (s >= 0) & (s < num_sets)
    n_teams = B * num_sets
    team = torch.where(ok, torch.arange(B, device=dev)[:, None] * num_sets + s, n_teams)
    pos = torch.arange(L, device=dev).expand(B, L)
    order = torch.argsort((team * L + pos).reshape(-1))
    team_o = team.reshape(-1)[order]
    keep = team_o < n_teams
    order, team_o = order[keep], team_o[keep]
    count = torch.bincount(team_o, minlength=n_teams)
    start = torch.cumsum(count, 0) - count
    rank = torch.arange(order.numel(), device=dev) - start[team_o]
    steps = int(count.max()) if count.numel() else 0
    seq = torch.full((n_teams, steps), -1, dtype=torch.long, device=dev)
    seq[team_o, rank] = order
    return seq


def cache_scan_by_set_plain(sets, tags, valid, num_sets: int, ways: int, policy: str = "lru"):
    """``cache_scan_plain`` computed as the kernel's teams compute it.

    Each row is split into its per-set sub-sequences (``set_sequences``: the
    valid accesses to one set, in row order, with their row positions as
    timestamps), and every (row, set) sequence walks a one-set cache of
    ``ways`` ways alone. The victim is the least key ``order << 6 | way`` of
    the kernel (LRU/FIFO order: timestamp + 1, 0 for an invalid way; SRRIP
    order: 3 - RRPV, whose least value is also the aging step). Returns
    ``(hit, evict)`` bool ``(B, L)``, equal to ``cache_scan_plain``'s.
    """
    if policy not in POLICY_IDS:
        raise ValueError(f"unknown policy {policy!r}; options: {sorted(POLICY_IDS)}")
    B, L = sets.shape
    dev = sets.device
    seq = set_sequences(sets, valid, num_sets)
    n_teams = seq.shape[0]
    flat_tags = tags.reshape(-1).to(torch.int32)
    way = torch.arange(ways, dtype=torch.int32, device=dev)
    state_tags = torch.full((n_teams, ways), -1, dtype=torch.int32, device=dev)
    meta = torch.full((n_teams, ways), MAX_RRPV if policy == "srrip" else -1,
                      dtype=torch.int32, device=dev)
    hits = torch.zeros(B * L, dtype=torch.bool, device=dev)
    evicts = torch.zeros(B * L, dtype=torch.bool, device=dev)
    for j in range(seq.shape[1]):
        at = seq[:, j]
        live = at >= 0
        idx = at.clamp_min(0)
        t = (idx % L).to(torch.int32)[:, None]      # the row position: the timestamp
        tag = flat_tags[idx][:, None]
        hit_vec = state_tags == tag
        hit = hit_vec.any(dim=1)
        hit_mask = _first_true(hit_vec)
        if policy == "srrip":
            order_key = MAX_RRPV - meta
        else:
            order_key = torch.where(state_tags < 0, 0, meta + 1)
        key = (order_key << 6) | way
        least = key.amin(dim=1, keepdim=True)
        victim_mask = way == (least & 63)
        if policy == "srrip":
            new_meta_hit = torch.where(hit_mask, 0, meta)
            new_meta_miss = torch.where(victim_mask, MAX_RRPV - 1, meta + (least >> 6))
        elif policy == "lru":
            new_meta_hit = torch.where(hit_mask, t, meta)
            new_meta_miss = torch.where(victim_mask, t, meta)
        else:  # fifo: hits do not touch metadata
            new_meta_hit = meta
            new_meta_miss = torch.where(victim_mask, t, meta)
        hit_b = hit[:, None]
        upd = live[:, None]
        new_tags = torch.where(hit_b, state_tags, torch.where(victim_mask, tag, state_tags))
        evict = live & ~hit & (victim_mask & (state_tags >= 0)).any(dim=1)
        meta = torch.where(upd, torch.where(hit_b, new_meta_hit, new_meta_miss), meta)
        state_tags = torch.where(upd, new_tags, state_tags)
        hits[idx[live]] = hit[live]
        evicts[idx[live]] = evict[live]
    return hits.reshape(B, L), evicts.reshape(B, L)


def _launcher():
    fn = load_library("cache_scan").cache_scan_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def blocks_per_sm(L: int, num_sets: int, ways: int, policy: str = "lru") -> int:
    """Blocks (rows) of one launch of this shape resident on one SM of the
    current card."""
    fn = load_library("cache_scan").cache_scan_occupancy
    blocks = ctypes.c_int(0)
    check_launch("cache_scan (occupancy)", fn(
        ctypes.c_int(L), ctypes.c_int(num_sets), ctypes.c_int(ways),
        ctypes.c_int(POLICY_IDS[policy]), ctypes.byref(blocks)))
    return blocks.value


def cache_scan_groups(sets, tags, valid, num_sets: int, ways: int, policy: str = "lru"):
    """Run B padded set-group sub-traces through the cache scan.

    ``sets``/``tags`` are int32 ``(B, L)``, ``valid`` bool ``(B, L)``, all on
    one device and contiguous. Returns ``(hit, evict)`` bool ``(B, L)`` on
    that device: the CUDA kernel for CUDA tensors, ``cache_scan_plain`` for
    CPU tensors. The kernel takes ``ways <= MAX_WAYS``, ``num_sets x
    team_lanes(ways) <= MAX_THREADS`` and ``L <= MAX_L``; a CUDA call outside
    them, or a failed build or launch, raises.
    """
    if policy not in POLICY_IDS:
        raise ValueError(f"unknown policy {policy!r}; options: {sorted(POLICY_IDS)}")
    check_rows("cache_scan", sets, tags, valid)
    if sets.device.type == "cpu":
        return cache_scan_plain(sets, tags, valid, num_sets, ways, policy)
    B, L = sets.shape
    if not (num_sets >= 1 and 1 <= ways <= MAX_WAYS and L <= MAX_L
            and num_sets * team_lanes(ways) <= MAX_THREADS):
        raise ValueError(
            f"cache_scan takes 1 <= ways <= {MAX_WAYS}, num_sets x team <= {MAX_THREADS} "
            f"threads (team = ways rounded up to a power of two, at most 32) and "
            f"L <= {MAX_L}; got num_sets={num_sets}, ways={ways}, L={L}"
        )
    hit = torch.empty((B, L), dtype=torch.bool, device=sets.device)
    evict = torch.empty((B, L), dtype=torch.bool, device=sets.device)
    if B == 0 or L == 0:
        return hit, evict
    with on_device(sets.device):
        err = _launcher()(
            sets.data_ptr(), tags.data_ptr(), valid.data_ptr(), hit.data_ptr(),
            evict.data_ptr(), B, L, int(num_sets), int(ways), POLICY_IDS[policy],
            torch.cuda.current_stream(sets.device).cuda_stream,
        )
    check_launch("cache_scan", err)
    count_launch(cache_scan_groups)
    return hit, evict


cache_scan_groups.launches = 0
