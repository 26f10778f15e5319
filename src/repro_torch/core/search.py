"""Successive-halving Pareto search over the DSE grid.

Exhaustive sweeps stop scaling around 10^3 configs; most of that work
evaluates configs nowhere near the frontier. ``search()``
prunes with cheap **low-fidelity** passes before spending full evaluations:

  * **Fidelity = trace batches.** A workload subsampled to its first k
    batches (``dataclasses.replace(wl, num_batches=k)``) runs the identical
    engine on a shorter trace — the relative ordering of configs is highly
    stable in k because classification is trace-driven, while cost scales
    ~linearly with k. The ladder grows k by ``eta`` per rung up to the full
    workload.
  * **Successive halving by memo-key group.** Each rung evaluates the
    surviving population through the memoized ``sweep(configs=...)`` engine
    (so degenerate configs still collapse), groups entries by memo key
    (group members are byte-identical by construction), and keeps the best
    ``1/eta`` of groups — ALWAYS including every currently non-dominated
    group, so a frontier config can only be pruned by a rung that already
    sees it dominated.
  * **Exact final rung.** Survivors re-evaluate at full fidelity; the
    returned front is computed from those exact results. On the 24-config
    reference grid the search recovers the exhaustive Pareto front in
    ``(total_cycles, energy_pj)`` within <=50% of the exhaustive full-
    fidelity evaluations (test-enforced; low-fidelity rungs are the cheap
    part and are reported separately).

The search composes with the rest of the scaling layer: ``devices=`` shards
every rung's sweep and ``checkpoint_dir=`` journals each rung to its own
``SweepCheckpoint`` file, so a killed search resumes rung-by-rung.
"""
from __future__ import annotations

import dataclasses
import math
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

from ..device import DeviceLike, indexed_device
from .hardware import HardwareConfig, tpuv6e
from .sweep import SweepConfig, SweepEntry, SweepResult, grid_configs, sweep
from .workload import Workload

__all__ = ["SearchResult", "pareto_front", "nondominated_ranks", "search"]

DEFAULT_OBJECTIVES = ("total_cycles", "energy_pj")


def _objective_point(entry: SweepEntry, objectives: Sequence[str]) -> Tuple[float, ...]:
    summ = entry.result.summary()
    return tuple(float(summ[o]) for o in objectives)


def _dominates(a: Sequence[float], b: Sequence[float]) -> bool:
    """a Pareto-dominates b (minimization): <= everywhere, < somewhere."""
    return all(x <= y for x, y in zip(a, b)) and any(x < y for x, y in zip(a, b))


def pareto_front(
    entries: Sequence[SweepEntry],
    objectives: Sequence[str] = DEFAULT_OBJECTIVES,
) -> List[SweepEntry]:
    """Non-dominated entries (minimization; ties all stay on the front),
    in input order."""
    pts = [_objective_point(e, objectives) for e in entries]
    return [
        e for i, e in enumerate(entries)
        if not any(_dominates(pts[j], pts[i]) for j in range(len(entries)) if j != i)
    ]


def nondominated_ranks(points: Sequence[Tuple[float, ...]]) -> List[int]:
    """Non-dominated sorting rank per point (0 = frontier, 1 = frontier
    after removing rank 0, ...). O(n^2) peeling — populations here are
    config grids, not GA swarms."""
    n = len(points)
    ranks = [-1] * n
    remaining = set(range(n))
    r = 0
    while remaining:
        front = [
            i for i in remaining
            if not any(_dominates(points[j], points[i])
                       for j in remaining if j != i)
        ]
        for i in front:
            ranks[i] = r
        remaining -= set(front)
        r += 1
    return ranks


@dataclass
class RungReport:
    num_batches: int          # fidelity of this rung (trace batches)
    configs: int              # population entering the rung
    groups: int               # distinct memo-key groups seen
    kept_groups: int          # groups surviving to the next rung
    wall_seconds: float = 0.0


@dataclass
class SearchResult:
    pareto: List[SweepEntry] = field(default_factory=list)
    population: List[SweepEntry] = field(default_factory=list)  # final full-fidelity survivors
    objectives: Tuple[str, ...] = DEFAULT_OBJECTIVES
    full_evals: int = 0       # distinct full-fidelity memo keys evaluated
    low_fidelity_evals: int = 0
    rungs: List[RungReport] = field(default_factory=list)
    wall_seconds: float = 0.0

    def front_labels(self) -> List[str]:
        return sorted(e.config.label for e in self.pareto)


def _group_by_memo_key(entries: Sequence[SweepEntry]) -> Dict[tuple, List[SweepEntry]]:
    groups: Dict[tuple, List[SweepEntry]] = {}
    for e in entries:
        groups.setdefault(e.memo_key, []).append(e)
    return groups


def _fidelity_workloads(wls: Sequence[Workload], k: int) -> List[Workload]:
    """Subsample every workload to its first k trace batches (same names, so
    the population's configs resolve unchanged)."""
    return [dataclasses.replace(wl, num_batches=min(k, wl.num_batches))
            for wl in wls]


def search(
    workloads: Union[Workload, Sequence[Workload]],
    base_hw: Optional[HardwareConfig] = None,
    *,
    configs: Optional[Sequence[SweepConfig]] = None,
    objectives: Sequence[str] = DEFAULT_OBJECTIVES,
    eta: int = 2,
    min_batches: int = 1,
    seed: int = 0,
    zipf_s=0.8,
    devices=None,
    checkpoint_dir: Optional[str] = None,
    fault_tolerance=None,
    fault_plan=None,
    device: DeviceLike = "cuda",
    **grid_axes,
) -> SearchResult:
    """Find the exact Pareto front in ``objectives`` over the config grid.

    ``configs`` gives the starting population explicitly; otherwise it is
    ``grid_configs(workloads, base_hw, zipf_s=zipf_s, **grid_axes)`` (the
    same axes ``sweep()`` takes: policies/capacities/ways/num_cores/...).

    The front is exact for the survivors by construction (final rung runs
    full fidelity); recovery of the full grid's front is a property of the
    pruning schedule, enforced on the reference grid by tests.

    ``fault_tolerance`` applies to every rung's sweep; rung-level recovery
    composes with per-rung checkpoints — a crashed rung resumes from its
    own journal, shard failures within a rung fail over and stay bitwise.
    ``fault_plan`` (tests/chaos only) is handed to each rung's sweep with a
    fresh injector, so its (shard, round) coordinates are *per rung*, not
    global across the search.

    ``device`` is where every rung's sweep runs: the CUDA card by default
    (raises when there is none), the CPU only when asked.
    """
    device = indexed_device(device)
    base_hw = base_hw or tpuv6e()
    wls: List[Workload] = list(workloads) if isinstance(
        workloads, (list, tuple)) else [workloads]
    if configs is None:
        configs = grid_configs(wls, base_hw, zipf_s=zipf_s, **grid_axes)
    population = list(configs)
    if not population:
        raise ValueError("empty search population")
    if eta < 2:
        raise ValueError(f"eta must be >= 2, got {eta}")

    full_batches = max(wl.num_batches for wl in wls)

    def run_rung(k: int, pop: Sequence[SweepConfig], tag: str) -> SweepResult:
        ckpt = None
        if checkpoint_dir is not None:
            ckpt = os.path.join(checkpoint_dir, f"search_{tag}.ckpt")
        return sweep(
            _fidelity_workloads(wls, k), base_hw, configs=pop, seed=seed,
            devices=devices, checkpoint=ckpt,
            fault_tolerance=fault_tolerance, fault_plan=fault_plan,
            device=device,
        )

    t0 = time.perf_counter()
    out = SearchResult(objectives=tuple(objectives))
    k = max(1, int(min_batches))
    while k < full_batches and len(population) > 1:
        rt0 = time.perf_counter()
        sr = run_rung(k, population, f"rung{k}")
        out.low_fidelity_evals += sr.distinct_memo_keys
        groups = _group_by_memo_key(sr.entries)
        gkeys = list(groups)
        pts = [_objective_point(groups[g][0], objectives) for g in gkeys]
        ranks = nondominated_ranks(pts)
        # Keep the best 1/eta of groups — and never prune a group that is
        # non-dominated at this fidelity (rank 0): the frontier must lose
        # only to observed domination, not to the budget.
        order = sorted(
            range(len(gkeys)),
            key=lambda i: (ranks[i], pts[i], groups[gkeys[i]][0].config.label),
        )
        keep = max(
            math.ceil(len(gkeys) / eta),
            sum(1 for r in ranks if r == 0),
        )
        kept = set(order[:keep])
        population = [
            e.config
            for i in kept
            for e in groups[gkeys[i]]
        ]
        # Deterministic population order (groups can interleave in `kept`).
        population.sort(key=lambda c: c.label)
        out.rungs.append(RungReport(
            num_batches=k, configs=sr.num_configs, groups=len(gkeys),
            kept_groups=len(kept),
            wall_seconds=time.perf_counter() - rt0,
        ))
        k *= eta

    # Final rung: exact, full-fidelity evaluation of the survivors.
    rt0 = time.perf_counter()
    sr = run_rung(full_batches, population, "final")
    out.full_evals = sr.distinct_memo_keys
    out.population = list(sr.entries)
    out.pareto = pareto_front(sr.entries, objectives)
    out.rungs.append(RungReport(
        num_batches=full_batches, configs=sr.num_configs,
        groups=sr.distinct_memo_keys, kept_groups=sr.distinct_memo_keys,
        wall_seconds=time.perf_counter() - rt0,
    ))
    out.wall_seconds = time.perf_counter() - t0
    return out
