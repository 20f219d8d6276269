"""Beyond-paper: local-search refinement of a consolidation assignment,
copied from ``repro/core/refine.py`` (float64, numpy only), with
``local_search_engine`` on the port's tensor search.

The paper's greedy is *online* (placements are final on arrival). Real
fleets get chances to re-pack offline — after elastic re-mesh events, queue
drains, or periodic rebalancing. ``local_search`` takes any feasible
assignment (usually the greedy's) and hill-climbs with single-workload moves
and pairwise swaps under the same two §V criteria, minimizing the paper's
global objective (total average load). It can only improve the objective and
never leaves the feasible region, so greedy + local_search is a strictly-
better offline allocator at O(iters x W x m) model evaluations (each one the
same Fig-8 check the Pallas scoring kernel batches).

``local_search_engine`` is the device-backed variant: it packs the state
into the engine's tensor representation, runs
``engine_torch.local_search_torch`` (best-improvement relocations, the
additions scored by the shared candidate scorer), and reconstructs the
assignment. Python first-improvement and array
best-improvement may take different descent paths; both are monotone and
criteria-preserving.
"""
from __future__ import annotations

import collections

import numpy as np

from .binpack import ClusterState


def _objective(state: ClusterState) -> float:
    return state.total_avg_load()


def local_search(state: ClusterState, max_iters: int = 100) -> tuple[ClusterState, int]:
    """Greedy first-improvement moves + swaps. Returns (state, n_improvements)."""
    cur = state.clone()
    best = _objective(cur)
    improved_total = 0
    for _ in range(max_iters):
        improved = False
        m = len(cur.servers)
        # single-workload relocations
        for s in range(m):
            for wi in range(len(cur.assignments[s])):
                w = cur.assignments[s][wi]
                for t in range(m):
                    if t == s:
                        continue
                    trial = cur.clone()
                    trial.assignments[s].pop(wi)
                    trial.assignments[t].append(w)
                    if not (trial.check(s).ok and trial.check(t).ok):
                        continue
                    obj = _objective(trial)
                    if obj < best - 1e-12:
                        cur, best = trial, obj
                        improved = True
                        improved_total += 1
                        break
                if improved:
                    break
            if improved:
                break
        if improved:
            continue
        # pairwise swaps
        for s in range(m):
            for t in range(s + 1, m):
                for wi in range(len(cur.assignments[s])):
                    for wj in range(len(cur.assignments[t])):
                        trial = cur.clone()
                        a = trial.assignments[s].pop(wi)
                        b = trial.assignments[t].pop(wj)
                        trial.assignments[s].append(b)
                        trial.assignments[t].append(a)
                        if not (trial.check(s).ok and trial.check(t).ok):
                            continue
                        obj = _objective(trial)
                        if obj < best - 1e-12:
                            cur, best = trial, obj
                            improved = True
                            improved_total += 1
                            break
                    if improved:
                        break
                if improved:
                    break
            if improved:
                break
        if not improved:
            break
    return cur, improved_total


def local_search_engine(state: ClusterState, max_iters: int = 100, *,
                        device=None) -> tuple[ClusterState, int]:
    """Tensor relocation search on the device; returns (state, n_moves).

    Workloads are interchangeable within a profiling-grid type for both §V
    criteria, so the refined type counts are mapped back to concrete
    workloads by redistributing the originals type by type. The additions
    are scored by the CUDA kernel's wrapper; ``device`` is where the search
    runs (None: the card).
    """
    from .binpack_torch import PackedCluster, counts_from_assignments
    from .engine_torch import local_search_torch
    from .workload import type_index

    cluster = PackedCluster.build(list(state.servers), state.D, list(state.alphas),
                                  device=device)
    counts0 = counts_from_assignments(cluster, state.assignments)
    counts1, moves = local_search_torch(cluster, counts0, max_iters=max_iters)

    pool = collections.defaultdict(list)
    for ws in state.assignments:
        for w in ws:
            pool[type_index(w)].append(w)
    c = counts1.cpu().numpy().round().astype(int)
    assignments = []
    for s in range(len(state.servers)):
        ws = []
        for t in np.nonzero(c[s])[0]:
            for _ in range(c[s, t]):
                ws.append(pool[int(t)].pop())
        assignments.append(ws)
    refined = ClusterState(state.servers, state.D, state.alphas, assignments)
    return refined, int(moves)
