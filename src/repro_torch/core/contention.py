"""The pairwise-profiling pipeline of the additive degradation model (C3+C4).

The paper's methodology, reproduced here:

  * §IV.B profiles D_{i,j} -- the degradation workload i causes on j -- by
    running every *pair* of grid workload types: (10x23)^2 = 52_900 runs per
    server. The additive model D_j = sum_{i != j} D_{i,j} (Eqn 3) then
    predicts N-way co-run degradation from pairs only.

Profiling here runs against the simulator (our testbed stand-in), fully
vectorized in numpy (float64); the engine's ground-truth rate tables come
from the same per-type tables.
"""
from __future__ import annotations

import functools
from typing import Sequence

import numpy as np

from .server import ServerSpec
from .simulator import (_BASELINE, _capacities, _demands, _sensitivity, competing_cache_bytes,
                        throughput_after_cache)
from .throughput import solo_throughput
from .workload import Workload, grid_types, type_index


def tdp_lhs(server: ServerSpec, workloads: Sequence[Workload]) -> float:
    """Eqn (2) LHS: competing data, excluding FS of workloads larger than LLC."""
    return competing_cache_bytes(server, workloads)


def type_tables(
    server: ServerSpec, types: Sequence[Workload] | None = None
) -> dict[str, np.ndarray]:
    """Per-type simulator tables in both cache states (keep / lost).

    Returns arrays indexed by grid type: ``solo`` / ``base_lost`` throughputs
    [T], per-resource ``dem_keep``/``dem_lost``/``sens_keep``/``sens_lost``
    [T, 3] (resources ordered mem, disk, cpu), resource capacities ``cap``
    [3], and ``comp_bytes`` [T] (RS + FS when LLC-resident, Eqn 2's per-type
    contribution). Shared by :func:`profile_pairwise_fast` and the engine's
    rate tables (engine_torch.PackedDynamics); the default-grid case is
    cached per server spec (callers treat the tables as read-only), so
    profiling, pair matrices, and engine construction compute them once.
    """
    if types is None:
        return _grid_type_tables(server)
    return _type_tables_uncached(server, types)


@functools.lru_cache(maxsize=None)
def _grid_type_tables(server: ServerSpec) -> dict[str, np.ndarray]:
    return _type_tables_uncached(server, grid_types("read"))


def _type_tables_uncached(
    server: ServerSpec, types: Sequence[Workload]
) -> dict[str, np.ndarray]:
    rs = np.array([w.rs for w in types])
    fs = np.array([w.fs for w in types])

    solo = np.array([solo_throughput(server, w) for w in types])
    base_lost = np.array([throughput_after_cache(server, w, True) for w in types])

    caps = _capacities(server)
    res_names = ("mem", "disk", "cpu")

    def stack(lost: bool):
        base = base_lost if lost else solo
        dem = np.zeros((len(types), 3))
        sens = np.zeros((len(types), 3))
        for t, w in enumerate(types):
            d = _demands(server, w, base[t], lost)
            s = _sensitivity(server, w, base[t], d)
            dem[t] = [d[r] for r in res_names]
            sens[t] = [s[r] for r in res_names]
        return dem, sens

    dem_k, sens_k = stack(False)
    dem_l, sens_l = stack(True)
    return {
        "rs": rs,
        "fs": fs,
        "solo": solo,
        "base_lost": base_lost,
        "dem_keep": dem_k,
        "dem_lost": dem_l,
        "sens_keep": sens_k,
        "sens_lost": sens_l,
        "cap": np.array([caps[r] for r in res_names]),
        "comp_bytes": rs + np.where(fs <= server.llc_bytes, fs, 0.0),
    }


def _pair_slowdown_grid(
    dem_i: np.ndarray, dem_j: np.ndarray, sens_j: np.ndarray, cap: np.ndarray
) -> np.ndarray:
    """d_{i,j} for every type pair under fixed demand/sensitivity tables.

    Per resource, excess-over-capacity sharing plus the baseline-interference
    term, composed multiplicatively over resources. Inputs are [i, j, r]
    broadcastable.
    """
    total = dem_i + dem_j
    with np.errstate(divide="ignore", invalid="ignore"):
        excess = np.where(total > 0, np.maximum(0.0, 1.0 - cap[None, None, :] / total), 0.0)
    baseline = dem_i / (dem_i + _BASELINE * cap[None, None, :])
    slow = 1.0 - (1.0 - excess) * (1.0 - baseline)
    return 1.0 - np.prod(1.0 - sens_j * slow, axis=-1)


def pair_slowdown_matrices(
    server: ServerSpec, types: Sequence[Workload] | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """(d_keep [T, T], d_lost [T, T]): slowdown type i imposes on type j.

    Unlike :func:`profile_pairwise_fast` (which resolves the cache outcome
    *per pair*, as physical pair profiling would), these matrices fix the
    cache state globally: ``d_keep`` assumes the set kept the LLC, ``d_lost``
    that it overflowed. The online engine picks per-step which matrix applies
    from the live co-run set, reproducing the simulator's co-run rates
    exactly for grid-typed workloads.
    """
    tt = type_tables(server, types)
    d_keep = _pair_slowdown_grid(
        tt["dem_keep"][:, None, :], tt["dem_keep"][None, :, :],
        tt["sens_keep"][None, :, :], tt["cap"])
    d_lost = _pair_slowdown_grid(
        tt["dem_lost"][:, None, :], tt["dem_lost"][None, :, :],
        tt["sens_lost"][None, :, :], tt["cap"])
    return d_keep, d_lost


def profile_pairwise_fast(server: ServerSpec, types: Sequence[Workload] | None = None) -> np.ndarray:
    """The paper's 52_900-run profiling pass on the simulator, vectorized.

    Returns the D matrix, D[i, j] = degradation that a workload of type i
    causes on a co-running workload of type j, with the cache outcome
    resolved per pair (as physical pair profiling would).
    """
    tt = type_tables(server, types)  # default grid hits the per-spec cache
    rs, fs = tt["rs"], tt["fs"]
    solo, base_lost = tt["solo"], tt["base_lost"]
    base_k, dem_k, sens_k = solo, tt["dem_keep"], tt["sens_keep"]
    base_l, dem_l, sens_l = base_lost, tt["dem_lost"], tt["sens_lost"]
    cap = tt["cap"]

    # pair cache outcome: competing bytes of {i, j} vs the physical tolerance
    comp = (rs[:, None] + rs[None, :]
            + np.where(fs <= server.llc_bytes, fs, 0.0)[:, None]
            + np.where(fs <= server.llc_bytes, fs, 0.0)[None, :])
    overflow = comp > server.llc_tolerance * server.llc_bytes  # [i, j]

    ov = overflow[:, :, None]
    dem_i = np.where(ov, dem_l[:, None, :], dem_k[:, None, :])  # [i, j, r]
    dem_j = np.where(ov, dem_l[None, :, :], dem_k[None, :, :])  # [i, j, r]
    sens_j = np.where(ov, sens_l[None, :, :], sens_k[None, :, :])  # [i, j, r]
    base_j = np.where(overflow, base_l[None, :], base_k[None, :])  # [i, j]

    d = _pair_slowdown_grid(dem_i, dem_j, sens_j, cap)
    t_j = base_j * (1.0 - d)
    return 1.0 - t_j / solo[None, :]


# --- Additive model (Eqn 3) ----------------------------------------------------

def additive_degradation(D: np.ndarray, members: Sequence[int]) -> np.ndarray:
    """Eqn (3): predicted D_j = sum_{i != j} D[i, j] for each member j.

    ``members`` are profiling-grid type indices of the co-located set
    (duplicates allowed -- N identical workloads is the Fig 3-4 case).
    """
    idx = np.asarray(members, dtype=int)
    if idx.size == 0:
        return np.zeros(0)
    sub = D[np.ix_(idx, idx)]
    col_sum = sub.sum(axis=0)
    self_term = np.diagonal(sub)
    return col_sum - self_term


def predict_degradations(
    D: np.ndarray, workloads: Sequence[Workload]
) -> np.ndarray:
    """Additive-model degradation prediction for concrete workloads.

    Workloads are snapped to the profiling grid for D-matrix lookup, exactly
    as the paper's scheduler consults previously collected D_{x,y}s (Fig 8).
    Predictions are clipped to [0, 1): a degradation can't exceed 100%.
    """
    members = [type_index(w) for w in workloads]
    return np.clip(additive_degradation(D, members), 0.0, 0.999999)
