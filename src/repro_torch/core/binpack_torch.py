"""PyTorch implementation of the paper's consolidation algorithm (Fig 8).

Counterpart of ``repro/core/binpack_jax.py``: the greedy of Fig 8 as tensor
ops that score every server in parallel, with the same state encoding.

State encoding
--------------
Workloads live on the paper's profiling grid of T types (230 = 10 RS x 23 FS).
A cluster of m servers is

  counts  : f32[m, T]   -- number of resident workloads of each type per server
  D       : f32[m, T, T]-- profiled pairwise degradation per server, D[s, i, j]
                           = degradation type-i causes on type-j on server s
  rs, fs  : f32[T]      -- grid coordinates (bytes)
  llc     : f32[m]      -- alpha_s * CacheSize_s   (criterion-2 budget)
  resident: f32[m, T]   -- 1.0 where fs_t <= CacheSize_s (Eqn 2's CS set)

The additive model (Eqn 3) for a type-t workload on server s with counts c:
  D_pred[s, t] = (c @ D[s])[t] - D[s, t, t]        (exclude its own pair-self)
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..device import resolve_device
from .server import ServerSpec
from .workload import FS_GRID, RS_GRID, Workload, type_index

QUEUED = -1  # sentinel placement: no feasible server (criterion-1 queue)

#: scores closer than this are treated as tied (lowest server index wins) --
#: the f32 analogue of the Python greedy's ``score < best - 1e-12`` rule
SCORE_MARGIN = 1e-6


@dataclasses.dataclass(frozen=True)
class PackedCluster:
    """Immutable device-side cluster description (see module docstring).

    ``active`` is the fleet-health mask (1.0 = eligible for placement): an
    inactive server keeps its rows in every table, but candidate scoring
    treats it as infeasible, exactly like a server that fails both criteria.
    """

    D: torch.Tensor  # f32[m, T, T]
    rs: torch.Tensor  # f32[T]
    fs: torch.Tensor  # f32[T]
    llc_budget: torch.Tensor  # f32[m] = alpha_s * CacheSize_s
    resident: torch.Tensor  # f32[m, T]
    active: torch.Tensor  # f32[m] 1.0 = placement-eligible (fleet-health mask)
    degradation_limit: float = 0.5

    @classmethod
    def build(
        cls,
        servers: Sequence[ServerSpec],
        D: Sequence[np.ndarray | torch.Tensor] | np.ndarray | torch.Tensor,
        alpha: float | Sequence[float] = 1.3,
        active: np.ndarray | None = None,
        *,
        device: str | torch.device | None = None,
    ) -> "PackedCluster":
        """Host tables in numpy (float32 casts of the same float64 values the
        JAX package casts), then one copy to ``device``. Each D-matrix, numpy
        or tensor, is cast to float32 on ``device``; one already there (the
        adaptive loop's estimates) makes no trip through the host."""
        device = resolve_device(device)
        m = len(servers)
        if isinstance(D, (np.ndarray, torch.Tensor)):
            D = [D] * m
        if isinstance(alpha, (int, float)):
            alpha = [float(alpha)] * m
        rs = np.asarray(RS_GRID, np.float32)
        fs = np.asarray(FS_GRID, np.float32)
        rs_t = np.repeat(rs, fs.shape[0])
        fs_t = np.tile(fs, rs.shape[0])
        llc = np.asarray([a * s.llc_bytes for a, s in zip(alpha, servers)], np.float32)
        cache = np.asarray([s.llc_bytes for s in servers], np.float32)
        resident = (fs_t[None, :] <= cache[:, None]).astype(np.float32)
        act = np.ones(m, np.float32) if active is None else np.asarray(active, np.float32)
        D_dev = torch.stack([torch.as_tensor(d).to(device=device, dtype=torch.float32)
                             for d in D])
        host = dict(rs=rs_t, fs=fs_t, llc_budget=llc, resident=resident, active=act)
        return cls(D=D_dev, **{k: torch.from_numpy(v).to(device) for k, v in host.items()})

    @property
    def m(self) -> int:
        return self.D.shape[0]

    @property
    def T(self) -> int:
        return self.D.shape[1]

    @property
    def device(self) -> torch.device:
        return self.D.device


def counts_from_assignments(cluster: PackedCluster,
                            assignments: Sequence[Sequence[Workload]]) -> torch.Tensor:
    """Resident type counts [m, T] of per-server workload lists, on the
    cluster's device."""
    c = np.zeros((cluster.m, cluster.T), np.float32)
    for s, ws in enumerate(assignments):
        for w in ws:
            c[s, type_index(w)] += 1.0
    return torch.from_numpy(c).to(cluster.device)


# --- per-server loads, fully vectorized ----------------------------------------

def server_loads(cluster: PackedCluster, counts: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(cache_in_use[m], max_degradation[m]) for the current counts.

    cache_in_use is criterion 2's LHS over its budget; max_degradation is
    criterion 1's Max(D_y) from the additive model over resident workloads.
    """
    comp = counts @ cluster.rs + (counts * cluster.resident) @ cluster.fs  # [m]
    col = torch.einsum("mt,mtu->mu", counts, cluster.D)  # [m, T] = c @ D
    return loads_from_sums(cluster, counts, comp, col)


def loads_from_sums(
    cluster: PackedCluster, counts: torch.Tensor, comp: torch.Tensor, col0: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`server_loads` from per-server base sums: ``comp`` [m] (Eqn 2's
    competing bytes) and ``col0`` [m, T] = counts @ D."""
    cache = comp / cluster.llc_budget
    d_pred = col0 - torch.diagonal(cluster.D, dim1=1, dim2=2)  # exclude self-pair
    d_pred = torch.clamp(d_pred, 0.0, 1.0)
    present = counts > 0
    max_d = torch.where(present, d_pred, -torch.inf).amax(1)
    max_d = torch.where(present.any(1), max_d, 0.0)
    return cache, max_d


def avg_loads(cluster: PackedCluster, counts: torch.Tensor) -> torch.Tensor:
    cache, max_d = server_loads(cluster, counts)
    return 0.5 * (cache + max_d)


# --- the shared candidate scorer (Fig 8 steps 2-4, batched) ---------------------

def score_candidates_torch(
    cluster: PackedCluster, counts: torch.Tensor, wtypes: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(cache_after [Q, m], maxd_after [Q, m]) for placing each candidate type.

    Incremental form of the shared scoring contract: per-server base sums
    (``counts @ D``) are computed once and each candidate adds one gathered
    row of D, so the cost is O(Q * m * T) instead of O(Q * m * T^2).
    """
    comp0 = counts @ cluster.rs + (counts * cluster.resident) @ cluster.fs  # [m]
    col0 = torch.einsum("mt,mtu->mu", counts, cluster.D)  # [m, T]
    return scores_from_sums(cluster, counts, comp0, col0, wtypes)


def scores_from_sums(
    cluster: PackedCluster, counts: torch.Tensor, comp0: torch.Tensor,
    col0: torch.Tensor, wtypes: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`score_candidates_torch` from per-server base sums: ``comp0`` [m]
    (Eqn 2's competing bytes) and ``col0`` [m, T] = counts @ D."""
    wl = torch.atleast_1d(wtypes).long()
    delta = cluster.rs[wl][None, :] + cluster.resident[:, wl] * cluster.fs[wl][None, :]
    cache_after = (comp0[:, None] + delta) / cluster.llc_budget[:, None]  # [m, Q]
    diag = torch.diagonal(cluster.D, dim1=1, dim2=2)  # [m, T]
    col_after = col0[:, None, :] + cluster.D[:, wl, :]  # [m, Q, T]
    d_pred = torch.clamp(col_after - diag[:, None, :], 0.0, 1.0)
    # one-hot by comparison: one_hot() reads the types' range back to the
    # host on the CPU, and this runs inside the event loop's blocks
    types = torch.arange(cluster.T, device=counts.device)
    onehot = (wl[:, None] == types[None, :]).to(counts.dtype)  # [Q, T]
    present = (counts[:, None, :] + onehot[None, :, :]) > 0
    maxd_after = torch.where(present, d_pred, -torch.inf).amax(-1)  # [m, Q]
    return cache_after.T, maxd_after.T


def argmin_with_margin(score: torch.Tensor, margin: float = SCORE_MARGIN) -> torch.Tensor:
    """First index along dim 1 whose score is within ``margin`` of the min.

    The pure-Python greedy keeps the earlier server unless a later one
    improves by more than 1e-12; preferring the first near-minimal index
    reproduces its tie-breaking. ``argmax`` returns the first maximal index
    (PyTorch's documented rule); it runs on int32 because a bool argmax is
    not supported on every device.
    """
    smin = score.amin(1, keepdim=True)
    return (score <= smin + margin).to(torch.int32).argmax(1)


def greedy_choice(
    cluster: PackedCluster,
    counts: torch.Tensor,
    cache_after: torch.Tensor,  # [Q, m] from any scoring backend
    maxd_after: torch.Tensor,  # [Q, m]
    objective: str = "sum_avg",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fig 8 step 5 over pre-computed candidate scores.

    Returns (server [Q], feasible_any [Q]); server == QUEUED where no server
    passes both criteria. Servers masked out by ``cluster.active`` are
    infeasible regardless of their scores.
    """
    avg_after = 0.5 * (cache_after + maxd_after)
    if objective == "sum_avg":  # Table II semantics: minimize the load increase
        score = avg_after - avg_loads(cluster, counts)[None, :]
    else:  # literal Fig 8: minimize the post-allocation average
        score = avg_after
    return choose(cluster, cache_after, maxd_after, score)


def choose(
    cluster: PackedCluster, cache_after: torch.Tensor, maxd_after: torch.Tensor,
    score: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Lowest-``score`` server [Q] among those that pass both criteria and
    the ``cluster.active`` mask, and whether one does; QUEUED where none."""
    return choose_scored(cluster, cache_after, maxd_after, score)[:2]


def choose_scored(
    cluster: PackedCluster, cache_after: torch.Tensor, maxd_after: torch.Tensor,
    score: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`choose`, with the feasibility-masked scores [Q, m] it chose
    from (inf where infeasible): the decision recorder's candidate rows."""
    feasible = ((maxd_after < cluster.degradation_limit) & (cache_after <= 1.0)
                & (cluster.active > 0.5)[None, :])
    score = torch.where(feasible, score, torch.inf)
    best = argmin_with_margin(score)  # oracle tie-breaking (lowest index)
    ok = feasible.any(1)
    return torch.where(ok, best, QUEUED), ok, score


# --- the greedy step (Fig 8), one arrival ---------------------------------------

def greedy_step(
    cluster: PackedCluster, counts: torch.Tensor, wtype: torch.Tensor,
    objective: str = "sum_avg",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Place one arriving workload of grid type ``wtype`` (shape [1]).

    Returns (new_counts, placement [1]) where placement == QUEUED when no
    server satisfies both criteria. Nothing is read back to the host: the
    count update is a masked add on server 0 when the workload queued.
    """
    cache_after, maxd_after = score_candidates_torch(cluster, counts, wtype)  # [1, m]
    placement, placed = greedy_choice(cluster, counts, cache_after, maxd_after, objective)
    server = torch.where(placed, placement, 0).long()
    new_counts = counts.clone()
    new_counts.index_put_((server, wtype.long()), placed.to(counts.dtype), accumulate=True)
    return new_counts, placement


def greedy_sequence(
    cluster: PackedCluster, counts: torch.Tensor, wtypes: torch.Tensor,
    objective: str = "sum_avg",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Allocate a whole arrival sequence (the §VIII experiment), in order."""
    placements = []
    for i in range(wtypes.shape[0]):
        counts, p = greedy_step(cluster, counts, wtypes[i:i + 1], objective)
        placements.append(p)
    if not placements:
        return counts, torch.empty(0, dtype=torch.int32, device=counts.device)
    return counts, torch.cat(placements).to(torch.int32)


# --- sharded + hierarchical sequence allocation ---------------------------------
#
# The fleet-scale variants of ``greedy_sequence``. Both take a
# :class:`~repro_torch.distributed.server_axis.ServerAxis` and are
# decision-exact against the dense loop: per-server scores are computed by the
# same arithmetic on the same rows, and only order-insensitive scalars (min,
# first index) cross ranks. Global in, global out: every rank passes the whole
# fleet, scores its own slice, and gets the placements (replicated) and the
# final counts (gathered once at the end). A dense axis with one pod is
# ``greedy_sequence`` itself.


def _choose_from_scores(axis, score_l: torch.Tensor, m_local: int):
    """Global (server, ok) [Q] from this rank's score columns [Q, m_local].

    ``argmin_with_margin``'s tie-breaking exactly: the global min by
    ``pmin``, then the first *global* index within the margin (the local
    first hit globalized with the rank's offset, ``pmin`` takes the lowest).
    Infeasible servers carry ``inf``; ``ok`` is "feasible anywhere" (the min
    is finite iff some server is feasible)."""
    m_g = m_local * axis.shards
    smin = axis.pmin(score_l.amin(1))  # [Q]
    hit = score_l <= (smin + SCORE_MARGIN)[:, None]
    has = hit.any(1)
    local_first = hit.to(torch.int32).argmax(1) + axis.offset(m_local)
    best = axis.pmin(torch.where(has, local_first, m_g))
    ok = torch.isfinite(smin)
    return torch.where(ok, best, QUEUED), ok


def _masked_scores(cluster: PackedCluster, counts: torch.Tensor, wtypes: torch.Tensor,
                   objective: str) -> torch.Tensor:
    """[Q, m] greedy scores with infeasible servers at ``inf``: the score
    half of :func:`greedy_choice`, on any slice of the fleet."""
    cache_after, maxd_after = score_candidates_torch(cluster, counts, wtypes)
    avg_after = 0.5 * (cache_after + maxd_after)
    if objective == "sum_avg":
        score = avg_after - avg_loads(cluster, counts)[None, :]
    else:
        score = avg_after
    feasible = ((maxd_after < cluster.degradation_limit) & (cache_after <= 1.0)
                & (cluster.active > 0.5)[None, :])
    return torch.where(feasible, score, torch.inf)


def _commit_local(counts_l: torch.Tensor, placement: torch.Tensor, ok: torch.Tensor,
                  wtype: torch.Tensor, lo: int) -> torch.Tensor:
    """Add the decision to ``counts_l`` in place where this rank owns the
    placed server (an off-rank or queued decision adds 0.0 to row 0, a
    masked write). Returns (the local row [1], owned [1])."""
    m_local = counts_l.shape[0]
    s_l = placement - lo
    owned = ok & (s_l >= 0) & (s_l < m_local)
    index = (torch.clamp(s_l, 0, m_local - 1).long(), wtype.long())
    counts_l.index_put_(index, counts_l[index] + owned.to(counts_l.dtype))
    return index[0], owned


def greedy_sequence_sharded(
    cluster: PackedCluster, counts: torch.Tensor, wtypes: torch.Tensor, axis,
    objective: str = "sum_avg",
) -> tuple[torch.Tensor, torch.Tensor]:
    """``greedy_sequence`` with the server axis sharded over ``axis``.

    Each rank scores its own slice of the fleet (the full Q x m candidate
    evaluation never forms on one rank); two ``pmin`` s per decision cross
    the group. Placements come back replicated and equal to the dense loop's;
    the final counts are gathered on exit. No host read per decision."""
    if not axis.is_sharded:
        return greedy_sequence(cluster, counts, wtypes, objective)
    m = cluster.m
    axis.validate(m)
    m_local = axis.local_m(m)
    lo = axis.offset(m_local)
    cluster_l = axis.local(cluster, m)
    c = axis.local(counts, m).clone()
    placements = []
    for i in range(wtypes.shape[0]):
        t = wtypes[i:i + 1]
        placement, ok = _choose_from_scores(axis, _masked_scores(cluster_l, c, t, objective),
                                            m_local)
        _commit_local(c, placement, ok, t, lo)
        placements.append(placement)
    return axis.all_gather(c), _cat_placements(placements, counts.device)


def _cat_placements(placements: list, device) -> torch.Tensor:
    if not placements:
        return torch.empty(0, dtype=torch.int32, device=device)
    return torch.cat(placements).to(torch.int32)


# --- hierarchical (pod) selection ------------------------------------------------

def _incremental_scores(cluster_l: PackedCluster, counts_l: torch.Tensor, col0: torch.Tensor,
                        comp0: torch.Tensor, maxd0: torch.Tensor, diag: torch.Tensor,
                        t: torch.Tensor, objective: str, types: torch.Tensor) -> torch.Tensor:
    """Exact greedy scores [m_local] from maintained per-server aggregates.

    The flat scorer pays ``counts @ D`` -- O(m T^2), a full pass over the
    [m, T, T] tensor -- on every decision. A decision changes one server's
    counts, so the three row aggregates the score needs (``col0 = counts @
    D`` [m, T], the cache composition ``comp0`` [m], the current max
    predicted degradation ``maxd0`` [m]) are maintained across the scan and
    only ``D[:, t, :]`` (O(m T)) is touched here. The expressions are the
    dense scorer's, so the decisions are its decisions. ``t`` has shape
    [1]; ``types`` is ``arange(T)``."""
    rs, fs = cluster_l.rs, cluster_l.fs
    cache0 = comp0 / cluster_l.llc_budget
    delta = rs[t] + cluster_l.resident[:, t][:, 0] * fs[t]  # [m]
    cache_after = (comp0 + delta) / cluster_l.llc_budget
    Dt = cluster_l.D.index_select(1, t.long())[:, 0]  # [m, T]: the only touch of D
    d_pred_after = torch.clamp(col0 + Dt - diag, 0.0, 1.0)
    present_after = (counts_l > 0) | (types == t)[None, :]
    maxd_after = torch.where(present_after, d_pred_after, -torch.inf).amax(1)
    feasible = ((maxd_after < cluster_l.degradation_limit) & (cache_after <= 1.0)
                & (cluster_l.active > 0.5))
    avg_after = 0.5 * (cache_after + maxd_after)
    if objective == "sum_avg":
        score = avg_after - 0.5 * (cache0 + maxd0)
    else:
        score = avg_after
    return torch.where(feasible, score, torch.inf)


def _row_aggregates(cluster_l: PackedCluster, row_c: torch.Tensor, D_row: torch.Tensor,
                    diag_row: torch.Tensor, resident_row: torch.Tensor):
    """(col0 [1, T], comp0 [1], maxd0 [1]) of one server row, rebuilt from
    their definitions: the refresh half of the maintenance rule. Row
    arguments carry a leading dim of 1; ``col0`` is the flat scorer's
    ``einsum`` on that one row."""
    new_col = torch.einsum("mt,mtu->mu", row_c, D_row)
    new_comp = row_c @ cluster_l.rs + (row_c * resident_row) @ cluster_l.fs
    pres = row_c > 0
    d_pred = torch.clamp(new_col - diag_row, 0.0, 1.0)
    new_maxd = torch.where(pres, d_pred, -torch.inf).amax(1)
    new_maxd = torch.where(pres.any(1), new_maxd, 0.0)
    return new_col, new_comp, new_maxd


def greedy_sequence_hier(
    cluster: PackedCluster, counts: torch.Tensor, wtypes: torch.Tensor, axis,
    objective: str = "sum_avg", col0: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Pod-hierarchical greedy: O(m T) per decision via maintained
    aggregates, sharded over whole pods.

    ``axis.pods`` pods of ``m // axis.pods`` servers each; on a sharded axis
    every rank owns ``pods // shards`` whole pods, so the pod-local state
    (the ``col0`` aggregate) never crosses ranks. Decision-identical to
    ``greedy_sequence`` (exact scores, exact tie-breaking). ``pods == 1``
    is ``greedy_sequence`` on a dense axis and
    :func:`greedy_sequence_sharded` on a sharded one.

    ``col0`` optionally supplies the ``counts @ D`` seed [m, T] (it must
    equal that product; zeros for an empty fleet); ``None`` computes it here,
    one O(m T^2) pass for the whole sequence. Per decision the loop then
    touches ``D[:, t, :]`` only, and rebuilds the placed server's rows of
    ``col0``, ``comp0`` and ``maxd0`` from their definitions, never by an
    additive drift (DESIGN.md section 15). No host read per decision.
    """
    if axis.pods <= 1:
        if axis.is_sharded:
            return greedy_sequence_sharded(cluster, counts, wtypes, axis, objective)
        return greedy_sequence(cluster, counts, wtypes, objective)
    m = cluster.m
    axis.validate(m)  # raises unless shards | pods | m
    m_local = axis.local_m(m)
    lo = axis.offset(m_local)
    cl = axis.local(cluster, m)
    c = axis.local(counts, m).clone()
    if col0 is None:
        col0 = torch.einsum("mt,mtu->mu", c, cl.D)
    else:
        col0 = axis.local(col0, m).clone()
    diag = torch.diagonal(cl.D, dim1=1, dim2=2)  # [m_local, T]
    # one-time O(m T) seeds of the scalar aggregates, from their definitions
    comp0 = c @ cl.rs + (c * cl.resident) @ cl.fs
    present0 = c > 0
    maxd0 = torch.where(present0, torch.clamp(col0 - diag, 0.0, 1.0), -torch.inf).amax(1)
    maxd0 = torch.where(present0.any(1), maxd0, 0.0)
    types = torch.arange(cl.T, device=c.device)
    placements = []
    for i in range(wtypes.shape[0]):
        t = wtypes[i:i + 1]
        score = _incremental_scores(cl, c, col0, comp0, maxd0, diag, t, objective, types)
        placement, ok = _choose_from_scores(axis, score[None], m_local)
        row, owned = _commit_local(c, placement, ok, t, lo)
        # the exact refresh of the one row a decision touched; an off-rank or
        # queued decision writes nothing (JAX's dropped scatter)
        new_col, new_comp, new_maxd = _row_aggregates(
            cl, c[row], cl.D[row], diag[row], cl.resident[row])
        col0.index_copy_(0, row, torch.where(owned[:, None], new_col, col0[row]))
        comp0.index_copy_(0, row, torch.where(owned, new_comp, comp0[row]))
        maxd0.index_copy_(0, row, torch.where(owned, new_maxd, maxd0[row]))
        placements.append(placement)
    return axis.all_gather(c), _cat_placements(placements, counts.device)


# --- vectorized brute force ------------------------------------------------------

def evaluate_assignment(
    cluster: PackedCluster, counts0: torch.Tensor, wtypes: torch.Tensor, assign: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Cost + feasibility of complete assignments (QUEUED allowed), batched:
    ``assign`` [n] or [B, n] gives cost and ok of shape [] or [B].

    Cost = sum of per-server average loads + 1.0 per queued workload (so a
    feasible placement always beats queueing), matching
    ``binpack.brute_force``. An assignment placing work on a server the
    fleet-health mask (``cluster.active``) has evicted is infeasible.
    """
    m, T = cluster.m, cluster.T
    single = assign.dim() == 1
    a = (assign[None] if single else assign).long()  # [B, n]
    types = torch.arange(T, device=counts0.device)
    onehots = (wtypes.long()[:, None] == types[None, :]).to(counts0.dtype)  # [n, T]
    placed = a >= 0
    srv = torch.where(placed, a, 0)
    servers = torch.arange(m, device=counts0.device)
    scatter = ((srv[..., None] == servers) & placed[..., None]).to(counts0.dtype)  # [B, n, m]
    counts = counts0[None] + torch.einsum("bnm,nt->bmt", scatter, onehots)  # [B, m, T]
    comp = counts @ cluster.rs + (counts * cluster.resident) @ cluster.fs  # [B, m]
    cache = comp / cluster.llc_budget
    col = torch.einsum("bmt,mtu->bmu", counts, cluster.D)  # [B, m, T]
    diag = torch.diagonal(cluster.D, dim1=1, dim2=2)
    d_pred = torch.clamp(col - diag, 0.0, 1.0)
    present = counts > 0
    maxd = torch.where(present, d_pred, -torch.inf).amax(-1)
    maxd = torch.where(present.any(-1), maxd, 0.0)
    on_inactive = (placed & (cluster.active[srv] <= 0.5)).any(-1)
    ok = ((maxd < cluster.degradation_limit) & (cache <= 1.0)).all(-1) & ~on_inactive
    cost = (0.5 * (cache + maxd)).sum(-1) + (~placed).sum(-1)
    cost = torch.where(ok, cost, torch.inf)
    return (cost[0], ok[0]) if single else (cost, ok)


def brute_force_torch(
    cluster: PackedCluster,
    counts0: torch.Tensor,
    wtypes: torch.Tensor,
    allow_queue: bool = True,
    batch: int = 4096,
) -> tuple[float, np.ndarray]:
    """Exhaustive optimum over all (m[+1])^n assignments, evaluated ``batch``
    at a time on the cluster's device (one host read per chunk). Ties keep
    the first assignment in enumeration order, as ``brute_force_jax``."""
    n = int(wtypes.shape[0])
    base = cluster.m + (1 if allow_queue else 0)
    total = base**n

    digits = np.arange(total)
    combos = np.stack([(digits // base**k) % base for k in range(n)], axis=1)
    if allow_queue:
        combos = np.where(combos == cluster.m, QUEUED, combos)

    wt = wtypes.to(cluster.device)
    best_cost, best_assign = np.inf, None
    for start in range(0, total, batch):
        chunk = torch.from_numpy(combos[start:start + batch]).to(cluster.device)
        costs, _ = evaluate_assignment(cluster, counts0, wt, chunk)
        costs = costs.cpu().numpy()
        i = int(costs.argmin())
        if costs[i] < best_cost:
            best_cost, best_assign = float(costs[i]), combos[start + i]
    if not np.isfinite(best_cost):
        raise RuntimeError("brute force (torch) found no feasible assignment")
    return best_cost, np.asarray(best_assign)
