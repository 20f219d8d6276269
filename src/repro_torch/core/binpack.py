"""Two-dimensional bin packing for workload consolidation (paper §VI-§VII),
copied from ``repro/core/binpack.py`` with the same names and float64
arithmetic (numpy only).

Servers are 2-D bins (Fig 7): dimension 1 is the LLC-competing data budget
(criterion 2), dimension 2 is the maximum mutual throughput degradation
(criterion 1). Workloads are *interacting* objects -- placing one changes the
size of the others (the paper notes this makes the problem strictly harder
than classical bin packing).

Implemented allocators:
  * ``greedy_place``    -- the paper's greedy (Fig 8 + the Table II objective)
  * ``brute_force``     -- exhaustive optimal, the paper's evaluation baseline
  * ``first_fit`` / ``best_fit_cache`` -- classical baselines (beyond paper,
    used to show the 2-D objective matters)

NOTE: like ``core.scheduler``, this pure-Python float64 path is the
*reference oracle* of the port's engine; the production allocation paths are
``binpack_torch`` (the tensor greedy + shared candidate scorer) and
``core.engine.ConsolidationEngine`` (the online runtime).

Objective: the paper's text ("minimizes the sum of the average loads ... on
all physical servers after allocation") and its Table II walk-through pick
the server whose *post-allocation* average-load increase is smallest -- note
Table II picks server B (sum 80 < 82.5) even though B's post-allocation
average (45) is larger than A's (40). The literal pseudocode in Fig 8
("If Avg_i < minimum") instead compares post-allocation averages directly.
Both are provided; ``objective='sum_avg'`` (Table II semantics) is the
default, ``objective='min_after'`` is the literal-Fig-8 variant. The
discrepancy is documented here and in DESIGN.md.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Literal, Sequence

import numpy as np

from .criteria import DEGRADATION_LIMIT, AdmissionCheck, check_consolidation
from .server import ServerSpec
from .workload import Workload

Objective = Literal["sum_avg", "min_after"]


@dataclasses.dataclass
class ClusterState:
    """Mutable view of a cluster during allocation: who runs where."""

    servers: tuple[ServerSpec, ...]
    D: Sequence[np.ndarray]  # one profiled D matrix per server (§VIII)
    alphas: tuple[float, ...]
    assignments: list[list[Workload]]  # per-server co-run sets

    @classmethod
    def empty(
        cls,
        servers: Sequence[ServerSpec],
        D: Sequence[np.ndarray] | np.ndarray,
        alpha: float | Sequence[float] = 1.3,
    ) -> "ClusterState":
        servers = tuple(servers)
        if isinstance(D, np.ndarray):
            D = [D] * len(servers)
        if isinstance(alpha, (int, float)):
            alphas = tuple(float(alpha) for _ in servers)
        else:
            alphas = tuple(float(a) for a in alpha)
        return cls(servers, list(D), alphas, [[] for _ in servers])

    def check(self, i: int, extra: Workload | None = None) -> AdmissionCheck:
        ws = list(self.assignments[i]) + ([extra] if extra is not None else [])
        return check_consolidation(self.servers[i], ws, self.D[i], self.alphas[i])

    def loads(self) -> list[AdmissionCheck]:
        return [self.check(i) for i in range(len(self.servers))]

    def total_avg_load(self) -> float:
        """The paper's global objective: sum over servers of Avg(CacheInUse, MaxD)."""
        return float(sum(c.avg_load for c in self.loads()))

    def feasible(self) -> bool:
        return all(c.ok for c in self.loads())

    def clone(self) -> "ClusterState":
        return ClusterState(
            self.servers, self.D, self.alphas, [list(a) for a in self.assignments]
        )


# --- The paper's greedy (Fig 8) -----------------------------------------------

def greedy_place(
    state: ClusterState, w: Workload, objective: Objective = "sum_avg"
) -> int | None:
    """Place one arriving workload; returns the chosen server index or None.

    Fig 8, per server i:
      1. tentatively assign W to S_i
      2. CacheInUse_i = competing data / (alpha_i * CacheSize_i)
      3. Max(D_y) from the profiled D_{x,y}s via the additive model
      4. reject S_i if Max(D_y) > 50% or CacheInUse_i > 100%
      5. score = Avg(CacheInUse_i, Max(D_y)); keep the argmin
    ``None`` means no server satisfies the criteria -> the caller queues W
    (criterion 1's queueing rule, §V).
    """
    best, best_score = None, np.inf
    for i in range(len(state.servers)):
        after = state.check(i, extra=w)
        if not after.ok:
            continue
        if objective == "sum_avg":
            score = after.avg_load - state.check(i).avg_load  # Table II semantics
        else:
            score = after.avg_load  # literal Fig 8
        if score < best_score - 1e-12:
            best, best_score = i, score
    if best is not None:
        state.assignments[best].append(w)
    return best


def greedy_sequence(
    state: ClusterState,
    arrivals: Sequence[Workload],
    objective: Objective = "sum_avg",
) -> tuple[list[int | None], list[Workload]]:
    """Allocate an arrival sequence one by one (§VIII). Returns (placements, queued)."""
    placements: list[int | None] = []
    queued: list[Workload] = []
    for w in arrivals:
        i = greedy_place(state, w, objective)
        placements.append(i)
        if i is None:
            queued.append(w)
    return placements, queued


# --- Brute force (the paper's optimality baseline, §VIII) -----------------------

def brute_force(
    state: ClusterState,
    arrivals: Sequence[Workload],
    allow_queue: bool = True,
) -> tuple[float, list[int | None]]:
    """Exhaustive search over all assignments of ``arrivals`` to servers.

    Minimizes the paper's global objective (total sum of per-server average
    loads) subject to both criteria on every server; a workload may be left
    unplaced (queued) if ``allow_queue``, at the cost of counting it as a
    full unit of load (so queueing is never preferred over a feasible spot).
    Exponential (m+1)^n -- usable for the paper-scale evaluation (m=4, n=5).
    """
    m = len(state.servers)
    options = list(range(m)) + ([None] if allow_queue else [])
    best_cost, best_assign = np.inf, None

    for combo in itertools.product(options, repeat=len(arrivals)):
        trial = state.clone()
        for w, s in zip(arrivals, combo):
            if s is not None:
                trial.assignments[s].append(w)
        checks = trial.loads()
        if not all(c.ok for c in checks):
            continue
        cost = sum(c.avg_load for c in checks)
        cost += sum(1.0 for s in combo if s is None)  # queue penalty
        if cost < best_cost - 1e-12:
            best_cost, best_assign = cost, list(combo)
    if best_assign is None:
        raise RuntimeError("brute force found no feasible assignment")
    return float(best_cost), best_assign


# --- Classical baselines (beyond paper) ----------------------------------------

def first_fit(state: ClusterState, w: Workload) -> int | None:
    for i in range(len(state.servers)):
        if state.check(i, extra=w).ok:
            state.assignments[i].append(w)
            return i
    return None


def best_fit_cache(state: ClusterState, w: Workload) -> int | None:
    """Best-fit on the cache dimension only (ignores the degradation dim)."""
    best, best_slack = None, np.inf
    for i in range(len(state.servers)):
        after = state.check(i, extra=w)
        if not after.ok:
            continue
        slack = 1.0 - after.cache_in_use
        if slack < best_slack:
            best, best_slack = i, slack
    if best is not None:
        state.assignments[best].append(w)
    return best


def run_allocator(
    state: ClusterState, arrivals: Sequence[Workload], allocator
) -> tuple[list[int | None], ClusterState]:
    st = state.clone()
    placements = [allocator(st, w) for w in arrivals]
    return placements, st


# --- Evaluation metric of Fig 9 -------------------------------------------------

def average_min_throughput(state: ClusterState) -> float:
    """Fig 9's bar metric: average over servers of the *minimum* per-workload
    relative throughput (1 - D) on that server, via the additive model."""
    vals = []
    for i in range(len(state.servers)):
        c = state.check(i)
        vals.append(1.0 - (max(c.degradations) if c.degradations else 0.0))
    return float(np.mean(vals))


def average_min_throughput_simulated(state: ClusterState) -> float:
    """Same metric but measured on the ground-truth simulator (not the model)."""
    from .simulator import simulate_corun

    vals = []
    for i, server in enumerate(state.servers):
        ws = state.assignments[i]
        if not ws:
            vals.append(1.0)
            continue
        res = simulate_corun(server, ws)
        vals.append(1.0 - res.max_degradation)
    return float(np.mean(vals))
