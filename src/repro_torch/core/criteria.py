"""The two consolidation criteria of paper §V (C5), copied from
``repro/core/criteria.py`` with the same names and arithmetic (numpy only).

Criterion 1 (Eqn 4, makespan): admit a new workload onto a server only if
  every co-run workload's *predicted* total degradation stays below 50%:
      D_i = O_i / (AR_i + O_i) < 0.5    for all i (including the new one).
  Fig 5's argument: D_i < 0.5  <=>  O_i < AR_i, so consolidation always beats
  running the set sequentially. If no server qualifies, the workload queues.

Criterion 2 (Eqn 5, cache): the total data competing for the LLC must fit an
  over-subscription budget:
      sum_i RS_i + sum_{i in CS} FS_i <= alpha * CacheSize,
      CS = {i | FS_i <= CacheSize}.
  alpha is the scheduler's estimate of the hardware's tolerance (the paper
  calibrates alpha ~= 7.76/6 ~= 1.3 on its testbed and sweeps {1, 1.3, 1.5}
  in Fig 9).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from .contention import predict_degradations, tdp_lhs
from .server import ServerSpec
from .workload import Workload

#: Eqn (4) threshold: degradation beyond this doubles execution time (§IV).
DEGRADATION_LIMIT = 0.5


def eviction_rate_floor(limit: float = DEGRADATION_LIMIT) -> float:
    """The observed-throughput fraction at which a server leaves the fleet.

    Criterion 1's threshold, read as a *health* rule: step-time inflation
    D = O / (AR + O) >= ``limit`` is the same condition as the observed rate
    dropping to <= (1 - limit) x its reference (for limit = 0.5, running at
    half speed, i.e. 2x slower). Both consumers of that rule -- the
    straggler monitor (``distributed.fault_tolerance.HeartbeatMonitor
    .stragglers``) and the fleet failure detector (``fleet.detect``, whose
    reference is the estimated base rate) -- read this single conversion, so
    eviction and straggler policy cannot drift apart.
    """
    if not 0.0 < limit < 1.0:
        raise ValueError(f"degradation limit must be in (0, 1), got {limit}")
    return 1.0 - limit


@dataclasses.dataclass(frozen=True)
class AdmissionCheck:
    """Result of evaluating both criteria for a candidate co-run set."""

    ok: bool
    max_degradation: float  # max_j predicted D_j           (criterion 1 load)
    cache_in_use: float  # competing bytes / (alpha*LLC)  (criterion 2 load), 1.0 == full
    degradations: tuple[float, ...]

    @property
    def avg_load(self) -> float:
        """Fig 8's Avg(CacheInUse, Max(Dy)) -- the greedy's per-server score."""
        return 0.5 * (self.cache_in_use + self.max_degradation)


def check_consolidation(
    server: ServerSpec,
    workloads: Sequence[Workload],
    D: np.ndarray,
    alpha: float = 1.3,
    degradation_limit: float = DEGRADATION_LIMIT,
) -> AdmissionCheck:
    """Evaluate criteria (4) and (5) for placing ``workloads`` together.

    The degradation estimate comes from the profiled D matrix via the
    additive model -- this is exactly what Fig 8's greedy consults
    ("Max(Dy) is calculated based on previously collected D_{x,y}s").
    """
    if not workloads:
        return AdmissionCheck(True, 0.0, 0.0, ())
    deg = predict_degradations(D, workloads)
    max_d = float(deg.max())
    cache = tdp_lhs(server, workloads) / (alpha * server.llc_bytes)
    ok = (max_d < degradation_limit) and (cache <= 1.0)
    return AdmissionCheck(ok, max_d, cache, tuple(float(x) for x in deg))
