"""Empirical alpha calibration (paper §V), copied from
``repro/core/calibrate.py`` with the same names and float64 arithmetic.

"alpha can be empirically found through comparing the actual TDPs of a
system versus its calculated ones. In our case ... actual TDPs are around
7.76MB, whereas the calculated TDPs are 6MB. Thus, for our system alpha
should be about 7.76/6 ~= 1.3."

``calibrate_alpha`` automates exactly that procedure: sweep co-run sets
along N for a grid of (RS, FS) combinations, locate the observed degradation
cliff, convert it to competing-bytes at the cliff, and divide by the Eqn-2
prediction. ``sweep_alpha`` additionally reproduces Fig 9's outer loop:
evaluate the scheduler end to end at several alphas and report the
average-minimum-throughput metric, so deployments can pick the balanced
setting the way the paper does.
"""
from __future__ import annotations

import numpy as np

from .binpack import ClusterState, average_min_throughput_simulated, greedy_sequence
from .criteria import DEGRADATION_LIMIT
from .server import ServerSpec
from .simulator import simulate_corun
from .units import KB, MB
from .workload import Workload


def observed_tdp_bytes(
    server: ServerSpec,
    rs: float,
    fs: float,
    max_n: int = 12,
    threshold: float = DEGRADATION_LIMIT,
) -> float | None:
    """Competing-byte total at the first N whose degradation exceeds the §V
    limit (``criteria.DEGRADATION_LIMIT`` -- the one source of truth for the
    50% threshold)."""
    if fs > server.llc_bytes:
        return None  # not LLC-resident: no TDP exists (Eqn 2's CS set)
    for n in range(2, max_n + 1):
        res = simulate_corun(server, [Workload(fs=fs, rs=rs)] * n)
        if res.degradations[0] > threshold:
            return n * (rs + fs)
    return None


def calibrate_alpha(
    server: ServerSpec,
    rs_grid=(64 * KB, 128 * KB, 256 * KB),
    fs_grid=(512 * KB, 1 * MB, 1280 * KB, 2 * MB),
) -> float:
    """The paper's alpha = mean(observed TDP bytes / calculated TDP bytes)."""
    ratios = []
    for rs in rs_grid:
        for fs in fs_grid:
            obs = observed_tdp_bytes(server, rs, fs)
            if obs is not None:
                ratios.append(obs / server.llc_bytes)
    if not ratios:
        raise RuntimeError("no TDP observed on the calibration grid")
    return float(np.mean(ratios))


def sweep_alpha(
    servers, D, initial_assignments, arrivals, alphas=(1.0, 1.1, 1.2, 1.3, 1.4, 1.5)
) -> dict[float, float]:
    """Fig 9's outer loop: end-to-end scheduler quality per alpha."""
    out = {}
    for alpha in alphas:
        state = ClusterState.empty(list(servers), list(D), alpha=alpha)
        state.assignments = [list(a) for a in initial_assignments]
        _, queued = greedy_sequence(state, arrivals)
        # queued workloads count as zero throughput against the metric
        metric = average_min_throughput_simulated(state)
        out[alpha] = metric - 0.1 * len(queued) / max(len(arrivals), 1)
    return out


def pick_alpha(sweep: dict[float, float]) -> float:
    return max(sweep, key=lambda a: sweep[a])
