"""Consolidated co-run simulator: the framework's stand-in for the paper's
physical testbed (§IV, Figures 3-4, 6).

The per-workload demand/sensitivity model and the cache-outcome base
throughput are what the vectorized profiling and the engine's rate tables
(``contention.type_tables``) are built from; ``simulate_corun`` is the
float64 ground truth the oracle scheduler (``core.scheduler``) runs on.
Copied from ``repro/core/simulator.py`` with the same names and arithmetic.

  1. LLC contention (§IV.A): the total data competing for the LLC is
       sum_i RS_i + sum_{i: FS_i <= LLC} FS_i                       (Eqn 1-2)
     The *physical* cache tolerates ``server.llc_tolerance`` (~1.29x, the
     7.76MB-vs-6MB observation of §V) before workloads start evicting each
     other. Past that point every LLC-resident workload (FS <= LLC) loses the
     cache and drops to level-2 bandwidth -- which for RS > 8KB costs more
     than 50% of its throughput (Fig 6).

  2. Mutual degradation (§IV.B): co-running workloads additionally contend
     for the storage subsystem and the CPU. Each co-runner ``i`` imposes an
     independent multiplicative slowdown factor (1 - d_i) on every other
     workload, where d_i is i's relative pressure on the shared bandwidth
     and CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from .server import ServerSpec
from .throughput import amortized, level_of, level_params, solo_throughput
from .workload import Workload


def competing_cache_bytes(server: ServerSpec, workloads: Sequence[Workload]) -> float:
    """LHS of Eqn (2): sum RS_i + sum_{FS_i <= CacheSize} FS_i.

    Workloads whose FS exceeds the LLC do not compete for it (§IV.A) -- they
    stream through -- so only their request buffers count.
    """
    total = 0.0
    for w in workloads:
        total += w.rs
        if w.fs <= server.llc_bytes:
            total += w.fs
    return total


def cache_overflow(server: ServerSpec, workloads: Sequence[Workload]) -> bool:
    """True when the physical LLC is past its (tolerant) capacity -> TDP hit."""
    return competing_cache_bytes(server, workloads) > server.llc_tolerance * server.llc_bytes


def _demands(server: ServerSpec, w: Workload, t_base: float, lost_cache: bool) -> dict:
    """Per-resource demand of one workload running at base throughput ``t_base``.

    Three shared resources (§IV.B: "competition ... to access shared disk
    bandwidth and processor execution time", plus the memory/file-cache
    subsystem the levels live in):

      mem  -- bytes/s drawn from the DRAM/file-cache subsystem.  An
              LLC-resident workload (level 1) barely touches it (warm-up
              traffic only); level-2/3 workloads stream through it.
      disk -- bytes/s of true disk traffic (level-3 writes; level-2 writes
              trickle write-back at a fraction of their rate).
      cpu  -- cores-worth of processor time (per-request + per-byte costs).
    """
    lvl = level_of(server, w.fs, w.op)
    if lost_cache and w.fs <= server.llc_bytes:
        lvl = max(lvl, 2)
    if lvl == 1:
        mem, disk = 0.05 * t_base, 0.0
    elif lvl == 2:
        mem = t_base
        disk = 0.1 * t_base if w.op == "write" else 0.0
    else:
        mem, disk = t_base, t_base
    reqs_per_s = t_base / w.rs
    cpu = reqs_per_s * (server.cpu_req_cost + w.rs * server.cpu_byte_cost)
    return {"mem": mem, "disk": disk, "cpu": cpu}


def _capacities(server: ServerSpec) -> dict:
    return {"mem": server.shared_bw, "disk": server.bw_l3_write, "cpu": float(server.cores)}


def _sensitivity(server: ServerSpec, w: Workload, t_base: float, dem: dict) -> dict:
    """Fraction of j's critical path bound by each resource (its exposure)."""
    return {
        "mem": min(1.0, dem["mem"] / t_base),
        "disk": min(1.0, dem["disk"] / t_base),
        "cpu": min(1.0, dem["cpu"]),
    }


#: baseline-interference scale: even an uncontended co-runner causes a little
#: degradation (OS scheduling, cache-line ping-pong) -- dem/(dem + BASE*cap).
_BASELINE = 20.0


def throughput_after_cache(server: ServerSpec, w: Workload, overflowed: bool) -> float:
    """Base throughput of ``w`` given the LLC outcome of the co-run set.

    A workload that *loses* the LLC falls from level-1 to level-2 bandwidth
    (Fig 6: its data is evicted by co-runners, every access misses to the
    next tier). Workloads already past the LLC (FS > LLC) are unaffected --
    they never competed (§IV.A).
    """
    if not overflowed or w.fs > server.llc_bytes:
        return solo_throughput(server, w)
    lvl = max(2, level_of(server, w.fs, w.op))
    bw, ov = level_params(server, lvl, w.op)
    return amortized(bw, ov, w.rs)


def pair_slowdown(
    server: ServerSpec,
    w_i: Workload,
    t_i: float,
    w_j: Workload,
    t_j: float,
    lost_cache: bool,
) -> float:
    """d_{i,j}: the slowdown factor workload i imposes on co-runner j.

    Per shared resource r with capacity C_r: proportional sharing only bites
    when the summed demand exceeds capacity --
        excess_r = max(0, 1 - C_r / (dem_i(r) + dem_j(r)))
    -- plus a small baseline-interference term b_i(r). j is exposed to r for
    a fraction s_j(r) of its critical path; independent resources compose
    multiplicatively:
        d_{i,j} = 1 - prod_r (1 - s_j(r) * (1 - (1-excess_r)(1-b_i(r)))).
    """
    dem_i = _demands(server, w_i, t_i, lost_cache)
    dem_j = _demands(server, w_j, t_j, lost_cache)
    sens_j = _sensitivity(server, w_j, t_j, dem_j)
    caps = _capacities(server)
    keep = 1.0
    for r, cap in caps.items():
        total = dem_i[r] + dem_j[r]
        excess = max(0.0, 1.0 - cap / total) if total > 0 else 0.0
        baseline = dem_i[r] / (dem_i[r] + _BASELINE * cap)
        slow = 1.0 - (1.0 - excess) * (1.0 - baseline)
        keep *= 1.0 - sens_j[r] * slow
    return 1.0 - keep


@dataclasses.dataclass(frozen=True)
class CoRunResult:
    throughputs: tuple[float, ...]  # bytes/s per workload under consolidation
    solo: tuple[float, ...]  # solo throughput per workload
    degradations: tuple[float, ...]  # D_i = 1 - T_corun / T_solo  (== O_i/(AR_i+O_i))
    cache_overflowed: bool

    @property
    def max_degradation(self) -> float:
        return max(self.degradations) if self.degradations else 0.0


def simulate_corun(server: ServerSpec, workloads: Sequence[Workload]) -> CoRunResult:
    """Ground-truth throughput of N consolidated workloads on one server."""
    if not workloads:
        return CoRunResult((), (), (), False)
    overflowed = cache_overflow(server, workloads)
    base = [throughput_after_cache(server, w, overflowed) for w in workloads]

    thr, deg, solo = [], [], []
    for j, w in enumerate(workloads):
        slow = 1.0
        for i in range(len(workloads)):
            if i != j:
                slow *= 1.0 - pair_slowdown(
                    server, workloads[i], base[i], w, base[j], overflowed
                )
        t = base[j] * slow
        s = solo_throughput(server, w)
        thr.append(t)
        solo.append(s)
        deg.append(1.0 - t / s)
    return CoRunResult(tuple(thr), tuple(solo), tuple(deg), overflowed)


def corun_throughput_grid(
    server: ServerSpec, rs: float, fs_grid, n_grid, op: str = "read"
) -> np.ndarray:
    """Throughput surface vs (N, FS) for N identical co-run workloads.

    This regenerates the paper's Figures 3(a)/4(a): fix RS (64KB / 256KB),
    sweep FS along one axis and the number of concurrent workloads N along
    the other; the sharp cliff is the TDP.
    """
    out = np.zeros((len(n_grid), len(fs_grid)))
    for ni, n in enumerate(n_grid):
        for fi, fs in enumerate(fs_grid):
            ws = [Workload(fs=float(fs), rs=float(rs), op=op)] * int(n)
            out[ni, fi] = simulate_corun(server, ws).throughputs[0]
    return out


def makespan_consolidated(server: ServerSpec, workloads: Sequence[Workload]) -> float:
    """Makespan when the set is consolidated on one server (§V, Fig 5).

    Each workload's completion time stretches from AR_i to AR_i/(1-D_i)
    (= AR_i + O_i with D_i = O_i/(AR_i+O_i)). The makespan is the max.
    This is the quantity the 50%-degradation criterion (Eqn 4) protects:
    D_i < 0.5  <=>  O_i < AR_i  <=>  consolidation beats sequential.
    """
    res = simulate_corun(server, workloads)
    t = 0.0
    for w, d, s in zip(workloads, res.degradations, res.solo):
        ar = w.data_total / s
        t = max(t, ar / max(1.0 - d, 1e-9))
    return t


def makespan_sequential(server: ServerSpec, workloads: Sequence[Workload]) -> float:
    """Makespan when the workloads run one after another (no consolidation)."""
    return sum(w.data_total / solo_throughput(server, w) for w in workloads)
