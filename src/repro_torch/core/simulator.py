"""Consolidated co-run simulator: the framework's stand-in for the paper's
physical testbed (§IV, Figures 3-4, 6).

Only the per-workload demand/sensitivity model and the cache-outcome base
throughput live here: they are what the vectorized profiling and the
engine's rate tables (``contention.type_tables``) are built from.

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

from .server import ServerSpec
from .throughput import amortized, level_of, level_params, solo_throughput
from .workload import Workload


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
