"""Single-workload-on-single-server throughput model (paper §III, C2).

The paper's Figures 1-2 show that solo throughput is a piecewise function of
FS with per-request-overhead amortization in RS:

  level 1 (highest):       FS fits the LLC                (FS <= LLC)
  level 2 (intermediate):  FS fits file cache + disk cache
  level 3 (write only):    FS exceeds file+disk cache -> true disk speed

Within a level with bandwidth ``bw`` and per-request overhead ``ov`` the
throughput of request size RS is the classic amortization curve

  T(RS) = RS / (ov + RS / bw)          (monotone increasing in RS, -> bw)

which reproduces the paper's "accessing disks with large RSs is always much
more efficient" observation (§III.C: 1MB at RS=1KB pays the overhead 1000x,
at RS=512KB only 2x).
"""
from __future__ import annotations

import numpy as np

from .server import ServerSpec
from .workload import Workload


def level_of(server: ServerSpec, fs: float, op: str) -> int:
    """Which throughput level (1/2/3) a solo workload with file size ``fs`` runs at."""
    if fs <= server.llc_bytes:
        return 1
    if op == "read" or fs <= server.cache_spill_bytes:
        return 2  # reads stay at level 2 (paper reports two read levels)
    return 3


def level_params(server: ServerSpec, level: int, op: str) -> tuple[float, float]:
    """(bandwidth, per-request overhead) for a level. Level 3 exists for writes."""
    if op == "read":
        bw = {1: server.bw_l1_read, 2: server.bw_l2_read}[min(level, 2)]
        return bw, server.ov_l12
    bw = {1: server.bw_l1_write, 2: server.bw_l2_write, 3: server.bw_l3_write}[level]
    ov = server.ov_l3 if level == 3 else server.ov_l12
    return bw, ov


def amortized(bw: float, ov: float, rs: float) -> float:
    """T(RS) = RS / (ov + RS/bw)."""
    return rs / (ov + rs / bw)


def solo_throughput(server: ServerSpec, w: Workload) -> float:
    """Solo throughput (bytes/s) of workload ``w`` on ``server`` (Figures 1-2)."""
    lvl = level_of(server, w.fs, w.op)
    bw, ov = level_params(server, lvl, w.op)
    return amortized(bw, ov, w.rs)


def solo_throughput_grid(server: ServerSpec, rs_grid, fs_grid, op: str) -> np.ndarray:
    """Vectorized solo throughput over a (RS x FS) grid -> array [len(rs), len(fs)].

    This is the surface plotted in the paper's Figures 1 (M1) and 2 (M2).
    """
    rs = np.asarray(rs_grid, dtype=float)[:, None]
    fs = np.asarray(fs_grid, dtype=float)[None, :]

    lvl = np.where(fs <= server.llc_bytes, 1, 2)
    if op == "write":
        lvl = np.where(fs > server.cache_spill_bytes, 3, lvl)

    out = np.zeros((rs.shape[0], fs.shape[1]))
    for level in (1, 2, 3):
        mask = lvl == level
        if not mask.any():
            continue
        bw, ov = level_params(server, level, op)
        out = np.where(mask, amortized(bw, ov, rs), out)
    return out


def solo_runtime(server: ServerSpec, w: Workload) -> float:
    """AR_i of §V: time to move ``data_total`` bytes when running alone."""
    return w.data_total / solo_throughput(server, w)
