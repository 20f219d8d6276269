"""Workload characterization (paper §III.A, contribution C1).

A data-intensive workload is characterized by two parameters, exactly as in
the paper (inspired by Iometer / IOzone / TestDFSIO / Bonnie++):

  FS -- file size: the block-sized chunk a Hadoop *task* works on
        (order of 64MB by default, NOT the terabyte-scale job size).
  RS -- request size: bytes read/written per file operation.

The paper profiles the pairwise-degradation matrix on a grid of
10 request sizes (1KB..512KB) x 23 file sizes (1KB..1GB), i.e. 230 workload
*types* per operation, 52_900 pair experiments per server (§IV.B, §VIII).
We reproduce that grid verbatim.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Iterable, Sequence

import numpy as np

from .units import KB, MB, fmt_size, parse_size

# --- The paper's profiling grid (§IV.B / §VIII) -----------------------------
# Ten request sizes: 1KB - 512KB (powers of two).
RS_GRID = tuple(float(KB * 2**i) for i in range(10))
# Twenty-three file sizes: 1KB - 1GB, log-spaced (2^0 .. 2^20 KB covers 21
# points; the paper uses 23, so we insert the half-way points 1.5GB-style
# steps at the top of the cache-transition region where resolution matters).
FS_GRID = tuple(
    float(v)
    for v in sorted(
        set(
            [KB * 2**i for i in range(21)]  # 1KB .. 1GB
            + [6 * MB, 448 * MB]  # LLC edge + file-cache edge resolution
        )
    )
)
assert len(RS_GRID) == 10 and len(FS_GRID) == 23, (len(RS_GRID), len(FS_GRID))

OPS = ("read", "write")


@dataclasses.dataclass(frozen=True)
class Workload:
    """One data-intensive workload (a Hadoop map task against HDFS).

    ``data_total`` is the total number of bytes the task must move before it
    completes; it determines the solo run time AR_i = data_total / T_solo
    used by the makespan analysis of §V. It defaults to one pass over the
    file.
    """

    fs: float  # file size in bytes (block-sized chunk)
    rs: float  # request size in bytes
    op: str = "read"  # 'read' | 'write'
    data_total: float | None = None
    name: str = ""

    def __post_init__(self):
        if self.op not in OPS:
            raise ValueError(f"op must be one of {OPS}, got {self.op!r}")
        if self.fs <= 0 or self.rs <= 0:
            raise ValueError("fs and rs must be positive")
        if self.data_total is None:
            object.__setattr__(self, "data_total", float(self.fs))

    def __repr__(self) -> str:  # matches the paper's "(RS, FS)" tuples
        tag = f" {self.name}" if self.name else ""
        return f"W({fmt_size(self.rs)}, {fmt_size(self.fs)}, {self.op}{tag})"


# --- Grid indexing -----------------------------------------------------------

def grid_types(op: str = "read") -> list[Workload]:
    """All 230 (RS, FS) workload types of the paper's profiling grid."""
    return [Workload(fs=fs, rs=rs, op=op) for rs in RS_GRID for fs in FS_GRID]


def type_index(w: Workload) -> int:
    """Index of the nearest grid type for workload ``w`` (nearest in log space)."""
    ri = int(np.argmin(np.abs(np.log(np.asarray(RS_GRID)) - np.log(w.rs))))
    fi = int(np.argmin(np.abs(np.log(np.asarray(FS_GRID)) - np.log(w.fs))))
    return ri * len(FS_GRID) + fi


def snap_to_grid(w: Workload) -> Workload:
    """Snap a workload to its nearest profiling-grid type (for D-matrix lookup)."""
    idx = type_index(w)
    ri, fi = divmod(idx, len(FS_GRID))
    return dataclasses.replace(w, rs=RS_GRID[ri], fs=FS_GRID[fi])


# --- Parsing the paper's Table III tuples ------------------------------------
_TUPLE_RE = re.compile(r"\(\s*([^,()]+)\s*,\s*([^,()]+)\s*\)")


def parse_workloads(text: str, op: str = "read") -> list[Workload]:
    """Parse '(32KB, 64KB), (4KB, 16KB), ...' as (RS, FS) pairs -> Workloads.

    The paper writes tuples as (RS, FS) -- request size first (Table III).
    """
    out = []
    for m in _TUPLE_RE.finditer(text):
        rs, fs = parse_size(m.group(1)), parse_size(m.group(2))
        out.append(Workload(fs=fs, rs=rs, op=op))
    if not out:
        raise ValueError(f"no (RS, FS) tuples found in {text!r}")
    return out


def characterize(request_trace: Sequence[tuple[str, float]], file_bytes: float) -> Workload:
    """Characterize an observed I/O trace into a (FS, RS) workload (C1).

    ``request_trace`` is a sequence of (op, nbytes) file operations. The
    request size is the byte-weighted typical operation size (geometric mean
    weighted by bytes, robust to a few metadata-sized ops); the op is the
    majority op by bytes.
    """
    if not request_trace:
        raise ValueError("empty trace")
    sizes = np.array([n for _, n in request_trace], dtype=float)
    by_op = {op: 0.0 for op in OPS}
    for op, n in request_trace:
        by_op[op] = by_op.get(op, 0.0) + n
    op = max(by_op, key=lambda k: by_op[k])
    rs = float(np.exp(np.average(np.log(sizes), weights=sizes)))
    return Workload(fs=float(file_bytes), rs=rs, op=op)


def total_bytes(workloads: Iterable[Workload]) -> float:
    return float(sum(w.data_total for w in workloads))
