"""Fleet consolidation: the paper's algorithm applied to (arch x shape) jobs
on pod slices (copied from ``repro/core/cluster.py``, same names and
arithmetic).

A *job* here is one training/serving step of an assigned architecture at an
assigned input shape; its resource vector is read off a dry-run artifact
(``repro_torch.launch.dryrun``):

  hbm_bytes        -- per-device working set  (paper's FS: the hard capacity dim)
  bytes_accessed   -- bytes per step          (paper's RS-amortization analogue)
  flops            -- FLOPs per step
  collective_bytes -- bytes over the chip-to-chip links per step

The pod is the 2-D bin: dimension 1 is the HBM byte budget (criterion 2 with
alpha=1.0 -- HBM, unlike an LLC, does not gracefully over-subscribe),
dimension 2 is the mutual throughput degradation from time-multiplexing jobs
on the same chips (criterion 1, the 50% rule).

Two degradation models are provided:
  * 'additive'  -- the paper's Eqn (3): profile D_{i,j} for job pairs, sum.
  * 'roofline'  -- each shared resource r (compute, HBM bw, link bw)
    saturates when the summed demand exceeds capacity; degradation of j is
    1 - 1/max(1, sum_i demand_r(i)/capacity_r) maximized over r.

A job and a pod run on one kind of chip (``ChipSpec``): the TPU v5e of the
JAX package, the default, so that packing and reports equal JAX's bit for
bit, or the H100 SXM (``H100_SXM``, ``h100_pod``), whose link term is
NVLink's rate per direction. The module-level constants are the v5e's, as
in JAX.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Literal, Sequence

import numpy as np

from ..launch import roofline

# TPU v5e hardware constants (per chip) -- same numbers as JAX's roofline spec.
PEAK_FLOPS = 197e12  # bf16 FLOP/s
HBM_BW = 819e9  # bytes/s
ICI_BW = 50e9  # bytes/s per link
HBM_BYTES = 16 * 2**30


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """One accelerator's roofline: dense bf16 FLOP/s, HBM bytes/s, the
    link's bytes/s and HBM bytes."""

    name: str
    peak_flops: float
    hbm_bw: float
    link_bw: float
    hbm_bytes: float


TPU_V5E = ChipSpec("tpu-v5e", PEAK_FLOPS, HBM_BW, ICI_BW, HBM_BYTES)
#: H100 SXM: the data sheet's numbers as ``launch.roofline`` keeps them (989e12
#: dense bf16 FLOP/s, 3.35e12 B/s HBM3, NVLink's 450e9 B/s per direction, 80 GB)
H100_SXM = ChipSpec("h100-sxm", roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW,
                    roofline.HBM_BYTES)


@dataclasses.dataclass(frozen=True)
class JobProfile:
    """Resource vector of one (arch x shape) cell from the dry-run artifact."""

    name: str
    flops: float
    bytes_accessed: float
    collective_bytes: float
    hbm_bytes: float  # per-device
    chips: int = 256
    chip: ChipSpec = TPU_V5E

    @classmethod
    def from_artifact(cls, path: str | pathlib.Path) -> "JobProfile":
        rec = json.loads(pathlib.Path(path).read_text())
        return cls(
            name=rec["cell"],
            flops=rec["flops"],
            bytes_accessed=rec["bytes_accessed"],
            collective_bytes=rec["collective_bytes"],
            hbm_bytes=rec["peak_memory_per_device"],
            chips=rec.get("chips", 256),
        )

    def step_time(self) -> float:
        """Solo step time = max of the three roofline terms (seconds)."""
        c = self.chip
        return max(
            self.flops / (self.chips * c.peak_flops),
            self.bytes_accessed / (self.chips * c.hbm_bw),
            self.collective_bytes / (self.chips * c.link_bw),
        )

    def demands(self) -> dict[str, float]:
        """Fractional demand on each shared resource while running solo."""
        c = self.chip
        t = self.step_time()
        return {
            "compute": self.flops / (self.chips * c.peak_flops) / t,
            "hbm_bw": self.bytes_accessed / (self.chips * c.hbm_bw) / t,
            "ici_bw": self.collective_bytes / (self.chips * c.link_bw) / t,
        }


@dataclasses.dataclass(frozen=True)
class PodSpec:
    """One pod slice as a consolidation bin."""

    name: str
    chips: int = 256
    hbm_budget: float = 256 * HBM_BYTES
    alpha: float = 1.0  # HBM does not over-subscribe


def h100_pod(name: str, chips: int = 256) -> PodSpec:
    """A pod of ``chips`` H100 SXM cards as a bin: their HBM is its budget."""
    return PodSpec(name=name, chips=chips, hbm_budget=chips * H100_SXM.hbm_bytes)


DegradationModel = Literal["additive", "roofline"]


def pair_degradation(a: JobProfile, b: JobProfile) -> float:
    """D_{a,b}: degradation a causes on b when time-multiplexed on one pod.

    Under fair time-multiplexing, job a occupies the shared pipe for a
    fraction of time equal to its own utilization of the binding resource;
    b's slowdown factor is a's demand share on b's *bottleneck* resource.
    """
    da, db = a.demands(), b.demands()
    bottleneck = max(db, key=lambda k: db[k])
    return da[bottleneck] / (da[bottleneck] + 1.0)


def additive_degradations(jobs: Sequence[JobProfile]) -> np.ndarray:
    """Paper Eqn (3) over job profiles: D_j = sum_{i != j} D_{i,j}."""
    n = len(jobs)
    out = np.zeros(n)
    for j in range(n):
        out[j] = sum(pair_degradation(jobs[i], jobs[j]) for i in range(n) if i != j)
    return np.clip(out, 0.0, 0.999999)


def roofline_degradations(jobs: Sequence[JobProfile]) -> np.ndarray:
    """Per-resource saturation of the shared pod."""
    if not jobs:
        return np.zeros(0)
    totals = {"compute": 0.0, "hbm_bw": 0.0, "ici_bw": 0.0}
    for j in jobs:
        for k, v in j.demands().items():
            totals[k] += v
    out = []
    for j in jobs:
        slow = 1.0
        for k, tot in totals.items():
            if tot > 1.0:
                slow = min(slow, 1.0 / tot)
        out.append(1.0 - slow)
    return np.asarray(out)


@dataclasses.dataclass
class FleetState:
    """Mutable fleet assignment: which jobs run on which pod."""

    pods: tuple[PodSpec, ...]
    assignments: list[list[JobProfile]]
    model: DegradationModel = "additive"

    @classmethod
    def empty(cls, pods: Sequence[PodSpec], model: DegradationModel = "additive") -> "FleetState":
        return cls(tuple(pods), [[] for _ in pods], model)

    def degradations(self, pod: int, extra: JobProfile | None = None) -> np.ndarray:
        jobs = list(self.assignments[pod]) + ([extra] if extra else [])
        fn = additive_degradations if self.model == "additive" else roofline_degradations
        return fn(jobs)

    def hbm_in_use(self, pod: int, extra: JobProfile | None = None) -> float:
        jobs = list(self.assignments[pod]) + ([extra] if extra else [])
        budget = self.pods[pod].alpha * self.pods[pod].hbm_budget
        return sum(j.hbm_bytes * j.chips for j in jobs) / budget

    def avg_load(self, pod: int, extra: JobProfile | None = None) -> float:
        d = self.degradations(pod, extra)
        return 0.5 * (self.hbm_in_use(pod, extra) + (float(d.max()) if d.size else 0.0))

    def feasible(self, pod: int, extra: JobProfile | None = None, limit: float = 0.5) -> bool:
        d = self.degradations(pod, extra)
        return (self.hbm_in_use(pod, extra) <= 1.0) and (d.size == 0 or float(d.max()) < limit)


def pack_jobs(
    fleet: FleetState, arrivals: Sequence[JobProfile]
) -> tuple[list[int | None], FleetState]:
    """The paper's greedy (Table II objective) over the fleet."""
    placements: list[int | None] = []
    for job in arrivals:
        best, best_score = None, np.inf
        for p in range(len(fleet.pods)):
            if not fleet.feasible(p, job):
                continue
            score = fleet.avg_load(p, job) - fleet.avg_load(p)
            if score < best_score - 1e-12:
                best, best_score = p, score
        if best is not None:
            fleet.assignments[best].append(job)
        placements.append(best)
    return placements, fleet


def fleet_throughput_report(fleet: FleetState) -> list[dict]:
    """Per-pod report: jobs, degradations, effective steps/s."""
    rows = []
    for p, pod in enumerate(fleet.pods):
        d = fleet.degradations(p)
        for job, dj in zip(fleet.assignments[p], d):
            t = job.step_time() / max(1e-9, 1.0 - dj)
            rows.append(
                dict(pod=pod.name, job=job.name, degradation=float(dj),
                     solo_steps_per_s=1.0 / job.step_time(), eff_steps_per_s=1.0 / t)
            )
    return rows
