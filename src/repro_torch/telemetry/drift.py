"""Drift scenarios: worlds where the profiled model goes stale.

A copy of ``repro/telemetry/drift.py`` (same names and arithmetic) over the
port's ``ServerSpec``; framework-free, it builds specs and schedules only.

The motivation for the telemetry loop is that interference profiles are not
stationary -- co-tenancy noise, hardware variability, aging disks. This
module builds perturbed/decaying/degraded variants of a ``ServerSpec`` and
schedules when they take effect, so the closed-loop engine can be evaluated
against a ground truth that *changes under it* while its estimator has to
notice purely from observations.

Only the *performance* constants drift (bandwidths, shared-subsystem
capacity, per-op CPU costs). Structural facts the scheduler legitimately
knows -- cache sizes, core counts, the Eqn-2 resident-set rule -- stay fixed:
drift models wear and contention, not hardware swaps.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from ..core.server import ServerSpec

#: the ServerSpec fields that represent measured performance (drift targets)
PERF_FIELDS = (
    "bw_l1_read", "bw_l2_read", "bw_l1_write", "bw_l2_write", "bw_l3_write",
    "shared_bw",
)


def scale_perf(spec: ServerSpec, factor: float, suffix: str) -> ServerSpec:
    """Uniformly scale every performance constant by ``factor``."""
    updates = {f: getattr(spec, f) * factor for f in PERF_FIELDS}
    return dataclasses.replace(spec, name=f"{spec.name}{suffix}", **updates)


def degrade_server(spec: ServerSpec, factor: float = 0.5) -> ServerSpec:
    """Degraded-server injection: a failing disk / throttled node.

    Every performance constant drops to ``factor`` of nominal; per-request
    CPU cost rises inversely (retries, error handling burn cycles). Because
    demands and capacities scale together, *pair* degradations barely move --
    this drift is observable mainly through the base rates (solo telemetry).
    """
    out = scale_perf(spec, factor, f":deg{factor:g}")
    return dataclasses.replace(out, cpu_req_cost=spec.cpu_req_cost / factor)


def congest_server(spec: ServerSpec, factor: float = 0.5) -> ServerSpec:
    """Shared-subsystem congestion: aggregate storage bandwidth drops to
    ``factor`` of nominal while per-level burst rates stay -- a failing RAID
    controller, or co-tenant noise outside the scheduler's view (the Ivanov
    et al. virtualized-Hadoop scenario). Unlike :func:`degrade_server`, this
    moves demand/capacity ratios, so the *pairwise D-matrix itself* changes:
    the drift the estimator can only see through co-run observations.
    """
    return dataclasses.replace(
        spec, name=f"{spec.name}:cong{factor:g}", shared_bw=spec.shared_bw * factor)


def perturb_spec(spec: ServerSpec, scale: float = 0.1, seed: int = 0) -> ServerSpec:
    """Log-normal multiplicative jitter on each performance constant.

    Models unit-to-unit hardware variability: same nominal part, different
    realized bandwidths (sigma = ``scale`` in log space, independent per
    field).
    """
    rng = np.random.default_rng(seed)
    updates = {
        f: getattr(spec, f) * float(np.exp(rng.normal(0.0, scale)))
        for f in PERF_FIELDS
    }
    return dataclasses.replace(spec, name=f"{spec.name}:pert{seed}", **updates)


def decayed_spec(spec: ServerSpec, rate: float, steps: int) -> ServerSpec:
    """Geometric wear: performance after ``steps`` segments of ``rate`` decay."""
    return scale_perf(spec, (1.0 - rate) ** steps, f":dec{steps}")


@dataclasses.dataclass(frozen=True)
class DriftEvent:
    """At the start of ``segment``, server ``server`` becomes ``spec``."""

    segment: int
    server: int
    spec: ServerSpec


@dataclasses.dataclass(frozen=True)
class DriftSchedule:
    """An ordered set of spec replacements applied at segment boundaries."""

    events: tuple[DriftEvent, ...] = ()

    def specs_at(self, base: Sequence[ServerSpec], segment: int) -> tuple[ServerSpec, ...]:
        """Fleet specs in effect during ``segment`` (events applied in order)."""
        out = list(base)
        for ev in self.events:
            if ev.segment <= segment:
                out[ev.server] = ev.spec
        return tuple(out)

    def changes_at(self, segment: int) -> tuple[DriftEvent, ...]:
        return tuple(ev for ev in self.events if ev.segment == segment)

    @property
    def first_segment(self) -> int | None:
        return min((ev.segment for ev in self.events), default=None)


def degradation_at(
    base: Sequence[ServerSpec], segment: int, server: int, factor: float = 0.5
) -> DriftSchedule:
    """The canonical benchmark scenario: one server degrades mid-run."""
    return DriftSchedule(
        (DriftEvent(segment, server, degrade_server(base[server], factor)),))


def congestion_at(
    base: Sequence[ServerSpec], segment: int, server: int, factor: float = 0.5
) -> DriftSchedule:
    """One server's shared subsystem congests mid-run (D-matrix drift)."""
    return DriftSchedule(
        (DriftEvent(segment, server, congest_server(base[server], factor)),))


def stochastic_congestion(
    base: Sequence[ServerSpec],
    rate: float,
    seed: int = 0,
    *,
    segments: int = 8,
    low: float = 0.4,
    high: float = 0.9,
    servers: Sequence[int] | None = None,
) -> DriftSchedule:
    """Multi-tenant background noise: a stochastic co-tenant per segment.

    The Ivanov et al. virtualized-Hadoop setting: co-tenants outside the
    scheduler's view come and go, stealing shared storage bandwidth. Each
    segment, each server is independently congested with probability
    ``rate`` (a ``congest_server`` event with factor ~ U[low, high] -- the
    drift that moves the pairwise D-matrix itself) and otherwise reverts to
    its nominal spec. Events are emitted only on state *changes* (congestion
    onset, factor change, or clearing), so a quiet fleet stays a short
    schedule. ``servers`` restricts the process to a subset of the fleet --
    benchmarks use it to keep one server's injected deterministic divergence
    out of the noise floor. Deterministic in ``seed``.
    """
    if not 0.0 <= rate <= 1.0:
        raise ValueError(f"congestion rate must be in [0, 1], got {rate}")
    rng = np.random.default_rng(seed)
    idx = list(range(len(base))) if servers is None else list(servers)
    events: list[DriftEvent] = []
    congested: dict[int, float] = {}  # server -> active congestion factor
    for seg in range(segments):
        for s in idx:
            if rng.random() < rate:
                factor = float(rng.uniform(low, high))
                if congested.get(s) != factor:
                    events.append(DriftEvent(seg, s, congest_server(base[s], factor)))
                    congested[s] = factor
            elif s in congested:
                events.append(DriftEvent(seg, s, base[s]))  # co-tenant left
                del congested[s]
    return DriftSchedule(tuple(events))


def merge_schedules(*schedules: DriftSchedule) -> DriftSchedule:
    """Overlay drift schedules (stable order within a segment; later
    arguments win ties on the same server+segment, since ``specs_at``
    applies events in sequence)."""
    events = [ev for sch in schedules for ev in sch.events]
    order = np.argsort([ev.segment for ev in events], kind="stable")
    return DriftSchedule(tuple(events[i] for i in order))


def gradual_decay(
    base: Sequence[ServerSpec],
    server: int,
    rate: float = 0.05,
    start: int = 0,
    segments: int = 8,
) -> DriftSchedule:
    """Per-segment geometric decay of one server from ``start`` onward."""
    events = tuple(
        DriftEvent(seg, server, decayed_spec(base[server], rate, seg - start + 1))
        for seg in range(start, segments))
    return DriftSchedule(events)
