"""Fault tolerance: heartbeats, straggler mitigation, elastic re-mesh (copied
from ``repro/distributed/fault_tolerance.py``, numpy only).

At 1000+ nodes the failure model is: (a) hard host loss (heartbeat timeout),
(b) stragglers (host alive but slow -- flaky HBM, thermal throttle, noisy
neighbor on the host NIC), (c) whole-pod loss (DCN partition). The policies
here are deliberately *mechanism-level* and runtime-agnostic: the fleet
controller (``fleet.controller``) consumes their decisions; tests drive them
with a simulated clock. (The JAX package's training launcher and checkpointer,
which consume the re-mesh plans there, are not ported yet.)

Straggler mitigation and the consolidation paper: a straggler is exactly a
server whose *observed* mutual degradation exceeds the model's prediction --
the monitor below reuses the paper's criterion (Eqn 4): hosts whose step
time inflation D = O/(AR+O) exceeds the 50% rule are evicted/replaced, the
same threshold the scheduler uses for admission.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from ..configs.base import MeshConfig
from ..core.criteria import DEGRADATION_LIMIT, eviction_rate_floor


@dataclasses.dataclass
class HostState:
    host_id: int
    last_heartbeat: float
    step_times: list[float] = dataclasses.field(default_factory=list)
    alive: bool = True


class HeartbeatMonitor:
    """Tracks per-host liveness + step-time statistics."""

    def __init__(self, n_hosts: int, timeout_s: float = 60.0, window: int = 20):
        self.hosts = {i: HostState(i, 0.0) for i in range(n_hosts)}
        self.timeout_s = timeout_s
        self.window = window

    def heartbeat(self, host: int, now: float, step_time: float | None = None):
        h = self.hosts[host]
        h.last_heartbeat = now
        if step_time is not None:
            h.step_times.append(step_time)
            del h.step_times[: -self.window]

    def dead_hosts(self, now: float) -> list[int]:
        return [i for i, h in self.hosts.items()
                if h.alive and now - h.last_heartbeat > self.timeout_s]

    def stragglers(self, limit: float = DEGRADATION_LIMIT) -> list[int]:
        """Hosts whose step-time inflation violates the paper's 50% rule.

        Inflation of host i is measured against the fleet-median step time
        AR: D_i = O_i / (AR + O_i) with O_i = t_i - AR. D_i >= `limit`
        (default 0.5, Eqn 4) marks a straggler -- its presence would double
        the synchronous step time, the same condition under which the paper
        refuses to consolidate. The comparison routes through
        ``criteria.eviction_rate_floor`` -- the same threshold conversion
        the fleet failure detector uses (effective rate med/t_i at or below
        the floor <=> inflation at or past ``limit``) -- so straggler and
        eviction policy share one knob.
        """
        med = np.median([np.mean(h.step_times) for h in self.hosts.values()
                         if h.alive and h.step_times] or [0.0])
        if med <= 0:
            return []
        floor = eviction_rate_floor(limit)
        out = []
        for i, h in self.hosts.items():
            if not h.alive or not h.step_times:
                continue
            t = float(np.mean(h.step_times[-5:]))
            if t > 0 and med / t <= floor:
                out.append(i)
        return out

    def mark_dead(self, host: int):
        self.hosts[host].alive = False


@dataclasses.dataclass(frozen=True)
class ReMeshPlan:
    reason: str
    old: MeshConfig
    new: MeshConfig
    restore_step: str = "latest"  # checkpoint policy

    @property
    def lost_fraction(self) -> float:
        return 1.0 - self.new.n_devices / self.old.n_devices


def plan_elastic_remesh(mesh: MeshConfig, lost_hosts: list[int], hosts_per_pod: int = 32) -> ReMeshPlan | None:
    """Shrink policy: losing any host degrades its whole pod slice (ICI is a
    physical torus -- you cannot route around a missing host), so the unit of
    elasticity is the pod. Multi-pod -> drop the affected pod(s) and continue
    data-parallel on the survivors; single-pod -> halve the data axis (use
    the surviving 8x16 sub-torus)."""
    if not lost_hosts:
        return None
    lost_pods = sorted({h // hosts_per_pod for h in lost_hosts})
    if mesh.multi_pod:
        surviving = mesh.pods - len([p for p in lost_pods if p < mesh.pods])
        if surviving <= 0:
            raise RuntimeError("all pods lost")
        new = dataclasses.replace(mesh, pods=surviving) if surviving > 1 else MeshConfig(
            multi_pod=False, data=mesh.data, model=mesh.model
        )
        return ReMeshPlan(f"lost pods {lost_pods}", mesh, new)
    new = dataclasses.replace(mesh, data=max(1, mesh.data // 2))
    return ReMeshPlan(f"lost hosts {lost_hosts} (single pod: shrink data axis)", mesh, new)


def scale_batch_for_mesh(global_batch: int, old: MeshConfig, new: MeshConfig,
                         keep_global: bool = True) -> int:
    """Elastic batch policy: keep the global batch (per-device batch grows)
    when memory allows, else scale it with the fleet."""
    if keep_global:
        return global_batch
    return max(new.dp, global_batch * new.n_devices // old.n_devices)
