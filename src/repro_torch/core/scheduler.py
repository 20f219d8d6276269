"""Online consolidation scheduler with criterion-1 queueing (paper §V, §VIII),
copied from ``repro/core/scheduler.py`` with the same names and float64
arithmetic (numpy only).

NOTE: this module is the *numpy reference oracle* of the port's engine.
Production traffic goes through ``core.engine.ConsolidationEngine``, whose
device event loop (``engine_torch.trace_segment``) is parity-tested against
this implementation; ``ConsolidationEngine(backend="numpy")`` runs this
loop instead. The float64 event loop below is kept as the readable, trusted
specification of the runtime semantics.

The paper's operating model: workloads *arrive* one at a time; the greedy
(Fig 8) places each on the best feasible server, or queues it "until a server
to satisfy this criterion is found -- most probably upon completion of
another workload" (§V). This module adds the missing runtime half: workload
completions, queue draining, and makespan accounting, so the Fig-5 argument
(consolidate only when every D_i < 50%) can be verified end to end.

Time model: a workload placed at time t with solo runtime AR finishes at
t + AR / (1 - D), where D is its (simulated, ground-truth) degradation under
whatever co-run set it experiences; we conservatively re-evaluate remaining
work whenever the co-run set changes (piecewise-constant rates).
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Callable, Sequence

import numpy as np

from .binpack import ClusterState, greedy_place
from .simulator import simulate_corun
from .throughput import solo_throughput
from .workload import Workload


@dataclasses.dataclass
class _Running:
    w: Workload
    server: int
    remaining_bytes: float
    rate: float  # current bytes/s under the present co-run set


@dataclasses.dataclass
class ScheduleEvent:
    time: float
    kind: str  # 'arrive' | 'place' | 'queue' | 'finish'
    workload: Workload
    server: int | None = None


@dataclasses.dataclass
class ScheduleResult:
    events: list[ScheduleEvent]
    makespan: float
    placements: dict[int, int | None]  # arrival index -> server (None = never ran!)
    max_observed_degradation: float


class OnlineScheduler:
    """Event-driven consolidation runtime around the paper's greedy."""

    def __init__(self, state: ClusterState, place: Callable = greedy_place):
        self.state = state
        self.place = place
        self.running: dict[int, list[_Running]] = {i: [] for i in range(len(state.servers))}
        self.queue: list[tuple[int, Workload]] = []
        self.events: list[ScheduleEvent] = []
        self.max_deg = 0.0

    # -- rate bookkeeping ------------------------------------------------
    def _refresh_rates(self, server: int) -> None:
        rs = self.running[server]
        if not rs:
            return
        res = simulate_corun(self.state.servers[server], [r.w for r in rs])
        for r, t, d in zip(rs, res.throughputs, res.degradations):
            r.rate = t
            self.max_deg = max(self.max_deg, d)

    def _next_finish(self, server: int) -> tuple[float, _Running] | None:
        rs = self.running[server]
        if not rs:
            return None
        r = min(rs, key=lambda r: r.remaining_bytes / r.rate)
        return r.remaining_bytes / r.rate, r

    def _advance(self, server: int, dt: float) -> None:
        for r in self.running[server]:
            r.remaining_bytes = max(0.0, r.remaining_bytes - r.rate * dt)

    # -- the simulation loop ----------------------------------------------
    def run(self, arrivals: Sequence[tuple[float, Workload]]) -> ScheduleResult:
        """Simulate arrivals [(time, workload)] to completion of all work."""
        arrivals = sorted(enumerate(arrivals), key=lambda kv: kv[1][0])
        heap: list[tuple[float, int, str, int]] = []  # (time, seq, kind, idx)
        seq = 0
        for idx, (t, _) in arrivals:
            heapq.heappush(heap, (t, seq, "arrive", idx))
            seq += 1
        arrival_map = {idx: w for idx, (_, w) in arrivals}
        placements: dict[int, int | None] = {}
        now = 0.0

        def try_place(idx: int, w: Workload, t: float) -> bool:
            s = self.place(self.state, w)
            if s is None:
                return False
            placements[idx] = s
            solo = solo_throughput(self.state.servers[s], w)
            self.running[s].append(_Running(w, s, w.data_total, solo))
            self._refresh_rates(s)
            self.events.append(ScheduleEvent(t, "place", w, s))
            return True

        while heap:
            # advance every server to the earlier of (next heap event, next finish)
            t_event = heap[0][0]
            # find earliest finish across servers
            finishes = []
            for s in self.running:
                nf = self._next_finish(s)
                if nf is not None:
                    finishes.append((now + nf[0], s, nf[1]))
            if finishes:
                t_fin, s_fin, r_fin = min(finishes, key=lambda x: x[0])
            else:
                t_fin = np.inf
            if t_fin <= t_event:
                # a completion happens first
                dt = t_fin - now
                for s in self.running:
                    self._advance(s, dt)
                now = t_fin
                self.running[s_fin] = [r for r in self.running[s_fin] if r is not r_fin]
                self.state.assignments[s_fin] = [
                    w for w in self.state.assignments[s_fin] if w is not r_fin.w
                ]
                self._refresh_rates(s_fin)
                self.events.append(ScheduleEvent(now, "finish", r_fin.w, s_fin))
                # completion may unblock the queue (§V)
                still = []
                for idx, w in self.queue:
                    if not try_place(idx, w, now):
                        still.append((idx, w))
                self.queue = still
                continue

            t, _, kind, idx = heapq.heappop(heap)
            dt = t - now
            for s in self.running:
                self._advance(s, dt)
            now = t
            w = arrival_map[idx]
            self.events.append(ScheduleEvent(now, "arrive", w))
            if not try_place(idx, w, now):
                placements[idx] = None
                self.queue.append((idx, w))
                self.events.append(ScheduleEvent(now, "queue", w))

        # drain: no more arrivals; let everything finish, placing queue as room opens
        while any(self.running.values()) or self.queue:
            finishes = []
            for s in self.running:
                nf = self._next_finish(s)
                if nf is not None:
                    finishes.append((now + nf[0], s, nf[1]))
            if not finishes:
                # queue non-empty but nothing running: place greedily on empty cluster
                progressed = False
                still = []
                for idx, w in self.queue:
                    if try_place(idx, w, now):
                        progressed = True
                    else:
                        still.append((idx, w))
                self.queue = still
                if not progressed:
                    raise RuntimeError("deadlock: queued workloads fit no empty server")
                continue
            t_fin, s_fin, r_fin = min(finishes, key=lambda x: x[0])
            dt = t_fin - now
            for s in self.running:
                self._advance(s, dt)
            now = t_fin
            self.running[s_fin] = [r for r in self.running[s_fin] if r is not r_fin]
            self.state.assignments[s_fin] = [
                w for w in self.state.assignments[s_fin] if w is not r_fin.w
            ]
            self._refresh_rates(s_fin)
            self.events.append(ScheduleEvent(now, "finish", r_fin.w, s_fin))
            still = []
            for idx, w in self.queue:
                if not try_place(idx, w, now):
                    still.append((idx, w))
            self.queue = still

        final_placements = {}
        for idx in arrival_map:
            # last placement wins (queued-then-placed updates the entry)
            final_placements[idx] = placements.get(idx)
        return ScheduleResult(self.events, now, final_placements, self.max_deg)
