"""Online consolidation engine as a host-driven loop over tensor state.

Counterpart of ``repro/core/engine_jax.py``: the full arrive -> score ->
place-or-queue -> run -> complete -> drain loop of the paper's operating
model (§V, §VIII) over fixed-shape tensors, one micro-event per iteration.
Where the JAX engine is one ``lax.while_loop``, this is a Python loop: each
iteration computes the event choice on the device and reads one small int
tensor (done, branch) to the host, which then runs the DRAIN, FINISH or
ARRIVE branch; a drain reads one more flag to decide whether the whole queue
must be rescanned. Every such read is counted in ``LoopStats.host_syncs``.
State tensors are updated in place.

State encoding (m servers, K = n run-slots per server, n arrivals, T types):

  counts    : f32[m, T]  -- resident type counts (drives the Fig-8 scorer)
  comp      : f32[m]     -- Eqn-2 competing bytes
  col0      : f32[m, T]  -- additive-model column sums counts @ D (Eqn 3)
  colog_*   : f32[m, T]  -- counts @ log(1 - d) under the keep/lost cache
                            outcome (ground-truth co-run slowdown sums)
  slot_type : i32[m, K]  -- grid type per run slot (-1 = free)
  slot_rem  : f32[m, K]  -- remaining bytes per slot
  slot_arr  : i32[m, K]  -- arrival index occupying the slot
  queued    : bool[n]    -- criterion-1 queue, in arrival order
  obs_*     : [n + 1, ...] -- per-arrival telemetry integrals (run_trace(
                            telemetry=True)); row n is a dump row, sliced away

Ground-truth rates reproduce the simulator exactly for grid-typed
workloads: with per-type counts c the log co-run slowdown of a type-t
workload on server s is

  log T_t / T_base,t = sum_u c_u * log(1 - d_s[u, t]) - log(1 - d_s[t, t])

with the keep/lost variant of ``d_s`` (and of the base throughput) selected
by the server's *physical* cache state (Eqn 2 vs llc_tolerance * CacheSize).

A JAX scatter drops a write whose index is out of bounds, and the JAX engine
uses that for its conditional writes. Here every conditional write is
masked instead (the old value is written back), and every gather whose
index may be the "none" sentinel is clamped, as JAX clamps it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from ..device import resolve_device
from .binpack_torch import PackedCluster, choose, loads_from_sums, scores_from_sums
from .contention import pair_slowdown_matrices, type_tables
from .server import ServerSpec

QUEUED = -1  # placement sentinel, same as binpack_torch

#: scoring backend signature: (cluster, counts [m,T], wtypes i32[Q]) ->
#: (cache_after [Q, m], maxd_after [Q, m])
Scorer = Callable[[PackedCluster, torch.Tensor, torch.Tensor],
                  tuple[torch.Tensor, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class PackedDynamics:
    """Per-type ground-truth rate tables (the simulator's co-run model)."""

    solo: torch.Tensor  # f32[m, T] solo throughput (bytes/s)
    base_lost: torch.Tensor  # f32[m, T] throughput after losing the LLC
    log_keep: torch.Tensor  # f32[m, T, T] log(1 - d_keep[i, j])
    log_lost: torch.Tensor  # f32[m, T, T] log(1 - d_lost[i, j])
    comp_bytes: torch.Tensor  # f32[m, T] per-type competing bytes (Eqn 2 terms)
    tol_budget: torch.Tensor  # f32[m] llc_tolerance * CacheSize (physical TDP)

    @classmethod
    def build(cls, servers: Sequence[ServerSpec], *,
              device: str | torch.device | None = None) -> "PackedDynamics":
        """Tables in float64 numpy on the host, cast to float32, then one copy
        to ``device``."""
        device = resolve_device(device)
        tables, logs = {}, {}
        solo, lost, lkeep, llost, comp, tol = [], [], [], [], [], []
        for s in servers:
            # keyed by the frozen spec value (not name): identical specs share
            # one pass, same-name variants do not
            if s not in tables:
                tables[s] = type_tables(s)
                logs[s] = pair_slowdown_matrices(s)
            tt, (d_keep, d_lost) = tables[s], logs[s]
            solo.append(tt["solo"])
            lost.append(tt["base_lost"])
            lkeep.append(np.log1p(-np.clip(d_keep, 0.0, 1.0 - 1e-9)))
            llost.append(np.log1p(-np.clip(d_lost, 0.0, 1.0 - 1e-9)))
            comp.append(tt["comp_bytes"])
            tol.append(s.llc_tolerance * s.llc_bytes)

        def f32(x):
            return torch.from_numpy(np.asarray(x, np.float32)).to(device)

        return cls(f32(np.stack(solo)), f32(np.stack(lost)), f32(np.stack(lkeep)),
                   f32(np.stack(llost)), f32(np.stack(comp)), f32(tol))


@dataclasses.dataclass
class EngineState:
    now: torch.Tensor  # f32 scalar simulation clock
    counts: torch.Tensor  # f32[m, T]
    comp: torch.Tensor  # f32[m] competing bytes (Eqn 2 LHS)
    col0: torch.Tensor  # f32[m, T] counts @ D
    colog_keep: torch.Tensor  # f32[m, T] counts @ log(1-d_keep)
    colog_lost: torch.Tensor  # f32[m, T] counts @ log(1-d_lost)
    slot_type: torch.Tensor  # i32[m, K]
    slot_rem: torch.Tensor  # f32[m, K]
    slot_arr: torch.Tensor  # i32[m, K]
    queued: torch.Tensor  # bool[n]
    was_queued: torch.Tensor  # bool[n] -- the §V queue *decision* per arrival
    placement: torch.Tensor  # i32[n] server index or QUEUED
    place_time: torch.Tensor  # f32[n]
    finish_time: torch.Tensor  # f32[n]
    makespan: torch.Tensor  # f32 scalar (time of latest completion)
    max_deg: torch.Tensor  # f32 scalar max *observed* (simulated) degradation
    draining: torch.Tensor  # bool -- queue re-check pending
    deadlock: torch.Tensor  # bool -- queued work that no empty server can take
    obs_co: torch.Tensor  # f32[n + 1, T] time-integrated co-resident type counts
    obs_lost: torch.Tensor  # f32[n + 1] time spent past the physical TDP
    obs_logr: torch.Tensor  # f32[n + 1] time-integrated log instantaneous rate
    ai: int = 0  # next-arrival pointer (the host runs the ARRIVE branch)

    @classmethod
    def zeros(cls, m: int, T: int, n: int, device: torch.device) -> "EngineState":
        f32 = dict(dtype=torch.float32, device=device)
        i32 = dict(dtype=torch.int32, device=device)
        return cls(
            now=torch.zeros((), **f32),
            counts=torch.zeros((m, T), **f32),
            comp=torch.zeros((m,), **f32),
            col0=torch.zeros((m, T), **f32),
            colog_keep=torch.zeros((m, T), **f32),
            colog_lost=torch.zeros((m, T), **f32),
            slot_type=torch.full((m, n), -1, **i32),
            slot_rem=torch.zeros((m, n), **f32),
            slot_arr=torch.full((m, n), -1, **i32),
            queued=torch.zeros((n,), dtype=torch.bool, device=device),
            was_queued=torch.zeros((n,), dtype=torch.bool, device=device),
            placement=torch.full((n,), QUEUED, **i32),
            place_time=torch.full((n,), -1.0, **f32),
            finish_time=torch.full((n,), torch.inf, **f32),
            makespan=torch.zeros((), **f32),
            max_deg=torch.zeros((), **f32),
            draining=torch.zeros((), dtype=torch.bool, device=device),
            deadlock=torch.zeros((), dtype=torch.bool, device=device),
            obs_co=torch.zeros((n + 1, T), **f32),
            obs_lost=torch.zeros((n + 1,), **f32),
            obs_logr=torch.zeros((n + 1,), **f32),
        )


@dataclasses.dataclass(frozen=True)
class LoopStats:
    """What the host loop did: micro-events run, device->host reads, and
    drains that had to rescore the whole queue."""

    events: int
    host_syncs: int
    drain_full_scans: int


@dataclasses.dataclass(frozen=True)
class EngineTrace:
    """Raw result of :func:`run_trace` (arrival-sorted order)."""

    placement: torch.Tensor  # i32[n]
    was_queued: torch.Tensor  # bool[n]
    place_time: torch.Tensor  # f32[n]
    finish_time: torch.Tensor  # f32[n]
    makespan: torch.Tensor  # f32
    max_deg: torch.Tensor  # f32
    deadlock: torch.Tensor  # bool
    obs_co: torch.Tensor  # f32[n, T] (zeros unless telemetry=True)
    obs_lost: torch.Tensor  # f32[n] (zeros unless telemetry=True)
    obs_logr: torch.Tensor  # f32[n] (zeros unless telemetry=True)
    stats: LoopStats


def corun_rates(
    cluster: PackedCluster, dyn: PackedDynamics, counts: torch.Tensor,
    slot_type: torch.Tensor,
) -> torch.Tensor:
    """Ground-truth bytes/s per run slot under the current co-run sets [m, K].

    Standalone (counts-based) form of the rate model the loop maintains
    incrementally; exported for tests and one-off evaluations.
    """
    overflow = (counts * dyn.comp_bytes).sum(-1) > dyn.tol_budget  # [m] physical TDP
    ck = torch.einsum("mt,mtu->mu", counts, dyn.log_keep)
    cl = torch.einsum("mt,mtu->mu", counts, dyn.log_lost)
    ldiag_keep = torch.diagonal(dyn.log_keep, dim1=1, dim2=2)
    ldiag_lost = torch.diagonal(dyn.log_lost, dim1=1, dim2=2)
    return _slot_rates(dyn, ldiag_keep, ldiag_lost, overflow, ck, cl, slot_type)


def _slot_rates(dyn, ldiag_keep, ldiag_lost, overflow, colog_keep, colog_lost, slot_type):
    """Per-slot rates from the maintained log-slowdown sums."""
    ov = overflow[:, None]
    colog = torch.where(ov, colog_lost, colog_keep)  # [m, T]
    ldiag = torch.where(ov, ldiag_lost, ldiag_keep)  # [m, T]
    base = torch.where(ov, dyn.base_lost, dyn.solo)  # [m, T]
    t = slot_type.clamp(min=0).long()  # [m, K]
    logslow = torch.gather(colog - ldiag, 1, t)
    return torch.gather(base, 1, t) * torch.exp(logslow)  # [m, K]


def _put_if(dst: torch.Tensor, index: tuple, value: torch.Tensor, mask: torch.Tensor) -> None:
    """dst[index] = value where mask, else unchanged (a masked scatter)."""
    dst.index_put_(index, torch.where(mask, value.to(dst.dtype), dst[index]))


class _TraceLoop:
    """One run of the event loop: the constants of a trace and its branches."""

    def __init__(self, cluster, dyn, arr_time, arr_type, arr_bytes, objective, scorer,
                 telemetry=False):
        self.cluster, self.dyn, self.scorer = cluster, dyn, scorer
        self.objective, self.telemetry = objective, telemetry
        self.arr_time, self.arr_type, self.arr_bytes = arr_time, arr_type, arr_bytes
        self.n = n = int(arr_time.shape[0])
        self.m, self.T, self.K = cluster.m, cluster.T, n
        self.W = min(8, n)  # drain fast-path window (first W queued candidates)
        dev = cluster.device
        self.comp_delta = cluster.rs[None, :] + cluster.resident * cluster.fs[None, :]
        self.ldiag_keep = torch.diagonal(dyn.log_keep, dim1=1, dim2=2)
        self.ldiag_lost = torch.diagonal(dyn.log_lost, dim1=1, dim2=2)
        # all per-server sum tables side by side: one matvec refreshes every
        # maintained sum of the touched server (see apply_delta)
        self.tables = torch.cat(
            [cluster.D, dyn.log_keep, dyn.log_lost, self.comp_delta[:, :, None]], dim=2
        )  # [m, T, 3T + 1]
        self.arange_n = torch.arange(n, device=dev)
        self.arange_T = torch.arange(self.T, device=dev)
        self.ranks = torch.arange(1, self.W + 1, device=dev)
        # device constants, made once: a host scalar copied per event would
        # make each event wait for the device
        self.inf = torch.tensor(torch.inf, device=dev)
        self.free_slot = torch.full((1,), -1, dtype=torch.int32, device=dev)
        self.syncs = self.full_scans = 0

    # -- scoring ------------------------------------------------------------
    def greedy_pick(self, st, wtypes):
        """Scoring + Fig-8 argmin (Table II / Fig-8 objective) for a batch.
        The in-loop scorer (``scorer=None``) reads the maintained sums
        instead of recomputing counts @ D."""
        cl = self.cluster
        if self.scorer is None:
            cache_a, maxd_a = scores_from_sums(cl, st.counts, st.comp, st.col0, wtypes)
        else:
            cache_a, maxd_a = self.scorer(cl, st.counts, wtypes)
        if self.objective == "sum_avg":  # Table II: minimize the load *increase*
            cache_now, maxd_now = loads_from_sums(cl, st.counts, st.comp, st.col0)
            if self.scorer is None:
                # the cache increase is known in closed form; using it directly
                # avoids the f32 cancellation of (cache_after - cache_now)
                dcache = (self.comp_delta[:, wtypes.long()] / cl.llc_budget[:, None]).T
            else:
                dcache = cache_a - cache_now[None, :]
            score = 0.5 * (dcache + (maxd_a - maxd_now[None, :]))
        else:  # literal Fig 8: minimize the post-allocation average
            score = 0.5 * (cache_a + maxd_a)
        return choose(cl, cache_a, maxd_a, score)

    # -- state updates --------------------------------------------------------
    def apply_delta(self, st, server, wtype, sign):
        """counts update + canonical refresh of the touched server's sums.

        The sums are recomputed *from the counts row* (one [T] @ [T, 3T+1]
        matvec, only for the modified server) rather than updated
        additively: identical servers with identical co-run multisets then
        hold bitwise-identical sums regardless of event history, so score
        ties break by server index exactly like the float64 oracle, and
        nothing drifts over long traces. ``sign=0`` is a no-op refresh.
        ``server``, ``wtype`` and ``sign`` have shape [1].
        """
        T = self.T
        st.counts.index_put_((server, wtype), sign, accumulate=True)
        sums = (st.counts[server][:, None, :] @ self.tables[server])[:, 0]  # [1, 3T+1]
        st.comp.index_copy_(0, server, sums[:, 3 * T])
        st.col0.index_copy_(0, server, sums[:, :T])
        st.colog_keep.index_copy_(0, server, sums[:, T:2 * T])
        st.colog_lost.index_copy_(0, server, sums[:, 2 * T:3 * T])

    def place_if(self, st, found, idx, server, wtype, nbytes, t, queue_on_fail):
        """Commit arrival ``idx`` to ``server`` when ``found``, else queue it
        (``queue_on_fail``) or leave it as it is. All index arguments have
        shape [1]; ``idx`` may be n (no candidate) when not ``found``."""
        server = torch.where(found, server, 0)
        self.apply_delta(st, server, wtype, found.to(torch.float32))
        # first free slot; K == n, so one exists whenever found
        k = (st.slot_type[server][0] < 0).to(torch.int32).argmax().reshape(1)
        _put_if(st.slot_type, (server, k), wtype, found)
        _put_if(st.slot_rem, (server, k), nbytes, found)
        _put_if(st.slot_arr, (server, k), idx, found)
        i = idx.clamp(max=self.n - 1)
        if queue_on_fail:
            st.queued.index_put_((i,), ~found)
            st.was_queued.index_put_((i,), st.was_queued[i] | ~found)
        else:
            _put_if(st.queued, (i,), torch.zeros_like(found), found)
        _put_if(st.placement, (i,), server, found)
        _put_if(st.place_time, (i,), t.reshape(1), found)

    def advance(self, st, rates, dt):
        active = st.slot_type >= 0
        st.slot_rem = torch.where(
            active, torch.clamp(st.slot_rem - rates * dt, min=0.0), st.slot_rem)
        if self.telemetry:
            # integrate each running workload's co-resident counts, TDP
            # exposure and log instantaneous rate over [now, now + dt), as
            # the JAX engine does. Its scatter drops inactive slots at index
            # n; here they land in the dump row n. Each arrival holds at most
            # one slot, so every real row takes at most one add: no duplicate
            # indices, and the sum does not depend on the add's order.
            m, K, T = self.m, self.K, self.T
            idx = torch.where(active, st.slot_arr, self.n).reshape(-1).long()  # [m K]
            own = self.arange_T == st.slot_type.clamp(min=0)[:, :, None]  # [m, K, T]
            co = torch.clamp(st.counts[:, None, :] - own.to(st.counts.dtype), min=0.0)
            overflow = (st.comp > self.dyn.tol_budget).to(st.counts.dtype)  # [m]
            logr = torch.log(torch.where(active, rates, 1.0))
            st.obs_co.index_add_(0, idx, dt * co.reshape(-1, T))
            st.obs_lost.index_add_(0, idx, dt * overflow[:, None].expand(m, K).reshape(-1))
            st.obs_logr.index_add_(0, idx, dt * logr.reshape(-1))

    # -- the three micro-events -------------------------------------------------
    def drain_branch(self, st, rates, tt):
        # Queue order == arrival order (workloads are never re-queued), so the
        # first feasible *queued arrival index* is the item the oracle places.
        n, W = self.n, self.W
        pos = torch.cumsum(st.queued, 0)  # 1-based rank among queued
        qlen = pos[-1]
        # arrival indices of the first W queued items (n where fewer than W):
        # the first index whose rank reaches r is the r-th queued item
        widx = torch.searchsorted(pos, self.ranks)  # [W] in [0, n]
        servers_w, ok_w = self.greedy_pick(st, self.arr_type[widx.clamp(max=n - 1)])
        ok_w &= widx < n
        found_w = ok_w.any().reshape(1)
        w_first = ok_w.to(torch.int32).argmax().reshape(1)
        full = bool(~found_w & (qlen > W))  # host read: rescan the whole queue?
        self.syncs += 1
        if full:
            # every window candidate failed but more are queued: score them all
            self.full_scans += 1
            servers, ok = self.greedy_pick(st, self.arr_type)  # [n]
            cand = st.queued & ok
            q = cand.to(torch.int32).argmax().reshape(1)
            server, found = servers[q], cand.any().reshape(1)
        else:
            q, server, found = widx[w_first], servers_w[w_first], found_w
        qc = q.clamp(max=n - 1)
        self.place_if(st, found, q, server, self.arr_type[qc].long(),
                      self.arr_bytes[qc], st.now, queue_on_fail=False)
        no_active = ~(st.slot_type >= 0).any()
        if st.ai >= n:  # deadlock: nothing runs, nothing arrives, the queue is stuck
            st.deadlock |= ~found[0] & no_active & st.queued.any()
        st.draining = found[0]

    def finish_branch(self, st, rates, tt):
        # margin argmin: exactly-simultaneous completions (identical workloads
        # on same-spec servers) must resolve lowest-server-first like the
        # oracle's event loop; f32 noise would otherwise order them arbitrarily
        flat = tt.reshape(-1)
        t_min = flat.min()
        k_flat = (flat <= t_min * (1.0 + 1e-5)).to(torch.int32).argmax().reshape(1)
        s_fin, k_fin = k_flat // self.K, k_flat % self.K
        t_fin = st.now + flat[k_flat][0]
        self.advance(st, rates, t_fin - st.now)
        idx = st.slot_arr[s_fin, k_fin].long()
        wtype = st.slot_type[s_fin, k_fin].long()
        self.apply_delta(st, s_fin, wtype, torch.full_like(t_fin.reshape(1), -1.0))
        st.now = t_fin
        st.makespan = t_fin
        st.slot_type.index_put_((s_fin, k_fin), self.free_slot)
        st.slot_arr.index_put_((s_fin, k_fin), self.free_slot)
        st.finish_time.index_put_((idx,), t_fin.reshape(1))
        st.draining = st.queued.any()  # §V: completion may unblock the queue

    def arrive_branch(self, st, rates, tt):
        ai = st.ai
        t_arr = self.arr_time[ai]
        self.advance(st, rates, t_arr - st.now)
        st.now = t_arr
        wtype = self.arr_type[ai:ai + 1]
        servers, ok = self.greedy_pick(st, wtype)
        self.place_if(st, ok, self.arange_n[ai:ai + 1], servers, wtype.long(),
                      self.arr_bytes[ai:ai + 1], t_arr, queue_on_fail=True)
        st.ai = ai + 1

    # -- the loop ---------------------------------------------------------------
    def run(self, n_steps: int) -> EngineTrace:
        n, dyn = self.n, self.dyn
        st = EngineState.zeros(self.m, self.T, n, self.cluster.device)
        branches = (self.drain_branch, self.finish_branch, self.arrive_branch)
        events = 0
        for _ in range(n_steps):
            overflow = st.comp > dyn.tol_budget
            rates = _slot_rates(dyn, self.ldiag_keep, self.ldiag_lost, overflow,
                                st.colog_keep, st.colog_lost, st.slot_type)
            active = st.slot_type >= 0
            any_active = active.any()
            queue_any = st.queued.any()
            arrived_all = st.ai >= n
            tt = torch.where(active, st.slot_rem / rates, torch.inf)
            t_fin = st.now + tt.min()
            t_arr = self.inf if arrived_all else self.arr_time[st.ai]
            done = st.deadlock | (arrived_all & ~any_active & ~queue_any)
            drain = st.draining | (queue_any & ~any_active & arrived_all)
            branch = torch.where(drain, 0, torch.where(any_active & (t_fin <= t_arr), 1, 2))
            is_done, b = torch.stack([done.to(torch.int64), branch]).tolist()
            self.syncs += 1
            if is_done:
                break
            # observed (ground-truth) degradation of the running set, for audits
            solo = torch.gather(dyn.solo, 1, st.slot_type.clamp(min=0).long())
            deg = torch.where(active, 1.0 - rates / solo, -torch.inf)
            st.max_deg = torch.maximum(st.max_deg, deg.max())
            branches[b](st, rates, tt)
            events += 1
        return EngineTrace(st.placement, st.was_queued, st.place_time, st.finish_time,
                           st.makespan, st.max_deg, st.deadlock, st.obs_co[:n],
                           st.obs_lost[:n], st.obs_logr[:n],
                           LoopStats(events, self.syncs, self.full_scans))


def run_trace(
    cluster: PackedCluster,
    dyn: PackedDynamics,
    arr_time: torch.Tensor,  # f32[n], non-decreasing
    arr_type: torch.Tensor,  # i32[n] grid types
    arr_bytes: torch.Tensor,  # f32[n] data_total per arrival
    *,
    objective: str = "sum_avg",
    scorer: Scorer | None = None,
    n_steps: int | None = None,
    telemetry: bool = False,
    metrics: bool = False,
    record: bool = False,
    axis=None,
) -> EngineTrace:
    """Run one arrival trace to completion.

    Every iteration is one micro-event; 4n + 8 steps are enough (n arrivals,
    <= n completions, <= n successful drain placements, and one failed drain
    check per completion), and the loop stops once all work has completed.

    Placements and queue decisions reproduce the float64 oracle: canonical
    per-server sum refreshes keep same-spec servers bitwise-tied, and
    ``argmin_with_margin`` resolves sub-margin score/finish-time ties to the
    lowest index like the oracle's strict-improvement loops.

    ``scorer=None`` uses the loop's incremental evaluation of the shared
    scoring contract from its maintained sums; an explicit scorer (e.g. the
    CUDA kernel via ``engine.make_scorer('cuda')``) scores every candidate
    batch instead.

    ``telemetry=True`` additionally accumulates, per arrival, the
    time-integrated co-resident type counts, time past the physical TDP and
    log instantaneous rate over its run (``obs_co``, ``obs_lost``,
    ``obs_logr``), the input of ``telemetry.observations_from_trace``.
    The JAX engine's ``metrics``, ``record`` and ``axis`` paths are not
    ported yet and raise.
    """
    for flag, name in ((metrics, "metrics"), (record, "record"),
                       (axis is not None, "axis")):
        if flag:
            raise NotImplementedError(f"run_trace({name}=...) is not ported yet")
    n = int(arr_time.shape[0])
    if n_steps is None:
        n_steps = 4 * n + 8
    loop = _TraceLoop(cluster, dyn, arr_time, arr_type, arr_bytes, objective, scorer,
                      telemetry)
    return loop.run(n_steps)
