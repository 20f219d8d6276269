"""Online consolidation engine as a device-resident event loop.

Counterpart of ``repro/core/engine_jax.py``: the full arrive -> score ->
place-or-queue -> run -> complete -> drain loop of the paper's operating
model (§V, §VIII) over fixed-shape tensors, one micro-event per step.

As in the JAX engine's ``lax.while_loop`` body (``_trace_segment``), a step
is a fixed sequence of tensor ops with no host read. JAX's ``lax.switch``
over DRAIN, FINISH and ARRIVE becomes three branches that all run, each
committing its writes under its mask; its ``lax.cond`` whole-queue rescan
becomes a gather over the queue. A step taken after the trace is done (or
past ``n_steps``) changes nothing, so steps run in blocks of ``S``
(``BLOCK_STEPS``, or the step budget where that is smaller), and after
each block the host reads one small int tensor -- done, deadlock and the
device counters -- to decide whether to run another. On the card a block is
captured once as a CUDA graph and replayed; on the CPU the same block runs
eagerly. ``LoopStats.host_syncs`` counts the reads: at most
``ceil(n_steps / S)`` per run.

Each step scores a candidate of every grid type once (Q = T, one call of
the scorer); the arrival, the drain's first feasible queued arrival and its
whole-queue rescan all gather their choice from those T rows. A candidate's
scores depend only on its type and the state, so this is what scoring each
candidate batch on its own gave.

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
  ai        : i32        -- next-arrival pointer
  obs_*     : [n, ...]   -- per-arrival telemetry integrals (run_trace(
                            telemetry=True))

``n = arr_time.shape[0]`` is a static capacity; ``n_valid`` (a traced count,
as in JAX) bounds the arrivals the loop consumes, and rows past it keep the
initial sentinels.

``metrics=True`` and ``record=True`` add the observability plane
(``repro_torch.obs``) to the step, as JAX's static flags do: a MetricFrame
and a decision ring held in static buffers and updated in place at JAX's
commit sites. As the step runs every branch, each update takes its
branch's mask as its increment or weight (a gauge's value is -inf off its
mask, a ring row is written back unchanged). With both flags off the step
runs exactly the operations it ran without the plane.

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

import collections
import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import consolidation as kc
from ..obs import metrics as obs_metrics
from ..obs import recorder as obs_recorder
from .binpack_torch import (PackedCluster, choose_scored, loads_from_sums, scores_from_sums,
                            server_loads)
from .contention import pair_slowdown_matrices, type_tables
from .server import ServerSpec

QUEUED = -1  # placement sentinel, same as binpack_torch

#: micro-events per block: one host read and one graph launch per block,
#: whose graph holds S steps of ~270 small kernels. At 32 a finished trace
#: runs at most 31 no-op steps past its end; a larger S saves reads and
#: launches, but captures longer and overshoots further
BLOCK_STEPS = 32

#: scoring backend signature: (cluster, counts [m,T], wtypes i32[Q]) ->
#: (cache_after [Q, m], maxd_after [Q, m])
Scorer = Callable[[PackedCluster, torch.Tensor, torch.Tensor],
                  tuple[torch.Tensor, torch.Tensor]]

_CLUSTER_TENSORS = ("D", "rs", "fs", "llc_budget", "resident", "active")


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


#: each state tensor's value at the start of a trace
_INITIAL = dict(now=0.0, ai=0, counts=0.0, comp=0.0, col0=0.0, colog_keep=0.0,
                colog_lost=0.0, slot_type=-1, slot_rem=0.0, slot_arr=-1, queued=False,
                was_queued=False, placement=QUEUED, place_time=-1.0, finish_time=np.inf,
                makespan=0.0, max_deg=0.0, draining=False, deadlock=False, obs_co=0.0,
                obs_lost=0.0, obs_logr=0.0, events=0, full_scans=0)


@dataclasses.dataclass
class EngineState:
    now: torch.Tensor  # f32 scalar simulation clock
    ai: torch.Tensor  # i32 scalar next-arrival pointer
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
    obs_co: torch.Tensor  # f32[n, T] time-integrated co-resident type counts
    obs_lost: torch.Tensor  # f32[n] time spent past the physical TDP
    obs_logr: torch.Tensor  # f32[n] time-integrated log instantaneous rate
    events: torch.Tensor  # i32 scalar micro-events run
    full_scans: torch.Tensor  # i32 scalar drains that rescanned the whole queue

    @classmethod
    def zeros(cls, m: int, T: int, n: int, device: torch.device) -> "EngineState":
        """A state for m servers, T types and n arrivals, at its initial values."""
        f32, i32 = torch.float32, torch.int32
        shapes = dict(now=((), f32), ai=((), i32), counts=((m, T), f32), comp=((m,), f32),
                      col0=((m, T), f32), colog_keep=((m, T), f32), colog_lost=((m, T), f32),
                      slot_type=((m, n), i32), slot_rem=((m, n), f32), slot_arr=((m, n), i32),
                      queued=((n,), torch.bool), was_queued=((n,), torch.bool),
                      placement=((n,), i32), place_time=((n,), f32),
                      finish_time=((n,), f32), makespan=((), f32), max_deg=((), f32),
                      draining=((), torch.bool), deadlock=((), torch.bool),
                      obs_co=((n, T), f32), obs_lost=((n,), f32), obs_logr=((n,), f32),
                      events=((), i32), full_scans=((), i32))
        st = cls(**{k: torch.empty(shape, dtype=dt, device=device)
                    for k, (shape, dt) in shapes.items()})
        st.reset()
        return st

    def reset(self) -> None:
        """Every tensor back to its initial value, in place."""
        for name, value in _INITIAL.items():
            getattr(self, name).fill_(value)


@dataclasses.dataclass(frozen=True)
class LoopStats:
    """What the event loop did: micro-events run, device->host reads (one
    per block of ``block_steps`` micro-events), and drains whose window of
    the first W queued arrivals held nothing feasible while more were queued
    (the whole-queue rescans)."""

    events: int
    host_syncs: int
    drain_full_scans: int
    block_steps: int


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
    metrics: "obs_metrics.MetricFrame | None" = None  # run(metrics=True)
    rec: "obs_recorder.RecState | None" = None  # run(record=True): the ring after the run


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
    rate = _rate_table(dyn.solo, dyn.base_lost, ldiag_keep, ldiag_lost, overflow, ck, cl)
    return torch.gather(rate, 1, slot_type.clamp(min=0).long())


def _rate_table(solo, base_lost, ldiag_keep, ldiag_lost, overflow, colog_keep, colog_lost):
    """Rate [m, T] of a workload of each type on each server, from the
    maintained log-slowdown sums; a run slot's rate is its type's entry."""
    ov = overflow[:, None]
    colog = torch.where(ov, colog_lost, colog_keep)  # [m, T]
    ldiag = torch.where(ov, ldiag_lost, ldiag_keep)  # [m, T]
    base = torch.where(ov, base_lost, solo)  # [m, T]
    return base * torch.exp(colog - ldiag)


def _put_if(dst: torch.Tensor, index: tuple, value: torch.Tensor, mask: torch.Tensor) -> None:
    """dst[index] = value where mask, else unchanged (a masked scatter)."""
    dst.index_put_(index, torch.where(mask, value.to(dst.dtype), dst[index]))


class _TraceLoop:
    """The event loop for one trace shape: static buffers for the cluster,
    the rate tables and the arrivals (filled by :meth:`load`), the state, the
    three branches and the block of micro-events, captured as a CUDA graph
    on the card. Index arguments of the branches have shape [1]; masks are
    0-d."""

    def __init__(self, cluster, dyn, arr_time, arr_type, arr_bytes, objective, scorer,
                 telemetry=False, n_valid=None, n_steps=None, *, metrics=False, record=False,
                 rec_capacity=None, npair_rows=None, rec=None, rec_ctx=None):
        self.n = self.K = n = int(arr_time.shape[0])
        self.m, self.T = m, T = cluster.m, cluster.T
        self.W = min(8, n)  # drain fast-path window (first W queued candidates)
        self.n_steps = 4 * n + 8 if n_steps is None else int(n_steps)
        self.S = max(1, min(BLOCK_STEPS, self.n_steps))
        self.objective, self.scorer, self.telemetry = objective, scorer, telemetry
        self.metrics, self.record = metrics, record
        self.device = dev = cluster.device
        f32 = dict(dtype=torch.float32, device=dev)
        # the inputs every run copies in: a captured block reads these
        self.cluster = dataclasses.replace(
            cluster, **{f: torch.empty_like(getattr(cluster, f)) for f in _CLUSTER_TENSORS})
        self.solo, self.base_lost = torch.empty((m, T), **f32), torch.empty((m, T), **f32)
        self.tol_budget = torch.empty((m,), **f32)
        self.ldiag_keep, self.ldiag_lost = torch.empty((m, T), **f32), torch.empty((m, T), **f32)
        self.comp_delta = torch.empty((m, T), **f32)
        self.dcache = torch.empty((T, m), **f32)  # closed-form cache increase per type
        # all per-server sum tables side by side: one matvec refreshes every
        # maintained sum of the touched server (see apply_delta)
        self.tables = torch.empty((m, T, 3 * T + 1), **f32)
        self.arr_time, self.arr_bytes = torch.empty((n,), **f32), torch.empty((n,), **f32)
        self.arr_type = torch.empty((n,), dtype=torch.long, device=dev)
        self.own = torch.empty((n, T) if telemetry else (0, T), **f32)  # one-hot of the type
        self.n_valid = torch.empty((), dtype=torch.int32, device=dev)
        # device constants, made once: nothing inside a block copies from the host
        self.types = torch.arange(T, dtype=torch.int32, device=dev)
        self.inf = torch.full((), torch.inf, **f32)
        self.free_slot = torch.full((1,), -1, dtype=torch.int32, device=dev)
        self.st = EngineState.zeros(m, T, n, dev)
        self.status = torch.zeros(4, dtype=torch.int32, device=dev)
        self.graph: torch.cuda.CUDAGraph | None = None
        self.tally: collections.Counter = collections.Counter()  # kernel launches per replay
        if metrics or record:
            self.servers = torch.arange(m, dtype=torch.int32, device=dev)
            self.diagD = torch.empty((m, T), **f32)  # the scoring D's diagonal
        # the observability plane's static buffers: the frame and the ring the
        # block updates in place, and the recorder's context it samples
        self.mf = obs_metrics.zeros(m, dev) if metrics else None
        if record:
            self.rec = obs_recorder.init(2 * n if rec_capacity is None else rec_capacity, dev)
            i32 = dict(dtype=torch.int32, device=dev)
            self.ctx = obs_recorder.RecCtx(
                n_pair=None if npair_rows is None else torch.empty((npair_rows, T, T), **f32),
                row_of=torch.empty((m,), **i32), cusum=torch.empty((m,), **f32),
                pool_row=torch.empty((m,), **i32), segment=torch.empty((), **i32))
        self._rec_in = None  # the ring a run continues (None: a fresh one)
        self.load(cluster, dyn, arr_time, arr_type, arr_bytes, n if n_valid is None else n_valid,
                  rec=rec, rec_ctx=rec_ctx)

    def load(self, cluster, dyn, arr_time, arr_type, arr_bytes, n_valid, rec=None,
             rec_ctx=None) -> None:
        """Copy a trace's inputs into the static buffers (device to device;
        ``n_valid`` an int or a 0-d tensor). With ``record``: ``rec`` is the
        ring the run continues (None: a fresh one) and ``rec_ctx`` the
        context it samples (None: ``recorder.default_ctx``)."""
        T, c = self.T, self.cluster
        for f in _CLUSTER_TENSORS:
            getattr(c, f).copy_(getattr(cluster, f))
        torch.add(c.rs[None, :], c.resident * c.fs[None, :], out=self.comp_delta)
        self.solo.copy_(dyn.solo)
        self.base_lost.copy_(dyn.base_lost)
        self.tol_budget.copy_(dyn.tol_budget)
        self.ldiag_keep.copy_(torch.diagonal(dyn.log_keep, dim1=1, dim2=2))
        self.ldiag_lost.copy_(torch.diagonal(dyn.log_lost, dim1=1, dim2=2))
        self.dcache.copy_((self.comp_delta / c.llc_budget[:, None]).T)
        self.tables[:, :, :T].copy_(c.D)
        self.tables[:, :, T:2 * T].copy_(dyn.log_keep)
        self.tables[:, :, 2 * T:3 * T].copy_(dyn.log_lost)
        self.tables[:, :, 3 * T].copy_(self.comp_delta)
        self.arr_time.copy_(arr_time)
        self.arr_type.copy_(arr_type)
        self.arr_bytes.copy_(arr_bytes)
        if self.telemetry:
            self.own.copy_(self.arr_type[:, None] == self.types[None, :])
        if torch.is_tensor(n_valid):
            self.n_valid.copy_(n_valid)
        else:
            self.n_valid.fill_(int(n_valid))
        if self.metrics or self.record:
            self.diagD.copy_(torch.diagonal(c.D, dim1=1, dim2=2))
        if self.record:
            if rec is not None and rec.capacity != self.rec.capacity:
                raise ValueError(f"a ring of capacity {rec.capacity} for a loop of "
                                 f"{self.rec.capacity}")
            self._rec_in = rec
            if rec_ctx is None:
                rec_ctx = obs_recorder.default_ctx(self.m, self.device)
            if (rec_ctx.n_pair is None) != (self.ctx.n_pair is None):
                raise ValueError("a recorder context with and without pair exposure for one "
                                 "loop")
            for dst, src in zip(self.ctx, rec_ctx):
                if dst is not None:
                    dst.copy_(src)

    # -- scoring ------------------------------------------------------------
    def pick_types(self, st):
        """Scoring + Fig-8 argmin (Table II / Fig-8 objective) for a candidate
        of every grid type: (server [T], feasible [T], feasibility-masked
        score [T, m]). The in-loop scorer (``scorer=None``) reads the
        maintained sums instead of recomputing counts @ D."""
        cl = self.cluster
        if self.scorer is None:
            cache_a, maxd_a = scores_from_sums(cl, st.counts, st.comp, st.col0, self.types)
        else:
            cache_a, maxd_a = self.scorer(cl, st.counts, self.types)
        if self.objective == "sum_avg":  # Table II: minimize the load *increase*
            cache_now, maxd_now = loads_from_sums(cl, st.counts, st.comp, st.col0)
            # without a scorer the cache increase is known in closed form;
            # using it directly avoids the f32 cancellation of
            # (cache_after - cache_now)
            dcache = self.dcache if self.scorer is None else cache_a - cache_now[None, :]
            score = 0.5 * (dcache + (maxd_a - maxd_now[None, :]))
        else:  # literal Fig 8: minimize the post-allocation average
            score = 0.5 * (cache_a + maxd_a)
        return choose_scored(cl, cache_a, maxd_a, score)

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
        st.counts.index_put_((server, wtype), st.counts[server, wtype] + sign)
        sums = (st.counts[server][:, None, :] @ self.tables[server])[:, 0]  # [1, 3T+1]
        st.comp.index_copy_(0, server, sums[:, 3 * T])
        st.col0.index_copy_(0, server, sums[:, :T])
        st.colog_keep.index_copy_(0, server, sums[:, T:2 * T])
        st.colog_lost.index_copy_(0, server, sums[:, 2 * T:3 * T])

    def place_if(self, st, found, idx, server, wtype, nbytes, t, queue_on_fail, *, on=None,
                 score_row=None):
        """Commit arrival ``idx`` to ``server`` where ``found``; where not,
        queue it where ``queue_on_fail`` (a bool or a mask), else change
        nothing. ``idx`` may be n (no candidate) when not ``found``.

        ``queue_on_fail`` other than False marks an arrival-time decision,
        the rest drain commits. With the observability plane: ``on`` is the
        branch's mask (an arrival records a row whenever on, a drain only
        where found) and ``score_row`` [m] the committed candidate's
        feasibility-masked scores, the recorder's provenance."""
        at_arrival = queue_on_fail is not False
        if self.record:
            server_g = torch.where(found, server, QUEUED)
            qdepth = st.queued.sum(dtype=torch.int32)
        server = torch.where(found, server, 0)
        self.apply_delta(st, server, wtype, found.to(torch.float32))
        # first free slot; K == n, so one exists whenever found
        k = (st.slot_type[server] < 0).to(torch.int32).argmax(-1)
        _put_if(st.slot_type, (server, k), wtype, found)
        _put_if(st.slot_rem, (server, k), nbytes, found)
        _put_if(st.slot_arr, (server, k), idx, found)
        i = idx.clamp(max=self.n - 1)
        fail = queue_on_fail & ~found
        _put_if(st.queued, (i,), fail, found | fail)  # placed: off the queue
        _put_if(st.was_queued, (i,), fail, fail)
        _put_if(st.placement, (i,), server, found)
        _put_if(st.place_time, (i,), t.reshape(1), found)
        if not (self.metrics or self.record):
            return
        # Eqn-4 headroom of the committed server, post-commit: how much of
        # the degradation budget this placement left on the table
        d_pred = torch.clamp(st.col0[server] - self.diagD[server], 0.0, 1.0)  # [1, T]
        present = st.counts[server] > 0
        maxd_s = torch.where(present, d_pred, -torch.inf).amax(1)
        maxd_s = torch.where(present.any(1), maxd_s, 0.0)
        headroom = self.cluster.degradation_limit - maxd_s  # [1]
        if self.metrics:
            mf = self.mf
            obs_metrics.count_(mf, "placements", found[0])
            if at_arrival:  # the §V queue decision
                obs_metrics.count_(mf, "queued", fail[0])
            else:
                obs_metrics.count_(mf, "drain_placements", found[0])
            obs_metrics.observe_(mf, "waiting_time", t - self.arr_time[i], found)
            obs_metrics.observe_(mf, "headroom", headroom, found)
            obs_metrics.add_server_(mf, "placements", (self.servers == server) & found)
        if self.record:
            ctx = self.ctx
            cand, csc = obs_recorder.top_candidates(score_row)
            if ctx.n_pair is None:
                npmin = torch.full_like(headroom, -1.0)
            else:
                row = torch.clamp(ctx.row_of[server], 0, ctx.n_pair.shape[0] - 1)
                npmin = obs_recorder.pair_exposure_min(
                    ctx.n_pair.index_select(0, row.long())[0], st.counts[server][0], wtype)
            kind = (torch.where(found, obs_recorder.KIND_ARRIVE, obs_recorder.KIND_QUEUED)
                    if at_arrival else torch.full_like(server, obs_recorder.KIND_DRAIN))
            obs_recorder.record_row(
                self.rec, on=on if at_arrival else found, arrival=idx, segment=ctx.segment,
                server=server_g, kind=kind, qdepth=qdepth,
                pool_row=torch.where(found, ctx.pool_row[server], -1), cand=cand, scores=csc,
                t=t, headroom=torch.where(found, headroom, 0.0),
                margin=obs_recorder.tie_margin(csc),
                n_pair_min=torch.where(found, npmin, -1.0),
                cusum=torch.where(found, ctx.cusum[server], 0.0))

    def advance(self, st, rate, rates, overflow, dt, moving):
        """Run every slot for ``dt`` where ``moving`` (a FINISH or an ARRIVE
        step), and integrate each running arrival's telemetry over it."""
        adv = (st.slot_type >= 0) & moving
        st.slot_rem.copy_(torch.where(
            adv, torch.clamp(st.slot_rem - rates * dt, min=0.0), st.slot_rem))
        if self.telemetry:
            # per arrival, as the JAX engine integrates per run slot: each
            # running arrival holds one slot on its server, whose co-resident
            # counts, TDP exposure and log rate it takes over [now, now + dt)
            running = moving & (st.placement >= 0) & torch.isinf(st.finish_time)  # [n]
            srv = st.placement.clamp(min=0).long()
            co = torch.clamp(st.counts[srv] - self.own, min=0.0)  # [n, T]
            lost = overflow.to(torch.float32)[srv]
            logr = torch.log(rate[srv, self.arr_type])
            st.obs_co.copy_(torch.where(running[:, None], st.obs_co + dt * co, st.obs_co))
            st.obs_lost.copy_(torch.where(running, st.obs_lost + dt * lost, st.obs_lost))
            st.obs_logr.copy_(torch.where(running, st.obs_logr + dt * logr, st.obs_logr))

    # -- the three micro-events, each under its mask ---------------------------
    def drain_branch(self, st, on=None, pick=None):
        """Place the first feasible queued arrival. ``on`` masks the branch
        (None: always); ``pick`` is the step's per-type choice (None: score
        now)."""
        W = self.W
        if on is None:
            on = torch.ones((), dtype=torch.bool, device=self.device)
        servers, ok, score = self.pick_types(st) if pick is None else pick
        # Queue order == arrival order (workloads are never re-queued), so the
        # first feasible *queued arrival index* is the item the oracle places:
        # the window of the first W queued finds it when its rank is <= W,
        # the whole-queue rescan otherwise
        cand = st.queued & ok[self.arr_type]
        found = cand.any().reshape(1)
        q = cand.to(torch.int32).argmax().reshape(1)
        pos = torch.cumsum(st.queued, 0)  # 1-based rank among queued
        full = ~(found & (pos[q] <= W)) & (pos[-1] > W)
        st.full_scans.add_((on & full[0]).to(torch.int32))
        wq = self.arr_type[q]
        self.place_if(st, found & on, q, servers[wq], wq, self.arr_bytes[q], st.now,
                      queue_on_fail=False, on=on, score_row=score[wq][0] if self.record else None)
        no_active = ~(st.slot_type >= 0).any()
        # deadlock: nothing runs, nothing arrives, the queue is stuck
        dead = ~found[0] & no_active & (st.ai >= self.n_valid) & st.queued.any()
        if self.metrics:
            obs_metrics.count_(self.mf, "drain_steps", on)
            obs_metrics.count_(self.mf, "drain_full_scans", on & full[0])
            obs_metrics.count_(self.mf, "deadlocks", on & dead & ~st.deadlock)
        st.deadlock.copy_(st.deadlock | (on & dead))
        st.draining.copy_(torch.where(on, found[0], st.draining))

    def finish_branch(self, st, on, k_flat, t_fin):
        """Free the slot ``k_flat`` (flat (server, slot) index) at ``t_fin``."""
        s_fin, k_fin = k_flat // self.K, k_flat % self.K
        idx = st.slot_arr[s_fin, k_fin].long().clamp(min=0)
        wtype = st.slot_type[s_fin, k_fin].long().clamp(min=0)
        self.apply_delta(st, s_fin, wtype, torch.where(on, -1.0, 0.0).reshape(1))
        _put_if(st.slot_type, (s_fin, k_fin), self.free_slot, on)
        _put_if(st.slot_arr, (s_fin, k_fin), self.free_slot, on)
        _put_if(st.finish_time, (idx,), t_fin.reshape(1), on)
        if self.metrics:
            # observed slowdown = actual duration / solo duration on the
            # server that ran it -- the serving-SLO quantity next to waiting
            srate = self.solo[s_fin, wtype]
            solo_dur = self.arr_bytes[idx] / torch.clamp(srate, min=1e-30)
            actual = t_fin - st.place_time[idx]
            mf = self.mf
            obs_metrics.count_(mf, "finishes", on)
            obs_metrics.observe_(mf, "slowdown", actual / torch.clamp(solo_dur, min=1e-30), on)
            obs_metrics.add_server_(mf, "finishes", (self.servers == s_fin) & on)
        st.makespan.copy_(torch.where(on, t_fin, st.makespan))
        # §V: completion may unblock the queue
        st.draining.copy_(torch.where(on, st.queued.any(), st.draining))

    def arrive_branch(self, st, on, pick, a, t_arr):
        """Run the Fig-8 greedy on arrival ``a`` at ``t_arr``; queue it if no
        server passes both criteria."""
        servers, ok, score = pick
        wtype = self.arr_type[a]
        if self.metrics:
            obs_metrics.count_(self.mf, "arrivals", on)
        self.place_if(st, ok[wtype] & on, a, servers[wtype], wtype, self.arr_bytes[a], t_arr,
                      queue_on_fail=on, on=on,
                      score_row=score[wtype][0] if self.record else None)
        st.ai.add_(on.to(torch.int32))

    # -- the loop ---------------------------------------------------------------
    def is_done(self, st):
        return st.deadlock | ((st.ai >= self.n_valid) & ~(st.slot_type >= 0).any()
                              & ~st.queued.any())

    def step(self, st) -> None:
        """One micro-event (JAX's ``event_step``): pick DRAIN, FINISH or
        ARRIVE on the device and commit that branch's writes."""
        n = self.n
        active = st.slot_type >= 0
        overflow = st.comp > self.tol_budget
        rate = _rate_table(self.solo, self.base_lost, self.ldiag_keep, self.ldiag_lost,
                           overflow, st.colog_keep, st.colog_lost)  # [m, T]
        rates = torch.gather(rate, 1, st.slot_type.clamp(min=0).long())  # [m, K]
        tt = torch.where(active, st.slot_rem / rates, torch.inf)
        # margin argmin: exactly-simultaneous completions (identical workloads
        # on same-spec servers) must resolve lowest-server-first like the
        # oracle's event loop; f32 noise would otherwise order them arbitrarily
        flat = tt.reshape(-1)
        t_min = flat.min()
        k_flat = (flat <= t_min * (1.0 + 1e-5)).to(torch.int32).argmax().reshape(1)
        any_active = active.any()
        queue_any = st.queued.any()
        arrived_all = st.ai >= self.n_valid
        a = st.ai.clamp(max=n - 1).long().reshape(1)
        t_arr = torch.where(arrived_all, self.inf, self.arr_time[a][0])
        done = st.deadlock | (arrived_all & ~any_active & ~queue_any)
        live = ~done & (st.events < self.n_steps)
        drain_next = st.draining | (queue_any & ~any_active & arrived_all)
        finish_next = any_active & (st.now + t_min <= t_arr)
        drain = live & drain_next
        finish = live & ~drain_next & finish_next
        arrive = live & ~drain_next & ~finish_next
        st.events.add_(live.to(torch.int32))
        # observed (ground-truth) degradation of the running set, for audits
        deg = torch.where(st.counts > 0, 1.0 - rate / self.solo, -torch.inf)
        st.max_deg.copy_(torch.where(live, torch.maximum(st.max_deg, deg.max()), st.max_deg))
        if self.metrics:
            mf = self.mf
            qdepth = st.queued.sum(dtype=torch.float32)
            obs_metrics.count_(mf, "events", live)
            obs_metrics.observe_(mf, "queue_depth", qdepth, live)
            obs_metrics.gauge_max_(mf, "queue_peak", torch.where(live, qdepth, -torch.inf))
            # utilization-floor violations: events where a running slot's
            # observed degradation exceeded the paper's limit, per server
            obs_metrics.add_server_(
                mf, "floor_violations",
                (deg > self.cluster.degradation_limit).any(1) & live)
            obs_metrics.add_server_(mf, "busy_events", active.any(1) & live)
        pick = self.pick_types(st)  # advancing time leaves the scores as they are
        t_fin = st.now + flat[k_flat][0]
        t_next = torch.where(finish, t_fin, torch.where(arrive, t_arr, st.now))
        self.advance(st, rate, rates, overflow, t_next - st.now, finish | arrive)
        st.now.copy_(t_next)
        self.finish_branch(st, finish, k_flat, t_fin)
        self.arrive_branch(st, arrive, pick, a, t_arr)
        self.drain_branch(st, drain, pick)

    def block(self) -> None:
        """S micro-events, then the status the host reads: (done, deadlock,
        events, full rescans)."""
        st = self.st
        for _ in range(self.S):
            self.step(st)
        done = self.is_done(st) | (st.events >= self.n_steps)
        self.status.copy_(torch.stack([done.to(torch.int32), st.deadlock.to(torch.int32),
                                       st.events, st.full_scans]))

    def _capture(self) -> None:
        """Warm a block up on a side stream (the kernel library's load, the
        allocator's blocks, cuBLAS), then capture it. The wrappers count a
        launch at capture, where nothing runs: those counts move to the
        per-replay tally. Raises if capture fails: there is no eager
        fallback on the card."""
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self.block()
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = collections.Counter(kc.LAUNCHES)
        with torch.cuda.graph(graph):
            self.block()
        tally = collections.Counter(kc.LAUNCHES)
        tally.subtract(before)
        self.tally = +tally
        for key, count in self.tally.items():
            kc.LAUNCHES[key] -= count
            if not kc.LAUNCHES[key]:
                del kc.LAUNCHES[key]
        self.graph = graph

    def run(self) -> EngineTrace:
        """The loaded trace to completion: blocks until the status read says
        done, at most ``ceil(n_steps / S)``; outputs copied out of the state."""
        st = self.st
        on_card = self.device.type == "cuda"
        if on_card and self.graph is None:
            self._reset()
            self._capture()
        self._reset()
        reads = 0
        for _ in range(-(-self.n_steps // self.S)):
            if on_card:
                self.graph.replay()
                kc.LAUNCHES.update(self.tally)
            else:
                self.block()
            done, _, events, full_scans = self.status.tolist()
            reads += 1
            if done:
                break
        return EngineTrace(
            st.placement.clone(), st.was_queued.clone(), st.place_time.clone(),
            st.finish_time.clone(), st.makespan.clone(), st.max_deg.clone(),
            st.deadlock.clone(), st.obs_co.clone(), st.obs_lost.clone(), st.obs_logr.clone(),
            LoopStats(events, reads, full_scans, self.S),
            metrics=obs_metrics.clone(self.mf) if self.metrics else None,
            rec=obs_recorder.clone(self.rec) if self.record else None)

    def _reset(self) -> None:
        """The state, the frame and the ring at a run's start, in place."""
        self.st.reset()
        if self.metrics:
            obs_metrics.reset_(self.mf)
        if self.record:
            if self._rec_in is None:
                self.rec.block.ints.fill_(-1)
                self.rec.block.floats.zero_()
                self.rec.ptr.zero_()
                self.rec.total.zero_()
            else:
                obs_recorder.copy_(self.rec, self._rec_in)


def trace_segment(
    cluster: PackedCluster,
    dyn: PackedDynamics,
    arr_time: torch.Tensor,  # f32[n], non-decreasing over the first n_valid
    arr_type: torch.Tensor,  # i32[n] grid types
    arr_bytes: torch.Tensor,  # f32[n] data_total per arrival
    n_valid: int | torch.Tensor,  # arrivals actually present (<= n)
    *,
    objective: str = "sum_avg",
    scorer: Scorer | None = None,
    n_steps: int | None = None,
    telemetry: bool = False,
    metrics: bool = False,
    record: bool = False,
    rec: "obs_recorder.RecState | None" = None,
    rec_ctx: "obs_recorder.RecCtx | None" = None,
    cache: dict | None = None,
) -> EngineTrace:
    """Body of :func:`run_trace`, with an arrival count apart from the shape.

    ``n = arr_time.shape[0]`` is the static capacity (slot counts, the step
    budget ``4n + 8``, sentinels), while ``n_valid`` (an int or a 0-d int32
    tensor on the device) bounds how many arrivals the event loop consumes.
    Rows past ``n_valid`` never arrive, so their outputs keep the initial
    sentinels (placement QUEUED, finish inf, zero telemetry), and
    ``n_valid = 0`` finishes at step 0. A trace padded to a larger capacity
    places exactly as the unpadded one: finish ties break in flat (server,
    slot) order, which more slots per server keep.

    ``metrics``, ``record``, ``rec`` and ``rec_ctx`` are :func:`run_trace`'s.

    ``cache`` (a dict the caller keeps) holds one loop per shape (m, n, T,
    device, degradation limit, objective, scorer, n_steps, telemetry, and
    the observability plane's flags, ring capacity and pair-exposure rows),
    with its static buffers and, on the card, its captured graph; a hit
    copies this trace's inputs into it, as JAX compiles once per shape.
    """
    n = int(arr_time.shape[0])
    n_steps = 4 * n + 8 if n_steps is None else int(n_steps)
    record = bool(record)
    rec_capacity = (2 * n if rec is None else rec.capacity) if record else None
    npair_rows = (int(rec_ctx.n_pair.shape[0]) if record and rec_ctx is not None
                  and rec_ctx.n_pair is not None else None)
    key = (cluster.m, n, cluster.T, str(cluster.device), cluster.degradation_limit,
           objective, scorer, n_steps, bool(telemetry), bool(metrics), record, rec_capacity,
           npair_rows)
    loop = None if cache is None else cache.get(key)
    if loop is None:
        loop = _TraceLoop(cluster, dyn, arr_time, arr_type, arr_bytes, objective, scorer,
                          bool(telemetry), n_valid=n_valid, n_steps=n_steps,
                          metrics=bool(metrics), record=record, rec_capacity=rec_capacity,
                          npair_rows=npair_rows, rec=rec, rec_ctx=rec_ctx)
        if cache is not None:
            cache[key] = loop
    else:
        loop.load(cluster, dyn, arr_time, arr_type, arr_bytes, n_valid, rec=rec,
                  rec_ctx=rec_ctx)
    return loop.run()


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
    rec: "obs_recorder.RecState | None" = None,
    rec_ctx: "obs_recorder.RecCtx | None" = None,
    axis=None,
    cache: dict | None = None,
) -> EngineTrace:
    """Run one arrival trace to completion: :func:`trace_segment` with
    ``n_valid = n``.

    Every step is one micro-event; 4n + 8 steps are enough (n arrivals,
    <= n completions, <= n successful drain placements, and one failed drain
    check per completion), and the loop stops after the block in which all
    work has completed.

    Placements and queue decisions reproduce the float64 oracle: canonical
    per-server sum refreshes keep same-spec servers bitwise-tied, and
    ``argmin_with_margin`` resolves sub-margin score/finish-time ties to the
    lowest index like the oracle's strict-improvement loops.

    ``scorer=None`` uses the loop's incremental evaluation of the shared
    scoring contract from its maintained sums; an explicit scorer (e.g. the
    CUDA kernel via ``engine.make_scorer('cuda')``) scores every grid type
    once per step instead.

    ``telemetry=True`` additionally accumulates, per arrival, the
    time-integrated co-resident type counts, time past the physical TDP and
    log instantaneous rate over its run (``obs_co``, ``obs_lost``,
    ``obs_logr``), the input of ``telemetry.observations_from_trace``.

    ``metrics=True`` updates an ``obs.MetricFrame`` in the loop (queue depth
    per event, waiting time and Eqn-4 headroom at commit, drain occupancy,
    observed slowdown at finish, per-server floor violations) and returns
    it on ``EngineTrace.metrics``; decisions are unchanged.

    ``record=True`` writes the decision flight recorder (``obs.recorder``):
    one provenance row per placement commit or queue-at-arrival decision,
    returned on ``EngineTrace.rec``. ``rec`` continues an existing ring
    (default: a fresh ring of capacity 2n) and ``rec_ctx`` supplies the
    estimator/detector context to sample (default: the no-estimator
    context). Recording never feeds back into scoring.

    The JAX engine's server axis (``axis``) is not ported yet and raises.
    """
    if axis is not None:
        raise NotImplementedError(
            "run_trace(axis=...) is not ported yet (ROADMAP Queue 1, item 8)")
    n = int(arr_time.shape[0])
    return trace_segment(cluster, dyn, arr_time, arr_type, arr_bytes, n,
                         objective=objective, scorer=scorer, n_steps=n_steps,
                         telemetry=telemetry, metrics=metrics, record=record, rec=rec,
                         rec_ctx=rec_ctx, cache=cache)


# --- tensor local search (core/refine.py's device backend) ------------------------

#: iterations of the local search per host read (one block of masked moves)
SEARCH_BLOCK = 8


def local_search_torch(
    cluster: PackedCluster, counts: torch.Tensor, max_iters: int = 100, *,
    scorer: Scorer | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Best-improvement hill-climb over single-workload relocations.

    The counterpart of JAX's ``local_search_jax``: every (source server s,
    resident type t, target server u) move is scored in one vectorized
    evaluation -- the additions through the shared scorer on every type at
    once (Q = T; ``scorer=None`` is the CUDA kernel's wrapper, which runs
    its plain version on CPU tensors), the removals by the same load
    algebra -- and the steepest feasible descent step is applied until no
    move improves the paper's global objective (sum of per-server average
    loads) or ``max_iters`` moves are made. Ties break as ``jnp.argmin``
    does: the first index of the flattened ``[m, T, m]`` delta.

    JAX's ``while_loop`` becomes blocks of ``SEARCH_BLOCK`` iterations with
    one host read each: an iteration after the search has stopped is masked and
    changes nothing. Returns (counts, n_moves) as tensors on the device.
    """
    m, T = counts.shape
    dev = counts.device
    if scorer is None:
        def scorer(cl, c, wtypes):
            return kc.consolidation_scores(
                c, cl.D, cl.rs, cl.resident * cl.fs[None, :], cl.llc_budget,
                wtypes.to(torch.int32))
    c = counts.to(torch.float32).clone()
    types = torch.arange(T, dtype=torch.int32, device=dev)
    diag = torch.diagonal(cluster.D, dim1=1, dim2=2)  # [m, T]
    delta_add = cluster.rs[None, :] + cluster.resident * cluster.fs[None, :]  # [m, T]
    eye_t = torch.eye(T, dtype=c.dtype, device=dev)
    not_self = ~torch.eye(m, dtype=torch.bool, device=dev)[:, None, :]  # [m, 1, m]
    eligible = (cluster.active > 0.5)[:, None]  # [m, 1]
    moves = torch.zeros((), dtype=torch.int32, device=dev)
    live = torch.ones((), dtype=torch.bool, device=dev)

    def iteration():
        cache_now, maxd_now = server_loads(cluster, c)
        avg0 = 0.5 * (cache_now + maxd_now)  # [m]
        # loads of each server after removing one of each type [m, T]
        comp0 = c @ cluster.rs + (c * cluster.resident) @ cluster.fs
        cache_rm = (comp0[:, None] - delta_add) / cluster.llc_budget[:, None]
        col0 = torch.einsum("mt,mtu->mu", c, cluster.D)
        d_rm = torch.clamp(col0[:, None, :] - cluster.D - diag[:, None, :], 0.0, 1.0)
        present = (c[:, None, :] - eye_t[None]) > 0  # [m, T(moved), T]
        maxd_rm = torch.where(present, d_rm, -torch.inf).amax(-1)
        maxd_rm = torch.where(present.any(-1), maxd_rm, 0.0)
        # additions: the shared scorer, every type on every server
        cache_ad, maxd_ad = (a.T for a in scorer(cluster, c, types))  # [m, T]
        avg_rm = 0.5 * (cache_rm + maxd_rm)
        avg_ad = 0.5 * (cache_ad + maxd_ad)
        # relocation targets honour the fleet-health mask like every other
        # scoring consumer: no move may land work on an evicted server
        feas_ad = (maxd_ad < cluster.degradation_limit) & (cache_ad <= 1.0) & eligible
        # delta[s, t, u] = objective change of moving one type-t from s to u
        delta = (avg_rm - avg0[:, None])[:, :, None] + (avg_ad - avg0[:, None]).T[None, :, :]
        valid = (c[:, :, None] > 0) & feas_ad.T[None, :, :] & not_self
        delta = torch.where(valid, delta, torch.inf).reshape(-1)
        flat = torch.argmin(delta)  # the first minimal index, as jnp.argmin
        improve = live & (delta[flat] < -1e-9) & (moves < max_iters)
        s, t, u = flat // (T * m), (flat // m) % T, flat % m
        inc = improve.to(c.dtype)
        c.view(-1).index_add_(0, torch.stack([s * T + t, u * T + t]), torch.stack([-inc, inc]))
        moves.add_(improve.to(torch.int32))
        live.copy_(improve)

    while True:
        for _ in range(SEARCH_BLOCK):
            iteration()
        if not bool(live):  # the block's one host read
            break
    return c, moves
