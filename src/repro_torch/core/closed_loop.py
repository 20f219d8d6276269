"""The device-resident closed loop: every segment without a host decision.

Counterpart of ``repro/core/closed_loop.py``. ``AdaptiveEngine.run``'s
host-alternating path returns to the host every segment: it reads the
telemetry's row count, the detector's flags and levels, decides splits and
evictions in Python, and rebuilds the cluster from the new D estimate.
:func:`run_closed_loop` keeps all of that on the device, in a carry --

  bank       the stacked :class:`DeviceEstimatorState` (all estimator rows)
  det        the drift detector's :class:`CusumState`
  row_map /  the pool's update and read routing (``PooledEstimatorBank``'s
  read_row   ``row_of`` / ``_read_row`` as device tensors)
  active     the placement-eligibility mask
  seen       the controller's burn-in clock
  req_*      the requeue buffer (work evicted servers had in flight,
             re-injected at the head of the next segment)
  ring       the telemetry ring's tensors, cursor and total

-- and each segment runs the event loop (``engine_torch.trace_segment``
with the arrival count ``req_n + n_seg`` as a device tensor), folds the
resulting :class:`RingBlock` through the fused estimator update
(``_bank_core``), the CUSUM scan (``kernels.cusum``) and the controller's
policy (``fleet.controller.fleet_step``, whose action loops are
``kernels.fleet_actions``), compacts the evicted work into the requeue
buffer and writes the ring. The host reads nothing between segments: the
event loop's one status read per block of micro-events (``LoopStats.
host_syncs``) is the only read, and every segment's outputs stay on the
device until the caller's epilogue.

As in JAX, segments bucket to a power-of-two ``S_cap`` (padding segments,
``seg_valid`` False, run with no arrivals and change nothing), each segment
holds ``n_seg`` chunk rows plus ``R`` requeue slots, and per-segment drift
is an index into a deduplicated tuple of :class:`PackedDynamics`. The
cluster's structural tables are fixed for the run; only ``D`` and
``active`` change. One deliberate difference from JAX: D is blended from
the carried bank in float64 and cast once to float32, exactly as the
host-alternating path's ``estimate_D`` and ``PackedCluster.build`` do, so
both paths schedule on the same bits (JAX blends in float32 and its tests
absorb the 1-ulp drift). It is rebuilt whole every segment; an untouched
entry recomputes to the same value.

``ClosedLoopConfig.metrics`` and ``.record`` carry the observability plane
(``repro_torch.obs``), as JAX's do: every segment's event loop updates a
fresh MetricFrame that the segment body merges into ``LoopCarry.metrics``
with the closed-loop accounting (segments, splits, evictions, requeues,
ring rows, D columns touched, the CUSUM-level histogram and three
high-water gauges), and the decision ring rides ``LoopCarry.rec``, its
context sampled from the carry at segment entry. Both stay on the device,
with no host read. The sharded branch (``axis``) waits for ROADMAP item 8.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..fleet.controller import fleet_step
from ..obs import metrics as obs_metrics
from ..obs import recorder as obs_recorder
from ..fleet.detect import CusumState, _cusum_update
from ..telemetry.estimator import DeviceEstimatorState, _bank_core, _blend_prior_t, _remap_rows
from ..telemetry.log import RingBlock, ring_write_masked, rows_from_trace
from .binpack_torch import PackedCluster
from .engine_torch import EngineTrace, LoopStats, PackedDynamics, Scorer, trace_segment


@dataclasses.dataclass(frozen=True)
class ClosedLoopConfig:
    """Static configuration of the fused loop: engine policy, the fleet
    controller's knobs and the estimator hyperparameters. ``fleet=False``
    runs estimation only (no detector, no actions), as a fleetless stream
    ``AdaptiveEngine`` does. ``scatter`` names the bank's pair-statistic
    backend ('cuda' or 'torch')."""

    objective: str = "sum_avg"
    scorer: Scorer | None = None
    fleet: bool = False
    # controller knobs (FleetController fields)
    warmup_segments: int = 2
    cusum_k: float = 0.25
    cusum_h: float = 2.0
    level_decay: float = 0.9
    fail_floor: float = 0.5
    min_exposure: float = 4.0
    det_max_lost_frac: float = 0.5
    # estimator hyperparameters (StreamingEstimator._hypers + the read blend)
    confidence_floor: float = 2.0
    lr: float = 0.6
    decay: float = 1.0
    step_damp: float = 0.5
    solo_eps: float = 0.05
    est_max_lost_frac: float = 0.5
    scatter: str = "cuda"
    # the observability plane: a MetricFrame in the carry (the event loop's
    # metrics plus the per-segment accounting), and the decision recorder,
    # which needs LoopCarry.rec to hold a RecState
    metrics: bool = False
    record: bool = False


class LoopCarry(NamedTuple):
    """Everything the host-alternating path shuttles between segments."""

    bank: DeviceEstimatorState  # stacked estimator rows [m, ...]
    det: CusumState  # drift detector state
    row_map: torch.Tensor  # i32[m] pool update routing (-1 = dropped)
    read_row: torch.Tensor  # i32[m] pool read routing (survives drops)
    active: torch.Tensor  # bool[m] placement eligibility
    seen: torch.Tensor  # i32 controller burn-in clock (segments observed)
    req_type: torch.Tensor  # i32[R] requeued arrival types
    req_bytes: torch.Tensor  # f32[R] requeued arrival sizes
    req_n: torch.Tensor  # i32 live requeue count (<= R)
    ring: RingBlock  # telemetry ring tensors [capacity, ...]
    ring_ptr: torch.Tensor  # i32 ring write cursor
    ring_total: torch.Tensor  # i32 rows ever pushed
    metrics: "obs_metrics.MetricFrame | None" = None  # the run's metrics plane
    rec: "obs_recorder.RecState | None" = None  # the decision recorder's ring


class SegmentIn(NamedTuple):
    """Per-segment inputs, stacked [S_cap, ...] and padded."""

    arr_time: torch.Tensor  # f32[S, n_seg] chunk-relative times (t - t0_k)
    arr_type: torch.Tensor  # i32[S, n_seg] grid types
    arr_bytes: torch.Tensor  # f32[S, n_seg] data_total per arrival
    dyn_idx: np.ndarray  # int[S] index into the dynamics tuple (host)
    seg_valid: torch.Tensor  # bool[S] False = padding segment (no-op)


class SegmentOut(NamedTuple):
    """One segment's outputs, on the device (``stack_outputs`` stacks them
    [S_cap, ...]); ``stats`` is the event loop's host-side record."""

    placement: torch.Tensor  # i32[n_cap] (-1 = never placed / padding)
    was_queued: torch.Tensor  # bool[n_cap]
    place_time: torch.Tensor  # f32[n_cap] chunk-relative
    finish_time: torch.Tensor  # f32[n_cap] chunk-relative
    makespan: torch.Tensor  # f32 chunk-relative
    max_deg: torch.Tensor  # f32
    deadlock: torch.Tensor  # bool (masked False on padding segments)
    used: torch.Tensor  # i32 telemetry rows the estimator consumed
    n_valid: torch.Tensor  # i32 arrivals this segment (requeue + chunk)
    n_requeued: torch.Tensor  # i32 requeued arrivals at segment entry
    req_overflow: torch.Tensor  # bool requeue demand exceeded capacity R
    split_fired: torch.Tensor  # bool[m]
    split_stat: torch.Tensor  # f32[m]
    evict_fired: torch.Tensor  # bool[m]
    evict_stat: torch.Tensor  # f32[m]
    evict_route: torch.Tensor  # bool[m] True = level route
    active_after: torch.Tensor  # bool[m] mask after this segment's actions
    stats: LoopStats | None = None


def stack_outputs(outs: Sequence[SegmentOut]) -> tuple[SegmentOut, list[LoopStats]]:
    """The segments' device outputs stacked [S, ...] and moved to the host
    as numpy in one pass (the epilogue's read), with their loop stats."""
    fields = SegmentOut._fields[:-1]
    stacked = SegmentOut(*(torch.stack([getattr(o, f) for o in outs]).cpu().numpy()
                           for f in fields))
    return stacked, [o.stats for o in outs]


def full_D(bank: DeviceEstimatorState, read_row: torch.Tensor, Lp_t: torch.Tensor,
           confidence_floor: float) -> torch.Tensor:
    """The scheduler's D [m, T(u), T(t)] float32 from the carried bank: the
    host path's ``estimate_D`` blend in float64 for every bank row (the
    target-major tables, prior ``Lp_t`` float64), then one gather by the
    read routing and one cast, as ``PackedCluster.build`` casts."""
    L_eff_t = _blend_prior_t(bank.L_t.to(torch.float64), bank.n_pair_t.to(torch.float64),
                             Lp_t, confidence_floor)
    D_rows = torch.clamp(-torch.expm1(L_eff_t), 0.0, 0.999999).to(torch.float32)
    rows = torch.clamp(read_row, 0, D_rows.shape[0] - 1).long()
    return D_rows[rows].transpose(1, 2).contiguous()


def _assemble(carry: LoopCarry, x_time, x_type, x_bytes, seg_valid, n_seg: int):
    """The segment's arrivals: requeued work first, at the chunk-relative
    origin (where the host prepends it), then the chunk rows; padding rows
    never arrive. Returns (a_time, a_type, a_bytes, n_valid), on the
    device."""
    R = carry.req_type.shape[0]
    n_cap = R + n_seg
    q = carry.req_n
    n_valid = torch.where(seg_valid, q + n_seg, 0).to(torch.int32)
    i = torch.arange(n_cap, dtype=torch.int32, device=q.device)
    is_req = i < q
    ci = torch.clamp(i - q, 0, n_seg - 1).long()
    ri = torch.clamp(i, 0, R - 1).long()
    inf = torch.full((), torch.inf, dtype=torch.float32, device=q.device)
    a_time = torch.where(is_req, 0.0, torch.where(i < q + n_seg, x_time[ci], inf))
    a_type = torch.where(is_req, carry.req_type[ri], x_type[ci])
    a_bytes = torch.where(is_req, carry.req_bytes[ri], x_bytes[ci])
    return a_time, a_type, a_bytes, n_valid


def _fold_segment(carry: LoopCarry, trace: EngineTrace, a_type, a_bytes, n_valid, seg_valid,
                  Lp_t, logb_priors, config: ClosedLoopConfig):
    """Everything after the segment's event loop, as device tensor ops with
    no host read: observe -> estimate (``_bank_core`` through the pool
    routing), detect (the CUSUM scan against the post-update model, on the
    un-remapped block), act (``fleet_step``), the next segment's D, the
    requeue compaction and the ring write. Returns (carry, D, outputs)."""
    m = carry.row_map.shape[0]
    R = carry.req_type.shape[0]
    n_cap = a_type.shape[0]
    dev = a_type.device
    block = rows_from_trace(trace, a_type)
    rblock = _remap_rows(block, carry.row_map)
    bank, used = _bank_core(
        carry.bank, rblock, lr=config.lr, decay=config.decay, step_damp=config.step_damp,
        solo_eps=config.solo_eps, max_lost_frac=config.est_max_lost_frac,
        scatter=config.scatter, sparse_tables=True)
    seen = carry.seen + seg_valid.to(torch.int32)
    quiet = torch.zeros(m, dtype=torch.bool, device=dev)
    if config.fleet:
        det, _ = _cusum_update(carry.det, block, bank.log_b, bank.L_t, carry.row_map,
                               k=config.cusum_k, level_decay=config.level_decay,
                               max_lost_frac=config.det_max_lost_frac)
        # burn-in: discard detector evidence, withhold actions
        in_warmup = seen <= config.warmup_segments
        det = CusumState(*(torch.where(in_warmup, torch.zeros_like(a), a) for a in det))
        out = fleet_step(bank, det, carry.row_map, carry.read_row, carry.active, logb_priors,
                         seg_valid & ~in_warmup, h=config.cusum_h,
                         level_decay=config.level_decay, fail_floor=config.fail_floor,
                         min_exposure=config.min_exposure)
        bank, det = out.bank, out.det
        row_map, read_row, active = out.row_map, out.read_row, out.active
        split_fired, split_stat = out.split_fired, out.split_stat
        evict_fired, evict_stat, evict_route = out.evict_fired, out.evict_stat, out.evict_route
    else:
        det = carry.det
        row_map, read_row, active = carry.row_map, carry.read_row, carry.active
        split_fired = evict_fired = evict_route = quiet
        split_stat = evict_stat = torch.zeros(m, dtype=torch.float32, device=dev)
    D = full_D(bank, read_row, Lp_t, config.confidence_floor)

    # act -> re-schedule: work an evicted server held (or that never placed)
    # re-enters at the head of the next segment, in row order
    i = torch.arange(n_cap, dtype=torch.int32, device=dev)
    placement = trace.placement
    pclip = torch.clamp(placement, 0, m - 1).long()
    req_mask = ((i < n_valid) & evict_fired.any()
                & (((placement >= 0) & evict_fired[pclip]) | (placement < 0)))
    pos = torch.cumsum(req_mask.to(torch.int32), 0) - 1
    n_req = req_mask.sum().to(torch.int32)
    dst = torch.where(req_mask & (pos < R), pos, R).long()
    req_type = torch.zeros(R + 1, dtype=torch.int32, device=dev).index_copy(0, dst, a_type)[:R]
    req_bytes = torch.ones(R + 1, dtype=torch.float32, device=dev).index_copy(
        0, dst, a_bytes)[:R]
    req_cnt = torch.clamp(n_req, max=R)

    # the host path's per-segment ring push: exactly n_valid rows land
    cap = carry.ring.ints.shape[0]
    ring = ring_write_masked(carry.ring, block, carry.ring_ptr, n_valid)

    mf = carry.metrics
    if config.metrics:
        # fold the segment's engine frame into the run frame, then add the
        # closed-loop accounting the host path keeps
        mf = obs_metrics.merge(carry.metrics, trace.metrics)
        obs_metrics.count_(mf, "segments", seg_valid)
        obs_metrics.count_(mf, "splits", split_fired.sum(dtype=torch.int32))
        obs_metrics.count_(mf, "evictions", evict_fired.sum(dtype=torch.int32))
        obs_metrics.count_(mf, "requeues", req_cnt)
        obs_metrics.count_(mf, "ring_rows", n_valid)
        # block rows naming a live (bank row, type) pair: the D columns the
        # segment's telemetry can have moved (JAX re-blends just these)
        touched = ((a_type >= 0) & (a_type < bank.L_t.shape[-1]) & (rblock.server >= 0)
                   & (rblock.server < m)).sum(dtype=torch.int32)
        obs_metrics.count_(mf, "d_cols_refreshed", touched)
        if config.fleet:
            obs_metrics.observe_(mf, "cusum_level", split_stat, carry.active & seg_valid)
        obs_metrics.gauge_max_(mf, "ring_occupancy_peak",
                               torch.clamp(carry.ring_total + n_valid, max=cap))
        obs_metrics.gauge_max_(mf, "evicted_peak", (~active).sum(dtype=torch.float32))
        obs_metrics.gauge_max_(mf, "requeue_peak", req_cnt)
    new = LoopCarry(
        bank=bank, det=det, row_map=row_map, read_row=read_row, active=active, seen=seen,
        req_type=req_type, req_bytes=req_bytes, req_n=req_cnt, ring=ring,
        ring_ptr=(carry.ring_ptr + n_valid) % cap, ring_total=carry.ring_total + n_valid,
        metrics=mf, rec=trace.rec if config.record else carry.rec)
    out_k = SegmentOut(
        placement=placement, was_queued=trace.was_queued, place_time=trace.place_time,
        finish_time=trace.finish_time, makespan=trace.makespan, max_deg=trace.max_deg,
        deadlock=trace.deadlock & seg_valid, used=used.to(torch.int32), n_valid=n_valid,
        n_requeued=carry.req_n, req_overflow=(n_req > R) & seg_valid,
        split_fired=split_fired, split_stat=split_stat, evict_fired=evict_fired,
        evict_stat=evict_stat, evict_route=evict_route, active_after=active,
        stats=trace.stats)
    return new, D, out_k


def run_closed_loop(
    cluster: PackedCluster,
    dyn_stack: Sequence[PackedDynamics],  # deduplicated per-segment worlds
    Lp_t: torch.Tensor,  # f64[m, T, T] target-major L priors per estimator row
    logb_priors: torch.Tensor,  # f32[m, T] nominal log base priors per row
    carry: LoopCarry,
    xs: SegmentIn,
    config: ClosedLoopConfig,
    *,
    cache: dict | None = None,
) -> tuple[LoopCarry, list[SegmentOut]]:
    """Run the observe -> estimate -> detect -> act cycle over all segments.

    ``cluster`` supplies the structural tables only: its ``D`` and
    ``active`` are replaced every segment from the carried bank and mask.
    ``cache`` holds the event loop per shape (its captured graph on the
    card). Returns the final carry and the per-segment outputs, all on the
    device."""
    n_seg = int(xs.arr_time.shape[1])
    D = full_D(carry.bank, carry.read_row, Lp_t, config.confidence_floor)
    outs = []
    for k in range(int(xs.arr_time.shape[0])):
        seg_valid = xs.seg_valid[k]
        a_time, a_type, a_bytes, n_valid = _assemble(
            carry, xs.arr_time[k], xs.arr_type[k], xs.arr_bytes[k], seg_valid, n_seg)
        cluster_k = dataclasses.replace(cluster, D=D, active=carry.active.to(torch.float32))
        rec_ctx = None
        if config.record:
            # the estimator / detector state the scheduler consults *this*
            # segment, before the post-segment update
            rec_ctx = obs_recorder.RecCtx(
                n_pair=carry.bank.n_pair_t,
                row_of=torch.clamp(carry.read_row, 0, carry.read_row.shape[0] - 1),
                cusum=carry.det.stat.amax(1), pool_row=carry.read_row, segment=carry.seen)
        trace = trace_segment(cluster_k, dyn_stack[int(xs.dyn_idx[k])], a_time, a_type,
                              a_bytes, n_valid, objective=config.objective,
                              scorer=config.scorer, telemetry=True, metrics=config.metrics,
                              record=config.record, rec=carry.rec, rec_ctx=rec_ctx,
                              cache=cache)
        carry, D, out_k = _fold_segment(carry, trace, a_type, a_bytes, n_valid, seg_valid,
                                        Lp_t, logb_priors, config)
        outs.append(out_k)
    return carry, outs
