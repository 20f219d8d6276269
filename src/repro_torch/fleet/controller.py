"""FleetController: the estimate -> diagnose -> act control plane.

Counterpart of ``repro/fleet/controller.py``. ``fleet.pool`` decides which
servers share a model; ``fleet.detect`` notices when that stops being true,
or when a server stops being viable at all. This module closes the loop: it
consumes each segment's telemetry block, updates the pooled estimators and
the detector in the same pass, and turns detector signals into actions:

  split   a pooled server whose CUSUM crossed ``h`` is re-routed to its own
          estimator row, seeded with the pool posterior, and its CUSUM pair
          reset.
  evict   a server failing either failure test leaves the fleet: its pool
          routing is dropped, its placement mask goes False (candidate
          scoring treats it as infeasible), the fault-tolerance plane is
          notified (``HeartbeatMonitor.mark_dead``; with a ``mesh``, a
          ``plan_elastic_remesh`` shrink plan is recorded and applied), and
          the driving ``AdaptiveEngine`` requeues the work it had in flight.

Two failure routes, both against ``criteria.eviction_rate_floor``: the
*level* route (the detector's residual level against the fleet median
level, the straggler monitor's relative rule) and the *base* route (a
server's own estimated base rate at or below ``fail_floor`` x its nominal
prior, for servers with a private row). The controller never evicts the
last active server.

:meth:`FleetController.observe` is host-side policy over device-side
mechanism (the host-alternating path); :func:`fleet_step` is the same policy
as device tensor ops for the fused closed loop (``core.closed_loop``), its
two action loops the hand-written CUDA kernel ``kernels.fleet_actions``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Hashable, Literal, NamedTuple, Sequence

import numpy as np
import torch

from ..configs.base import MeshConfig
from ..core.criteria import eviction_rate_floor
from ..core.server import ServerSpec
from ..distributed.fault_tolerance import HeartbeatMonitor, ReMeshPlan, plan_elastic_remesh
from ..kernels.fleet_actions import evict_loop, split_loop
from ..telemetry.estimator import DeviceEstimatorState, StreamingEstimator
from ..telemetry.log import RingBlock
from .detect import CusumState, DriftDetector
from .pool import PooledEstimatorBank


def base_ratio(log_b, n_base, priors, src_of, read_row, min_exposure: float) -> torch.Tensor:
    """Per-server base-rate / nominal-prior ratio, on the device.

    ``log_b`` / ``n_base`` / ``priors`` are bank-row tables [rows, T];
    ``read_row`` i32[m] maps each server to the row it reads and ``src_of``
    i32[rows] resolves a row's content (the fused loop's pending row copies;
    the identity on the host path, whose copies are already made). The
    ratio is the solo-exposure-weighted geometric mean of ``exp(log_b -
    prior)`` per type; rows with total exposure under ``min_exposure``
    report 1.0. The prior stays the reading row's own. One expression for
    both paths, so they read the same bits.
    """
    rows_cap = log_b.shape[0]
    rr = torch.clamp(read_row, 0, rows_cap - 1).long()
    src = src_of[rr].long()
    lb, w = log_b[src], n_base[src]
    tot = w.sum(dim=1)
    ratio = torch.exp((w * (lb - priors[rr])).sum(dim=1) / torch.clamp(tot, min=1e-12))
    return torch.where(tot >= min_exposure, ratio, 1.0)


class FleetStepOut(NamedTuple):
    """One traced controller step's outcome (see :func:`fleet_step`)."""

    bank: DeviceEstimatorState  # post-action stacked bank [m rows]
    det: CusumState  # post-action detector state
    row_map: torch.Tensor  # i32[m] update routing (-1 = dropped)
    read_row: torch.Tensor  # i32[m] read routing (survives drops)
    active: torch.Tensor  # bool[m] placement eligibility
    split_fired: torch.Tensor  # bool[m]
    split_stat: torch.Tensor  # f32[m] CUSUM max per server, pre-reset
    evict_fired: torch.Tensor  # bool[m]
    evict_stat: torch.Tensor  # f32[m] level-vs-median or log base ratio
    evict_route: torch.Tensor  # bool[m] True = level route, False = base route


def fleet_step(
    bank: DeviceEstimatorState,
    det: CusumState,
    row_map: torch.Tensor,
    read_row: torch.Tensor,
    active: torch.Tensor,
    logb_priors: torch.Tensor,
    act_ok: torch.Tensor,
    *,
    h: float,
    level_decay: float,
    fail_floor: float,
    min_exposure: float,
) -> FleetStepOut:
    """``FleetController.observe``'s decision logic as device tensor ops.

    JAX's ``fleet_step``: the split-then-evict policy with every pool action
    as array ops, so the fused closed loop runs observe -> estimate ->
    detect -> act without reading the host. Flags, level, median and the
    base ratio are snapshots taken before each action loop, while pool
    membership evolves live inside the loops (the hand-written kernel
    ``kernels.fleet_actions``, one launch per loop). ``act_ok`` (a device
    bool) False turns the step into the identity (warm-up, padding).

    The loops carry a row-provenance map ``src_of`` over [m] ints instead of
    copying [rows, T, T] tables; one gather through it applies every copy at
    the end, unconditionally (through the identity it changes no bit). The
    pre-action screen (flags, level hits, base hits against pre-action
    state) decides exactly whether anything can fire; where nothing can, the
    kernel returns at its first instruction (JAX's ``lax.cond`` on
    ``take_slow``), with nothing read back to the host.
    """
    m = int(row_map.shape[0])
    dev = row_map.device
    rows_cap = int(bank.log_b.shape[0])
    ident = torch.arange(rows_cap, dtype=torch.int32, device=dev)
    inf = torch.full((), torch.inf, dtype=torch.float32, device=dev)

    # -- snapshots, before either loop acts --------------------------------
    split_stat = det.stat.max(dim=1).values  # [m]
    flags = (split_stat >= h) & active & act_ok
    exposure = det.n
    level = torch.where(exposure > 0.0,
                        det.level / torch.clamp((1.0 - level_decay) * exposure, min=1e-12),
                        0.0)
    seen = active & (exposure > 0.0)
    cnt = seen.sum()
    sv = torch.sort(torch.where(seen, level, inf)).values
    mid = torch.clamp(torch.div(torch.stack([cnt - 1, cnt]), 2, rounding_mode="floor"),
                      0, m - 1)
    lo_hi = sv[mid]  # a tensor index: gathered on the device, not read back
    med = torch.where(cnt > 0, 0.5 * (lo_hi[0] + lo_hi[1]), 0.0)
    level_hits = (exposure >= min_exposure) & (level - med <= math.log(fail_floor)) & act_ok

    # -- the screen: can anything fire against pre-action state? -----------
    ratio0 = base_ratio(bank.log_b, bank.n_base, logb_priors, ident, read_row, min_exposure)
    row_live = row_map >= 0
    size0 = ((row_map[:, None] == row_map[None, :])
             & row_live[None, :] & row_live[:, None]).sum(dim=1)
    gate0 = active & (active.sum() > 1) & act_ok
    maybe_evict = gate0 & (level_hits | ((size0 == 1) & (ratio0 <= fail_floor)))
    take_slow = flags.any() | maybe_evict.any()
    ctl = torch.stack([take_slow, act_ok.reshape(())]).to(torch.int32)

    sp = split_loop(flags, row_map, read_row, ident, det.stat, det.pool_level, det.pool_n, ctl)
    # -- failures: level route vs fleet median, base route vs nominal ------
    ratio = base_ratio(bank.log_b, bank.n_base, logb_priors, sp.src_of, sp.read_row,
                       min_exposure)
    base_ok = ratio <= fail_floor
    stat_val = torch.where(level_hits, level - med, torch.log(ratio))
    ev = evict_loop(level_hits, base_ok, stat_val, sp.row_map, sp.read_row, sp.src_of, active,
                    sp.stat, det.level, det.n, sp.pool_level, sp.pool_n, ctl)
    src = ev.src_of.long()
    bank2 = DeviceEstimatorState(*(a[src] for a in bank))
    det2 = CusumState(ev.stat, ev.level, ev.n, ev.pool_level, ev.pool_n)
    return FleetStepOut(
        bank=bank2, det=det2, row_map=ev.row_map, read_row=ev.read_row, active=ev.active,
        split_fired=sp.fired, split_stat=split_stat, evict_fired=ev.fired,
        evict_stat=ev.stats, evict_route=level_hits)


@dataclasses.dataclass(frozen=True)
class HealthEvent:
    """One fleet-health decision, as the controller's audit record."""

    kind: Literal["split", "evict"]
    server: int
    segment: int
    stat: float  # the detector statistic that fired (CUSUM max or level)
    detail: str = ""


class FleetController:
    """Fleet-health policy bound to a fleet's estimators (module docstring).

    Parameters are the JAX controller's: ``pools`` ('spec' groups servers
    whose ``ServerSpec`` compare equal; a label sequence groups arbitrarily;
    None disables pooling); ``cusum_k``, ``cusum_h``, ``level_decay``,
    ``min_exposure``, ``max_lost_frac`` for the :class:`DriftDetector`;
    ``fail_floor`` the eviction rate floor (default
    ``criteria.eviction_rate_floor()``); ``mesh`` a training-mesh config
    whose ``plan_elastic_remesh`` shrink plans evictions record and apply;
    ``heartbeat_timeout`` for the :class:`HeartbeatMonitor`, in segments;
    ``warmup_segments`` the ``observe`` calls whose detector evidence is
    discarded and whose actions are withheld, once per controller lifetime.
    The controller binds late (``bind``), to the estimators the engine
    builds, and on their device.
    """

    def __init__(
        self,
        pools: "Literal['spec'] | Sequence[Hashable] | None" = "spec",
        *,
        cusum_k: float = 0.25,
        cusum_h: float = 2.0,
        level_decay: float = 0.9,
        fail_floor: float | None = None,
        min_exposure: float = 4.0,
        max_lost_frac: float = 0.5,
        mesh: MeshConfig | None = None,
        heartbeat_timeout: float = 2.0,
        warmup_segments: int = 2,
    ):
        self._pools_spec = pools
        self.cusum_k = cusum_k
        self.cusum_h = cusum_h
        self.level_decay = level_decay
        self.fail_floor = eviction_rate_floor() if fail_floor is None else fail_floor
        self.min_exposure = min_exposure
        self.max_lost_frac = max_lost_frac
        self.mesh = mesh
        self._heartbeat_timeout = heartbeat_timeout
        self.warmup_segments = int(warmup_segments)
        self._segments_seen = 0  # observe() calls consumed (burn-in clock)
        self.events: list[HealthEvent] = []
        self.plans: list[ReMeshPlan] = []
        self.pool: PooledEstimatorBank | None = None
        self.detector: DriftDetector | None = None
        self.monitor: HeartbeatMonitor | None = None
        self._active: np.ndarray | None = None

    # -- binding -----------------------------------------------------------
    def bind(
        self,
        servers: Sequence[ServerSpec],
        estimators: Sequence[StreamingEstimator],
    ) -> "FleetController":
        """Attach to a fleet: build the pool map, detector and monitor, on
        the estimators' device. A controller binds once."""
        if self.pool is not None:
            raise RuntimeError("FleetController is already bound to a fleet")
        if len(servers) != len(estimators):
            raise ValueError(f"{len(servers)} servers, {len(estimators)} estimators")
        m = len(servers)
        if self._pools_spec == "spec":
            seen: dict[ServerSpec, int] = {}
            labels: Sequence[Hashable] = [seen.setdefault(s, len(seen)) for s in servers]
        else:
            labels = self._pools_spec
        self.pool = PooledEstimatorBank(estimators, labels)
        self.detector = DriftDetector(
            m=m, k=self.cusum_k, h=self.cusum_h, level_decay=self.level_decay,
            fail_floor=self.fail_floor, min_exposure=self.min_exposure,
            max_lost_frac=self.max_lost_frac, device=self.pool.device)
        self.monitor = HeartbeatMonitor(m, timeout_s=self._heartbeat_timeout)
        self._active = np.ones(m, bool)
        # nominal per-row log base priors, stacked once
        self._logb_priors = torch.stack(
            [e._logb_prior for e in self.pool.bank.estimators]).to(torch.float32)
        return self

    def _require_bound(self) -> None:
        if self.pool is None:
            raise RuntimeError("FleetController.bind(servers, estimators) first")

    @property
    def m(self) -> int:
        self._require_bound()
        return self.pool.m

    # -- fleet state reads -------------------------------------------------
    def active_mask(self) -> np.ndarray:
        """Placement eligibility per server (bool [m], False = evicted)."""
        self._require_bound()
        return self._active.copy()

    def current_D(self) -> list[torch.Tensor]:
        """Per-server D estimates through the pool map (shared when pooled)."""
        self._require_bound()
        return self.pool.estimate_D()

    def base_ratio(self) -> np.ndarray:
        """Estimated base rate / nominal prior per server [m], computed on
        the device from the bank's live stacked state; one [m] read."""
        self._require_bound()
        st = self.pool.bank.stacked_state()
        rows = st.log_b.shape[0]
        ident = torch.arange(rows, dtype=torch.int32, device=st.log_b.device)
        read_row = torch.from_numpy(self.pool._read_row.astype(np.int32)).to(st.log_b.device)
        ratio = base_ratio(st.log_b, st.n_base, self._logb_priors, ident, read_row,
                           self.min_exposure)
        return ratio.cpu().numpy().astype(np.float64)

    def recorder_ctx(self, segment: int):
        """The decision recorder's per-segment context (``obs.recorder``):
        the pair-exposure bank rows, pool read routing and per-server CUSUM
        levels exactly as the *next* segment's scheduler consults them --
        call after this segment's ``observe`` (as the fused loop samples its
        carry at segment entry)."""
        from ..obs import recorder as obs_recorder

        self._require_bound()
        dev = self.detector.state.stat.device
        read_row = torch.from_numpy(self.pool._read_row.astype(np.int32)).to(dev)
        return obs_recorder.RecCtx(
            n_pair=self.pool.bank.stacked_state().n_pair_t,
            row_of=read_row,
            cusum=self.detector.state.stat.amax(1),
            pool_row=read_row,
            segment=torch.tensor(segment, dtype=torch.int32, device=dev))

    # -- the per-segment step ---------------------------------------------
    def observe(self, block: RingBlock, segment: int) -> tuple[int, list[HealthEvent]]:
        """Fold one segment's telemetry in; diagnose; act.

        One fused pooled-bank update, one detector update (against the
        *post-update* pooled model), then host-side policy. Returns (rows
        consumed, events fired this call); events also accumulate on
        ``self.events``."""
        self._require_bound()
        used_dev = self.pool.update_device(block, sync=False)
        log_b, L_t, row_map = self.pool.refs()
        self.detector.update(block, log_b, L_t, row_map, sync=False)
        used = int(used_dev)
        events: list[HealthEvent] = []

        # liveness plane: surviving servers heartbeat on the segment clock
        for s in range(self.m):
            if self._active[s]:
                self.monitor.heartbeat(s, now=float(segment))

        self._segments_seen += 1
        if self._segments_seen <= self.warmup_segments:
            # burn-in, once per controller lifetime: discard the evidence
            self.detector.reset_all()
            return used, events

        # splits: pooled servers whose residual stream diverged
        split = self.detector.split_flags()
        stat = self.detector.stat_max()
        for s in map(int, np.flatnonzero(split)):
            if not self._active[s]:
                continue
            if self.pool.split(s):
                self._follow_migration()
                events.append(HealthEvent(
                    "split", s, segment, float(stat[s]),
                    detail=f"cusum {stat[s]:.2f} >= h {self.detector.h:g}"))
            # only the CUSUM: the failure level keeps its history
            self.detector.reset_stat(s)

        # failures: the level route (vs the fleet median level) or the base
        # route (own estimated base rate vs nominal, private rows only)
        level = self.detector.level_hat()
        exposure = self.detector.exposure()
        ratio = self.base_ratio()
        seen = self._active & (exposure > 0)
        med = float(np.median(level[seen])) if seen.any() else 0.0
        level_hits = self.detector.fail_flags(center=med)
        for s in range(self.m):
            if not self._active[s]:
                continue
            if self._active.sum() <= 1:
                break  # never evict the last server: a sick fleet > none
            level_hit = bool(level_hits[s])
            base_hit = self.pool.pool_size(s) == 1 and ratio[s] <= self.fail_floor
            if not (level_hit or base_hit):
                continue
            stat_val = float(level[s] - med if level_hit else np.log(ratio[s]))
            detail = ("residual level vs fleet median" if level_hit
                      else "estimated base") + (
                f" {np.exp(stat_val):.3f} <= floor {self.fail_floor:g}")
            events.append(self._evict(s, segment, stat_val, detail))

        self.events.extend(events)
        return used, events

    def adopt_device_outcome(
        self,
        bank_state: DeviceEstimatorState,
        det_state: CusumState,
        row_map: np.ndarray,
        read_row: np.ndarray,
        active: np.ndarray,
        outcomes: Sequence[dict],
    ) -> list[list[HealthEvent]]:
        """Mirror a fused closed-loop run into host fleet state: the final
        routing, mask, detector state and stacked bank are adopted whole,
        and the host-side bookkeeping the device cannot carry is replayed
        per segment (heartbeats, the burn-in counter, :class:`HealthEvent`
        records, ``mark_dead`` and re-mesh plans per eviction).
        ``outcomes`` is one dict per real segment, ascending, with the
        ``FleetStepOut`` decision arrays as numpy. Returns the events per
        segment (also accumulated on ``self.events``)."""
        self._require_bound()
        per_segment: list[list[HealthEvent]] = []
        entry_active = self._active.copy()
        for out in outcomes:
            seg = int(out["segment"])
            for s in range(self.m):
                if entry_active[s]:
                    self.monitor.heartbeat(s, now=float(seg))
            self._segments_seen += 1
            events: list[HealthEvent] = []
            stat = np.asarray(out["split_stat"], np.float64)
            for s in map(int, np.flatnonzero(out["split_fired"])):
                events.append(HealthEvent(
                    "split", s, seg, float(stat[s]),
                    detail=f"cusum {stat[s]:.2f} >= h {self.detector.h:g}"))
            est = np.asarray(out["evict_stat"], np.float64)
            route = np.asarray(out["evict_route"], bool)
            for s in map(int, np.flatnonzero(out["evict_fired"])):
                stat_val = float(est[s])
                detail = ("residual level vs fleet median" if route[s]
                          else "estimated base") + (
                    f" {np.exp(stat_val):.3f} <= floor {self.fail_floor:g}")
                events.append(HealthEvent("evict", s, seg, stat_val, detail=detail))
                self.monitor.mark_dead(s)
                self._plan_remesh(s)
            self.events.extend(events)
            per_segment.append(events)
            entry_active = np.asarray(out["active_after"], bool).copy()
        self.pool.adopt_rows(row_map, read_row)
        self._active = np.asarray(active, bool).copy()
        self.detector.state = CusumState(*det_state)
        self.pool.bank._stacked = DeviceEstimatorState(*bank_state)
        self.pool.bank._dirty = True
        return per_segment

    def _follow_migration(self) -> None:
        """Keep the detector's pool-centering rows aligned with a pool that
        just migrated to a new leader row (``pool.last_migration``)."""
        mig = self.pool.last_migration
        if mig is not None:
            self.detector.move_pool_row(*mig)

    def _plan_remesh(self, server: int) -> None:
        if self.mesh is not None:
            plan = plan_elastic_remesh(self.mesh, [server])
            if plan is not None:
                self.plans.append(plan)
                self.mesh = plan.new  # consecutive failures compose

    def _evict(self, server: int, segment: int, stat: float, detail: str) -> HealthEvent:
        """Remove ``server`` from the fleet (mask, routing, fault plane)."""
        self._active[server] = False
        self.pool.drop(server)
        self._follow_migration()
        self.detector.reset(server)
        self.monitor.mark_dead(server)
        self._plan_remesh(server)
        return HealthEvent("evict", server, segment, stat, detail=detail)

    # -- audit helpers -----------------------------------------------------
    def evicted(self) -> tuple[int, ...]:
        self._require_bound()
        return tuple(int(s) for s in np.flatnonzero(~self._active))

    def events_of(self, kind: str) -> tuple[HealthEvent, ...]:
        return tuple(ev for ev in self.events if ev.kind == kind)
