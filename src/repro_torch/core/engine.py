"""ConsolidationEngine: the front end of the port's online consolidation runtime.

Counterpart of ``repro/core/engine.py``. ``ConsolidationEngine.run`` takes an
arrival trace [(time, workload)] through the paper's online operating model
(arrive -> score -> place-or-queue -> run -> complete -> drain, §V/§VIII) on
the device-resident ``engine_torch.trace_segment`` loop, the trace padded to
a power-of-two capacity (``capacity``) so that traces of one capacity share
one loop: on the card, one captured CUDA graph of a block of micro-events,
replayed until the trace is done. ``backend='numpy'`` runs the float64
oracle instead (``core.scheduler.OnlineScheduler``, the copied reference
event loop), as the JAX engine's numpy backend does.

Candidate scoring goes through the shared (counts, wtypes) ->
(cache_after, maxd_after) interface, provided by

  scorer='cuda'   the hand-written CUDA kernel (``kernels.consolidation``),
                  the default; on CPU tensors its plain PyTorch version runs;
  scorer='torch'  the loop's incremental evaluation from its maintained sums
                  (``binpack_torch.score_candidates_torch`` outside the loop).

``AdaptiveEngine`` closes the observe -> estimate -> schedule loop on top of
this: it feeds telemetry-enabled runs into per-server streaming
D-estimators (``repro_torch.telemetry``) and places each trace segment from
the *estimated* D while the simulator stays ground truth -- through per-
server logs (the host-alternating path) or, with ``stream=True``, through
the device-resident observation stream and one banked estimator update per
segment. ``fleet=FleetController(...)`` adds the fleet-health control plane
(pooling, drift detection, eviction and requeue), and ``run(device_loop=
True)`` runs every segment through the fused closed loop
(``core.closed_loop``) with no host decision between segments.

``run(metrics=True, record=True)`` on either engine adds the observability
plane (``repro_torch.obs``): the run's MetricFrame on ``result.metrics``
and the decision flight recorder on ``result.decisions``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import TYPE_CHECKING, Callable, Literal, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.consolidation import consolidation_scores
from ..obs import metrics as obs_metrics
from ..obs import recorder as obs_recorder
from ..obs import trace as obs_trace
from ..obs.metrics import MetricFrame
from ..obs.recorder import DecisionRing
from ..telemetry.estimator import EstimatorBank, ScatterName, StreamingEstimator
from ..telemetry.log import (ObservationLog, ObservationRing, RingBlock,
                             observations_from_trace, rows_from_trace)
from .binpack import ClusterState, greedy_place
from .binpack_torch import PackedCluster, score_candidates_torch
from .contention import profile_pairwise_fast, type_tables
from .engine_torch import QUEUED, EngineTrace, LoopStats, PackedDynamics, Scorer, trace_segment
from .scheduler import OnlineScheduler
from .server import ServerSpec
from .workload import FS_GRID, RS_GRID, Workload, snap_to_grid, type_index

if TYPE_CHECKING:
    from ..fleet import FleetController, HealthEvent
    from ..telemetry.drift import DriftSchedule

ScorerName = Literal["cuda", "torch"]
Backend = Literal["torch", "numpy"]

#: the smallest event-loop capacity: short traces share one shape
MIN_CAPACITY = 8


def kernel_args(cluster: PackedCluster, counts: torch.Tensor, wtypes: torch.Tensor) -> tuple:
    """The scorer kernel's inputs for ``cluster``: (counts, D, rs, fs_resident,
    llc_budget, wtypes as int32 [Q])."""
    return (counts, cluster.D, cluster.rs, cluster.resident * cluster.fs[None, :],
            cluster.llc_budget, torch.atleast_1d(wtypes).to(torch.int32))


def _cuda_scorer(cluster: PackedCluster, counts: torch.Tensor, wtypes: torch.Tensor):
    return consolidation_scores(*kernel_args(cluster, counts, wtypes))


def make_scorer(backend: ScorerName = "cuda") -> Scorer:
    """Resolve a scoring-backend name to the shared-interface callable (the
    same object on every call: the event loop's cache keys on it)."""
    if backend == "torch":
        return score_candidates_torch
    if backend == "cuda":
        return _cuda_scorer
    raise ValueError(f"unknown scorer backend {backend!r}")


def score_candidates(
    cluster: PackedCluster, counts: torch.Tensor, wtypes: torch.Tensor,
    backend: ScorerName = "cuda",
) -> tuple[torch.Tensor, torch.Tensor]:
    """The shared scoring interface, dispatched by backend name."""
    return make_scorer(backend)(cluster, counts, wtypes)


@dataclasses.dataclass(frozen=True)
class EngineResult:
    """Outcome of one arrival trace."""

    placements: tuple[int | None, ...]  # final server per arrival (None = never ran)
    was_queued: tuple[bool, ...]  # §V queue decision at arrival time
    place_times: tuple[float, ...]  # -1 where never placed
    finish_times: tuple[float, ...]  # +inf where never finished
    makespan: float
    max_observed_degradation: float
    backend: str
    stats: LoopStats | None = None  # what the event loop did (None: empty trace)
    observations: ObservationLog | None = None  # filled when run(telemetry=True)
    #: the same records as validity-masked device rows (run(telemetry=
    #: 'device')): what AdaptiveEngine's stream mode folds into its ring
    stream_block: RingBlock | None = None
    #: the metrics plane (run(metrics=True)): queue depth, waiting time,
    #: Eqn-4 headroom, slowdown, per-server floor violations (repro_torch.obs)
    metrics: MetricFrame | None = None
    #: decision flight recorder state (run(record=True)): one provenance row
    #: per placement commit / queue decision, in trace (arrival-sorted) order
    decisions: "obs_recorder.RecState | None" = None

    @property
    def queued_indices(self) -> tuple[int, ...]:
        return tuple(i for i, q in enumerate(self.was_queued) if q)


class Deadlock(RuntimeError):
    """A run stopped with queued workloads that no empty server can take."""


class ConsolidationEngine:
    """The online consolidation runtime on one device (see module docstring).

    ``device=None`` means the card and raises without one; pass
    ``device='cpu'`` to run on the CPU. ``scorer`` is a backend name or a
    callable with the shared scoring signature. ``backend='numpy'`` runs
    every trace through the float64 oracle (``OnlineScheduler``) instead of
    the device event loop.
    """

    def __init__(
        self,
        servers: Sequence[ServerSpec],
        D: Sequence[np.ndarray | torch.Tensor] | np.ndarray | torch.Tensor | None = None,
        alpha: float | Sequence[float] = 1.3,
        objective: str = "sum_avg",
        scorer: ScorerName | Scorer = "cuda",
        active: Sequence[bool] | np.ndarray | None = None,
        *,
        device: str | torch.device | None = None,
        backend: Backend = "torch",
    ):
        self.device = resolve_device(device)
        if isinstance(scorer, str) and scorer not in ("cuda", "torch"):
            raise ValueError(f"unknown scorer backend {scorer!r}")
        if backend not in ("torch", "numpy"):
            raise ValueError(f"unknown engine backend {backend!r}")
        self.backend = backend
        self.servers = tuple(servers)
        if D is None:
            # keyed by the frozen spec value, not its name: same-name variant
            # specs (dataclasses.replace) must not share a profiling pass
            cache: dict[ServerSpec, np.ndarray] = {}
            for s in self.servers:  # identical specs share one profiling pass
                if s not in cache:
                    cache[s] = profile_pairwise_fast(s)
            D = [cache[s] for s in self.servers]
        elif isinstance(D, (np.ndarray, torch.Tensor)):
            D = [D] * len(self.servers)
        self.D = list(D)
        self.alpha = alpha
        self.objective = objective
        self.scorer = scorer
        self._active: np.ndarray | None = (  # fleet-health placement mask
            None if active is None else np.asarray(active, bool))
        self.cluster = self._build_cluster()
        self._dyn: PackedDynamics | None = None
        #: the event loop per trace shape (static buffers; on the card its
        #: captured graph), reused across runs and across set_D / set_active
        self._loops: dict = {}

    def _build_cluster(self) -> PackedCluster:
        return PackedCluster.build(list(self.servers), self.D, self.alpha,
                                   active=self._active, device=self.device)

    @property
    def dyn(self) -> PackedDynamics:
        """Ground-truth rate tables, built on first use."""
        if self._dyn is None:
            self._dyn = PackedDynamics.build(self.servers, device=self.device)
        return self._dyn

    def set_D(
        self,
        D: Sequence[np.ndarray | torch.Tensor] | np.ndarray | torch.Tensor,
        active: Sequence[bool] | np.ndarray | None = None,
    ) -> None:
        """Swap the scoring D-matrices, rebuilding only the PackedCluster (the
        ground-truth ``PackedDynamics`` keys on server specs, not D).
        Matrices given as device tensors stay on the device. ``active``
        optionally swaps the placement mask in the same build."""
        if active is not None:
            self._active = self._check_mask(active)
        if isinstance(D, (np.ndarray, torch.Tensor)):
            D = [D] * len(self.servers)
        self.D = list(D)
        self.cluster = self._build_cluster()

    def _check_mask(self, active) -> np.ndarray:
        mask = np.asarray(active, bool)
        if mask.shape != (len(self.servers),):
            raise ValueError(
                f"active mask shape {mask.shape} != ({len(self.servers)},)")
        return mask

    def set_active(self, active: Sequence[bool] | np.ndarray) -> None:
        """Swap the fleet-health placement mask (True = eligible).

        Masked servers stay in every table, but candidate scoring treats
        them as infeasible, so they receive no further placements.
        """
        mask = self._check_mask(active)
        if self._active is not None and np.array_equal(mask, self._active):
            return
        if self._active is None and mask.all():
            self._active = mask  # cluster is already all-active
            return
        self._active = mask
        self.cluster = self._build_cluster()

    # -- public API -------------------------------------------------------
    def run(
        self,
        arrivals: Sequence[tuple[float, Workload]],
        backend: Backend | None = None,
        *,
        telemetry: bool | Literal["host", "device"] = False,
        metrics: bool = False,
        record: bool = False,
        rec: "obs_recorder.RecState | None" = None,
        rec_ctx: "obs_recorder.RecCtx | None" = None,
    ) -> EngineResult:
        """Simulate arrivals [(time, workload)] to completion of all work.

        Workloads are snapped to the profiling grid (as the paper's scheduler
        snaps every candidate for its D-matrix lookup); ``data_total`` is
        honoured per arrival. Raises :class:`Deadlock` (a ``RuntimeError``)
        when a queued workload fits no *empty* server, like the oracle.

        ``telemetry=True`` (or ``'host'``) attaches the completion-observation
        log (``repro_torch.telemetry.ObservationLog``, tensors on the engine's
        device) to the result: the input of the estimator's ``update``.
        ``'device'`` attaches the same records as a validity-masked
        ``stream_block`` (``RingBlock``) instead, with nothing filtered or
        read back: the input of ``update_device`` and the observation ring.

        ``metrics=True`` updates the ``repro_torch.obs`` MetricFrame in the
        event loop and attaches it as ``result.metrics`` (waiting-time /
        headroom / slowdown histograms, queue depth, per-server floor
        violations). ``record=True`` writes the decision flight recorder in
        the event loop and attaches the ring state as ``result.decisions``:
        one provenance row per placement commit or queue decision,
        decision-identical to an unrecorded run. ``rec`` continues an
        existing ring across calls and ``rec_ctx`` supplies the estimator /
        detector context to sample; both default per run. Telemetry,
        metrics and recording are the device loop's: the numpy backend
        raises ``ValueError`` on them, as JAX's does.

        ``backend`` overrides the engine's backend for this call.
        """
        if telemetry not in (False, True, "host", "device"):
            raise ValueError(f"unknown telemetry mode {telemetry!r}")
        backend = backend or self.backend
        if backend not in ("torch", "numpy"):
            raise ValueError(f"unknown engine backend {backend!r}")
        if backend == "numpy":
            for flag, name in ((telemetry, "telemetry"), (metrics, "metrics"),
                               (record, "record")):
                if flag:
                    raise ValueError(f"{name} requires the torch engine backend")
            if self._active is not None and not self._active.all():
                raise ValueError("server masking (set_active) requires the torch "
                                 "engine backend; the numpy oracle has no mask")
        if not arrivals:
            obs = (ObservationLog.empty(self.cluster.T, self.device)
                   if telemetry in (True, "host") else None)
            frame = obs_metrics.zeros(len(self.servers), self.device) if metrics else None
            return EngineResult((), (), (), (), 0.0, 0.0, backend, observations=obs,
                                metrics=frame, decisions=rec if record else None)
        if backend == "numpy":
            return self._run_oracle(arrivals)
        return self._run_torch(arrivals, telemetry, metrics=metrics, record=record, rec=rec,
                               rec_ctx=rec_ctx)

    def _run_torch(self, arrivals: Sequence[tuple[float, Workload]],
                   telemetry: bool | Literal["host", "device"] = False, *,
                   metrics: bool = False, record: bool = False,
                   rec: "obs_recorder.RecState | None" = None,
                   rec_ctx: "obs_recorder.RecCtx | None" = None) -> EngineResult:
        n = len(arrivals)
        times = np.asarray([t for t, _ in arrivals], np.float64)
        order = np.argsort(times, kind="stable")
        # the trace padded to a power-of-two capacity, as JAX's closed loop
        # pads its segments: traces of one capacity share one event loop
        # (one captured graph on the card); padding rows never arrive
        cap = capacity(n)
        # normalize to the first arrival before the f32 cast: absolute
        # epoch-scale timestamps would otherwise collapse below f32 resolution
        t0 = float(times.min())
        dev = self.device
        host_time = np.zeros(cap, np.float32)
        host_type = np.zeros(cap, np.int32)
        host_bytes = np.ones(cap, np.float32)
        host_time[:n] = times[order] - t0
        host_type[:n] = [type_index(arrivals[i][1]) for i in order]
        host_bytes[:n] = [arrivals[i][1].data_total for i in order]
        arr_time, arr_type, arr_bytes = (torch.from_numpy(x).to(dev)
                                         for x in (host_time, host_type, host_bytes))

        # scorer='torch' -> None: the loop's incremental evaluation of the
        # same contract from its maintained sums; the others score every
        # grid type once per micro-event through the shared interface
        if callable(self.scorer):
            scorer = self.scorer
        else:
            scorer = None if self.scorer == "torch" else make_scorer(self.scorer)
        if record and rec is None:
            # a fresh ring of 2n rows, as JAX's run_trace mints one; the
            # padded capacity would size it by the padding instead
            rec = obs_recorder.init(2 * n, dev)
        trace = _head(trace_segment(self.cluster, self.dyn, arr_time, arr_type, arr_bytes, n,
                                    objective=self.objective, scorer=scorer,
                                    telemetry=bool(telemetry), metrics=metrics,
                                    record=record, rec=rec, rec_ctx=rec_ctx,
                                    cache=self._loops), n)
        arr_type, arr_bytes = arr_type[:n], arr_bytes[:n]
        if bool(trace.deadlock):
            raise Deadlock("deadlock: queued workloads fit no empty server")
        # observation records are per run; the trace's arrival-sorted order
        # serves as well as submission order
        obs = block = None
        if telemetry == "device":
            block = rows_from_trace(trace, arr_type)
        elif telemetry:
            obs = observations_from_trace(trace, arr_type, arr_bytes)

        inv = np.empty(n, np.int64)
        inv[order] = np.arange(n)
        placement = trace.placement.cpu().numpy()[inv]
        was_queued = trace.was_queued.cpu().numpy()[inv]
        place_time = trace.place_time.cpu().numpy().astype(np.float64)[inv]
        finish_time = trace.finish_time.cpu().numpy().astype(np.float64)[inv]
        place_time = np.where(place_time >= 0.0, place_time + t0, place_time)
        finish_time = np.where(np.isfinite(finish_time), finish_time + t0, finish_time)
        return EngineResult(
            placements=tuple(int(p) if p != QUEUED else None for p in placement),
            was_queued=tuple(bool(q) for q in was_queued),
            place_times=tuple(float(t) for t in place_time),
            finish_times=tuple(float(t) for t in finish_time),
            makespan=float(trace.makespan) + t0,
            max_observed_degradation=float(trace.max_deg),
            backend="torch",
            stats=trace.stats,
            observations=obs,
            stream_block=block,
            metrics=trace.metrics,
            decisions=trace.rec,
        )

    # -- reference oracle -------------------------------------------------
    def _run_oracle(self, arrivals: Sequence[tuple[float, Workload]]) -> EngineResult:
        """The float64 reference event loop (``OnlineScheduler``) over the
        engine's D, as JAX's ``backend='numpy'``."""
        D = [d.cpu().numpy() if torch.is_tensor(d) else np.asarray(d) for d in self.D]
        state = ClusterState.empty(list(self.servers), D, self.alpha)
        place = functools.partial(greedy_place, objective=self.objective)
        sched = OnlineScheduler(state, place=place)
        # distinct object identities per arrival so events map back uniquely
        # (callers may legitimately pass the same Workload object many times)
        copies = [(t, dataclasses.replace(snap_to_grid(w))) for t, w in arrivals]
        result = sched.run(copies)

        idx_of = {id(w): i for i, (_, w) in enumerate(copies)}
        n = len(copies)
        was_queued = [False] * n
        place_time = [-1.0] * n
        finish_time = [float("inf")] * n
        for e in result.events:
            i = idx_of.get(id(e.workload))
            if i is None:
                continue
            if e.kind == "queue":
                was_queued[i] = True
            elif e.kind == "place":
                place_time[i] = e.time
            elif e.kind == "finish":
                finish_time[i] = e.time
        return EngineResult(
            placements=tuple(result.placements[i] for i in range(n)),
            was_queued=tuple(was_queued),
            place_times=tuple(place_time),
            finish_times=tuple(finish_time),
            makespan=float(result.makespan),
            max_observed_degradation=float(result.max_observed_degradation),
            backend="numpy",
        )


def capacity(n: int) -> int:
    """The event loop's capacity for a trace of ``n`` arrivals: the next
    power of two, at least MIN_CAPACITY."""
    return max(MIN_CAPACITY, 1 << max(0, n - 1).bit_length())


def _head(trace: EngineTrace, n: int) -> EngineTrace:
    """The first ``n`` arrivals' rows of a padded trace."""
    return dataclasses.replace(trace, **{f: getattr(trace, f)[:n] for f in (
        "placement", "was_queued", "place_time", "finish_time", "obs_co", "obs_lost",
        "obs_logr")})


GRID_T = len(RS_GRID) * len(FS_GRID)


@dataclasses.dataclass(frozen=True)
class AdaptiveResult:
    """Outcome of one :meth:`AdaptiveEngine.run`: per-segment engine results."""

    segments: tuple[EngineResult, ...]
    n_obs: tuple[int, ...]  # observations consumed by the estimators per segment
    t_starts: tuple[float, ...]  # first arrival time per segment
    #: fleet-health events fired after each segment (empty without a fleet
    #: controller): splits and evictions, in the order they were taken
    health: "tuple[tuple[HealthEvent, ...], ...]" = ()
    #: merged run-level MetricFrame (run(metrics=True)): the per-segment
    #: engine frames merged, plus the closed-loop counters (segments,
    #: splits, evictions, requeues, ring rows) and gauges
    metrics: MetricFrame | None = None
    #: the engine's decision flight recorder after the run (run(record=True)):
    #: the host mirror whose ring holds every recorded placement decision
    decisions: "DecisionRing | None" = None

    @property
    def makespans(self) -> tuple[float, ...]:
        """Absolute completion time per segment (the engine's makespan)."""
        return tuple(r.makespan for r in self.segments)

    @property
    def durations(self) -> tuple[float, ...]:
        """First-arrival -> last-completion span per segment: the quantity
        comparable across segments (and against an oracle run of the same
        chunk), independent of where the chunk sits on the trace clock."""
        return tuple(r.makespan - t0 for r, t0 in zip(self.segments, self.t_starts))

    @property
    def total_obs(self) -> int:
        return int(sum(self.n_obs))


class AdaptiveEngine:
    """The closed-loop front end: place from *estimated* dynamics, observe the
    (simulated) world, refresh the estimate, repeat.

    The D each placement consults comes from a per-server
    :class:`~repro_torch.telemetry.StreamingEstimator` fed purely by
    completion observations, while the engine's ``PackedDynamics`` (built
    from the *true* server specs, which a
    :class:`~repro_torch.telemetry.DriftSchedule` may change under the
    scheduler) remains the ground truth that generates those observations.

    ``run`` splits the arrival trace into contiguous segments and alternates:
    run one segment to completion with the current estimate -> fold its
    observation log into the estimators -> rebuild D for the next segment.
    Each segment starts from an empty cluster, so segment makespans compare
    directly against a true-D oracle run under the same protocol.

    ``stream=True`` is the JAX package's stream mode of the same loop: each
    segment runs with ``telemetry='device'``, its observation rows are pushed
    into a device-resident :class:`~repro_torch.telemetry.ObservationRing`
    (``ring_capacity`` rows of bounded history), and every estimator refresh
    is one fused :class:`~repro_torch.telemetry.EstimatorBank` update -- one
    banked scatter launch for all servers, no host ``ObservationLog``. The
    estimators consume the segment's full block; the ring only bounds
    history.

    ``fleet=FleetController(...)`` puts the fleet-health control plane
    (``repro_torch.fleet``) in the loop, implying ``stream=True``: the
    controller binds to this engine's servers and estimators, same-spec
    servers pool onto shared estimator rows, each segment's block feeds the
    controller's CUSUM detector, and its decisions act on the next segment
    -- split servers get their own seeded estimator, evicted servers are
    masked out of candidate scoring (``set_active``), and their in-flight
    work (placed on the evicted server in the detection segment, or never
    placed) is requeued at the head of the next segment.

    ``run(metrics=True)`` merges every segment's MetricFrame with the
    closed-loop counters into one run frame, and ``run(record=True)``
    records every segment's decisions into one ring (``self.decisions``, of
    ``decision_capacity`` rows, minted on first use), on both paths.
    """

    def __init__(
        self,
        servers: Sequence[ServerSpec],
        prior: float | str | np.ndarray | Sequence[np.ndarray] = 0.0,
        alpha: float | Sequence[float] = 1.3,
        objective: str = "sum_avg",
        scorer: ScorerName = "cuda",
        drift: "DriftSchedule | None" = None,
        lr: float = 0.6,
        decay: float = 1.0,
        confidence_floor: float = 2.0,
        max_lost_frac: float = 0.5,
        scatter: ScatterName = "cuda",
        stream: bool = False,
        ring_capacity: int = 4096,
        fleet: "FleetController | None" = None,
        decision_capacity: int = 1024,
        *,
        device: str | torch.device | None = None,
    ):
        """``prior`` selects what the scheduler believes before any telemetry:
        a scalar is a uniform D prior (0.0 = optimistic "no interference" --
        the fleet consolidates aggressively and learns the cost), 'profiled'
        seeds each estimator with the offline pairwise pass on the *initial*
        spec (stale once drift hits), and an array (or one per server) is an
        explicit prior. Solo base rates always start from the cheap per-type
        solo profile of the initial spec. ``scorer`` and ``scatter`` name the
        candidate-scoring and pair-statistic backends, ``device`` where the
        engines and estimators run (``None``: the card)."""
        self.device = resolve_device(device)
        self.servers = tuple(servers)
        self.fleet = fleet
        stream = stream or fleet is not None  # the control plane is stream-fed
        self.stream = stream
        self.ring = (ObservationRing(ring_capacity, GRID_T, device=self.device)
                     if stream else None)
        self.alpha = alpha
        self.objective = objective
        self.scorer = scorer
        self.drift = drift
        # segment-engine cache: under an unchanged world only the D-matrices
        # and the active mask move between segments, so the engine -- with
        # its PackedDynamics tables and its event loops (captured graphs on
        # the card) -- is reused via set_D, which swaps both. Keyed by specs
        # alone: drift schedules revisit worlds (congest -> recover).
        self._engine_cache: dict[tuple[ServerSpec, ...], ConsolidationEngine] = {}
        self._dyn_cache: dict[tuple[ServerSpec, ...], PackedDynamics] = {}
        #: the fused loop's event loops per shape (their graphs on the card)
        self._closed_loops: dict = {}
        # the decision flight recorder's host mirror, minted on the first
        # run(record=True) (capacity is spent in decisions, not segments)
        self.decision_capacity = int(decision_capacity)
        self.decisions: DecisionRing | None = None

        priors: list[np.ndarray | float]
        if isinstance(prior, str):
            if prior != "profiled":
                raise ValueError(f"unknown prior {prior!r}")
            cache: dict[ServerSpec, np.ndarray] = {}
            for s in self.servers:
                if s not in cache:
                    cache[s] = profile_pairwise_fast(s)
            priors = [cache[s] for s in self.servers]
        elif isinstance(prior, (int, float)):
            priors = [float(prior)] * len(self.servers)
        elif isinstance(prior, np.ndarray):
            priors = [prior] * len(self.servers)
        else:
            priors = list(prior)

        self.estimators = [
            StreamingEstimator(
                T=GRID_T,
                prior_D=priors[i],
                prior_solo=type_tables(s)["solo"],
                lr=lr,
                decay=decay,
                confidence_floor=confidence_floor,
                max_lost_frac=max_lost_frac,
                scatter=scatter,
                device=self.device,
            )
            for i, s in enumerate(self.servers)
        ]
        #: stream mode refreshes every server's estimator in one fused step;
        #: with a fleet controller the controller's pooled bank is that step
        #: (two banks over the same estimators would fight for their state)
        if fleet is not None:
            fleet.bind(self.servers, self.estimators)
            self.bank = None
        else:
            self.bank = EstimatorBank(self.estimators) if stream else None

    # -- estimates --------------------------------------------------------
    def current_D(self) -> list[torch.Tensor]:
        """The per-server D-matrices (float64 tensors on the engine's device)
        the next segment's placements will use; with a fleet controller they
        resolve through the pool map (pooled servers share their pool's)."""
        if self.fleet is not None:
            return self.fleet.current_D()
        return [est.estimate_D() for est in self.estimators]

    def engine_for_segment(self, segment: int) -> ConsolidationEngine:
        """A ConsolidationEngine scoring with estimates over the true world.

        Engines are cached per world: while the specs are unchanged only the
        estimated D and the fleet's active mask move, and ``set_D`` swaps
        both without rebuilding the ground-truth dynamics or the event
        loops. A new world reuses any ``PackedDynamics`` the fused loop
        already built for it."""
        specs = (tuple(self.drift.specs_at(self.servers, segment))
                 if self.drift is not None else self.servers)
        mask = self.fleet.active_mask() if self.fleet is not None else None
        engine = self._engine_cache.get(specs)
        if engine is not None:
            engine.set_D(self.current_D(), active=mask)
            return engine
        engine = ConsolidationEngine(
            list(specs), D=self.current_D(), alpha=self.alpha,
            objective=self.objective, scorer=self.scorer, active=mask, device=self.device)
        if specs in self._dyn_cache:
            engine._dyn = self._dyn_cache[specs]
        else:
            self._dyn_cache[specs] = engine.dyn  # builds the tables once
        self._engine_cache[specs] = engine
        return engine

    def _decision_ring(self) -> DecisionRing:
        """The recorder's host mirror, minted on first use."""
        if self.decisions is None:
            self.decisions = DecisionRing(self.decision_capacity, self.device)
        return self.decisions

    def _recorder_ctx(self, segment: int) -> "obs_recorder.RecCtx":
        """Per-segment recorder context from the live host-side state --
        what the *next* engine run's scheduler will consult."""
        if self.fleet is not None:
            # stamp with the controller's live burn-in clock -- the fused
            # loop stamps carry.seen, which starts at _segments_seen
            return self.fleet.recorder_ctx(self.fleet._segments_seen)
        m = len(self.servers)
        if self.bank is not None:
            n_pair = self.bank.stacked_state().n_pair_t
        else:
            n_pair = torch.stack([e.n_pair.T for e in self.estimators]).to(torch.float32)
        ident = torch.arange(m, dtype=torch.int32, device=self.device)
        return obs_recorder.RecCtx(
            n_pair=n_pair, row_of=ident,
            cusum=torch.zeros((m,), dtype=torch.float32, device=self.device),  # no detector
            pool_row=ident, segment=torch.tensor(segment, dtype=torch.int32,
                                                 device=self.device))

    # -- the loop ---------------------------------------------------------
    def run(
        self,
        arrivals: Sequence[tuple[float, Workload]],
        segments: int = 8,
        on_segment: Callable[[int, EngineResult, "AdaptiveEngine"], None] | None = None,
        *,
        device_loop: bool = False,
        metrics: bool = False,
        record: bool = False,
    ) -> AdaptiveResult:
        """Alternate ``segments`` trace chunks with estimator refreshes.

        ``on_segment(k, result, self)`` fires after each segment's
        observations have been folded in (and, with a fleet controller,
        after its health actions). With a fleet controller, an eviction
        requeues the evicted server's in-flight work: the detection
        segment's arrivals that ran on it, plus any never-placed arrivals,
        re-enter at the head of the next segment's chunk (an eviction in
        the final segment has no next chunk).

        ``device_loop=True`` runs the whole multi-segment cycle through the
        fused closed loop (``core.closed_loop``): the same decisions and
        final state, with no host read between segments beyond the event
        loop's one per block. It requires stream mode, an arrival count
        divisible by ``segments``, drift that leaves ``llc_bytes`` /
        ``llc_tolerance`` alone, and no ``on_segment``.

        ``metrics=True`` updates the ``repro_torch.obs`` MetricFrame in every
        segment's event loop and attaches the merged run frame as
        ``result.metrics``; the split/evict/requeue counters match
        ``result.health`` on both paths. Here it is merged per segment on the
        host; on the fused loop it rides the carry.

        ``record=True`` records every segment's decisions into one ring
        (``self.decisions``, capacity ``decision_capacity``), sampling the
        estimator pair exposure / detector CUSUM state the segment's
        scheduler consulted, and returns it on ``result.decisions``.
        Decisions are unchanged.
        """
        if device_loop:
            if on_segment is not None:
                raise ValueError(
                    "device_loop=True runs all segments without a host point "
                    "between them; there is none for on_segment -- use the "
                    "host-alternating path")
            return self._run_device_loop(arrivals, segments, metrics=metrics, record=record)
        m = len(self.servers)
        frame = obs_metrics.zeros(m, self.device) if metrics else None
        ring = self._decision_ring() if record else None
        ordered = sorted(arrivals, key=lambda tw: tw[0])
        bounds = np.linspace(0, len(ordered), segments + 1).astype(int)
        results, n_obs, t_starts, health = [], [], [], []
        requeue: list[Workload] = []
        for k in range(segments):
            chunk = ordered[bounds[k]:bounds[k + 1]]
            if requeue:
                t0 = chunk[0][0] if chunk else 0.0
                chunk = [(t0, w) for w in requeue] + chunk
                requeue = []
            engine = self.engine_for_segment(k)
            obs_kw = dict(metrics=metrics)
            if record:
                obs_kw.update(record=True, rec=ring.state, rec_ctx=self._recorder_ctx(k))
            events: "tuple[HealthEvent, ...]" = ()
            if self.stream:
                # the segment's rows go trace -> ring -> one banked update
                # without a host log; the estimators consume the FULL block
                # (the ring keeps only its newest capacity rows for history)
                res = engine.run(chunk, telemetry="device", **obs_kw)
                used = 0
                if res.stream_block is not None:
                    self.ring.push(res.stream_block)
                    if self.fleet is not None:
                        used, evs = self.fleet.observe(res.stream_block, segment=k)
                        events = tuple(evs)
                        evicted = {ev.server for ev in evs if ev.kind == "evict"}
                        if evicted:
                            requeue = [w for (_, w), p in zip(chunk, res.placements)
                                       if p in evicted or p is None]
                    else:
                        # the indexed table update: the dense form's values
                        # without forming the [2, m, T, T] statistics
                        used = self.bank.update_device(res.stream_block, sparse_tables=True)
            else:
                res = engine.run(chunk, telemetry=True, **obs_kw)
                used = sum(est.update(res.observations.for_server(s))
                           for s, est in enumerate(self.estimators))
            if record and res.decisions is not None:
                ring.adopt(res.decisions)  # the next segment continues it
            if metrics:
                # the closed-loop accounting the fused loop keeps in its
                # carry, from the host's own bookkeeping
                frame = obs_metrics.merge(frame, res.metrics)
                obs_metrics.count_(frame, "segments", 1)
                obs_metrics.count_(frame, "splits", sum(1 for ev in events if ev.kind == "split"))
                obs_metrics.count_(frame, "evictions",
                                   sum(1 for ev in events if ev.kind == "evict"))
                obs_metrics.count_(frame, "requeues", len(requeue))
                obs_metrics.gauge_max_(frame, "requeue_peak", float(len(requeue)))
                if self.stream:
                    obs_metrics.count_(frame, "ring_rows", len(chunk))
                    obs_metrics.gauge_max_(frame, "ring_occupancy_peak",
                                           float(min(self.ring.total, self.ring.capacity)))
                if self.fleet is not None:
                    obs_metrics.gauge_max_(frame, "evicted_peak",
                                           float((~self.fleet.active_mask()).sum()))
            results.append(res)
            n_obs.append(used)
            t_starts.append(chunk[0][0] if chunk else 0.0)
            health.append(events)
            if on_segment is not None:
                on_segment(k, res, self)
        return AdaptiveResult(tuple(results), tuple(n_obs), tuple(t_starts), tuple(health),
                              metrics=frame, decisions=ring)

    # -- the fused device-resident loop -----------------------------------
    def _run_device_loop(self, arrivals: Sequence[tuple[float, Workload]],
                         segments: int, *, metrics: bool = False,
                         record: bool = False) -> AdaptiveResult:
        """One ``run_closed_loop`` over the whole multi-segment run.

        Host work is prologue (pack the arrivals and dynamics, snapshot the
        live estimator, detector and pool state into the carry) and
        epilogue (one read of every segment's outputs, then the final carry
        mirrored into the host objects through
        ``FleetController.adopt_device_outcome`` /
        ``PooledEstimatorBank.adopt_rows``). Per-segment ``EngineResult`` s
        carry no ``observations`` / ``stream_block``: the telemetry was
        consumed on the device (the ring holds the bounded history).

        The three host phases are wrapped in ``repro_torch.obs.trace`` spans
        (``closed_loop.pack`` / ``.dispatch`` / ``.epilogue``). With
        ``metrics=True`` the MetricFrame rides the carry and the run frame is
        returned on ``AdaptiveResult.metrics``; with ``record=True`` the
        decision ring does, and is adopted into ``self.decisions``.
        """
        from ..fleet.detect import CusumState
        from .closed_loop import (ClosedLoopConfig, LoopCarry, SegmentIn, run_closed_loop,
                                  stack_outputs)

        if not self.stream:
            raise ValueError("device_loop=True requires stream mode "
                             "(stream=True or a fleet controller)")
        n = len(arrivals)
        if n == 0 or segments <= 0 or n % segments != 0:
            raise ValueError(
                f"device_loop=True needs a non-empty arrival trace divisible "
                f"by segments (got {n} arrivals / {segments} segments); the "
                f"host-alternating path handles ragged chunks")
        m = len(self.servers)
        n_seg = n // segments
        R = n_seg  # requeue capacity: one segment's worth of in-flight work
        if R + n_seg > self.ring.capacity:
            raise ValueError(
                f"segment size {n_seg} (+{R} requeue slots) exceeds the "
                f"telemetry ring capacity {self.ring.capacity}")
        e0 = self.estimators[0]
        if any(e.confidence_floor != e0.confidence_floor for e in self.estimators):
            raise ValueError("device_loop=True blends every row's D with one "
                             "confidence_floor; estimators disagree")
        dev = self.device

        with obs_trace.span("closed_loop.pack", segments=segments, m=m):
            ordered = sorted(arrivals, key=lambda tw: tw[0])
            times = np.asarray([t for t, _ in ordered], np.float64)
            wtypes = np.asarray([type_index(w) for _, w in ordered], np.int32)
            nbytes = np.asarray([w.data_total for _, w in ordered], np.float64)

            # segments bucket to a power-of-two count (padding masked by
            # seg_valid), as JAX buckets its compiled scan
            S_cap = 4
            while S_cap < segments:
                S_cap *= 2
            arr_time = np.zeros((S_cap, n_seg), np.float32)
            arr_type = np.zeros((S_cap, n_seg), np.int32)
            arr_bytes = np.ones((S_cap, n_seg), np.float32)
            t0s = []
            for k in range(segments):
                sl = slice(k * n_seg, (k + 1) * n_seg)
                t0 = float(times[k * n_seg])
                t0s.append(t0)
                arr_time[k] = times[sl] - t0
                arr_type[k] = wtypes[sl]
                arr_bytes[k] = nbytes[sl]

            # per-segment worlds, deduplicated; the cluster's structural tables
            # must hold for all of them
            structural = [(s.llc_bytes, s.llc_tolerance) for s in self.servers]
            spec_of: dict[tuple[ServerSpec, ...], int] = {}
            dyn_idx = np.zeros(S_cap, np.int64)
            for k in range(segments):
                specs = (tuple(self.drift.specs_at(self.servers, k))
                         if self.drift is not None else self.servers)
                if [(s.llc_bytes, s.llc_tolerance) for s in specs] != structural:
                    raise ValueError(
                        "device_loop=True keeps one cluster for all segments: "
                        "drift may not change llc_bytes/llc_tolerance (run the "
                        "host-alternating path for structural drift)")
                dyn_idx[k] = spec_of.setdefault(specs, len(spec_of))
            for specs in spec_of:
                if specs not in self._dyn_cache:
                    self._dyn_cache[specs] = PackedDynamics.build(list(specs), device=dev)
            dyn_stack = tuple(self._dyn_cache[s] for s in spec_of)
            cluster = PackedCluster.build(list(self.servers),
                                          torch.zeros((GRID_T, GRID_T), dtype=torch.float32,
                                                      device=dev), self.alpha, device=dev)
            Lp_t = torch.stack([e._L_prior.T for e in self.estimators]).contiguous()
            logb_priors = torch.stack([e._logb_prior for e in self.estimators]).to(torch.float32)

            scorer = None if self.scorer == "torch" else make_scorer(self.scorer)
            h = e0._hypers
            est_h = dict(lr=h["lr"], decay=h["decay"], step_damp=h["step_damp"],
                         solo_eps=h["solo_eps"], est_max_lost_frac=h["max_lost_frac"],
                         scatter=h["scatter"])
            i32 = dict(dtype=torch.int32, device=dev)
            queue = dict(req_type=torch.zeros(R, **i32),
                         req_bytes=torch.ones(R, dtype=torch.float32, device=dev),
                         req_n=torch.zeros((), **i32), ring=self.ring._buf,
                         ring_ptr=torch.tensor(self.ring.ptr, **i32),
                         ring_total=torch.tensor(self.ring.total, **i32))
            # the observability plane's carry, built here: a tensor made from
            # host data inside a segment would be a copy that waits on the card
            obs0 = dict(metrics=obs_metrics.zeros(m, dev) if metrics else None,
                        rec=obs_recorder.clone(self._decision_ring().state) if record else None)
            fc = self.fleet
            if fc is not None:
                fc._require_bound()
                config = ClosedLoopConfig(
                    objective=self.objective, scorer=scorer, fleet=True,
                    warmup_segments=fc.warmup_segments, cusum_k=fc.cusum_k, cusum_h=fc.cusum_h,
                    level_decay=fc.level_decay, fail_floor=fc.fail_floor,
                    min_exposure=fc.min_exposure, det_max_lost_frac=fc.max_lost_frac,
                    confidence_floor=float(e0.confidence_floor), metrics=metrics, record=record,
                    **est_h)
                carry0 = LoopCarry(
                    bank=fc.pool.bank.stacked_state(), det=fc.detector.state,
                    row_map=torch.from_numpy(fc.pool.row_of.astype(np.int32)).to(dev),
                    read_row=torch.from_numpy(fc.pool._read_row.astype(np.int32)).to(dev),
                    active=torch.from_numpy(fc._active.copy()).to(dev),
                    seen=torch.tensor(fc._segments_seen, **i32), **queue, **obs0)
            else:
                config = ClosedLoopConfig(objective=self.objective, scorer=scorer, fleet=False,
                                          confidence_floor=float(e0.confidence_floor), metrics=metrics, record=record,
                    **est_h)
                carry0 = LoopCarry(
                    bank=self.bank.stacked_state(), det=CusumState.zeros(m, device=dev),
                    row_map=torch.arange(m, **i32), read_row=torch.arange(m, **i32),
                    active=torch.ones(m, dtype=torch.bool, device=dev),
                    seen=torch.zeros((), **i32), **queue, **obs0)
            xs = SegmentIn(
                arr_time=torch.from_numpy(arr_time).to(dev),
                arr_type=torch.from_numpy(arr_type).to(dev),
                arr_bytes=torch.from_numpy(arr_bytes).to(dev), dyn_idx=dyn_idx,
                seg_valid=torch.from_numpy(np.arange(S_cap) < segments).to(dev))

        with obs_trace.span("closed_loop.dispatch", segments=segments, m=m, s_cap=S_cap):
            final, outs = run_closed_loop(cluster, dyn_stack, Lp_t, logb_priors, carry0, xs, config,
                                          cache=self._closed_loops)
            ys, stats = stack_outputs(outs)

        # failures surface before any state is adopted, leaving the host
        # objects where they were (the failed run never happened)
        if ys.deadlock[:segments].any():
            raise Deadlock("deadlock: queued workloads fit no empty server")
        if ys.req_overflow[:segments].any():
            raise RuntimeError(
                f"eviction requeued more than one segment's worth of work "
                f"({R} slots); run the host-alternating path")

        with obs_trace.span("closed_loop.epilogue", segments=segments):
            results, n_obs = [], []
            for k in range(segments):
                nv = int(ys.n_valid[k])
                t0 = t0s[k]
                placement = ys.placement[k][:nv]
                pt = ys.place_time[k][:nv].astype(np.float64)
                ft = ys.finish_time[k][:nv].astype(np.float64)
                pt = np.where(pt >= 0.0, pt + t0, pt)
                ft = np.where(np.isfinite(ft), ft + t0, ft)
                results.append(EngineResult(
                    placements=tuple(int(p) if p != QUEUED else None for p in placement),
                    was_queued=tuple(bool(q) for q in ys.was_queued[k][:nv]),
                    place_times=tuple(float(t) for t in pt),
                    finish_times=tuple(float(t) for t in ft),
                    makespan=float(ys.makespan[k]) + t0,
                    max_observed_degradation=float(ys.max_deg[k]),
                    backend="torch", stats=stats[k]))
                n_obs.append(int(ys.used[k]))

            if fc is not None:
                outcomes = [dict(segment=k, split_fired=ys.split_fired[k],
                                 split_stat=ys.split_stat[k], evict_fired=ys.evict_fired[k],
                                 evict_stat=ys.evict_stat[k], evict_route=ys.evict_route[k],
                                 active_after=ys.active_after[k])
                            for k in range(segments)]
                per_seg = fc.adopt_device_outcome(
                    final.bank, final.det, final.row_map.cpu().numpy(),
                    final.read_row.cpu().numpy(), final.active.cpu().numpy(), outcomes)
                health = [tuple(evs) for evs in per_seg]
            else:
                self.bank._stacked = final.bank
                self.bank._dirty = True
                health = [() for _ in range(segments)]
            self.ring._buf = final.ring
            self.ring.ptr = int(final.ring_ptr)
            self.ring.total = int(final.ring_total)
            if record:
                self.decisions.adopt(final.rec)
            log = obs_trace.active_log()
            if metrics and log is not None:
                log.snapshot("closed_loop.metrics", obs_metrics.snapshot(final.metrics))
        return AdaptiveResult(tuple(results), tuple(n_obs), tuple(t0s), tuple(health),
                              metrics=final.metrics,
                              decisions=self.decisions if record else None)
