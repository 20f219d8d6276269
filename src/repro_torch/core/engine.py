"""ConsolidationEngine: the front end of the port's online consolidation runtime.

Counterpart of ``repro/core/engine.py``. ``ConsolidationEngine.run`` takes an
arrival trace [(time, workload)] through the paper's online operating model
(arrive -> score -> place-or-queue -> run -> complete -> drain, §V/§VIII) on
the device-resident ``engine_torch.trace_segment`` loop, the trace padded to
a power-of-two capacity (``capacity``) so that traces of one capacity share
one loop: on the card, one captured CUDA graph of a block of micro-events,
replayed until the trace is done. The runtime is PyTorch only; the
float64 oracle (``OnlineScheduler``) stays in the JAX package as the
reference the tests hold this engine to.

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
segment.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Callable, Literal, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.consolidation import consolidation_scores
from ..telemetry.estimator import EstimatorBank, ScatterName, StreamingEstimator
from ..telemetry.log import (ObservationLog, ObservationRing, RingBlock,
                             observations_from_trace, rows_from_trace)
from .binpack_torch import PackedCluster, score_candidates_torch
from .contention import profile_pairwise_fast, type_tables
from .engine_torch import QUEUED, EngineTrace, LoopStats, PackedDynamics, Scorer, trace_segment
from .server import ServerSpec
from .workload import FS_GRID, RS_GRID, Workload, type_index

if TYPE_CHECKING:
    from ..telemetry.drift import DriftSchedule

ScorerName = Literal["cuda", "torch"]

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

    @property
    def queued_indices(self) -> tuple[int, ...]:
        return tuple(i for i, q in enumerate(self.was_queued) if q)


class Deadlock(RuntimeError):
    """A run stopped with queued workloads that no empty server can take."""


class ConsolidationEngine:
    """The online consolidation runtime on one device (see module docstring).

    ``device=None`` means the card and raises without one; pass
    ``device='cpu'`` to run on the CPU. ``scorer`` is a backend name or a
    callable with the shared scoring signature.
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
    ):
        self.device = resolve_device(device)
        if isinstance(scorer, str) and scorer not in ("cuda", "torch"):
            raise ValueError(f"unknown scorer backend {scorer!r}")
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
        *,
        telemetry: bool | Literal["host", "device"] = False,
        metrics: bool = False,
        record: bool = False,
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
        The JAX engine's ``metrics`` and ``record`` outputs are not ported
        yet and raise ``NotImplementedError``.
        """
        if telemetry not in (False, True, "host", "device"):
            raise ValueError(f"unknown telemetry mode {telemetry!r}")
        for flag, name in ((metrics, "metrics"), (record, "record")):
            if flag:
                raise NotImplementedError(f"run({name}=...) is not ported yet")
        if not arrivals:
            obs = (ObservationLog.empty(self.cluster.T, self.device)
                   if telemetry in (True, "host") else None)
            return EngineResult((), (), (), (), 0.0, 0.0, "torch", observations=obs)
        return self._run_torch(arrivals, telemetry)

    def _run_torch(self, arrivals: Sequence[tuple[float, Workload]],
                   telemetry: bool | Literal["host", "device"] = False) -> EngineResult:
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
        trace = _head(trace_segment(self.cluster, self.dyn, arr_time, arr_type, arr_bytes, n,
                                    objective=self.objective, scorer=scorer,
                                    telemetry=bool(telemetry), cache=self._loops), n)
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

    The JAX package's fleet-health control plane (``fleet=``), fused loop
    (``run(device_loop=True)``), metrics plane and decision recorder are not
    ported yet and raise ``NotImplementedError``.
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
        fleet=None,
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
        if fleet is not None:
            raise NotImplementedError(
                "AdaptiveEngine(fleet=...): the fleet-health control plane is "
                "not ported yet (ROADMAP Queue 1, item 5)")
        self.device = resolve_device(device)
        self.servers = tuple(servers)
        self.stream = stream
        self.ring = (ObservationRing(ring_capacity, GRID_T, device=self.device)
                     if stream else None)
        self.alpha = alpha
        self.objective = objective
        self.scorer = scorer
        self.drift = drift
        # segment-engine cache: under an unchanged world only the D-matrices
        # move between segments, so the engine -- and with it the
        # PackedDynamics tables -- is reused via set_D. Keyed by (specs,
        # active-mask) like the JAX engine's (the mask is always None until
        # the fleet plane is ported); PackedDynamics caches on specs alone,
        # since drift schedules revisit worlds.
        self._engine_cache: dict[tuple, ConsolidationEngine] = {}
        self._dyn_cache: dict[tuple[ServerSpec, ...], PackedDynamics] = {}

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
        #: stream mode refreshes every server's estimator in one fused step
        self.bank = EstimatorBank(self.estimators) if stream else None

    # -- estimates --------------------------------------------------------
    def current_D(self) -> list[torch.Tensor]:
        """The per-server D-matrices (float64 tensors on the engine's device)
        the next segment's placements will use."""
        return [est.estimate_D() for est in self.estimators]

    def engine_for_segment(self, segment: int) -> ConsolidationEngine:
        """A ConsolidationEngine scoring with estimates over the true world.

        Engines are cached across segments: while the specs are unchanged
        only the estimated D moves, and ``set_D`` swaps it without rebuilding
        the ground-truth dynamics. When drift changes the specs, the new
        engine still reuses any previously built ``PackedDynamics`` for that
        world (drift schedules revisit worlds: congest -> recover)."""
        specs = (tuple(self.drift.specs_at(self.servers, segment))
                 if self.drift is not None else self.servers)
        key = (specs, None)
        engine = self._engine_cache.get(key)
        if engine is not None:
            engine.set_D(self.current_D())
            return engine
        engine = ConsolidationEngine(
            list(specs), D=self.current_D(), alpha=self.alpha,
            objective=self.objective, scorer=self.scorer, device=self.device)
        if specs in self._dyn_cache:
            engine._dyn = self._dyn_cache[specs]
        else:
            self._dyn_cache[specs] = engine.dyn  # builds the tables once
        self._engine_cache[key] = engine
        return engine

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
        observations have been folded in. ``device_loop``, ``metrics`` and
        ``record`` are the JAX engine's fused loop, metrics plane and
        decision recorder; they are not ported yet and raise.
        """
        for flag, name, item in ((device_loop, "device_loop", "6"),
                                 (metrics, "metrics", "7"), (record, "record", "7")):
            if flag:
                raise NotImplementedError(
                    f"AdaptiveEngine.run({name}=True) is not ported yet "
                    f"(ROADMAP Queue 1, item {item})")
        ordered = sorted(arrivals, key=lambda tw: tw[0])
        bounds = np.linspace(0, len(ordered), segments + 1).astype(int)
        results, n_obs, t_starts = [], [], []
        for k in range(segments):
            chunk = ordered[bounds[k]:bounds[k + 1]]
            engine = self.engine_for_segment(k)
            if self.stream:
                # the segment's rows go trace -> ring -> one banked update
                # without a host log; the estimators consume the FULL block
                # (the ring keeps only its newest capacity rows for history)
                res = engine.run(chunk, telemetry="device")
                used = 0
                if res.stream_block is not None:
                    self.ring.push(res.stream_block)
                    # the indexed table update: the dense form's values
                    # without forming the [2, m, T, T] statistics
                    used = self.bank.update_device(res.stream_block, sparse_tables=True)
            else:
                res = engine.run(chunk, telemetry=True)
                used = sum(est.update(res.observations.for_server(s))
                           for s, est in enumerate(self.estimators))
            results.append(res)
            n_obs.append(used)
            t_starts.append(chunk[0][0] if chunk else 0.0)
            if on_segment is not None:
                on_segment(k, res, self)
        return AdaptiveResult(tuple(results), tuple(n_obs), tuple(t_starts))
