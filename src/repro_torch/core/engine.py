"""ConsolidationEngine: the front end of the port's online consolidation runtime.

Counterpart of ``repro/core/engine.py``. ``ConsolidationEngine.run`` takes an
arrival trace [(time, workload)] through the paper's online operating model
(arrive -> score -> place-or-queue -> run -> complete -> drain, §V/§VIII) on
the ``engine_torch.run_trace`` loop. The runtime is PyTorch only; the
float64 oracle (``OnlineScheduler``) stays in the JAX package as the
reference the tests hold this engine to.

Candidate scoring goes through the shared (counts, wtypes) ->
(cache_after, maxd_after) interface, provided by

  scorer='cuda'   the hand-written CUDA kernel (``kernels.consolidation``),
                  the default; on CPU tensors its plain PyTorch version runs;
  scorer='torch'  the loop's incremental evaluation from its maintained sums
                  (``binpack_torch.score_candidates_torch`` outside the loop).
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.consolidation import consolidation_scores
from .binpack_torch import PackedCluster, score_candidates_torch
from .contention import profile_pairwise_fast
from .engine_torch import QUEUED, LoopStats, PackedDynamics, Scorer, run_trace
from .server import ServerSpec
from .workload import Workload, type_index

ScorerName = Literal["cuda", "torch"]


def kernel_args(cluster: PackedCluster, counts: torch.Tensor, wtypes: torch.Tensor) -> tuple:
    """The scorer kernel's inputs for ``cluster``: (counts, D, rs, fs_resident,
    llc_budget, wtypes as int32 [Q])."""
    return (counts, cluster.D, cluster.rs, cluster.resident * cluster.fs[None, :],
            cluster.llc_budget, torch.atleast_1d(wtypes).to(torch.int32))


def make_scorer(backend: ScorerName = "cuda") -> Scorer:
    """Resolve a scoring-backend name to the shared-interface callable."""
    if backend == "torch":
        return score_candidates_torch
    if backend == "cuda":
        return lambda cluster, counts, wtypes: consolidation_scores(
            *kernel_args(cluster, counts, wtypes))
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

    @property
    def queued_indices(self) -> tuple[int, ...]:
        return tuple(i for i, q in enumerate(self.was_queued) if q)


class ConsolidationEngine:
    """The online consolidation runtime on one device (see module docstring).

    ``device=None`` means the card and raises without one; pass
    ``device='cpu'`` to run on the CPU. ``scorer`` is a backend name or a
    callable with the shared scoring signature.
    """

    def __init__(
        self,
        servers: Sequence[ServerSpec],
        D: Sequence[np.ndarray] | np.ndarray | None = None,
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
        elif isinstance(D, np.ndarray):
            D = [D] * len(self.servers)
        self.D = list(D)
        self.alpha = alpha
        self.objective = objective
        self.scorer = scorer
        self._active: np.ndarray | None = (  # fleet-health placement mask
            None if active is None else np.asarray(active, bool))
        self.cluster = self._build_cluster()
        self._dyn: PackedDynamics | None = None

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
        D: Sequence[np.ndarray] | np.ndarray,
        active: Sequence[bool] | np.ndarray | None = None,
    ) -> None:
        """Swap the scoring D-matrices, rebuilding only the PackedCluster (the
        ground-truth ``PackedDynamics`` keys on server specs, not D).
        ``active`` optionally swaps the placement mask in the same build."""
        if active is not None:
            self._active = self._check_mask(active)
        if isinstance(D, np.ndarray):
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
        telemetry: bool = False,
        metrics: bool = False,
        record: bool = False,
    ) -> EngineResult:
        """Simulate arrivals [(time, workload)] to completion of all work.

        Workloads are snapped to the profiling grid (as the paper's scheduler
        snaps every candidate for its D-matrix lookup); ``data_total`` is
        honoured per arrival. Raises ``RuntimeError`` on deadlock (a queued
        workload no *empty* server can take), like the oracle. The JAX
        engine's ``telemetry``, ``metrics`` and ``record`` outputs are not
        ported yet and raise ``NotImplementedError``.
        """
        for flag, name in ((telemetry, "telemetry"), (metrics, "metrics"),
                           (record, "record")):
            if flag:
                raise NotImplementedError(f"run({name}=...) is not ported yet")
        if not arrivals:
            return EngineResult((), (), (), (), 0.0, 0.0, "torch")
        return self._run_torch(arrivals)

    def _run_torch(self, arrivals: Sequence[tuple[float, Workload]]) -> EngineResult:
        n = len(arrivals)
        times = np.asarray([t for t, _ in arrivals], np.float64)
        order = np.argsort(times, kind="stable")
        # normalize to the first arrival before the f32 cast: absolute
        # epoch-scale timestamps would otherwise collapse below f32 resolution
        t0 = float(times.min())
        dev = self.device
        arr_time = torch.from_numpy((times[order] - t0).astype(np.float32)).to(dev)
        arr_type = torch.tensor([type_index(arrivals[i][1]) for i in order],
                                dtype=torch.int32, device=dev)
        arr_bytes = torch.from_numpy(np.asarray(
            [arrivals[i][1].data_total for i in order], np.float32)).to(dev)

        # scorer='torch' -> None: run_trace's incremental evaluation of the
        # same contract from its maintained sums; the others score each
        # candidate batch through the shared interface
        if callable(self.scorer):
            scorer = self.scorer
        else:
            scorer = None if self.scorer == "torch" else make_scorer(self.scorer)
        trace = run_trace(self.cluster, self.dyn, arr_time, arr_type, arr_bytes,
                          objective=self.objective, scorer=scorer)
        if bool(trace.deadlock):
            raise RuntimeError("deadlock: queued workloads fit no empty server")

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
        )
