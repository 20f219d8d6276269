"""Core library of the port: the paper's online consolidation decision.

Public API:
  Workload, grid_types, type_index, snap_to_grid, parse_workloads,
  characterize, total_bytes                       -- §III characterization
  ServerSpec, M1, M2, PAPER_CLUSTER               -- Table I testbed
  TPU_V5E_HOST, TPU_V5E_POD256, H100_HOST         -- accelerator hosts as bins
  solo_throughput, solo_throughput_grid, solo_runtime -- §III model (Fig 1-2)
  simulate_corun, competing_cache_bytes, corun_throughput_grid,
  makespan_consolidated, makespan_sequential      -- §IV ground truth (Fig 3-5)
  tdp_lhs, tdp_lhs_naive, predict_tdp_hit, predict_tdp_n,
  profile_pairwise, profile_pairwise_fast, predict_degradations,
  type_tables, pair_slowdown_matrices             -- Eqns 1-3
  check_consolidation, DEGRADATION_LIMIT          -- §V criteria (Eqns 4-5)
  PackedCluster, server_loads, score_candidates_torch, greedy_choice,
  argmin_with_margin, greedy_step, greedy_sequence -- the Fig-8 greedy on
                                                     the device
                                                     (greedy_sequence is
                                                     JAX's
                                                     greedy_sequence_jax)
  greedy_sequence_sharded, greedy_sequence_hier   -- the greedy over a
                                                     ServerAxis (sharded,
                                                     pod-hierarchical)
  counts_from_assignments, evaluate_assignment, brute_force_torch,
  local_search_torch                              -- offline packing
  ClusterState, OnlineScheduler, greedy_place, brute_force, first_fit,
  best_fit_cache, run_allocator, average_min_throughput(_simulated),
  calibrate_alpha, sweep_alpha, pick_alpha, local_search,
  local_search_engine                             -- the float64 oracle
                                                     (core.binpack,
                                                     core.scheduler,
                                                     core.calibrate,
                                                     core.refine); its
                                                     greedy_sequence, which
                                                     is repro.core's, is
                                                     reachable only as
                                                     core.binpack.greedy_sequence
  PackedDynamics, trace_segment, run_trace, corun_rates -- the event loop
  ClosedLoopConfig, run_closed_loop               -- the fused multi-segment loop
  ConsolidationEngine, EngineResult, Deadlock, make_scorer,
  score_candidates, kernel_args
                                                  -- the online runtime
  AdaptiveEngine, AdaptiveResult                  -- the observe -> estimate
                                                     -> schedule loop
  JobProfile, PodSpec, FleetState, pack_jobs, pair_degradation,
  additive_degradations, roofline_degradations,
  fleet_throughput_report                         -- (arch x shape) jobs packed
                                                     onto pods (core.cluster;
                                                     ChipSpec, TPU_V5E,
                                                     H100_SXM, h100_pod there)
"""
from .binpack_torch import (
    QUEUED,
    SCORE_MARGIN,
    PackedCluster,
    argmin_with_margin,
    avg_loads,
    brute_force_torch,
    counts_from_assignments,
    evaluate_assignment,
    greedy_choice,
    greedy_sequence,
    greedy_sequence_hier,
    greedy_sequence_sharded,
    greedy_step,
    score_candidates_torch,
    server_loads,
)
from .binpack import (
    ClusterState,
    average_min_throughput,
    average_min_throughput_simulated,
    best_fit_cache,
    brute_force,
    first_fit,
    greedy_place,
    run_allocator,
)
from .calibrate import calibrate_alpha, pick_alpha, sweep_alpha
from .cluster import (
    FleetState,
    JobProfile,
    PodSpec,
    additive_degradations,
    fleet_throughput_report,
    pack_jobs,
    pair_degradation,
    roofline_degradations,
)
from .contention import (
    additive_degradation,
    measure_pair_simulated,
    pair_slowdown_matrices,
    predict_degradations,
    predict_tdp_hit,
    predict_tdp_n,
    profile_pairwise,
    profile_pairwise_fast,
    tdp_lhs,
    tdp_lhs_naive,
    type_tables,
)
from .criteria import DEGRADATION_LIMIT, AdmissionCheck, check_consolidation
from .engine import (AdaptiveEngine, AdaptiveResult, ConsolidationEngine, Deadlock,
                     EngineResult, kernel_args, make_scorer, score_candidates)
from .engine_torch import (EngineTrace, LoopStats, PackedDynamics, corun_rates,
                           local_search_torch, run_trace, trace_segment)
from .refine import local_search, local_search_engine
from .scheduler import OnlineScheduler, ScheduleResult
from .server import H100_HOST, M1, M2, PAPER_CLUSTER, TPU_V5E_HOST, TPU_V5E_POD256, ServerSpec
from .simulator import (
    CoRunResult,
    cache_overflow,
    competing_cache_bytes,
    corun_throughput_grid,
    makespan_consolidated,
    makespan_sequential,
    simulate_corun,
)
from .throughput import solo_runtime, solo_throughput, solo_throughput_grid
from .workload import (
    FS_GRID,
    RS_GRID,
    Workload,
    characterize,
    grid_types,
    parse_workloads,
    snap_to_grid,
    total_bytes,
    type_index,
)


def __getattr__(name: str):
    """``ClosedLoopConfig`` and ``run_closed_loop`` load on first use: the
    fused loop imports the fleet plane, which imports this package."""
    if name in ("ClosedLoopConfig", "run_closed_loop"):
        from . import closed_loop
        return getattr(closed_loop, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
