"""Core library of the port: the paper's online consolidation decision.

Public API:
  Workload, grid_types, type_index, snap_to_grid  -- §III characterization
  ServerSpec, M1, M2, PAPER_CLUSTER               -- Table I testbed
  TPU_V5E_HOST, H100_HOST                         -- accelerator hosts as bins
  profile_pairwise_fast, type_tables, pair_slowdown_matrices -- Eqns 1-3
  PackedCluster, server_loads, score_candidates_torch, greedy_choice,
  argmin_with_margin, greedy_step, greedy_sequence -- the Fig-8 greedy
  greedy_sequence_sharded, greedy_sequence_hier   -- the greedy over a
                                                     ServerAxis (sharded,
                                                     pod-hierarchical)
  counts_from_assignments, evaluate_assignment, brute_force_torch,
  local_search_torch                              -- offline packing
  ClusterState, OnlineScheduler                   -- the float64 oracle
                                                     (core.binpack,
                                                     core.scheduler)
  PackedDynamics, trace_segment, run_trace, corun_rates -- the event loop
  ConsolidationEngine, EngineResult, Deadlock, make_scorer,
  score_candidates, kernel_args
                                                  -- the online runtime
  AdaptiveEngine, AdaptiveResult                  -- the observe -> estimate
                                                     -> schedule loop
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
from .binpack import ClusterState
from .contention import pair_slowdown_matrices, profile_pairwise_fast, type_tables
from .engine import (AdaptiveEngine, AdaptiveResult, ConsolidationEngine, Deadlock,
                     EngineResult, kernel_args, make_scorer, score_candidates)
from .engine_torch import (EngineTrace, LoopStats, PackedDynamics, corun_rates,
                           local_search_torch, run_trace, trace_segment)
from .scheduler import OnlineScheduler
from .server import H100_HOST, M1, M2, PAPER_CLUSTER, TPU_V5E_HOST, ServerSpec
from .workload import FS_GRID, RS_GRID, Workload, grid_types, snap_to_grid, type_index
