"""Telemetry and online D-matrix estimation: the observe -> estimate ->
schedule loop (counterpart of ``repro.telemetry``, host-alternating half).

  observe   ``engine_torch.run_trace(..., telemetry=True)`` accumulates
            per-arrival telemetry integrals; ``log.observations_from_trace``
            lifts them to per-completion records (type, co-residency, rate).
  estimate  ``estimator.StreamingEstimator`` recovers per-type base rates and
            the pairwise D-matrix in log-slowdown space, with per-pair
            confidence counts and prior fallback. Its pair-statistic scatter
            is the CUDA kernel ``kernels.telemetry.pair_scatter``.
  schedule  ``core.engine.AdaptiveEngine`` alternates trace segments with
            estimator refreshes, placing from *estimated* dynamics while the
            simulator stays ground truth.
  drift     ``drift`` builds the non-stationary worlds the loop must track.

The device-resident stream (``RingBlock``, ``ObservationRing``,
``DeviceEstimatorState``, ``EstimatorBank``, ``update_device``) is not
ported yet.
"""
from .drift import (
    DriftEvent,
    DriftSchedule,
    congest_server,
    congestion_at,
    decayed_spec,
    degradation_at,
    degrade_server,
    gradual_decay,
    merge_schedules,
    perturb_spec,
    scale_perf,
    stochastic_congestion,
)
from .estimator import StreamingEstimator, make_scatter
from .log import ObservationLog, observations_from_trace

__all__ = [
    "DriftEvent",
    "DriftSchedule",
    "ObservationLog",
    "StreamingEstimator",
    "congest_server",
    "congestion_at",
    "decayed_spec",
    "degradation_at",
    "degrade_server",
    "gradual_decay",
    "make_scatter",
    "merge_schedules",
    "observations_from_trace",
    "perturb_spec",
    "scale_perf",
    "stochastic_congestion",
]
