"""Telemetry and online D-matrix estimation: the observe -> estimate ->
schedule loop (counterpart of ``repro.telemetry``).

  observe   ``engine_torch.run_trace(..., telemetry=True)`` accumulates
            per-arrival telemetry integrals; ``log.observations_from_trace``
            lifts them to per-completion records (type, co-residency, rate),
            ``log.rows_from_trace`` to the device stream's validity-masked
            ``RingBlock`` rows, which an ``ObservationRing`` holds.
  estimate  ``estimator.StreamingEstimator`` recovers per-type base rates and
            the pairwise D-matrix in log-slowdown space, with per-pair
            confidence counts and prior fallback: ``update`` from a log,
            ``update_device`` from a block; ``EstimatorBank`` updates m
            servers' estimators in one fused step. Their pair-statistic
            scatter is the CUDA kernel ``kernels.telemetry`` (the contract
            entry for ``update``, the banked entry for the stream).
  schedule  ``core.engine.AdaptiveEngine`` alternates trace segments with
            estimator refreshes, placing from *estimated* dynamics while the
            simulator stays ground truth (``stream=True``: through the ring
            and the bank).
  drift     ``drift`` builds the non-stationary worlds the loop must track.
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
from .estimator import (DeviceEstimatorState, EstimatorBank, StreamingEstimator,
                        make_scatter)
from .log import (ObservationLog, ObservationRing, RingBlock, block_from_log,
                  observations_from_trace, ring_write_masked, rows_from_trace)

__all__ = [
    "DeviceEstimatorState",
    "DriftEvent",
    "DriftSchedule",
    "EstimatorBank",
    "ObservationLog",
    "ObservationRing",
    "RingBlock",
    "StreamingEstimator",
    "block_from_log",
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
    "ring_write_masked",
    "rows_from_trace",
    "scale_perf",
    "stochastic_congestion",
]
