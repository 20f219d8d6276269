"""Fleet health: pooled estimation, drift detection, failure-driven eviction
(counterpart of ``repro.fleet``).

  pool        ``PooledEstimatorBank`` -- same-spec servers share one
              estimator row through a device-side server -> row map over
              the ``EstimatorBank``; splits re-route a server to its own row
              seeded with the pool posterior.
  detect      ``DriftDetector`` -- a chunk-invariant CUSUM over each
              server's residual stream against its pool's model, plus an
              exposure-weighted residual level for failure detection; the
              fold is the hand-written CUDA kernel ``kernels.cusum``.
  controller  ``FleetController`` -- consumes each segment's telemetry
              block, applies splits and evicts failing servers (placement
              mask, pool routing dropped, ``HeartbeatMonitor.mark_dead`` and
              ``plan_elastic_remesh`` notified, in-flight work requeued by
              ``AdaptiveEngine``); ``fleet_step`` is the same policy on the
              device for the fused closed loop, its action loops the
              hand-written CUDA kernel ``kernels.fleet_actions``.

Driven end to end by ``AdaptiveEngine(fleet=FleetController(...))``.
"""
from .controller import FleetController, HealthEvent
from .detect import CusumState, DriftDetector
from .pool import PooledEstimatorBank

__all__ = [
    "CusumState",
    "DriftDetector",
    "FleetController",
    "HealthEvent",
    "PooledEstimatorBank",
]
