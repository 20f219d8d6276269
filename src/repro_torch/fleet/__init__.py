"""Fleet health: pooled estimation, drift detection, failure-driven eviction
(counterpart of ``repro.fleet``).

  pool        ``PooledEstimatorBank`` -- same-spec servers share one
              estimator row through a device-side server -> row map over
              the ``EstimatorBank``; splits re-route a server to its own row
              seeded with the pool posterior. ``shard_local_pools`` and
              ``resolve_leaders_device`` keep pools inside one rank of a
              sharded ``ServerAxis``.
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
from .detect import CusumState, DriftDetector, cusum_update_sharded
from .pool import PooledEstimatorBank, resolve_leaders_device, shard_local_pools

__all__ = [
    "CusumState",
    "DriftDetector",
    "FleetController",
    "HealthEvent",
    "PooledEstimatorBank",
    "cusum_update_sharded",
    "resolve_leaders_device",
    "shard_local_pools",
]
