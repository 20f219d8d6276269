"""The completion-observation log: what a production fleet actually sees.

Counterpart of the host half of ``repro/telemetry/log.py``. One record per
*completed* workload run, assembled from the per-arrival telemetry integrals
``engine_torch.run_trace`` accumulates with ``telemetry=True``:

  wtype      -- the workload's profiling-grid type (§III characterization)
  server     -- which server it ran on
  duration   -- wall-clock run time (place -> finish)
  rate       -- observed effective throughput, data_total / duration (bytes/s)
  geo_rate   -- geometric-mean throughput, exp(mean of log instantaneous
                rate): the estimator's y, which keeps its log-linear model
                exact when co-residency changes mid-run
  co_counts  -- time-*averaged* co-resident type counts over the run [T]
  lost_frac  -- fraction of the run spent while the server was past its
                physical TDP

Only quantities a real deployment can log: no solo throughputs, no pairwise
slowdowns, no cache state. The arrays are tensors on the engine's device:
float64 for the float fields, int32 for ``wtype`` and ``server``, holding
the values the JAX package computes after its float64 casts.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np
import torch

from ..device import resolve_device


@dataclasses.dataclass(frozen=True)
class ObservationLog:
    """A batch of completion observations (tensors share the leading axis)."""

    wtype: torch.Tensor  # i32[N] grid type per completed run
    server: torch.Tensor  # i32[N] server the run was placed on
    duration: torch.Tensor  # f64[N] place -> finish wall time (s)
    rate: torch.Tensor  # f64[N] observed effective throughput (bytes/s)
    geo_rate: torch.Tensor  # f64[N] geometric-mean throughput (bytes/s)
    co_counts: torch.Tensor  # f64[N, T] time-averaged co-resident type counts
    lost_frac: torch.Tensor  # f64[N] fraction of the run spent past the TDP

    def __post_init__(self):
        n = len(self.wtype)
        for f in dataclasses.fields(self):
            if len(getattr(self, f.name)) != n:
                raise ValueError(f"{f.name} length {len(getattr(self, f.name))} != {n}")

    def __len__(self) -> int:
        return len(self.wtype)

    @property
    def T(self) -> int:
        return self.co_counts.shape[1]

    @classmethod
    def empty(cls, T: int, device: str | torch.device | None = None) -> "ObservationLog":
        device = resolve_device(device)
        f64 = dict(dtype=torch.float64, device=device)
        i32 = dict(dtype=torch.int32, device=device)
        return cls(
            wtype=torch.zeros(0, **i32),
            server=torch.zeros(0, **i32),
            duration=torch.zeros(0, **f64),
            rate=torch.zeros(0, **f64),
            geo_rate=torch.zeros(0, **f64),
            co_counts=torch.zeros((0, T), **f64),
            lost_frac=torch.zeros(0, **f64),
        )

    def select(self, mask: torch.Tensor) -> "ObservationLog":
        """Subset of the log (boolean mask or index tensor)."""
        return ObservationLog(
            **{f.name: getattr(self, f.name)[mask] for f in dataclasses.fields(self)})

    def for_server(self, server: int) -> "ObservationLog":
        return self.select(self.server == server)

    @classmethod
    def merge(cls, logs: Iterable["ObservationLog"]) -> "ObservationLog":
        logs = list(logs)
        if not logs:
            raise ValueError("merge of zero logs (T unknown)")
        return cls(**{
            f.name: torch.cat([getattr(l, f.name) for l in logs])
            for f in dataclasses.fields(cls)})


def _on(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``x`` as a ``dtype`` tensor on ``device``; a host sequence goes through
    numpy first, so Python floats stay float64 on the way."""
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.asarray(x))
    return x.to(device=device, dtype=dtype)


def observations_from_trace(
    trace,
    arr_type: Sequence[int] | torch.Tensor,
    arr_bytes: Sequence[float] | torch.Tensor,
    min_duration: float = 1e-12,
) -> ObservationLog:
    """Build the log from a telemetry-enabled ``EngineTrace``.

    Never-placed or never-finished arrivals (queued at deadlock, zero-length
    runs below ``min_duration``) are dropped -- a fleet cannot observe a rate
    for work that did not complete. Order follows the trace's arrival axis.
    """
    dev = trace.place_time.device
    place = trace.place_time.to(torch.float64)
    finish = trace.finish_time.to(torch.float64)
    placement = trace.placement
    duration = finish - place
    ok = ((placement >= 0) & (place >= 0.0) & torch.isfinite(finish)
          & (duration > min_duration))

    wtype = _on(arr_type, torch.int32, dev)[ok]
    nbytes = _on(arr_bytes, torch.float64, dev)[ok]
    duration = duration[ok]
    obs_co = trace.obs_co.to(torch.float64)[ok]
    obs_lost = trace.obs_lost.to(torch.float64)[ok]
    obs_logr = trace.obs_logr.to(torch.float64)[ok]
    return ObservationLog(
        wtype=wtype,
        server=placement[ok].to(torch.int32),
        duration=duration,
        rate=nbytes / duration,
        geo_rate=torch.exp(obs_logr / duration),
        co_counts=obs_co / duration[:, None],
        lost_frac=torch.clamp(obs_lost / duration, 0.0, 1.0),
    )
