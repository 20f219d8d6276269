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
slowdowns, no cache state.

Two representations of the same stream live here:

* :class:`ObservationLog` -- one row per *completed* run, filtered at
  construction; tensors on the engine's device, float64 for the float
  fields and int32 for ``wtype`` and ``server``, holding the values the JAX
  package computes after its float64 casts. The host-alternating
  estimator path consumes it.
* :class:`RingBlock` rows in an :class:`ObservationRing` -- the device-
  resident stream (counterpart of the JAX package's): rows keep the
  trace's fixed shape in float32 and carry a **validity mask** instead of
  being filtered, so the observe -> estimate path reads nothing back to the
  host (``StreamingEstimator.update_device``, ``EstimatorBank``).
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, NamedTuple, Sequence

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


# --- the device-resident stream ----------------------------------------------

class RingBlock(NamedTuple):
    """One fixed-shape block of observation rows on the device.

    The device twin of an :class:`ObservationLog` batch: the same per-run
    quantities in float32, but invalid rows (never placed, never finished,
    zero-length) stay in place with ``valid`` false instead of being
    filtered, so every tensor keeps the trace's shape. ``y`` is the
    estimator's regressand ``log(geo_rate)``.

    Storage is packed into three tensors (the integer fields, the scalar
    float fields, the co-residency matrix); the named accessors are column
    views. The scalars carry two columns derived from ``co`` at the row's
    birth -- its row sum and squared row norm -- so no estimator refresh
    passes over the [n, T] matrix for them again.
    """

    ints: torch.Tensor  # i32[n, 2]: (wtype, server); -1 on invalid rows
    scalars: torch.Tensor  # f32[n, 6]: (duration, y, lost_frac, valid, co_sum, co_sq)
    co: torch.Tensor  # f32[n, T] time-averaged co-resident type counts

    # tuple semantics (three fields) stay intact: the row count is a property
    rows = property(lambda s: int(s.ints.shape[0]))

    @property
    def T(self) -> int:
        return int(self.co.shape[1])

    wtype = property(lambda s: s.ints[:, 0])  # grid type per row
    server = property(lambda s: s.ints[:, 1])  # placement server
    duration = property(lambda s: s.scalars[:, 0])  # place -> finish wall time
    y = property(lambda s: s.scalars[:, 1])  # log geometric-mean throughput
    lost_frac = property(lambda s: s.scalars[:, 2])  # run fraction past the TDP
    valid = property(lambda s: s.scalars[:, 3] > 0.5)  # row is a real observation
    co_sum = property(lambda s: s.scalars[:, 4])  # total co-resident exposure
    co_sq = property(lambda s: s.scalars[:, 5])  # squared norm of the co row

    @classmethod
    def build(cls, wtype, server, duration, y, co, lost_frac, valid) -> "RingBlock":
        """Pack per-field tensors or host arrays into the stored layout, on
        ``co``'s device when it is a tensor, else on the card."""
        dev = co.device if torch.is_tensor(co) else resolve_device(None)
        f32, i32 = torch.float32, torch.int32
        co = _on(co, f32, dev)
        return cls(
            ints=torch.stack([_on(wtype, i32, dev), _on(server, i32, dev)], dim=1),
            scalars=torch.stack([_on(duration, f32, dev), _on(y, f32, dev),
                                 _on(lost_frac, f32, dev), _on(valid, f32, dev),
                                 co.sum(dim=1), (co * co).sum(dim=1)], dim=1),
            co=co.contiguous(),
        )


def rows_from_trace(trace, arr_type: Sequence[int] | torch.Tensor,
                    min_duration: float = 1e-12) -> RingBlock:
    """Device-side :func:`observations_from_trace`: trace -> masked rows.

    The same completion semantics (never-placed, never-finished and sub-
    ``min_duration`` runs are not observations), expressed as a validity
    mask over the trace's arrival axis instead of filtering, in the trace's
    float32, so the block never leaves the device and nothing is read back.
    """
    dev = trace.place_time.device
    place, finish = trace.place_time, trace.finish_time
    duration = finish - place
    ok = ((trace.placement >= 0) & (place >= 0.0) & torch.isfinite(finish)
          & (duration > min_duration))
    dur = torch.where(ok, duration, torch.ones_like(duration))  # dummy divisor
    minus1 = torch.full_like(trace.placement, -1, dtype=torch.int32)
    return RingBlock.build(
        wtype=torch.where(ok, _on(arr_type, torch.int32, dev), minus1),
        server=torch.where(ok, trace.placement.to(torch.int32), minus1),
        duration=torch.where(ok, duration, torch.zeros_like(duration)),
        y=trace.obs_logr / dur,
        co=trace.obs_co / dur[:, None],
        lost_frac=torch.clamp(trace.obs_lost / dur, 0.0, 1.0),
        valid=ok,
    )


def ring_write_masked(buf: RingBlock, block: RingBlock, ptr: torch.Tensor,
                      n_valid: int | torch.Tensor) -> RingBlock:
    """Masked modular ring write with a traced row count: rows [0, n_valid)
    of ``block`` land at [ptr, ptr + n_valid) mod capacity and the rest are
    dropped (JAX's ``_ring_write_masked``, whose scatter drops out-of-bounds
    rows). ``ptr`` and ``n_valid`` may be device scalars: nothing is read
    back to the host. Returns new ring tensors (the fused closed loop's
    carry), each written through one extra dump row that is sliced away;
    ``n_valid`` must not exceed the capacity."""
    cap = buf.ints.shape[0]
    n = block.ints.shape[0]
    i = torch.arange(n, dtype=torch.int64, device=buf.co.device)
    idx = torch.where(i < n_valid, (ptr + i) % cap, cap)
    out = []
    for b, v in zip(buf, block):
        ext = torch.cat([b, b[:1]])  # row ``cap`` takes the dropped rows
        ext.index_copy_(0, idx, v.to(b.dtype))
        out.append(ext[:cap])
    return RingBlock(*out)


class ObservationRing:
    """Fixed-capacity ring of observation rows on the device.

    Completion telemetry accumulates here across traces as fixed-shape
    :class:`RingBlock` rows -- validity mask included, no filtering -- and
    the estimators consume blocks (or ring windows) without forming an
    :class:`ObservationLog`. Capacity is spent in trace rows, valid or not;
    once full, the oldest rows are overwritten. Pushes write the ring's
    tensors in place.
    """

    def __init__(self, capacity: int, T: int, *,
                 device: str | torch.device | None = None):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive (got {capacity})")
        dev = resolve_device(device)
        self.capacity = int(capacity)
        self._buf = RingBlock(
            ints=torch.full((capacity, 2), -1, dtype=torch.int32, device=dev),
            scalars=torch.zeros((capacity, 6), dtype=torch.float32, device=dev),
            co=torch.zeros((capacity, T), dtype=torch.float32, device=dev),
        )
        self.ptr = 0  # next write slot
        self.total = 0  # rows ever pushed (valid or not)

    @property
    def T(self) -> int:
        return self._buf.T

    @property
    def device(self) -> torch.device:
        return self._buf.co.device

    def __len__(self) -> int:
        """Rows currently held (slots written at least once)."""
        return min(self.total, self.capacity)

    def push(self, block: RingBlock) -> RingBlock:
        """Append one block of rows; returns the block as written.

        A block longer than the ring keeps only its newest ``capacity`` rows
        (the older ones would be overwritten within the same push).
        """
        n = block.rows
        if n == 0:
            return block
        if n > self.capacity:
            block = RingBlock(*(a[n - self.capacity:] for a in block))
            n = self.capacity
        if self.ptr + n <= self.capacity:  # contiguous: one slice write each
            for buf, v in zip(self._buf, block):
                buf[self.ptr:self.ptr + n] = v
        else:
            idx = (self.ptr + torch.arange(n, device=self.device)) % self.capacity
            for buf, v in zip(self._buf, block):
                buf.index_copy_(0, idx, v.to(buf.dtype))
        self.ptr = (self.ptr + n) % self.capacity
        self.total += n
        return block

    def push_trace(self, trace, arr_type: Sequence[int] | torch.Tensor,
                   min_duration: float = 1e-12) -> RingBlock:
        """Fold one telemetry-enabled ``EngineTrace`` into the ring."""
        return self.push(rows_from_trace(trace, arr_type, min_duration))

    def view(self) -> RingBlock:
        """The ring's full contents as one masked block. Never-written slots
        carry ``valid`` false (and type -1), so any masked consumer takes the
        view at any fill level. The view shares the ring's tensors: a later
        push overwrites its rows, so consume (or clone) it first."""
        return self._buf

    def host_log(self) -> ObservationLog:
        """:class:`ObservationLog` of the currently valid rows (a debugging
        and test view, on the ring's device). ``rate`` mirrors ``geo_rate``:
        the ring keeps no byte totals, and the estimator never reads the
        arithmetic rate."""
        ints, scalars = self._buf.ints, self._buf.scalars.to(torch.float64)
        valid = scalars[:, 3] > 0.5
        geo = torch.exp(scalars[valid, 1])
        return ObservationLog(
            wtype=ints[valid, 0].clone(),
            server=ints[valid, 1].clone(),
            duration=scalars[valid, 0],
            rate=geo,
            geo_rate=geo.clone(),
            co_counts=self._buf.co.to(torch.float64)[valid],
            lost_frac=scalars[valid, 2],
        )


def block_from_log(obs: ObservationLog) -> RingBlock:
    """Lift an :class:`ObservationLog` to a block (every row valid), on the
    log's device: the device estimator path consumes it as it consumes
    trace-born blocks. ``y`` is taken in float64 and rounded once, as the
    JAX package does."""
    dev = obs.co_counts.device
    return RingBlock.build(
        wtype=obs.wtype,
        server=obs.server,
        duration=obs.duration.to(torch.float32),
        y=torch.log(obs.geo_rate.to(torch.float64)).to(torch.float32),
        co=obs.co_counts.to(torch.float32),
        lost_frac=obs.lost_frac.to(torch.float32),
        valid=torch.ones(len(obs), dtype=torch.float32, device=dev),
    )
