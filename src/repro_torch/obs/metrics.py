"""Device-resident metrics plane: counters, gauges, histograms in the loop.

Counterpart of ``repro/obs/metrics.py``. The device-resident engine keeps
the host out of the hot path, so nothing host-side can watch the loop run:
a :class:`MetricFrame` is a small fixed-shape tuple of tensors (integer
counters, high-water gauges, log-spaced histograms and a per-server block)
that the event loop updates in place inside its blocks of micro-events --
behind a ``metrics=`` flag -- and that is read out once, at the end of a run.

Slots are named at import and indexed at run time: the registry tuples
below map metric names to fixed indices, so every record op is a
fixed-index add/max/scatter -- no strings, no data-dependent shapes, no
host read.

Histograms are fixed-bin and log-spaced (``HIST_BINS`` bins between a
spec's ``lo`` and ``hi``): streaming percentile state whose merge is plain
addition. :func:`percentiles` extracts p50/p95/p99 on the host, in numpy,
by geometric interpolation inside the covering bin. Values at or below
``lo`` clamp into bin 0; values at or above ``hi`` into the last bin.

Merge semantics make frames **chunk-invariant**: counters, histograms and
the per-server block add; gauges are high-water marks and take the
elementwise max. Every weight the engines record is integer-valued and far
below 2**24, so float32 accumulation is exact in any order -- a scatter-add
gives the same bits whichever order its atomics land in, and splitting a
run into segments and merging the per-segment frames reproduces the
single-run frame bitwise.

The record ops come in two forms: ``count_`` / ``gauge_max_`` /
``observe_`` / ``add_server_`` update a frame's tensors in place (what the
event loop's captured blocks run), and ``count`` / ``gauge_max`` /
``observe`` / ``add_server`` return a new frame, as JAX's do. An increment,
value or weight may be a Python number or a tensor on the frame's device;
a masked update passes its mask as the increment or the weight.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

# Bins per histogram. Shared so the hist block is one dense [H, B] tensor.
HIST_BINS = 64


@dataclasses.dataclass(frozen=True)
class HistSpec:
    """A named log-spaced histogram: HIST_BINS bins covering [lo, hi)."""

    name: str
    lo: float
    hi: float
    desc: str = ""

    def edges(self) -> np.ndarray:
        """Bin edges, f64[HIST_BINS + 1], geometric."""
        return np.geomspace(self.lo, self.hi, HIST_BINS + 1)

    def bin_ratio(self) -> float:
        """Multiplicative width of one bin = the percentile resolution."""
        return (self.hi / self.lo) ** (1.0 / HIST_BINS)


# ---------------------------------------------------------------------------
# Slot registries. Order is the tensor index; append to add a metric.
# ---------------------------------------------------------------------------

COUNTERS: "tuple[str, ...]" = (
    "events",            # engine micro-events (one per live step)
    "arrivals",          # arrival events consumed
    "placements",        # committed placements (arrival-time + drain)
    "queued",            # arrivals sent to the §V wait queue
    "drain_steps",       # drain events scored
    "drain_placements",  # placements committed from the drain
    "drain_full_scans",  # drains that fell past the W-candidate window
    "finishes",          # workload completions
    "deadlocks",         # deadlock-flag transitions (0 -> 1)
    "segments",          # closed-loop segments observed
    "splits",            # fleet pool splits fired
    "evictions",         # fleet evictions fired
    "requeues",          # in-flight arrivals requeued after evictions
    "ring_rows",         # telemetry rows pushed into the observation ring
    "d_cols_refreshed",  # D-matrix type-columns the segment's block touched
)

# High-water marks; merge takes the elementwise max.
GAUGES: "tuple[str, ...]" = (
    "queue_peak",           # max §V queue depth over all events
    "ring_occupancy_peak",  # max rows resident in the observation ring
    "evicted_peak",         # max servers simultaneously marked dead
    "requeue_peak",         # max arrivals requeued out of one segment
)

HISTOGRAMS: "tuple[HistSpec, ...]" = (
    HistSpec("waiting_time", 1e-4, 1e4, "arrival -> placement wall time (s)"),
    HistSpec("slowdown", 1.0, 64.0, "observed duration / solo duration"),
    HistSpec("queue_depth", 0.5, 2048.0, "queued arrivals, sampled per event"),
    HistSpec("headroom", 1e-4, 1.0, "Eqn-4 margin at commit (limit - max deg)"),
    HistSpec("cusum_level", 1e-3, 64.0, "per-server CUSUM stat per segment"),
)

PER_SERVER: "tuple[str, ...]" = (
    "placements",        # commits routed to this server
    "finishes",          # completions on this server
    "floor_violations",  # events where a slot's degradation exceeded the limit
    "busy_events",       # events with at least one active slot
)

_C_IDX = {name: i for i, name in enumerate(COUNTERS)}
_G_IDX = {name: i for i, name in enumerate(GAUGES)}
_H_IDX = {spec.name: i for i, spec in enumerate(HISTOGRAMS)}
_S_IDX = {name: i for i, name in enumerate(PER_SERVER)}


class MetricFrame(NamedTuple):
    """Fixed-shape metric state: four dense tensors on one device.

    counters    i32[len(COUNTERS)]              merge: add (exact)
    gauges      f32[len(GAUGES)]                merge: elementwise max
    hist        f32[len(HISTOGRAMS), HIST_BINS] merge: add (bit-exact for
                                                integer weights < 2**24)
    per_server  f32[m, len(PER_SERVER)]         merge: add
    """

    counters: torch.Tensor
    gauges: torch.Tensor
    hist: torch.Tensor
    per_server: torch.Tensor

    @property
    def m(self) -> int:
        return int(self.per_server.shape[0])


def zeros(m: int, device: str | torch.device = "cpu") -> MetricFrame:
    """An empty frame for an m-server fleet on ``device``.

    Gauges start at ``-inf``, not 0: a high-water mark of 0 is a legitimate
    reading (e.g. requeue_peak on a run with no evictions), and the
    sentinel keeps "never set" distinguishable from "peak was zero"
    (``gauge_set``). ``-inf`` is the identity of max, so ``gauge_max`` and
    ``merge`` need no special cases.
    """
    f32 = dict(dtype=torch.float32, device=device)
    return MetricFrame(
        counters=torch.zeros((len(COUNTERS),), dtype=torch.int32, device=device),
        gauges=torch.full((len(GAUGES),), -torch.inf, **f32),
        hist=torch.zeros((len(HISTOGRAMS), HIST_BINS), **f32),
        per_server=torch.zeros((m, len(PER_SERVER)), **f32),
    )


def reset_(frame: MetricFrame) -> MetricFrame:
    """Every tensor of ``frame`` back to :func:`zeros`' values, in place."""
    frame.counters.zero_()
    frame.gauges.fill_(-torch.inf)
    frame.hist.zero_()
    frame.per_server.zero_()
    return frame


def clone(frame: MetricFrame) -> MetricFrame:
    return MetricFrame(*(t.clone() for t in frame))


# ---------------------------------------------------------------------------
# Record ops, in place -- safe inside a captured block (no host read).
# ---------------------------------------------------------------------------

def count_(frame: MetricFrame, name: str, inc=1) -> MetricFrame:
    """counters[name] += inc (a Python int or a 0-d int/bool tensor)."""
    slot = frame.counters.narrow(0, _C_IDX[name], 1)
    slot.add_(inc.to(torch.int32) if torch.is_tensor(inc) else int(inc))
    return frame


def gauge_max_(frame: MetricFrame, name: str, value) -> MetricFrame:
    """gauges[name] = max(gauges[name], value) -- a high-water mark."""
    slot = frame.gauges.narrow(0, _G_IDX[name], 1)
    if torch.is_tensor(value):
        torch.maximum(slot, value.to(torch.float32).reshape(1), out=slot)
    else:
        slot.clamp_(min=float(np.float32(value)))
    return frame


def _bin_of(spec: HistSpec, v: torch.Tensor) -> torch.Tensor:
    """Log-spaced bin index of each value (float32 arithmetic, as JAX's);
    clamps under/overflow, and a NaN into bin 0."""
    log_lo = math.log(spec.lo)
    scale = HIST_BINS / (math.log(spec.hi) - log_lo)
    x = torch.log(torch.clamp(v, min=float(np.float32(1e-37)))) - float(np.float32(log_lo))
    x = torch.nan_to_num(x * float(np.float32(scale)), nan=0.0)
    return torch.floor(torch.clamp(x, 0.0, HIST_BINS - 1)).long()


def observe_(frame: MetricFrame, name: str, values, weight=1.0) -> MetricFrame:
    """Scatter ``weight`` into hist[name] at each value's bin, in place.

    ``weight`` broadcasts against ``values``; a weight of 0 masks a row out
    exactly (the scatter adds 0). Integer-valued weights keep accumulation
    order-independent, hence chunk-invariant.
    """
    h = _H_IDX[name]
    dev = frame.hist.device
    v = (values.to(torch.float32) if torch.is_tensor(values)
         else torch.as_tensor(values, dtype=torch.float32, device=dev))
    v = torch.atleast_1d(v)
    w = (weight.to(torch.float32) if torch.is_tensor(weight)
         else torch.full((), float(weight), dtype=torch.float32, device=dev))
    w = torch.broadcast_to(w, v.shape).reshape(-1)
    frame.hist[h].index_add_(0, _bin_of(HISTOGRAMS[h], v).reshape(-1), w)
    return frame


def add_server_(frame: MetricFrame, name: str, values) -> MetricFrame:
    """per_server[:, name] += values (f32[m]), in place."""
    frame.per_server[:, _S_IDX[name]].add_(values.to(torch.float32))
    return frame


# ---------------------------------------------------------------------------
# Pure record ops: each returns a new frame (the input is left as it was).
# ---------------------------------------------------------------------------

def count(frame: MetricFrame, name: str, inc=1) -> MetricFrame:
    return count_(clone(frame), name, inc)


def gauge_max(frame: MetricFrame, name: str, value) -> MetricFrame:
    return gauge_max_(clone(frame), name, value)


def observe(frame: MetricFrame, name: str, values, weight=1.0) -> MetricFrame:
    return observe_(clone(frame), name, values, weight)


def add_server(frame: MetricFrame, name: str, values) -> MetricFrame:
    return add_server_(clone(frame), name, values)


def merge(a: MetricFrame, b: MetricFrame) -> MetricFrame:
    """Combine two frames; associative and commutative."""
    return MetricFrame(
        counters=a.counters + b.counters,
        gauges=torch.maximum(a.gauges, b.gauges),
        hist=a.hist + b.hist,
        per_server=a.per_server + b.per_server,
    )


# ---------------------------------------------------------------------------
# Host-side readout, in numpy.
# ---------------------------------------------------------------------------

def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def counter_value(frame: MetricFrame, name: str) -> int:
    return int(_host(frame.counters)[_C_IDX[name]])


def gauge_value(frame: MetricFrame, name: str) -> float:
    """The gauge's peak; 0.0 when it was never set (see ``gauge_set``)."""
    v = float(_host(frame.gauges)[_G_IDX[name]])
    return v if np.isfinite(v) else 0.0


def gauge_set(frame: MetricFrame, name: str) -> bool:
    """Whether the gauge recorded at least one value (its ``-inf``
    never-set sentinel has been displaced)."""
    return bool(np.isfinite(_host(frame.gauges)[_G_IDX[name]]))


def hist_counts(frame: MetricFrame, name: str) -> np.ndarray:
    """Raw bin weights, f64[HIST_BINS]."""
    return _host(frame.hist).astype(np.float64)[_H_IDX[name]]


def server_values(frame: MetricFrame, name: str) -> np.ndarray:
    """Per-server column, f64[m]."""
    return _host(frame.per_server).astype(np.float64)[:, _S_IDX[name]]


def percentiles(frame: MetricFrame, name: str,
                qs=(50.0, 95.0, 99.0)) -> np.ndarray:
    """Percentile estimates from the binned weights.

    Walks the bin CDF to the covering bin, then interpolates geometrically
    inside it -- deterministic, and within one bin ratio of the true sample
    percentile for in-range data. NaN where the histogram is empty.
    """
    spec = HISTOGRAMS[_H_IDX[name]]
    h = hist_counts(frame, name)
    total = h.sum()
    if total <= 0:
        return np.full(len(qs), np.nan)
    edges = spec.edges()
    cdf = np.cumsum(h)
    out = np.empty(len(qs))
    for k, q in enumerate(qs):
        target = (q / 100.0) * total
        b = min(int(np.searchsorted(cdf, target, side="left")), HIST_BINS - 1)
        inbin = h[b]
        below = cdf[b] - inbin
        frac = (target - below) / inbin if inbin > 0 else 0.0
        frac = min(max(frac, 0.0), 1.0)
        out[k] = edges[b] * (edges[b + 1] / edges[b]) ** frac
    return out


def snapshot(frame: MetricFrame) -> dict:
    """Flatten a frame into a JSON-serializable dict (for span logs and the
    report CLI)."""
    counters = _host(frame.counters)
    gauges = _host(frame.gauges)
    hists = {}
    for spec in HISTOGRAMS:
        h = hist_counts(frame, spec.name)
        total = float(h.sum())
        entry = {"count": total}
        if total > 0:
            p50, p95, p99 = percentiles(frame, spec.name)
            entry.update(p50=float(p50), p95=float(p95), p99=float(p99))
        hists[spec.name] = entry
    return {
        "counters": {n: int(counters[i]) for i, n in enumerate(COUNTERS)},
        "gauges": {n: (float(gauges[i]) if np.isfinite(gauges[i]) else 0.0)
                   for i, n in enumerate(GAUGES)},
        "gauges_set": {n: bool(np.isfinite(gauges[i]))
                       for i, n in enumerate(GAUGES)},
        "histograms": hists,
        "per_server": {
            n: [float(x) for x in server_values(frame, n)]
            for n in PER_SERVER},
    }
