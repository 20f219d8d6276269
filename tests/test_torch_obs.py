"""Port: the metrics plane (``repro_torch.obs.metrics``) against ``repro.obs``.

The frame ops on the same seeded inputs give JAX's frames bit for bit;
``percentiles`` land within 1.5 log-bin widths of ``numpy.percentile``;
chunked merges are bitwise invariant for counters and histograms, and the
``queue_peak`` gauge is the largest chunk length (``tests/test_obs.py::
test_merge_chunk_invariance`` compares it with n instead and fails by
construction; ROADMAP item 7). In the event loop, ``metrics=True`` gives
JAX's counters, gauges and per-server columns exactly, its histogram bins
exactly but for values within a few float32 ulps of a bin edge (the port's
clock matches JAX's to a few ulps), the same decisions as a run without the
flag, and with the flag off the micro-event runs the operations it ran
before the plane existed. The adaptive loop's frame matches JAX's on both
paths, its closed-loop counters bit-matching the health events.
"""
import collections
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.random import default_rng
from torch.utils._python_dispatch import TorchDispatchMode

from _hyp import given, settings, st
from repro.configs.base import MeshConfig
from repro.core import M1, AdaptiveEngine
from repro.core import run_trace as jax_run_trace
from repro.core.engine_jax import _trace_segment as jax_trace_segment
from repro.fleet import FleetController as JaxController
from repro.obs import metrics as JM
from repro.obs.report import snapshot_records as jax_snapshot_records
from repro.telemetry import gradual_decay
from repro_torch.configs import MeshConfig as TMesh
from repro_torch.core import M1 as TM1
from repro_torch.core import AdaptiveEngine as TorchAdaptive
from repro_torch.core import engine_torch, make_scorer, run_trace
from repro_torch.core.engine_torch import trace_segment
from repro_torch.fleet import FleetController
from repro_torch.obs import metrics as M
from repro_torch.obs.report import render_report, snapshot_records
from repro_torch.telemetry import gradual_decay as tgradual_decay
from test_closed_loop import _replay, _segment
from test_torch_engine import one_intra_op_thread  # noqa: F401  -- autouse
from test_torch_event_loop import _case

#: a histogram value this close to a bin edge (in float32 ulps of the edge)
#: may land in the neighbouring bin: the port's clock and JAX's agree to a
#: few ulps (ROADMAP Queue 3)
EDGE_ULPS = 4


def _frames_equal(got: M.MetricFrame, want) -> None:
    for name, a, b in zip(M.MetricFrame._fields, got, want):
        assert np.array_equal(a.numpy(), np.asarray(b)), name


# -- the frame ops ------------------------------------------------------------

def test_frame_ops_equal_jax():
    """Every op on the same seeded inputs, integer weights and masks among
    them, values out of range, zero and inf: JAX's frame bit for bit, and
    the pure ops leave their input as it was."""
    rng = default_rng(0)
    j, t = JM.zeros(3), M.zeros(3)
    for k, spec in enumerate(M.HISTOGRAMS):
        vals = np.exp(rng.uniform(np.log(spec.lo / 100), np.log(spec.hi * 100), 257))
        vals = np.concatenate([vals, [0.0, np.inf, spec.lo, spec.hi]]).astype(np.float32)
        w = rng.integers(0, 3, vals.shape).astype(np.float32)
        j = JM.observe(j, spec.name, vals, weight=w)
        before = t.hist.clone()
        t2 = M.observe(t, spec.name, torch.from_numpy(vals), weight=torch.from_numpy(w))
        assert torch.equal(t.hist, before)
        t = M.observe(t2, spec.name, vals[:5])  # numpy values, a scalar weight
        j = JM.observe(j, spec.name, vals[:5])
    for name, inc in (("events", 7), ("queued", 2), ("events", 1)):
        j, t = JM.count(j, name, inc), M.count(t, name, torch.tensor(inc, dtype=torch.int32))
    j, t = JM.count(j, "splits", True), M.count(t, "splits", torch.tensor(True))
    for name, v in (("queue_peak", 3.0), ("queue_peak", 1.0), ("requeue_peak", 0.0)):
        j, t = JM.gauge_max(j, name, v), M.gauge_max(t, name, torch.tensor(v))
    j, t = JM.gauge_max(j, "evicted_peak", 2.5), M.gauge_max(t, "evicted_peak", 2.5)
    col = np.array([1.0, 0.0, 2.0], np.float32)
    j, t = JM.add_server(j, "busy_events", col), M.add_server(t, "busy_events",
                                                              torch.from_numpy(col))
    _frames_equal(t, j)
    _frames_equal(M.merge(t, M.zeros(3)), JM.merge(j, JM.zeros(3)))
    _frames_equal(M.merge(t, t), JM.merge(j, j))
    assert M.snapshot(t) == JM.snapshot(j)
    assert snapshot_records(t) == jax_snapshot_records(j)
    assert not M.gauge_set(t, "ring_occupancy_peak") and M.gauge_set(t, "requeue_peak")


@pytest.mark.parametrize("spec", M.HISTOGRAMS, ids=lambda s: s.name)
def test_percentiles_match_numpy_and_jax(spec):
    rng = default_rng(0)
    lo, hi = spec.lo * spec.bin_ratio(), spec.hi / spec.bin_ratio()
    vals = np.exp(rng.uniform(np.log(lo), np.log(hi), size=4096)).astype(np.float32)
    frame = M.observe(M.zeros(1), spec.name, vals)
    est = M.percentiles(frame, spec.name, (50.0, 95.0, 99.0))
    ref = np.percentile(vals.astype(np.float64), [50.0, 95.0, 99.0])
    tol = 1.5 * np.log(spec.bin_ratio())
    np.testing.assert_array_less(np.abs(np.log(est) - np.log(ref)), tol)
    want = JM.percentiles(JM.observe(JM.zeros(1), spec.name, vals), spec.name)
    assert np.array_equal(est, want)
    assert np.isnan(M.percentiles(M.zeros(1), spec.name)).all()


def test_observe_clips_out_of_range():
    spec = M.HISTOGRAMS[0]
    vals = np.array([0.0, spec.lo / 10, spec.hi * 10, np.inf, np.nan], np.float32)
    counts = M.hist_counts(M.observe(M.zeros(1), spec.name, vals), spec.name)
    assert counts.sum() == len(vals)
    assert counts[0] == 3 and counts[-1] == 2  # under (and NaN) -> first, over -> last


@settings(max_examples=10, deadline=None)
@given(st.integers(min_value=0, max_value=10_000), st.integers(1, 12), st.integers(1, 400))
def test_merge_chunk_invariance(seed, chunks, n):
    """Any chunking merges to the bit-identical counters and histogram bins;
    the ``queue_peak`` high-water mark of the merge is the largest chunk's
    length, which is what each chunk recorded."""
    rng = default_rng(seed)
    spec = M.HISTOGRAMS[seed % len(M.HISTOGRAMS)]
    vals = np.exp(rng.uniform(np.log(spec.lo / 10), np.log(spec.hi * 10),
                              size=n)).astype(np.float32)
    whole = M.observe(M.zeros(2), spec.name, vals)
    whole = M.count(whole, "events", n)
    parts, peak = M.zeros(2), 0
    for chunk in np.array_split(vals, chunks):
        part = M.observe(M.zeros(2), spec.name, chunk)
        part = M.count(part, "events", len(chunk))
        part = M.gauge_max(part, "queue_peak", float(len(chunk)))
        parts = M.merge(parts, part)
        peak = max(peak, len(chunk))
    for field in ("counters", "hist"):
        assert torch.equal(getattr(whole, field), getattr(parts, field))
    assert M.gauge_value(parts, "queue_peak") == float(peak)


# -- the event loop -------------------------------------------------------------

def _edge_hits(spec: M.HistSpec, raw: np.ndarray) -> int:
    """Values within EDGE_ULPS float32 ulps of one of ``spec``'s bin edges."""
    edges = spec.edges()
    ulp = np.spacing(edges.astype(np.float32)).astype(np.float64)
    gap = np.abs(raw.astype(np.float64)[:, None] - edges[None, :])
    return int((gap <= EDGE_ULPS * ulp[None, :]).any(1).sum())


def _assert_hists(got: M.MetricFrame, want, raw: dict) -> dict:
    """Histogram bins equal; where they differ, only by values that lie at a
    bin edge (``raw``: the port's own recorded values per histogram). Returns
    the number of edge values per histogram (printed, for the log)."""
    hits = {}
    for spec in M.HISTOGRAMS:
        g, w = M.hist_counts(got, spec.name), JM.hist_counts(want, spec.name)
        assert g.sum() == w.sum(), spec.name
        hits[spec.name] = _edge_hits(spec, raw[spec.name]) if spec.name in raw else 0
        drift = np.abs(np.cumsum(g) - np.cumsum(w)).max()
        assert drift <= hits[spec.name], (spec.name, g, w)
    print("histogram values within", EDGE_ULPS, "ulps of a bin edge:", hits)
    return hits


def _raw(case_arrays, trace, dyn_solo) -> dict:
    """The port's recorded values, recomputed on the host in float32 as the
    loop computes them: waiting time and headroom from the decision ring,
    slowdown from the trace's times."""
    t, ty, by = case_arrays
    ints = trace.rec.block.ints.numpy()[: int(trace.rec.total)]
    fl = trace.rec.block.floats.numpy()[: int(trace.rec.total)]
    placed = ints[:, 2] >= 0
    arr = ints[placed, 0]
    waiting = fl[placed, 0] - t[arr]
    place = trace.placement.numpy()
    done = np.isfinite(trace.finish_time.numpy()) & (place >= 0)
    i = np.flatnonzero(done)
    solo = dyn_solo[place[i], ty[i]]
    solo_dur = by[i] / solo
    actual = trace.finish_time.numpy()[i] - trace.place_time.numpy()[i]
    return {"waiting_time": waiting, "headroom": fl[placed, 1],
            "slowdown": (actual / solo_dur).astype(np.float32)}


@pytest.mark.parametrize("case,scorer", [("heavy_8srv", "torch"), ("queue_drain", "torch"),
                                         ("heavy_8srv", "cuda")])
def test_run_trace_metrics_match_jax(case, scorer):
    jc, jd, tc, td, t, ty, by = _case(case)
    jt = jax_run_trace(jc, jd, t, ty, by, metrics=True)
    sc = None if scorer == "torch" else make_scorer(scorer)
    args = (tc, td, torch.from_numpy(t), torch.from_numpy(ty), torch.from_numpy(by))
    pt = run_trace(*args, scorer=sc, metrics=True, record=True)
    bare = run_trace(*args, scorer=sc)
    assert bare.metrics is None and bare.rec is None
    for name in ("placement", "was_queued", "place_time", "finish_time"):
        assert torch.equal(getattr(pt, name), getattr(bare, name)), name
    assert np.array_equal(pt.placement.numpy(), np.asarray(jt.placement))
    for name in ("counters", "gauges", "per_server"):
        assert np.array_equal(getattr(pt.metrics, name).numpy(),
                              np.asarray(getattr(jt.metrics, name))), name
    assert M.counter_value(pt.metrics, "events") == pt.stats.events
    assert M.counter_value(pt.metrics, "drain_full_scans") == pt.stats.drain_full_scans >= 1
    assert M.counter_value(pt.metrics, "queued") == int(pt.was_queued.sum()) > 0
    assert M.gauge_value(pt.metrics, "queue_peak") > 0
    _assert_hists(pt.metrics, jt.metrics, _raw((t, ty, by), pt, td.solo.numpy()))


def test_padded_trace_segment_metrics_match_jax():
    """A padded trace with a traced arrival count: the frame of JAX's
    ``_trace_segment`` on the same padding."""
    pad = 24
    jc, jd, tc, td, t, ty, by = _case("queue_drain", pad)
    n = len(t) - pad
    seg = jax.jit(functools.partial(jax_trace_segment, objective="sum_avg", scorer=None,
                                    telemetry=True, metrics=True))
    jt = seg(jc, jd, t, ty, by, jnp.int32(n))
    pt = trace_segment(tc, td, torch.from_numpy(t), torch.from_numpy(ty), torch.from_numpy(by),
                       torch.tensor(n, dtype=torch.int32), telemetry=True, metrics=True)
    for name in ("counters", "gauges", "per_server", "hist"):
        assert np.array_equal(getattr(pt.metrics, name).numpy(),
                              np.asarray(getattr(jt.metrics, name))), name


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


#: aten operators one micro-event dispatched before the observability plane
#: existed (counted on the parent tree by the same probe): the in-loop
#: scorer, the kernel's wrapper, and the in-loop scorer with telemetry
_STEP_OPS = {("torch", False): 352, ("cuda", False): 353, ("torch", True): 378}


@pytest.mark.parametrize("scorer,telemetry", list(_STEP_OPS))
def test_micro_event_ops_unchanged_with_flags_off(scorer, telemetry):
    _, _, tc, td, t, ty, by = _case("heavy_8srv")
    sc = None if scorer == "torch" else make_scorer(scorer)
    counts = []
    for flags in (dict(), dict(metrics=True, record=True)):
        loop = engine_torch._TraceLoop(tc, td, torch.from_numpy(t), torch.from_numpy(ty),
                                       torch.from_numpy(by), "sum_avg", sc, telemetry, **flags)
        probe = _Count()
        with probe:
            loop.step(loop.st)
        counts.append(probe.n)
    assert counts[0] == _STEP_OPS[(scorer, telemetry)]
    assert counts[1] > counts[0]  # the plane's commits, when on
    print("aten ops per micro-event, flags off / on:", counts)


# -- the adaptive loop ------------------------------------------------------------

@functools.cache
def _adaptive_runs():
    """``tests/test_obs.py``'s eviction scenario (3 servers, 6 x 14, server
    1 in a gradual decay) through JAX's host path and the port's two."""
    segments, n_seg = 6, 14
    arrivals = _replay(_segment(11, n_seg), segments)
    jdrift = gradual_decay([M1] * 3, server=1, rate=0.65, start=1, segments=segments)
    jres = AdaptiveEngine([M1] * 3, prior=0.0, decay=0.997, drift=jdrift,
                          fleet=JaxController(mesh=MeshConfig()), ring_capacity=256).run(
        arrivals, segments=segments, metrics=True)
    out = []
    for device_loop in (False, True):
        tdrift = tgradual_decay([TM1] * 3, server=1, rate=0.65, start=1, segments=segments)
        eng = TorchAdaptive([TM1] * 3, prior=0.0, decay=0.997, drift=tdrift,
                            fleet=FleetController(mesh=TMesh()), ring_capacity=256,
                            scatter="torch", scorer="torch", device="cpu")
        out.append(eng.run(arrivals, segments=segments, metrics=True,
                           device_loop=device_loop))
    return arrivals, jres, out[0], out[1]


def test_adaptive_metrics_match_jax_and_health():
    arrivals, jres, host, fused = _adaptive_runs()
    events = collections.Counter(ev.kind for evs in host.health for ev in evs)
    for res in (host, fused):
        f = res.metrics
        assert M.counter_value(f, "evictions") == events["evict"] > 0
        assert M.counter_value(f, "splits") == events["split"]
        total_placed = sum(len(seg.placements) for seg in res.segments)
        assert M.counter_value(f, "requeues") == total_placed - len(arrivals) > 0
        assert M.counter_value(f, "segments") == 6
        assert M.counter_value(f, "arrivals") == total_placed
    # the host path against JAX's host path: the whole frame
    for name in ("counters", "gauges", "per_server"):
        assert np.array_equal(getattr(host.metrics, name).numpy(),
                              np.asarray(getattr(jres.metrics, name))), name
    # the fused loop against the host path: every shared counter, the
    # per-server columns and the event histograms (d_cols_refreshed and the
    # cusum_level histogram are the fused loop's own, as in JAX)
    shared = [i for i, n in enumerate(M.COUNTERS) if n != "d_cols_refreshed"]
    assert torch.equal(host.metrics.counters[shared], fused.metrics.counters[shared])
    assert torch.equal(host.metrics.per_server, fused.metrics.per_server)
    for spec in M.HISTOGRAMS[:4]:
        assert np.array_equal(M.hist_counts(host.metrics, spec.name),
                              M.hist_counts(fused.metrics, spec.name)), spec.name
    assert M.hist_counts(fused.metrics, "cusum_level").sum() > 0
    text = render_report(host, title="eviction run")
    assert "health-event timeline:" in text and "evict" in text


def test_adaptive_metrics_off_returns_none():
    arrivals = _replay(_segment(3, 4), 2)
    eng = TorchAdaptive([TM1] * 2, prior=0.0, stream=True, scatter="torch", device="cpu")
    assert eng.run(arrivals, segments=2).metrics is None
    assert eng.run(arrivals, segments=2, device_loop=True).metrics is None
