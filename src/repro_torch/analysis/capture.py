"""Capture guard: the hot loop must not rebuild or recapture.

Counterpart of the JAX package's compile-cache guard (``repro/analysis/
retrace.py``). Where JAX compiles a program once per static key, the port
builds an event loop (``engine_torch._TraceLoop``: static buffers, and on
the card one captured CUDA graph of a block of micro-events) once per shape,
caches engines and ground-truth dynamics per world, and caches the fused
loop's event loops per shape. Each of those can silently regress into a
per-segment rebuild: a cache key that churns, an engine rebuilt after an
eviction, a dynamics table rebuilt per run. Each costs a graph capture (or
a table build) per segment instead of per shape.

:class:`CaptureGuard` counts, around a block of work, the event loops
built, the graphs captured, the dynamics tables and engines built, and the
new entries in a watched ``AdaptiveEngine`` 's caches (``_engine_cache``,
``_dyn_cache``, ``_closed_loops``) and its engines' loop caches
(``ConsolidationEngine._loops``). :func:`run_capture_audit` runs JAX's
scenario on a 2-server streaming ``AdaptiveEngine``:

  warm run    at most one build or capture of each kind: the segments share
              one shape, so a count of 2+ means something churns per segment;
  rerun       zero anywhere, on the same engine;
  device loop a warm 4-segment ``run(device_loop=True)``, then 2 and 3
              segments (one power-of-two bucket, one per-segment shape):
              zero new;

the same with ``metrics=True`` and with ``record=True``, and the sharded
fused loop over a one-rank ``ServerAxis``, warm then rerun: zero new. Graph
captures happen on the card only; on the CPU the same blocks run eagerly,
so the capture count there is zero by construction and the other counts
carry the contract.
"""
from __future__ import annotations

import collections
import contextlib

import numpy as np
import torch

from . import Finding

#: the builds and captures the guard counts, by audit name
COUNTED = ("engine_torch._TraceLoop", "engine_torch._TraceLoop._capture",
           "engine_torch.PackedDynamics.build", "engine.ConsolidationEngine")
def _cache_sizes(engine) -> dict[str, int]:
    if engine is None:
        return {}
    return {"AdaptiveEngine._engine_cache": len(engine._engine_cache),
            "AdaptiveEngine._dyn_cache": len(engine._dyn_cache),
            "AdaptiveEngine._closed_loops": len(engine._closed_loops),
            "ConsolidationEngine._loops": sum(len(e._loops)
                                              for e in engine._engine_cache.values())}


class CaptureGuard:
    """Context manager over build and capture counts.

    >>> with CaptureGuard(engine) as guard:
    ...     engine.run(arrivals, segments=3)
    >>> guard.deltas  # {'engine_torch._TraceLoop': 1, ...}
    >>> guard.assert_max(0)  # raises on any build or capture

    Counts every construction of the classes and calls of the functions in
    :data:`COUNTED` (the patches are process-wide while the guard is open),
    and the growth of ``engine`` 's caches when one is given."""

    def __init__(self, engine=None):
        self.engine = engine
        self.deltas: dict[str, int] = {}
        self._counts: collections.Counter = collections.Counter()
        self._stack = contextlib.ExitStack()

    def _count(self, owner, attr: str, name: str, kind: str = "function") -> None:
        orig = owner.__dict__[attr]
        counts = self._counts

        if kind == "classmethod":
            fn = orig.__func__

            def counted(cls, *args, **kwargs):
                counts[name] += 1
                return fn(cls, *args, **kwargs)
            new = classmethod(counted)
        else:
            def new(*args, **kwargs):
                counts[name] += 1
                return orig(*args, **kwargs)
        setattr(owner, attr, new)
        self._stack.callback(setattr, owner, attr, orig)

    def __enter__(self) -> "CaptureGuard":
        from ..core import engine as engine_mod
        from ..core import engine_torch

        self._before = _cache_sizes(self.engine)
        self._count(engine_torch._TraceLoop, "__init__", COUNTED[0])
        self._count(engine_torch._TraceLoop, "_capture", COUNTED[1])
        self._count(engine_torch.PackedDynamics, "build", COUNTED[2], "classmethod")
        self._count(engine_mod.ConsolidationEngine, "__init__", COUNTED[3])
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self._stack.close()
        after = _cache_sizes(self.engine)
        self.deltas = {name: self._counts[name] for name in COUNTED}
        self.deltas.update({k: after[k] - self._before[k] for k in after})

    def new_builds(self) -> dict[str, int]:
        """Only what was built or captured (delta > 0)."""
        return {k: v for k, v in self.deltas.items() if v > 0}

    def assert_max(self, limit: int, context: str = "") -> None:
        bad = {k: v for k, v in self.deltas.items() if v > limit}
        if bad:
            where = f" during {context}" if context else ""
            raise AssertionError(
                f"capture guard{where}: builds exceeded limit {limit}: "
                + ", ".join(f"{k} (+{v})" for k, v in sorted(bad.items())))


def _small_adaptive_engine(device: torch.device):
    """A 2-server streaming AdaptiveEngine at audit scale, the kernels' route
    on the card (their plain versions on the CPU)."""
    from ..core.engine import AdaptiveEngine
    from ..core.server import M1, M2

    return AdaptiveEngine([M1, M2], prior=0.0, scorer="cuda", stream=True, ring_capacity=64,
                          scatter="cuda" if device.type == "cuda" else "torch", device=device)


def _audit_arrivals(n: int = 24):
    """n arrivals over a few grid types, divisible into equal segments (all
    segments then share one shape: one loop covers them all)."""
    from ..core.workload import FS_GRID, RS_GRID, Workload, snap_to_grid

    arrivals = []
    for i in range(n):
        w = snap_to_grid(Workload(
            fs=FS_GRID[(7 * i) % len(FS_GRID)], rs=RS_GRID[i % len(RS_GRID)],
            data_total=64e6))
        arrivals.append((0.25 * i, w))
    return arrivals


def _sharded_closed_loop(device: torch.device, axis):
    """The fused loop's inputs for 4 segments of 8 arrivals on the 2-server
    engine's fleet, with ``axis`` in the config: a callable that runs it into
    one loop cache."""
    from ..core.closed_loop import ClosedLoopConfig, LoopCarry, SegmentIn, run_closed_loop
    from ..core.engine import GRID_T, make_scorer
    from ..core.engine_torch import PackedDynamics
    from ..core.binpack_torch import PackedCluster
    from ..fleet.detect import CusumState
    from ..telemetry.log import ObservationRing
    from ..core.workload import type_index

    eng = _small_adaptive_engine(device)
    m, n_seg, S = 2, 8, 4
    arrivals = _audit_arrivals(n_seg * S)
    times = np.asarray([t for t, _ in arrivals], np.float32).reshape(S, n_seg)
    types = np.asarray([type_index(w) for _, w in arrivals], np.int32).reshape(S, n_seg)
    nbytes = np.asarray([w.data_total for _, w in arrivals], np.float32).reshape(S, n_seg)
    i32 = dict(dtype=torch.int32, device=device)
    ring = ObservationRing(eng.ring.capacity, GRID_T, device=device)
    carry = LoopCarry(
        bank=eng.bank.stacked_state(), det=CusumState.zeros(m, device=device),
        row_map=torch.arange(m, **i32), read_row=torch.arange(m, **i32),
        active=torch.ones(m, dtype=torch.bool, device=device), seen=torch.zeros((), **i32),
        req_type=torch.zeros(n_seg, **i32),
        req_bytes=torch.ones(n_seg, dtype=torch.float32, device=device),
        req_n=torch.zeros((), **i32), ring=ring._buf, ring_ptr=torch.zeros((), **i32),
        ring_total=torch.zeros((), **i32))
    xs = SegmentIn(arr_time=torch.from_numpy(times - times[:, :1]).to(device),
                   arr_type=torch.from_numpy(types).to(device),
                   arr_bytes=torch.from_numpy(nbytes).to(device), dyn_idx=np.zeros(S, np.int64),
                   seg_valid=torch.ones(S, dtype=torch.bool, device=device))
    cluster = PackedCluster.build(list(eng.servers),
                                  torch.zeros((GRID_T, GRID_T), device=device), eng.alpha,
                                  device=device)
    dyn = (PackedDynamics.build(list(eng.servers), device=device),)
    Lp_t = torch.stack([e._L_prior.T for e in eng.estimators]).contiguous()
    logb = torch.stack([e._logb_prior for e in eng.estimators]).to(torch.float32)
    config = ClosedLoopConfig(scorer=make_scorer("cuda"), fleet=True, axis=axis,
                              scatter="cuda" if device.type == "cuda" else "torch")
    cache: dict = {}

    def run():
        final, outs = run_closed_loop(cluster, dyn, Lp_t, logb, carry, xs, config, cache=cache)
        return outs

    return run, cache


#: (guard, most builds allowed, rule id, what the guard watched): JAX's rule
#: ids, each with its contract
RULES = (
    ("warm", 1, "per-segment-retrace", "a warm {s}-segment run of one shape"),
    ("rerun", 0, "rerun-recompile", "an identical rerun"),
    ("device_rerun", 0, "device-loop-recompile",
     "2- and 3-segment device loops after a warm 4-segment one"),
    ("metrics_warm", 1, "metrics-retrace", "a warm {s}-segment run of one shape, metrics on"),
    ("metrics_rerun", 0, "metrics-rerun-recompile", "an identical metrics-on rerun"),
    ("metrics_device_rerun", 0, "metrics-device-loop-recompile",
     "metrics-on 2- and 3-segment device loops after a warm 4-segment one"),
    ("recorder_warm", 1, "recorder-retrace", "a warm {s}-segment run of one shape, recorder on"),
    ("recorder_rerun", 0, "recorder-rerun-recompile", "an identical recorder-on rerun"),
    ("recorder_device_rerun", 0, "recorder-device-loop-recompile",
     "recorder-on 2- and 3-segment device loops after a warm 4-segment one"),
    ("sharded_rerun", 0, "sharded-loop-recompile", "a rerun of the warm sharded fused loop"),
)


def findings_from_guards(guards: "dict[str, CaptureGuard]", segments: int) -> list[Finding]:
    """Every count over its rule's limit, as findings."""
    return [Finding("capture", rule, name,
                    f"{delta} in {what.format(s=segments)} (expected at most {limit})")
            for key, limit, rule, what in RULES
            for name, delta in sorted(guards[key].deltas.items()) if delta > limit]


def run_capture_audit(device: torch.device, stats: "dict | None" = None,
                      segments: int = 3) -> list[Finding]:
    """JAX's retrace scenario under the guard (the module docstring)."""
    from .dispatch_audit import one_rank_axis

    arrivals = _audit_arrivals(n=8 * segments)
    n_seg = 8
    dev_arrivals = _audit_arrivals(n=n_seg * 4)
    guards: dict[str, CaptureGuard] = {}

    def scenario(tag: str, **flags):
        eng = _small_adaptive_engine(device)
        with CaptureGuard(eng) as guards[f"{tag}warm"]:
            eng.run(arrivals, segments=segments, **flags)
        with CaptureGuard(eng) as guards[f"{tag}rerun"]:
            eng.run(arrivals, segments=segments, **flags)
        dev = _small_adaptive_engine(device)
        with CaptureGuard(dev) as guards[f"{tag}device_warm"]:
            dev.run(dev_arrivals, segments=4, device_loop=True, **flags)
        with CaptureGuard(dev) as guards[f"{tag}device_rerun"]:
            dev.run(dev_arrivals[:n_seg * 2], segments=2, device_loop=True, **flags)
            dev.run(dev_arrivals[:n_seg * 3], segments=3, device_loop=True, **flags)

    with torch.no_grad():
        scenario("")
        scenario("metrics_", metrics=True)
        scenario("recorder_", record=True)
        with one_rank_axis(device) as axis:
            run, cache = _sharded_closed_loop(device, axis())
            with CaptureGuard() as guards["sharded_warm"]:
                run()
            loops = len(cache)
            with CaptureGuard() as guards["sharded_rerun"]:
                run()
            guards["sharded_rerun"].deltas["closed_loop cache"] = len(cache) - loops

    findings = findings_from_guards(guards, segments)
    if stats is not None:
        stats["capture"] = {key: g.new_builds() for key, g in guards.items()}
        stats["capture"]["graphs"] = device.type == "cuda"
    return findings
