"""The port's registered hot entry points: what each promises and how to call it.

Counterpart of the JAX package's ``HotEntry`` / ``REGISTRY``
(``repro/analysis/jaxpr_audit.py``). Every entry point that claims to run on
the device without the host is registered with a **purity tier** and a
builder. A builder takes a :class:`BuildCtx` (the device, a :class:`Shape`
and, for the sharded entries, a one-rank ``ServerAxis``) and returns
``(fn, args)``: everything that reads the host (profiled tables, seeded
inputs, copies to the card) happens in the builder, and ``fn(*args)`` is
the one eager call the audit watches. On the card the shapes are the
production ones -- T = 230 (the paper's 10 x 23 grid), m = 64 and 1024
servers, observation blocks of B = 512 and 8192 rows, the serving shapes of
the LM kernels -- and on the CPU small ones.

Tiers, as JAX's:

  device      no host read, no float64 output (every hot-loop entry)
  device-f64  device-resident, float64 allowed
  host        host orchestration: float64 and host reads allowed; only shape
              stability is checked

``bodies`` names the functions whose source the AST pass reads for an entry
(``module:qualname``). Their positional parameters are taken as tensors (or
as carrying tensors) and their keyword-only ones as host values, as
``repro`` takes a jitted function's non-static parameters as traced;
``static`` names positional host values and ``traced`` keyword-only
tensors. ``kernel`` names the ``csrc/*.cu`` source an entry launches on the
card.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, NamedTuple

import numpy as np
import torch

# -- purity tiers ----------------------------------------------------------------
TIER_DEVICE = "device"
TIER_DEVICE_F64 = "device-f64"
TIER_HOST = "host"

#: relaxations granted by each tier (checks *skipped* for members)
TIER_RELAXATIONS: dict[str, frozenset[str]] = {
    TIER_DEVICE: frozenset(),
    TIER_DEVICE_F64: frozenset({"float64-leak"}),
    TIER_HOST: frozenset({"float64-leak", "host-callback", "host-sync"}),
}

T = 230  # len(RS_GRID) * len(FS_GRID): the paper's profiling grid


class Shape(NamedTuple):
    """One set of sizes the builders take."""

    label: str
    m: int  # servers
    n: int  # event-loop capacity (arrivals)
    n_seg: int  # fused-loop segment rows; R = n_seg requeue slots, B = 2 n_seg
    serving: bool  # LM kernels at the served models' shapes (else small ones)

    @property
    def B(self) -> int:
        """Rows of a segment's observation block (requeue slots + chunk)."""
        return 2 * self.n_seg


CPU_SHAPES = (Shape("small", 4, 16, 8, False),)
#: phase 4's and 5's widths; the fused loop's blocks of phase 14 (B 512, 8192)
CARD_SHAPES = (Shape("rack", 64, 1024, 256, True), Shape("fleet", 1024, 4096, 4096, True))


def shapes_for(device: torch.device) -> tuple[Shape, ...]:
    return CARD_SHAPES if device.type == "cuda" else CPU_SHAPES


@dataclasses.dataclass
class BuildCtx:
    """What a builder may use: the device, the sizes, and (for the sharded
    entries) the audit's one-rank axis, made on first use."""

    device: torch.device
    shape: Shape
    axis_factory: Callable[[], object] | None = None

    def axis(self):
        if self.axis_factory is None:
            raise RuntimeError("this entry needs a one-rank ServerAxis")
        return self.axis_factory()

    @property
    def scatter(self) -> str:
        """The pair-statistic backend the main path takes on this device."""
        return "cuda" if self.device.type == "cuda" else "torch"


@dataclasses.dataclass(frozen=True)
class HotEntry:
    """One registered hot path: what it promises and how to call it."""

    name: str
    tier: str
    build: Callable[[BuildCtx], tuple[Callable, tuple]]
    #: functions whose source the AST pass reads (``module:qualname``)
    bodies: tuple[str, ...] = ()
    #: positional parameters of those bodies that hold host values
    static: frozenset[str] = frozenset()
    #: keyword-only parameters of those bodies that hold tensors
    traced: frozenset[str] = frozenset()
    #: attributes of ``self`` (in methods among the bodies) that are host values
    host_attrs: frozenset[str] = frozenset()
    #: the csrc/*.cu source the entry launches on the card
    kernel: str | None = None
    #: the entry's cost does not depend on m: audit it at one shape only
    unscaled: bool = False
    #: why the entry has the tier it has, where that is not ``device``
    note: str = ""


# -- seeded inputs -------------------------------------------------------------------

def _servers(m: int):
    from ..core.server import M1, M2
    return [M1, M2] * (m // 2) + [M1] * (m % 2)


@functools.cache
def _profiled_D() -> tuple[np.ndarray, np.ndarray]:
    from ..core.contention import profile_pairwise_fast
    from ..core.server import M1, M2
    return profile_pairwise_fast(M1), profile_pairwise_fast(M2)


def _cluster(ctx: BuildCtx):
    from ..core.binpack_torch import PackedCluster
    m, dev = ctx.shape.m, ctx.device
    pair = torch.stack([torch.from_numpy(d.astype(np.float32)) for d in _profiled_D()]).to(dev)
    return PackedCluster.build(_servers(m), list(pair[torch.arange(m) % 2]), 1.3, device=dev)


def _dynamics(ctx: BuildCtx):
    from ..core.engine_torch import PackedDynamics
    return PackedDynamics.build(_servers(ctx.shape.m), device=ctx.device)


def _arrivals(n: int, dev: torch.device, seed: int = 3):
    """Seeded heavy arrivals (FS 4-128 MB, RS 32-512 KB, 8 passes of the
    file, exponential gaps of 1e-4 s): they fill servers, queue and drain."""
    from ..core.workload import FS_GRID, RS_GRID
    rng = np.random.default_rng(seed)
    fs_i = rng.integers(12, 18, n)  # FS_GRID[12:18]: 4 MB .. 128 MB
    rs_i = rng.integers(5, len(RS_GRID), n)  # RS_GRID[5:]: 32 KB .. 512 KB
    times = np.cumsum(rng.exponential(1e-4, n)).astype(np.float32)
    types = (rs_i * len(FS_GRID) + fs_i).astype(np.int32)
    nbytes = (8.0 * np.asarray(FS_GRID)[fs_i]).astype(np.float32)
    return tuple(torch.from_numpy(x).to(dev) for x in (times, types, nbytes))


def _f32(shape, fill: float, dev) -> torch.Tensor:
    return torch.full(shape, fill, dtype=torch.float32, device=dev)


def _rand(shape, dev, seed: int, lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
    """Seeded uniform float32 in [lo, hi), drawn on ``dev``."""
    gen = torch.Generator(dev).manual_seed(seed)
    return torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo


def _pooled(m: int, dev) -> torch.Tensor:
    """Servers pooled in pairs onto the even server's row."""
    return (torch.arange(m, dtype=torch.int32) // 2 * 2).to(dev)


def _ring_block(B: int, m: int, dev, seed: int = 5):
    """A block of B observation rows over m servers, every fifth voided."""
    from ..telemetry.log import RingBlock
    rng = np.random.default_rng(seed)
    server = rng.integers(0, m, B).astype(np.int32)
    server[::5] = -1
    co = rng.uniform(0.0, 0.5, (B, T)).astype(np.float32) * (rng.uniform(size=(B, 1)) < 0.8)
    return RingBlock.build(
        wtype=torch.from_numpy(rng.integers(0, T, B).astype(np.int32)).to(dev),
        server=torch.from_numpy(server).to(dev),
        duration=_rand((B,), dev, seed + 1, 0.5, 2.0), y=_rand((B,), dev, seed + 2, -0.5, 0.1),
        co=torch.from_numpy(co).to(dev), lost_frac=_rand((B,), dev, seed + 3, 0.0, 0.6),
        valid=torch.from_numpy(server >= 0).to(dev))


def _bank(m: int, dev):
    from ..telemetry.estimator import DeviceEstimatorState
    return DeviceEstimatorState(
        L_t=_rand((m, T, T), dev, 7, -0.2, 0.0), log_b=_f32((m, T), math.log(1e6), dev),
        n_pair_t=_rand((m, T, T), dev, 8, 0.0, 3.0), n_base=_f32((m, T), 2.0, dev),
        n_obs=torch.zeros((m,), dtype=torch.int32, device=dev))


def _detector(m: int, dev):
    """A detector state whose CUSUM crosses h = 2 on servers 1 and 5 (pooled
    members: they split) and whose level sits far below the median on
    server 3 (it is evicted)."""
    from ..kernels.cusum import CusumState
    stat = torch.zeros((m, 2), dtype=torch.float32)
    stat[1 % m, 0] = stat[5 % m, 1] = 3.0
    level = torch.zeros(m, dtype=torch.float32)
    level[3 % m] = -20.0
    return CusumState(stat=stat.to(dev), level=level.to(dev), n=_f32((m,), 10.0, dev),
                      pool_level=_f32((m,), 0.1, dev), pool_n=_f32((m,), 5.0, dev))


def _hypers(ctx: BuildCtx) -> dict:
    return dict(lr=0.6, decay=0.997, step_damp=0.5, solo_eps=0.05, max_lost_frac=0.5,
                scatter=ctx.scatter)


# -- the event loop ------------------------------------------------------------------

def _build_block(ctx: BuildCtx, metrics: bool = False, record: bool = False,
                 sharded: bool = False):
    """One block of the event loop, set up as ``trace_segment`` sets it up
    (telemetry on, the kernel's scorer), from a reset state."""
    from ..core.engine import make_scorer
    from ..core.engine_torch import _TraceLoop
    cluster, dyn = _cluster(ctx), _dynamics(ctx)
    axis = None
    if sharded:
        axis = ctx.axis()
        axis.validate(cluster.m)
        cluster, dyn = axis.local(cluster, cluster.m), axis.local(dyn, cluster.m)
    loop = _TraceLoop(cluster, dyn, *_arrivals(ctx.shape.n, ctx.device), "sum_avg",
                      make_scorer("cuda"), True, metrics=metrics, record=record, axis=axis)
    loop._reset()
    return loop.block, ()


# -- the fused loop's segment body -----------------------------------------------------

def _synthetic_trace(ctx: BuildCtx, n_cap: int, metrics: bool, record: bool, rec_capacity: int):
    """An event loop's outputs at capacity ``n_cap``: placements over the
    fleet (every seventh arrival never placed), finish times, telemetry
    integrals. The body folds whatever the loop produced, so a seeded trace
    exercises it at fleet width without running the loop first."""
    from ..core.engine_torch import EngineTrace, LoopStats
    from ..obs import metrics as obs_metrics
    from ..obs import recorder as obs_recorder
    dev, m = ctx.device, ctx.shape.m
    rng = np.random.default_rng(11)
    placement = rng.integers(0, m, n_cap).astype(np.int32)
    placement[::7] = -1
    place = rng.uniform(0.0, 1.0, n_cap).astype(np.float32)
    dur = rng.uniform(0.1, 2.0, n_cap).astype(np.float32)
    placed = placement >= 0
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)  # noqa: E731
    return EngineTrace(
        placement=t(placement), was_queued=t(rng.uniform(size=n_cap) < 0.2),
        place_time=t(np.where(placed, place, -1.0).astype(np.float32)),
        finish_time=t(np.where(placed, place + dur, np.inf).astype(np.float32)),
        makespan=t(np.float32(3.0)), max_deg=t(np.float32(0.3)), deadlock=t(np.bool_(False)),
        obs_co=t((rng.uniform(0, 0.5, (n_cap, T)) * dur[:, None]).astype(np.float32)),
        obs_lost=t(np.zeros(n_cap, np.float32)), obs_logr=t((dur * -0.1).astype(np.float32)),
        stats=LoopStats(0, 0, 0, 32),
        metrics=obs_metrics.zeros(m, dev) if metrics else None,
        rec=obs_recorder.init(rec_capacity, dev) if record else None)


def _build_segment_body(ctx: BuildCtx, metrics: bool = False, record: bool = False,
                        sharded: bool = False):
    """``closed_loop._assemble`` then ``_fold_segment`` for one segment past
    the controller's warm-up, with pooled routing and a detector state that
    splits and evicts, as ``run_closed_loop`` calls them (on a sharded axis
    after its localization)."""
    from ..core.closed_loop import ClosedLoopConfig, LoopCarry, _assemble, _fold_segment
    from ..core.engine import make_scorer
    from ..obs import metrics as obs_metrics
    from ..obs import recorder as obs_recorder
    from ..telemetry.log import RingBlock
    dev, m, n_seg = ctx.device, ctx.shape.m, ctx.shape.n_seg
    R = n_seg
    cap = 4 * n_seg
    axis = ctx.axis() if sharded else None
    config = ClosedLoopConfig(scorer=make_scorer("cuda"), fleet=True, metrics=metrics,
                              record=record, scatter=ctx.scatter, axis=axis)
    i32 = dict(dtype=torch.int32, device=dev)
    rec_cap = 2 * (R + n_seg)
    carry = LoopCarry(
        bank=_bank(m, dev), det=_detector(m, dev), row_map=_pooled(m, dev),
        read_row=_pooled(m, dev), active=torch.ones(m, dtype=torch.bool, device=dev),
        seen=torch.tensor(3, **i32), req_type=torch.arange(R, **i32) % T,
        req_bytes=_f32((R,), 1e6, dev), req_n=torch.tensor(min(3, R), **i32),
        ring=RingBlock(ints=torch.full((cap, 2), -1, **i32), scalars=_f32((cap, 6), 0.0, dev),
                       co=_f32((cap, T), 0.0, dev)),
        ring_ptr=torch.tensor(5, **i32), ring_total=torch.tensor(5, **i32),
        metrics=obs_metrics.zeros(m, dev) if metrics else None,
        rec=obs_recorder.init(rec_cap, dev) if record else None)
    x_time, x_type, x_bytes = _arrivals(n_seg, dev)
    x_time = x_time - x_time[0]
    seg_valid = torch.ones((), dtype=torch.bool, device=dev)
    trace = _synthetic_trace(ctx, R + n_seg, metrics, record, rec_cap)
    Lp_t = torch.zeros((m, T, T), dtype=torch.float64, device=dev)
    logb = _f32((m, T), math.log(1e6), dev)
    if axis is not None:
        axis.validate(m)
        Lp_t = axis.local(Lp_t, m)
        carry = carry._replace(bank=axis.local(carry.bank, m), det=axis.local(carry.det, m))

    def body(carry, x_time, x_type, x_bytes, seg_valid, trace, Lp_t, logb):
        a_time, a_type, a_bytes, n_valid = _assemble(carry, x_time, x_type, x_bytes, seg_valid,
                                                     n_seg)
        return _fold_segment(carry, trace, a_type, a_bytes, n_valid, seg_valid, Lp_t, logb,
                             config)

    return body, (carry, x_time, x_type, x_bytes, seg_valid, trace, Lp_t, logb)


# -- estimator, detector, controller, ring, recorder -------------------------------------

def _build_update_device(ctx: BuildCtx):
    from ..telemetry.estimator import DeviceEstimatorState, _update_device
    bank = _bank(1, ctx.device)
    state = DeviceEstimatorState(*(a[0] for a in bank))
    block = _ring_block(ctx.shape.B, 1, ctx.device)
    hypers = _hypers(ctx)
    return (lambda st, blk: _update_device(st, blk, -1, **hypers)), (state, block)


def _build_bank_core(ctx: BuildCtx):
    from ..telemetry.estimator import _bank_core
    m = ctx.shape.m
    hypers = _hypers(ctx)
    return ((lambda st, blk: _bank_core(st, blk, sparse_tables=True, **hypers)),
            (_bank(m, ctx.device), _ring_block(ctx.shape.B, m, ctx.device)))


def _build_cusum_update(ctx: BuildCtx):
    from ..fleet.detect import _cusum_update
    m, dev = ctx.shape.m, ctx.device
    bank = _bank(m, dev)
    fn = lambda st, blk, lb, lt, rm: _cusum_update(  # noqa: E731
        st, blk, lb, lt, rm, k=0.25, level_decay=0.9, max_lost_frac=0.5)
    return fn, (_detector(m, dev), _ring_block(ctx.shape.B, m, dev), bank.log_b, bank.L_t,
                _pooled(m, dev))


def _build_fleet_step(ctx: BuildCtx):
    from ..fleet.controller import fleet_step
    m, dev = ctx.shape.m, ctx.device
    fn = lambda *a: fleet_step(*a, h=2.0, level_decay=0.9, fail_floor=0.5,  # noqa: E731
                               min_exposure=4.0)
    return fn, (_bank(m, dev), _detector(m, dev), _pooled(m, dev), _pooled(m, dev),
                torch.ones(m, dtype=torch.bool, device=dev), _f32((m, T), math.log(1e6), dev),
                torch.ones((), dtype=torch.bool, device=dev))


def _build_ring_push(ctx: BuildCtx):
    from ..telemetry.log import ObservationRing
    ring = ObservationRing(4 * ctx.shape.B, T, device=ctx.device)
    return ring.push, (_ring_block(ctx.shape.B, ctx.shape.m, ctx.device),)


def _build_ring_write_masked(ctx: BuildCtx):
    from ..telemetry.log import RingBlock, ring_write_masked
    B, dev = ctx.shape.B, ctx.device
    i32 = dict(dtype=torch.int32, device=dev)
    buf = RingBlock(ints=torch.full((2 * B, 2), -1, **i32), scalars=_f32((2 * B, 6), 0.0, dev),
                    co=_f32((2 * B, T), 0.0, dev))
    return ring_write_masked, (buf, _ring_block(B, ctx.shape.m, dev), torch.tensor(B + 7, **i32),
                               torch.tensor(B - 3, **i32))


def _build_record_row(ctx: BuildCtx):
    """One decision row, with its top-K candidates and tie margin, as
    ``place_if`` writes it (the row's scalars made here: a tensor built from
    host data inside the call would be a copy that waits on the card)."""
    from ..obs import recorder as obs_recorder
    dev, m = ctx.device, ctx.shape.m
    rec = obs_recorder.init(2 * ctx.shape.n, dev)
    i32 = dict(dtype=torch.int32, device=dev)
    score_row = torch.where(_rand((m,), dev, 13) < 0.7, _rand((m,), dev, 14), torch.inf)
    row = dict(on=torch.ones((), dtype=torch.bool, device=dev),
               arrival=torch.full((1,), 3, **i32), segment=torch.full((), 1, **i32),
               kind=torch.zeros((1,), **i32), qdepth=torch.full((), 2, **i32),
               t=_f32((1,), 0.5, dev), headroom=_f32((1,), 0.2, dev),
               n_pair_min=_f32((), -1.0, dev), cusum=_f32((1,), 0.0, dev))

    def fn(rec, score_row, row):
        cand, csc = obs_recorder.top_candidates(score_row)
        return obs_recorder.record_row(rec, server=cand[:1], pool_row=cand[:1], cand=cand,
                                       scores=csc, margin=obs_recorder.tie_margin(csc), **row)

    return fn, (rec, score_row, row)


def _build_greedy_sharded(ctx: BuildCtx):
    from ..core.binpack_torch import greedy_sequence_sharded
    cluster = _cluster(ctx)
    Q = 16 if ctx.device.type == "cpu" else 64
    _, types, _ = _arrivals(Q, ctx.device)
    counts = torch.zeros((cluster.m, T), dtype=torch.float32, device=ctx.device)
    axis = ctx.axis()
    return (lambda c, cnt, wt: greedy_sequence_sharded(c, cnt, wt, axis)), (cluster, counts,
                                                                             types)


# -- the kernel wrappers -------------------------------------------------------------------

def _scorer_inputs(ctx: BuildCtx):
    """The scorer's inputs at the loop's call: every grid type once (Q = T),
    seeded sparse counts."""
    cluster = _cluster(ctx)
    rng = np.random.default_rng(17)
    counts = rng.poisson(0.02, (cluster.m, T)).astype(np.float32)
    counts[0] = 0.0
    counts = torch.from_numpy(counts).to(ctx.device)
    return cluster, counts, torch.arange(T, dtype=torch.int32, device=ctx.device)


def _build_consolidation_scores(ctx: BuildCtx):
    from ..core.engine import kernel_args
    from ..kernels.consolidation import consolidation_scores
    return consolidation_scores, kernel_args(*_scorer_inputs(ctx))


def _build_make_scorer(ctx: BuildCtx):
    from ..core.engine import make_scorer
    return make_scorer("cuda"), _scorer_inputs(ctx)


def _build_pair_scatter(ctx: BuildCtx):
    from ..kernels.telemetry import pair_scatter
    blk = _ring_block(ctx.shape.B, 1, ctx.device)
    vals = torch.stack([blk.y, blk.duration]).contiguous()
    return pair_scatter, (blk.wtype.contiguous(), blk.co, vals)


def _build_pair_scatter_banked(ctx: BuildCtx):
    from ..kernels.telemetry import pair_scatter_banked
    m = ctx.shape.m
    blk = _ring_block(ctx.shape.B, m, ctx.device)
    keys = torch.where(blk.valid, blk.server * T + blk.wtype, -1).to(torch.int32)
    vals = torch.stack([blk.y, blk.duration]).contiguous()
    return pair_scatter_banked, (keys, blk.co, vals, m * T)


def _build_cusum_scan(ctx: BuildCtx):
    from ..kernels.cusum import cusum_scan
    m, B, dev = ctx.shape.m, ctx.shape.B, ctx.device
    blk = _ring_block(B, m, dev)
    server = torch.clamp(blk.server, 0, m - 1).contiguous()
    fn = lambda *a: cusum_scan(*a, k=0.25, level_decay=0.9)  # noqa: E731
    return fn, (_detector(m, dev), server, (server // 2 * 2).contiguous(), blk.y.contiguous(),
                blk.valid.contiguous())


def _action_inputs(ctx: BuildCtx):
    m, dev = ctx.shape.m, ctx.device
    det = _detector(m, dev)
    flags = det.stat.amax(1) >= 2.0
    ctl = torch.ones(2, dtype=torch.int32, device=dev)
    return m, dev, det, flags, ctl


def _build_split_loop(ctx: BuildCtx):
    from ..kernels.fleet_actions import split_loop
    m, dev, det, flags, ctl = _action_inputs(ctx)
    return split_loop, (flags, _pooled(m, dev), _pooled(m, dev),
                        torch.arange(m, dtype=torch.int32, device=dev), det.stat,
                        det.pool_level, det.pool_n, ctl)


def _build_evict_loop(ctx: BuildCtx):
    from ..kernels.fleet_actions import evict_loop
    m, dev, det, _, ctl = _action_inputs(ctx)
    hits = det.level < -1.0
    return evict_loop, (hits, torch.zeros(m, dtype=torch.bool, device=dev), det.level,
                        _pooled(m, dev), _pooled(m, dev),
                        torch.arange(m, dtype=torch.int32, device=dev),
                        torch.ones(m, dtype=torch.bool, device=dev), det.stat, det.level, det.n,
                        det.pool_level, det.pool_n, ctl)


def _lm_dtype(ctx: BuildCtx) -> torch.dtype:
    return torch.bfloat16 if ctx.shape.serving else torch.float32


def _build_flash_attention(ctx: BuildCtx):
    """tinyllama-1.1b's prefill (8 x 512 tokens, 32 heads over 4 kv heads,
    dh 64, bf16) on the card."""
    from ..kernels.flash_attention import flash_attention
    B, S, H, Hkv, dh = (8, 512, 32, 4, 64) if ctx.shape.serving else (1, 64, 4, 2, 16)
    dt, dev = _lm_dtype(ctx), ctx.device
    q = _rand((B, S, H, dh), dev, 21, -1, 1).to(dt)
    k, v = (_rand((B, S, Hkv, dh), dev, s, -1, 1).to(dt) for s in (22, 23))
    return (lambda q, k, v: flash_attention(q, k, v, causal=True)), (q, k, v)


def _build_rwkv6_scan(ctx: BuildCtx):
    """rwkv6-7b's prefill (8 x 512 tokens, 64 heads, dh 64, bf16) on the card."""
    from ..kernels.rwkv6_scan import rwkv6_scan
    B, S, H, dh = (8, 512, 64, 64) if ctx.shape.serving else (1, 33, 2, 16)
    dt, dev = _lm_dtype(ctx), ctx.device
    r, k, v = (_rand((B, S, H, dh), dev, s, -0.5, 0.5).to(dt) for s in (31, 32, 33))
    wlog = _rand((B, S, H, dh), dev, 34, -2.0, -0.01)
    return rwkv6_scan, (r, k, v, wlog, _rand((H, dh), dev, 35, 0, 0.5),
                        _f32((B, H, dh, dh), 0.0, dev))


def _build_mamba_scan(ctx: BuildCtx):
    """The contract entry at the JAX registry's shape (2 x 64 tokens, E 512,
    N 16) on the card."""
    from ..kernels.mamba_scan import mamba_scan
    B, S, E, N = (2, 64, 512, 16) if ctx.shape.serving else (1, 8, 32, 16)
    dev = ctx.device
    return mamba_scan, (_rand((B, S, E, N), dev, 41, 0.8, 1.0), _rand((B, S, E, N), dev, 42, 0, .1),
                        _rand((B, S, N), dev, 43, 0, .1), _f32((B, E, N), 0.0, dev))


def _build_mamba_selective_scan(ctx: BuildCtx):
    """The model entry at jamba-v0.1-52b's prefill (8 x 512 tokens, E 8192,
    N 16, bf16 u/B/C) on the card."""
    from ..kernels.mamba_scan import mamba_selective_scan
    B, S, E, N = (8, 512, 8192, 16) if ctx.shape.serving else (1, 8, 32, 16)
    dt, dev = _lm_dtype(ctx), ctx.device
    return mamba_selective_scan, (
        _rand((B, S, E), dev, 51, 0.001, 0.1), _rand((B, S, E), dev, 52, -1, 1).to(dt),
        _rand((B, S, N), dev, 53, -1, 1).to(dt), _rand((B, S, N), dev, 54, -1, 1).to(dt),
        _rand((E, N), dev, 55, -8.0, -0.5), _f32((B, E, N), 0.0, dev))


# -- the registry ---------------------------------------------------------------------------

_LOOP = "repro_torch.core.engine_torch:_TraceLoop."
#: the event loop's block and every method it calls
_BLOCK_BODIES = tuple(_LOOP + f for f in (
    "block", "step", "is_done", "pick_types", "owner", "apply_delta", "place_if", "advance",
    "drain_branch", "finish_branch", "arrive_branch")) + (
    "repro_torch.core.engine_torch:_rate_table", "repro_torch.core.engine_torch:_put_if")
#: the loop's host attributes: sizes, flags, configuration, the graph
LOOP_HOST_ATTRS = frozenset({"n", "K", "m", "T", "axis", "lo", "m_g", "W", "n_steps", "S",
                             "objective", "scorer", "telemetry", "metrics", "record", "device",
                             "graph", "tally", "calls", "_rec_in"})
_SEGMENT_BODIES = tuple(f"repro_torch.core.closed_loop:{f}" for f in (
    "_assemble", "_fold_segment", "full_D", "local_rows")) + (
    "repro_torch.telemetry.log:rows_from_trace", "repro_torch.telemetry.log:ring_write_masked",
    "repro_torch.telemetry.estimator:_remap_rows",
    "repro_torch.telemetry.estimator:_localize_block")
_BANK_BODIES = ("repro_torch.telemetry.estimator:_bank_core",
                "repro_torch.telemetry.estimator:_blend_prior_t")
REGISTRY: tuple[HotEntry, ...] = (
    HotEntry("engine_torch._TraceLoop.block", TIER_DEVICE, _build_block,
             bodies=_BLOCK_BODIES, traced=frozenset({"on", "score_row"}),
             host_attrs=LOOP_HOST_ATTRS, kernel="consolidation_scores"),
    HotEntry("engine_torch._TraceLoop.block[metrics]", TIER_DEVICE,
             functools.partial(_build_block, metrics=True), kernel="consolidation_scores"),
    HotEntry("engine_torch._TraceLoop.block[record]", TIER_DEVICE,
             functools.partial(_build_block, record=True), kernel="consolidation_scores"),
    HotEntry("engine_torch._TraceLoop.block[sharded]", TIER_DEVICE,
             functools.partial(_build_block, sharded=True), kernel="consolidation_scores"),
    HotEntry("closed_loop.segment_body", TIER_DEVICE, _build_segment_body,
             bodies=_SEGMENT_BODIES,
             static=frozenset({"n_seg", "config", "confidence_floor", "lo", "m_local",
                               "min_duration"}),
             note="the float64 D blend of full_D is the host path's (ROADMAP Queue 3)"),
    HotEntry("closed_loop.segment_body[metrics]", TIER_DEVICE,
             functools.partial(_build_segment_body, metrics=True)),
    HotEntry("closed_loop.segment_body[record]", TIER_DEVICE,
             functools.partial(_build_segment_body, metrics=True, record=True)),
    HotEntry("closed_loop.segment_body[sharded]", TIER_DEVICE,
             functools.partial(_build_segment_body, sharded=True)),
    HotEntry("binpack_torch.greedy_sequence_sharded", TIER_DEVICE, _build_greedy_sharded,
             bodies=("repro_torch.core.binpack_torch:greedy_sequence_sharded",
                     "repro_torch.core.binpack_torch:_choose_from_scores",
                     "repro_torch.core.binpack_torch:_masked_scores",
                     "repro_torch.core.binpack_torch:_commit_local"),
             static=frozenset({"axis", "objective", "m_local", "lo"})),
    HotEntry("estimator._update_device", TIER_DEVICE, _build_update_device,
             bodies=("repro_torch.telemetry.estimator:_update_device",),
             static=frozenset({"server"}),
             kernel="pair_scatter"),
    HotEntry("estimator._bank_core", TIER_DEVICE, _build_bank_core, bodies=_BANK_BODIES,
             static=frozenset({"confidence_floor"}), kernel="pair_scatter"),
    HotEntry("detect._cusum_update", TIER_DEVICE, _build_cusum_update,
             bodies=("repro_torch.fleet.detect:_cusum_update",),
             kernel="cusum_scan"),
    HotEntry("controller.fleet_step", TIER_DEVICE, _build_fleet_step,
             bodies=("repro_torch.fleet.controller:fleet_step",
                     "repro_torch.fleet.controller:base_ratio"),
             static=frozenset({"min_exposure"}), kernel="fleet_actions"),
    HotEntry("log.ObservationRing.push", TIER_HOST, _build_ring_push,
             bodies=("repro_torch.telemetry.log:ObservationRing.push",),
             host_attrs=frozenset({"capacity", "ptr", "total"}),
             note="the cursor is a host int (ObservationRing.ptr): where the block lands is "
                  "decided on the host, so the push is host orchestration; the fused loop "
                  "writes its ring by log.ring_write_masked, a device entry"),
    HotEntry("log.ring_write_masked", TIER_DEVICE, _build_ring_write_masked),
    HotEntry("recorder.record_row", TIER_DEVICE, _build_record_row,
             bodies=("repro_torch.obs.recorder:record_row",
                     "repro_torch.obs.recorder:top_candidates",
                     "repro_torch.obs.recorder:tie_margin"),
             traced=frozenset({"on", "arrival", "segment", "server", "kind", "qdepth",
                               "pool_row", "cand", "scores", "t", "headroom", "margin",
                               "n_pair_min", "cusum"})),
    HotEntry("kernels.consolidation.consolidation_scores", TIER_DEVICE,
             _build_consolidation_scores,
             bodies=("repro_torch.kernels.consolidation:consolidation_scores",
                     "repro_torch.kernels.consolidation:launch"),
             static=frozenset({"lib", "path", "stream"}), kernel="consolidation_scores"),
    HotEntry("engine.make_scorer[cuda]", TIER_DEVICE, _build_make_scorer,
             bodies=("repro_torch.core.engine:_cuda_scorer", "repro_torch.core.engine:kernel_args"),
             kernel="consolidation_scores"),
    HotEntry("kernels.telemetry.pair_scatter", TIER_DEVICE, _build_pair_scatter,
             bodies=("repro_torch.kernels.telemetry:pair_scatter",),
             kernel="pair_scatter"),
    HotEntry("kernels.telemetry.pair_scatter_banked", TIER_DEVICE, _build_pair_scatter_banked,
             bodies=("repro_torch.kernels.telemetry:pair_scatter_banked",),
             static=frozenset({"n_rows"}),
             kernel="pair_scatter"),
    HotEntry("kernels.cusum.cusum_scan", TIER_DEVICE, _build_cusum_scan,
             bodies=("repro_torch.kernels.cusum:cusum_scan", "repro_torch.kernels.cusum:launch"),
             static=frozenset({"lib", "path", "stream"}), kernel="cusum_scan"),
    HotEntry("kernels.fleet_actions.split_loop", TIER_DEVICE, _build_split_loop,
             bodies=("repro_torch.kernels.fleet_actions:split_loop",), kernel="fleet_actions"),
    HotEntry("kernels.fleet_actions.evict_loop", TIER_DEVICE, _build_evict_loop,
             bodies=("repro_torch.kernels.fleet_actions:evict_loop",), kernel="fleet_actions"),
    HotEntry("kernels.flash_attention.flash_attention", TIER_DEVICE, _build_flash_attention,
             bodies=("repro_torch.kernels.flash_attention:flash_attention",),
             kernel="flash_attention", unscaled=True),
    HotEntry("kernels.rwkv6_scan.rwkv6_scan", TIER_DEVICE, _build_rwkv6_scan,
             bodies=("repro_torch.kernels.rwkv6_scan:rwkv6_scan",), kernel="rwkv6_scan",
             unscaled=True),
    HotEntry("kernels.mamba_scan.mamba_scan", TIER_DEVICE, _build_mamba_scan,
             bodies=("repro_torch.kernels.mamba_scan:mamba_scan",), kernel="mamba_scan",
             unscaled=True),
    HotEntry("kernels.mamba_scan.mamba_selective_scan", TIER_DEVICE,
             _build_mamba_selective_scan,
             bodies=("repro_torch.kernels.mamba_scan:mamba_selective_scan",),
             kernel="mamba_scan", unscaled=True),
)

#: every csrc/*.cu source and the wrapper file that loads it: ``ast_rules``
#: fails a ``_build.load`` site or a source outside this map, so a new
#: kernel cannot land without a registered entry that launches it
KERNEL_COVERAGE: dict[str, str] = {
    "consolidation_scores": "src/repro_torch/kernels/consolidation.py",
    "pair_scatter": "src/repro_torch/kernels/telemetry.py",
    "cusum_scan": "src/repro_torch/kernels/cusum.py",
    "fleet_actions": "src/repro_torch/kernels/fleet_actions.py",
    "flash_attention": "src/repro_torch/kernels/flash_attention.py",
    "rwkv6_scan": "src/repro_torch/kernels/rwkv6_scan.py",
    "mamba_scan": "src/repro_torch/kernels/mamba_scan.py",
}

#: every entry of the JAX package's REGISTRY and the port's entry for it
JAX_COUNTERPARTS: dict[str, str] = {
    "engine_jax.run_trace": "engine_torch._TraceLoop.block",
    "engine_jax.run_trace[metrics]": "engine_torch._TraceLoop.block[metrics]",
    "engine_jax.run_trace[record]": "engine_torch._TraceLoop.block[record]",
    "core.closed_loop.run_closed_loop": "closed_loop.segment_body",
    "core.closed_loop.run_closed_loop[metrics]": "closed_loop.segment_body[metrics]",
    "core.closed_loop.run_closed_loop[record]": "closed_loop.segment_body[record]",
    "core.closed_loop.run_closed_loop[sharded]": "closed_loop.segment_body[sharded]",
    "binpack_jax.greedy_sequence[sharded]": "binpack_torch.greedy_sequence_sharded",
    "telemetry.estimator.update_device": "estimator._update_device",
    "telemetry.estimator.update_bank": "estimator._bank_core",
    "fleet.detect.cusum_update": "detect._cusum_update",
    "telemetry.log.ring_push": "log.ObservationRing.push",
    "kernels.consolidation.consolidation_scores": "kernels.consolidation.consolidation_scores",
    "kernels.telemetry.pair_scatter": "kernels.telemetry.pair_scatter",
    "engine.make_scorer[pallas]": "engine.make_scorer[cuda]",
    "kernels.rwkv6_scan.rwkv6_scan": "kernels.rwkv6_scan.rwkv6_scan",
    "kernels.flash_attention.flash_attention": "kernels.flash_attention.flash_attention",
    "kernels.mamba_scan.mamba_scan": "kernels.mamba_scan.mamba_scan",
}

