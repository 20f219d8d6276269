"""Port: the device-resident event loop (``repro_torch.core.engine_torch``).

``trace_segment`` takes a traced arrival count: a trace padded past
``n_valid`` must run bitwise as the unpadded trace does, and as JAX's
``_trace_segment`` places and queues. A block of micro-events must make no
host read, and a run at most ``ceil((4n + 8) / S)`` reads. Cases are
``tests/test_torch_telemetry.py``'s ``queue_drain`` and ``heavy_8srv``
traces, on the CPU.
"""
import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.core import M1, M2, profile_pairwise_fast, type_index
from repro.core import PackedCluster as JaxCluster
from repro.core import PackedDynamics as JaxDynamics
from repro.core import run_trace as jax_run_trace
from repro.core.engine_jax import _trace_segment as jax_trace_segment
from repro.obs.metrics import counter_value
from repro_torch import convert
from repro_torch.core import ConsolidationEngine as TorchEngine
from repro_torch.core import M1 as TM1
from repro_torch.core import M2 as TM2
from repro_torch.core import engine_torch, make_scorer, run_trace
from repro_torch.core.engine import capacity
from repro_torch.core.engine_torch import BLOCK_STEPS, QUEUED, trace_segment
from test_engine import _trace
from test_torch_engine import one_intra_op_thread  # noqa: F401  -- autouse

CASES = {
    "queue_drain": ([M1, M2] * 8, dict(n=64, gap=2e-5, passes=8, seed=3, heavy=True)),
    "heavy_8srv": ([M1, M2] * 4, dict(n=40, gap=3e-5, passes=8, seed=9, heavy=True)),
}
OUTPUTS = ("placement", "was_queued", "place_time", "finish_time", "obs_co", "obs_lost",
           "obs_logr")
SENTINELS = dict(placement=QUEUED, was_queued=False, place_time=-1.0, finish_time=np.inf,
                 obs_co=0.0, obs_lost=0.0, obs_logr=0.0)


def _fields(obj):
    return {f.name: (np.asarray(getattr(obj, f.name)) if f.name != "degradation_limit"
                     else getattr(obj, f.name)) for f in dataclasses.fields(obj)}


@functools.cache
def _case(case: str, pad: int = 0):
    """JAX tables, the same tables carried to the port, and the trace as
    numpy arrays padded by ``pad`` rows (time 0, type 0, 1 byte, as JAX's
    closed loop pads)."""
    servers, kw = CASES[case]
    jc = JaxCluster.build(servers, [profile_pairwise_fast(s) for s in servers])
    jd = JaxDynamics.build(servers)
    tc = convert.cluster_from_numpy(_fields(jc), device="cpu")
    td = convert.dynamics_from_numpy(_fields(jd), device="cpu")
    arrivals = _trace(**kw)
    times = np.asarray([a for a, _ in arrivals], np.float64)
    n = len(arrivals)
    t = np.zeros(n + pad, np.float32)
    ty = np.zeros(n + pad, np.int32)
    by = np.ones(n + pad, np.float32)
    t[:n] = times - times.min()
    ty[:n] = [type_index(w) for _, w in arrivals]
    by[:n] = [w.data_total for _, w in arrivals]
    return jc, jd, tc, td, t, ty, by


def _port(tc, td, t, ty, by, n_valid=None, **kw):
    args = (tc, td, torch.from_numpy(t), torch.from_numpy(ty), torch.from_numpy(by))
    if n_valid is None:
        return run_trace(*args, **kw)
    return trace_segment(*args, n_valid, **kw)


def _reads_bound(n: int) -> int:
    S = min(BLOCK_STEPS, 4 * n + 8)
    return -(-(4 * n + 8) // S)


@pytest.mark.parametrize("case,scorer", [("queue_drain", "torch"), ("heavy_8srv", "cuda")])
def test_padded_trace_segment_equals_run_trace(case, scorer):
    """Rows past ``n_valid`` change nothing: the padded trace places, times
    and integrates bitwise as the unpadded one, and keeps its sentinels
    past ``n_valid``. Each run reads the host at most once per block."""
    pad = 37
    _, _, tc, td, t, ty, by = _case(case)
    _, _, _, _, pt, pty, pby = _case(case, pad)
    n = len(t)
    sc = None if scorer == "torch" else make_scorer(scorer)
    want = _port(tc, td, t, ty, by, scorer=sc, telemetry=True)
    got = _port(tc, td, pt, pty, pby, n_valid=n, scorer=sc, telemetry=True)
    assert bool(want.was_queued.any()) and want.stats.drain_full_scans >= 1
    for name in OUTPUTS:
        g, w = getattr(got, name), getattr(want, name)
        assert torch.equal(g[:n], w), name
        assert bool((g[n:] == SENTINELS[name]).all()), name
    for name in ("makespan", "max_deg", "deadlock"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert (got.stats.events, got.stats.drain_full_scans) == (
        want.stats.events, want.stats.drain_full_scans)
    assert want.stats.host_syncs <= _reads_bound(n)
    assert got.stats.host_syncs <= _reads_bound(n + pad)
    # one read per block; every block before the last ran S live steps
    S, reads = got.stats.block_steps, got.stats.host_syncs
    assert S == BLOCK_STEPS and (reads - 1) * S <= got.stats.events <= reads * S


def test_n_valid_zero_finishes_at_step_zero():
    _, _, tc, td, t, ty, by = _case("heavy_8srv")
    got = _port(tc, td, t, ty, by, n_valid=torch.tensor(0, dtype=torch.int32),
                telemetry=True)
    assert got.stats.events == 0 and got.stats.host_syncs == 1
    for name in OUTPUTS:
        assert bool((getattr(got, name) == SENTINELS[name]).all()), name
    assert float(got.makespan) == 0.0 and not bool(got.deadlock)


@pytest.mark.parametrize("case", list(CASES))
def test_trace_segment_matches_jax_trace_segment(case):
    """The padded trace through JAX's ``_trace_segment`` (jitted with static
    kwargs) and the port's: the same placements and queue decisions, the
    same counters."""
    pad = 24
    jc, jd, tc, td, t, ty, by = _case(case, pad)
    n = len(t) - pad
    seg = jax.jit(functools.partial(jax_trace_segment, objective="sum_avg", scorer=None,
                                    telemetry=True, metrics=True))
    jt = seg(jc, jd, t, ty, by, jnp.int32(n))
    pt = _port(tc, td, t, ty, by, n_valid=n, telemetry=True)
    assert np.array_equal(pt.placement.numpy(), np.asarray(jt.placement))
    assert np.array_equal(pt.was_queued.numpy(), np.asarray(jt.was_queued))
    assert bool(pt.was_queued.any())
    np.testing.assert_allclose(pt.finish_time.numpy(), np.asarray(jt.finish_time), rtol=1e-4)
    assert pt.stats.events == counter_value(jt.metrics, "events")
    assert pt.stats.drain_full_scans == counter_value(jt.metrics, "drain_full_scans") >= 1


@pytest.mark.parametrize("scorer", ["torch", "cuda"])
def test_loop_counters_match_jax_metrics(scorer):
    """``LoopStats.events`` and ``drain_full_scans`` are JAX's ``events`` and
    ``drain_full_scans`` counters of ``run_trace(metrics=True)``, on a trace
    whose drains rescan the whole queue."""
    jc, jd, tc, td, t, ty, by = _case("heavy_8srv")
    jt = jax_run_trace(jc, jd, t, ty, by, metrics=True)
    sc = None if scorer == "torch" else make_scorer(scorer)
    pt = _port(tc, td, t, ty, by, scorer=sc)
    assert np.array_equal(pt.placement.numpy(), np.asarray(jt.placement))
    assert pt.stats.events == counter_value(jt.metrics, "events")
    assert pt.stats.drain_full_scans == counter_value(jt.metrics, "drain_full_scans") >= 1


class _NoHostRead(TorchDispatchMode):
    """Fails on the ops that read a tensor back to the host."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in (torch.ops.aten._local_scalar_dense, torch.ops.aten.nonzero):
            raise AssertionError(f"host read inside a block: {func}")
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def _no_host_read(monkeypatch):
    """The dispatch-mode guard, with ``Tensor.tolist`` and ``Tensor.numpy``
    refused too: they do not reach the dispatcher."""
    def refuse(self, *args, **kwargs):
        raise AssertionError("host read inside a block: Tensor.tolist / Tensor.numpy")

    with monkeypatch.context() as mp:
        mp.setattr(torch.Tensor, "tolist", refuse)
        mp.setattr(torch.Tensor, "numpy", refuse)
        with _NoHostRead():
            yield


def test_no_host_read_guard_catches_reads(monkeypatch):
    x = torch.arange(3.0)
    for read in (lambda: x.sum().item(), lambda: bool(x.any()), lambda: x.tolist(),
                 lambda: x.numpy(), lambda: torch.nonzero(x)):
        with pytest.raises(AssertionError, match="host read"):
            with _no_host_read(monkeypatch):
                read()


@pytest.mark.parametrize("scorer", ["torch", "cuda"])
def test_block_makes_no_host_read(monkeypatch, scorer):
    """Every block of the loop, with telemetry, by either scorer, runs under
    the guard; the host reads only the status between blocks. The trace
    queues, drains and rescans the whole queue inside the blocks."""
    _, _, tc, td, t, ty, by = _case("heavy_8srv")
    sc = None if scorer == "torch" else make_scorer(scorer)
    loop = engine_torch._TraceLoop(tc, td, torch.from_numpy(t), torch.from_numpy(ty),
                                   torch.from_numpy(by), "sum_avg", sc, True)
    blocks = 0
    for _ in range(_reads_bound(len(t))):
        with _no_host_read(monkeypatch):
            loop.block()
        blocks += 1
        done, deadlock, events, full_scans = loop.status.tolist()
        if done:
            break
    assert done and not deadlock and blocks <= _reads_bound(len(t))
    assert full_scans >= 1 and bool(loop.st.was_queued.any())
    assert bool(loop.st.obs_co.any()) and bool(torch.isfinite(loop.st.finish_time).all())


def test_engine_reuses_one_loop_per_capacity():
    """Traces of one capacity share the engine's loop: its static buffers are
    refilled per run (arrivals, and D after ``set_D``), so every run equals
    the same run on a fresh engine."""
    servers = [TM1, TM2] * 4
    D = [profile_pairwise_fast(s) for s in (M1, M2) * 4]
    a = _trace(24, gap=2e-5, passes=8, seed=4, heavy=True)
    b = _trace(19, gap=2e-5, passes=8, seed=9, heavy=True)
    assert capacity(len(a)) == capacity(len(b)) == 32
    eng = TorchEngine(servers, D=D, scorer="torch", device="cpu")
    runs = [eng.run(a), eng.run(b)]
    eng.set_D([d * 0.5 for d in D])
    runs.append(eng.run(b))
    assert len(eng._loops) == 1
    fresh = [TorchEngine(servers, D=D, scorer="torch", device="cpu").run(a),
             TorchEngine(servers, D=D, scorer="torch", device="cpu").run(b),
             TorchEngine(servers, D=[d * 0.5 for d in D], scorer="torch",
                         device="cpu").run(b)]
    for got, want in zip(runs, fresh):
        assert got.placements == want.placements and got.was_queued == want.was_queued
        assert got.finish_times == want.finish_times and got.makespan == want.makespan
        assert got.stats == want.stats
    assert any(runs[0].was_queued) and runs[1].placements != runs[2].placements
