"""Port: the online consolidation engine (``repro_torch.core.engine``).

Every case of ``tests/test_engine.py`` runs through the port on the CPU and
is held to the JAX engine (``backend='jax'``) and the float64 oracle
(``backend='numpy'``): identical placements and queue decisions, makespan
within 1e-3 relative. The copied numpy modules and the carried-across tables
are held to ``repro`` bitwise.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import M1, M2, PAPER_CLUSTER, ConsolidationEngine
from repro.core import PackedCluster as JaxCluster
from repro.core import PackedDynamics as JaxDynamics
from repro.core import Workload, contention, counts_from_assignments, criteria
from repro.core import profile_pairwise_fast, run_trace as jax_run_trace, simulate_corun
from repro.core import snap_to_grid, type_index
from repro.core.units import KB, MB
from repro.core.workload import grid_types
from repro_torch import convert
from repro_torch.core import ConsolidationEngine as TorchEngine
from repro_torch.core import Deadlock
from repro_torch.core import M1 as TM1
from repro_torch.core import M2 as TM2
from repro_torch.core import PAPER_CLUSTER as T_PAPER_CLUSTER
from repro_torch.core import PackedCluster, PackedDynamics, corun_rates, run_trace
from repro_torch.core import score_candidates, score_candidates_torch
from repro_torch.core import contention as tcontention
from repro_torch.core import criteria as tcriteria
from repro_torch.core import engine_torch
from repro_torch.core.workload import grid_types as tgrid_types
from repro_torch.distributed import DENSE
from repro_torch.kernels.consolidation import consolidation_scores_torch
from test_engine import _trace

SCORERS = ["torch", "cuda"]  # "cuda" runs the kernel's plain version on the CPU


def _port(specs):
    return [{M1: TM1, M2: TM2}[s] for s in specs]


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread per module: the engine's CPU blocks are hundreds
    of small ops per step, where a thread team per op costs more than it
    saves, and far more when test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def rack16():
    """16-server rack (alternating M1/M2): the JAX engine and the port's, one
    per scorer, sharing the profiling pass."""
    servers = [M1, M2] * 8
    jax_engine = ConsolidationEngine(servers)
    ports = {s: TorchEngine(_port(servers), D=jax_engine.D, scorer=s, device="cpu")
             for s in SCORERS}
    return jax_engine, ports


def _assert_parity(jax_engine, port, arrivals, makespan_rtol=1e-3):
    py = jax_engine.run(arrivals, backend="numpy")
    jx = jax_engine.run(arrivals, backend="jax")
    pt = port.run(arrivals)
    assert pt.backend == "torch"
    for ref in (py, jx):
        assert pt.placements == ref.placements
        assert pt.was_queued == ref.was_queued
        assert pt.makespan == pytest.approx(ref.makespan, rel=makespan_rtol)
    return py, pt


@pytest.mark.parametrize("scorer", SCORERS)
def test_engine_parity_16srv_64_arrivals(rack16, scorer):
    jax_engine, ports = rack16
    _assert_parity(jax_engine, ports[scorer], _trace(64, gap=1e-3))


@pytest.mark.parametrize("scorer", SCORERS)
def test_engine_parity_queueing_and_drain(rack16, scorer):
    jax_engine, ports = rack16
    arrivals = _trace(64, gap=2e-5, passes=8, seed=3, heavy=True)
    py, pt = _assert_parity(jax_engine, ports[scorer], arrivals)
    assert sum(py.was_queued) >= 1
    assert pt.stats.drain_full_scans >= 1  # the whole-queue rescan ran
    first_fin = min(t for t in py.finish_times if np.isfinite(t))
    for i in range(len(arrivals)):
        if py.was_queued[i] and py.placements[i] is not None:
            assert pt.place_times[i] >= first_fin - 1e-6


@pytest.mark.parametrize("scorer", SCORERS)
def test_engine_parity_epoch_scale_timestamps(rack16, scorer):
    jax_engine, ports = rack16
    base = 1.7e9
    arrivals = [(base + t, w) for t, w in _trace(48, gap=1e-3, seed=11)]
    py, pt = _assert_parity(jax_engine, ports[scorer], arrivals)
    assert pt.makespan > base


@pytest.mark.parametrize("scorer", SCORERS)
def test_engine_parity_single_server_queue(scorer):
    jax_engine = ConsolidationEngine([M1])
    port = TorchEngine([TM1], scorer=scorer, device="cpu")
    heavy = snap_to_grid(Workload(fs=64 * MB, rs=512 * KB))
    py, pt = _assert_parity(jax_engine, port, [(0.0, heavy)] * 5)
    assert sum(py.was_queued) >= 1
    assert all(p is not None for p in pt.placements)
    assert all(np.isfinite(t) for t in pt.finish_times)


def test_engine_cuda_scorer_route_matches_pallas():
    """The kernel route (its plain version on the CPU) against the JAX
    engine driven through the Pallas kernel, and the oracle."""
    jax_engine = ConsolidationEngine([M1, M2], scorer="pallas")
    port = TorchEngine([TM1, TM2], scorer="cuda", device="cpu")
    _assert_parity(jax_engine, port, _trace(12, gap=1e-4, seed=5))


@pytest.mark.parametrize("scorer", SCORERS)
def test_engine_max_degradation_close_to_oracle(rack16, scorer):
    jax_engine, ports = rack16
    arrivals = _trace(48, gap=5e-5, passes=4, seed=7)
    py = jax_engine.run(arrivals, backend="numpy")
    pt = ports[scorer].run(arrivals)
    assert pt.max_observed_degradation == pytest.approx(py.max_observed_degradation, abs=1e-3)


def test_engine_deadlock_raises():
    w = snap_to_grid(Workload(fs=8 * MB, rs=512 * KB))
    with pytest.raises(RuntimeError):
        ConsolidationEngine([M1], alpha=0.01).run([(0.0, w)], backend="jax")
    with pytest.raises(Deadlock):
        TorchEngine([TM1], alpha=0.01, device="cpu").run([(0.0, w)])


def test_engine_empty_trace_and_unported_flags():
    """An empty trace on every mode; ``metrics`` and ``record`` (item 7) now
    run as JAX's do: an empty frame, the ring passed in (or none), and the
    numpy oracle refuses them with JAX's ``ValueError``."""
    from repro.obs import metrics as JM
    from repro_torch.obs import metrics as TM
    from repro_torch.obs import recorder as TR

    port = TorchEngine([TM1], device="cpu")
    res = port.run([])
    assert res.backend == "torch" and res.placements == () and res.stats is None
    got = port.run([], metrics=True).metrics
    want = ConsolidationEngine([M1]).run([], backend="jax", metrics=True).metrics
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert port.run([], record=True).decisions is None
    ring = TR.init(4)
    assert port.run([], record=True, rec=ring).decisions is ring
    assert TM.counter_value(got, "events") == JM.counter_value(want, "events") == 0
    oracle = TorchEngine([TM1], device="cpu", backend="numpy")
    for flag in ("metrics", "record", "telemetry"):
        with pytest.raises(ValueError, match=flag):
            oracle.run([], **{flag: True})
    assert len(port.run([], telemetry=True).observations) == 0
    with pytest.raises(ValueError):
        TorchEngine([TM1], scorer="pallas", device="cpu")


def test_corun_rates_match_simulator():
    servers = [M1, M2]
    D = [profile_pairwise_fast(s) for s in servers]
    cluster = PackedCluster.build(_port(servers), D, alpha=1.3, device="cpu")
    dyn = PackedDynamics.build(_port(servers), device="cpu")
    ws = [snap_to_grid(Workload(fs=fs, rs=rs))
          for fs, rs in [(512 * KB, 64 * KB), (2 * MB, 256 * KB), (64 * MB, 512 * KB)]]
    assignments = [ws, ws[:2]]
    jc = JaxCluster.build(servers, D, alpha=1.3)
    counts = torch.tensor(np.asarray(counts_from_assignments(jc, assignments)))
    K = max(len(a) for a in assignments)
    slot_type = np.full((2, K), -1, np.int32)
    for s, a in enumerate(assignments):
        for k, w in enumerate(a):
            slot_type[s, k] = type_index(w)
    rates = corun_rates(cluster, dyn, counts, torch.tensor(slot_type)).numpy()
    for s, a in enumerate(assignments):
        want = simulate_corun(servers[s], a).throughputs
        np.testing.assert_allclose(rates[s, :len(a)], want, rtol=1e-4)


@pytest.mark.parametrize("spec", range(len(PAPER_CLUSTER)))
def test_copied_numpy_modules_bitwise(spec):
    """The port's copies of the profiling pipeline give repro's float64
    tables bit for bit (the same spec values, the same arithmetic)."""
    js, ts = PAPER_CLUSTER[spec], T_PAPER_CLUSTER[spec]
    assert dataclasses.asdict(js) == dataclasses.asdict(ts)
    assert np.array_equal(tcontention.profile_pairwise_fast(ts), contention.profile_pairwise_fast(js))
    for a, b in zip(tcontention.pair_slowdown_matrices(ts), contention.pair_slowdown_matrices(js)):
        assert np.array_equal(a, b)
    got, want = tcontention.type_tables(ts), contention.type_tables(js)
    assert got.keys() == want.keys()
    assert all(np.array_equal(got[k], want[k]) for k in want)
    # core/criteria.py: the same constants and the same admission checks
    assert tcriteria.DEGRADATION_LIMIT == criteria.DEGRADATION_LIMIT
    assert tcriteria.eviction_rate_floor(0.4) == criteria.eviction_rate_floor(0.4)
    D = contention.profile_pairwise_fast(js)
    for sl in (slice(0), slice(1), slice(100, 104), slice(None, None, 23)):
        a = tcriteria.check_consolidation(ts, tgrid_types()[sl], D, alpha=1.3)
        b = criteria.check_consolidation(js, grid_types()[sl], D, alpha=1.3)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)


def test_dynamics_build_equals_jax_and_convert():
    servers = [M1, M2, M2]
    jd = JaxDynamics.build(servers)
    td = PackedDynamics.build(_port(servers), device="cpu")
    carried = convert.dynamics_from_numpy(
        {f.name: np.asarray(getattr(jd, f.name)) for f in dataclasses.fields(jd)}, device="cpu")
    for f in dataclasses.fields(td):
        want = np.asarray(getattr(jd, f.name))
        assert np.array_equal(getattr(td, f.name).numpy(), want), f.name
        assert np.array_equal(getattr(carried, f.name).numpy(), want), f.name


def test_run_trace_on_carried_tables_matches_jax():
    """The slice as a whole on identical inputs: the JAX tables carried across
    with ``convert`` and one arrival trace through both event loops."""
    servers = [M1, M2] * 4
    jc = JaxCluster.build(servers, [profile_pairwise_fast(s) for s in servers])
    jd = JaxDynamics.build(servers)
    fields = lambda obj: {f.name: (np.asarray(getattr(obj, f.name))  # noqa: E731
                                   if f.name != "degradation_limit" else getattr(obj, f.name))
                          for f in dataclasses.fields(obj)}
    tc = convert.cluster_from_numpy(fields(jc), device="cpu")
    td = convert.dynamics_from_numpy(fields(jd), device="cpu")
    arr = _trace(40, gap=3e-5, passes=8, seed=9, heavy=True)
    t = np.asarray([a for a, _ in arr], np.float32)
    ty = np.asarray([type_index(w) for _, w in arr], np.int32)
    by = np.asarray([w.data_total for _, w in arr], np.float32)
    jt = jax_run_trace(jc, jd, t, ty, by)
    tt = run_trace(tc, td, torch.tensor(t), torch.tensor(ty), torch.tensor(by))
    assert np.array_equal(tt.placement.numpy(), np.asarray(jt.placement))
    assert np.array_equal(tt.was_queued.numpy(), np.asarray(jt.was_queued))
    assert bool(tt.was_queued.any())
    np.testing.assert_allclose(tt.finish_time.numpy(), np.asarray(jt.finish_time), rtol=1e-4)
    assert tt.stats.events <= 4 * len(arr) + 8
    # metrics (item 7) run, with JAX's counters and the same decisions
    jm = jax_run_trace(jc, jd, t, ty, by, metrics=True)
    tm = run_trace(tc, td, torch.tensor(t), torch.tensor(ty), torch.tensor(by), metrics=True)
    assert torch.equal(tm.placement, tt.placement) and tt.metrics is None
    assert np.array_equal(tm.metrics.counters.numpy(), np.asarray(jm.metrics.counters))
    assert np.array_equal(tm.metrics.per_server.numpy(), np.asarray(jm.metrics.per_server))
    # the server axis (item 8): the dense axis is the unthreaded loop, bit for
    # bit, and anything that is not a ServerAxis is refused
    td_ = run_trace(tc, td, torch.tensor(t), torch.tensor(ty), torch.tensor(by), axis=DENSE)
    for f in ("placement", "was_queued", "place_time", "finish_time", "makespan", "max_deg"):
        assert torch.equal(getattr(td_, f), getattr(tt, f)), f
    assert td_.stats == tt.stats
    with pytest.raises(TypeError, match="ServerAxis"):
        run_trace(tc, td, torch.tensor(t), torch.tensor(ty), torch.tensor(by), axis=object())


def test_masked_writes_not_found_side():
    """The conditional writes JAX drops out of bounds are masked here: a
    candidate that is not placed (index n, or a real arrival) changes only
    the queue flags it should, and a drain over an empty queue changes
    nothing but the drain flag."""
    servers = [TM1, TM2]
    cl = PackedCluster.build(servers, [profile_pairwise_fast(s) for s in (M1, M2)], device="cpu")
    dyn = PackedDynamics.build(servers, device="cpu")
    n = 4
    loop = engine_torch._TraceLoop(cl, dyn, torch.zeros(n), torch.full((n,), 5, dtype=torch.int32),
                                   torch.ones(n), "sum_avg", None)
    st = engine_torch.EngineState.zeros(cl.m, cl.T, n, cl.device)
    before = {k: v.clone() for k, v in vars(st).items() if torch.is_tensor(v)}

    def changed():
        return {k for k, v in vars(st).items() if torch.is_tensor(v) and not torch.equal(v, before[k])}

    no = torch.tensor([False])
    one = lambda v, dt=torch.long: torch.tensor([v], dtype=dt)  # noqa: E731
    # drain-style miss at the "no candidate" index n: nothing changes
    loop.place_if(st, no, one(n), one(1), one(5), one(1.0, torch.float32), st.now, False)
    assert changed() == set()
    # arrival-style miss: only the queue flags of that arrival change
    loop.place_if(st, no, one(2), one(1), one(5), one(1.0, torch.float32), st.now, True)
    assert changed() == {"queued", "was_queued"}
    assert st.queued.tolist() == [False, False, True, False] == st.was_queued.tolist()
    # a drain over an empty queue (a drain right after the last queued item ran)
    st.queued.zero_()
    st.draining = torch.tensor(True)
    before = {k: v.clone() for k, v in vars(st).items() if torch.is_tensor(v)}
    loop.drain_branch(st, None, None)
    assert changed() == {"draining"} and not bool(st.draining)
    # a hit commits the slot, the counts and the placement
    loop.place_if(st, torch.tensor([True]), one(3), one(1), one(5), one(2.0, torch.float32),
                  st.now, False)
    assert int(st.placement[3]) == 1 and float(st.counts[1, 5]) == 1.0
    assert st.slot_type[1].tolist().count(5) == 1 and float(st.slot_rem[1].max()) == 2.0


def test_set_active_and_set_D_match_jax(rack16):
    """A masked server takes no work, exactly as in the JAX engine; swapping
    D rebuilds the scoring tables."""
    jax_engine, ports = rack16
    mask = np.ones(16, bool)
    mask[[0, 5]] = False
    jax16 = ConsolidationEngine([M1, M2] * 8, D=jax_engine.D, active=mask)
    port = TorchEngine(_port([M1, M2] * 8), D=jax_engine.D, scorer="cuda", device="cpu")
    port.set_active(mask)
    arrivals = _trace(64, gap=1e-3, seed=4)
    jx, pt = jax16.run(arrivals, backend="jax"), port.run(arrivals)
    assert pt.placements == jx.placements and pt.was_queued == jx.was_queued
    assert not {0, 5} & set(pt.placements)
    port.set_D([d * 0.5 for d in jax_engine.D])
    assert torch.equal(port.cluster.D, 0.5 * ports["cuda"].cluster.D)
    assert port.cluster.active.tolist() == mask.astype(np.float32).tolist()


def test_score_candidates_dispatch():
    servers = [TM1, TM2, TM1]
    cl = PackedCluster.build(servers, [profile_pairwise_fast(s) for s in (M1, M2, M1)],
                             device="cpu")
    counts = torch.zeros(3, cl.T)
    counts[1, [4, 40]] = 1.0
    wt = torch.tensor([4, 100], dtype=torch.int32)
    fs_res = cl.resident * cl.fs[None, :]
    want_cuda = consolidation_scores_torch(counts, cl.D, cl.rs, fs_res, cl.llc_budget, wt)
    want_torch = score_candidates_torch(cl, counts, wt)
    for backend, want in (("cuda", want_cuda), ("torch", want_torch)):
        got = score_candidates(cl, counts, wt, backend)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    np.testing.assert_allclose(want_cuda[1].numpy(), want_torch[1].numpy(), atol=1e-6)
