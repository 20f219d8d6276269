"""Port: the float64 oracle copies (ROADMAP item 3) against ``repro``.

``repro_torch.core.{binpack,scheduler,calibrate,refine}`` and the
``simulate_corun`` they run on are copies of the JAX package's numpy
modules: on the inputs of ``tests/test_core_binpack.py``,
``test_core_scheduler.py``, ``test_core_calibrate.py`` and
``test_refine_placement.py`` they must give ``repro``'s results bit for bit.
``ConsolidationEngine(backend="numpy")`` runs the copied ``OnlineScheduler``
and must equal JAX's numpy backend exactly. The tensor twins of JAX's
array-native paths -- ``local_search_torch`` (``local_search_jax``) and
``brute_force_torch`` / ``evaluate_assignment`` (``binpack_jax``) -- must
make the same moves and find the same optimum, on the CPU.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import (M1, M2, PAPER_CLUSTER, ClusterState, ConsolidationEngine, OnlineScheduler,
                        PackedCluster, Workload, brute_force, brute_force_jax,
                        counts_from_assignments, first_fit, greedy_sequence, parse_workloads,
                        profile_pairwise_fast, run_allocator, simulate_corun, snap_to_grid,
                        type_index)
from repro.core import binpack as jbinpack
from repro.core import refine as jrefine
from repro.core.binpack_jax import evaluate_assignment as jax_evaluate_assignment
from repro.core.calibrate import calibrate_alpha, sweep_alpha
from repro.core.engine_jax import local_search_jax
from repro.core.units import KB, MB
from repro_torch.core import M1 as TM1
from repro_torch.core import M2 as TM2
from repro_torch.core import PAPER_CLUSTER as TPAPER
from repro_torch.core import ConsolidationEngine as TorchEngine
from repro_torch.core import PackedCluster as TorchCluster
from repro_torch.core import binpack as tbinpack
from repro_torch.core import calibrate as tcalibrate
from repro_torch.core import refine as trefine
from repro_torch.core import scheduler as tscheduler
from repro_torch.core import simulator as tsimulator
from repro_torch.core.binpack_torch import (brute_force_torch, counts_from_assignments as
                                            tcounts_from_assignments, evaluate_assignment,
                                            score_candidates_torch)
from repro_torch.core.engine_torch import local_search_torch
from repro_torch.core.workload import Workload as TWorkload
from test_core_binpack import INITIAL, SEQUENCES
from test_engine import _trace
from test_torch_engine import one_intra_op_thread  # noqa: F401  -- autouse

_PORT_SPEC = {M1: TM1, M2: TM2}
_D = {}


def _pw(w: Workload) -> TWorkload:
    return TWorkload(**dataclasses.asdict(w))


def _D_of(s):
    if s not in _D:
        _D[s] = profile_pairwise_fast(s)
    return _D[s]


def _states(alpha=1.3):
    """Table III's initial cluster in both packages (the same D arrays)."""
    servers = list(PAPER_CLUSTER)
    D = [_D_of(s) for s in servers]
    j = ClusterState.empty(servers, D, alpha=alpha)
    t = tbinpack.ClusterState.empty(list(TPAPER), D, alpha=alpha)
    for i, txt in INITIAL.items():
        j.assignments[i] = [snap_to_grid(w) for w in parse_workloads(txt)]
        t.assignments[i] = [_pw(w) for w in j.assignments[i]]
    return j, t


def _types(state) -> list[list[int]]:
    return [[type_index(w) for w in ws] for ws in state.assignments]


@pytest.mark.parametrize("seq", SEQUENCES)
def test_binpack_copy_bitwise(seq):
    """Greedy (both objectives), first fit and the Fig-9 metrics on Table
    III's cluster: the same placements and the same float64 bits."""
    arrivals = [snap_to_grid(w) for w in parse_workloads(seq)]
    for objective in ("sum_avg", "min_after"):
        j, t = _states()
        jp, jq = greedy_sequence(j, arrivals, objective)
        tp, tq = tbinpack.greedy_sequence(t, [_pw(w) for w in arrivals], objective)
        assert jp == tp and len(jq) == len(tq)
        assert _types(j) == _types(t)
        assert j.total_avg_load() == t.total_avg_load()
        assert jbinpack.average_min_throughput(j) == tbinpack.average_min_throughput(t)
        assert (jbinpack.average_min_throughput_simulated(j)
                == tbinpack.average_min_throughput_simulated(t))
    j, t = _states()
    jp, js = run_allocator(j, arrivals, first_fit)
    tp, ts = tbinpack.run_allocator(t, [_pw(w) for w in arrivals], tbinpack.first_fit)
    assert jp == tp and js.total_avg_load() == ts.total_avg_load()


def test_brute_force_copy_and_tensor_twin():
    """The paper's exhaustive baseline on Table III's first sequence: the
    copy gives ``repro``'s cost and assignment bit for bit; the tensor twin
    the cost (float32, rel 1e-5) and assignment of ``brute_force_jax``."""
    arrivals = [snap_to_grid(w) for w in parse_workloads(SEQUENCES[0])]
    j, t = _states()
    cost, assign = brute_force(j, arrivals)
    tcost, tassign = tbinpack.brute_force(t, [_pw(w) for w in arrivals])
    assert (cost, assign) == (tcost, tassign)

    servers = list(PAPER_CLUSTER)
    D = [_D_of(s) for s in servers]
    jc = PackedCluster.build(servers, D, alpha=1.3)
    tc = TorchCluster.build(list(TPAPER), D, alpha=1.3, device="cpu")
    j, t = _states()
    counts = counts_from_assignments(jc, j.assignments)
    tcounts = tcounts_from_assignments(tc, t.assignments)
    assert np.array_equal(tcounts.numpy(), np.asarray(counts))
    wt = [type_index(w) for w in arrivals]
    jcost, jassign = brute_force_jax(jc, counts, jnp.asarray(wt))
    pcost, passign = brute_force_torch(tc, tcounts, torch.tensor(wt))
    assert pcost == pytest.approx(jcost, rel=1e-5) and pcost == pytest.approx(cost, rel=1e-5)
    assert np.array_equal(passign, jassign)
    assert [None if a < 0 else int(a) for a in passign] == list(assign)


def test_evaluate_assignment_and_fleet_mask():
    """Single and batched assignments against JAX's ``evaluate_assignment``;
    an evicted server makes every assignment that uses it infeasible."""
    servers = list(PAPER_CLUSTER)
    D = [_D_of(s) for s in servers]
    active = np.array([1.0, 0.0, 1.0, 1.0], np.float32)
    jc = PackedCluster.build(servers, D, alpha=1.3, active=active)
    tc = TorchCluster.build(list(TPAPER), D, alpha=1.3, active=active, device="cpu")
    j, t = _states()
    counts = counts_from_assignments(jc, j.assignments)
    tcounts = tcounts_from_assignments(tc, t.assignments)
    wt = [type_index(snap_to_grid(w)) for w in parse_workloads(SEQUENCES[1])]
    rng = np.random.default_rng(0)
    assigns = rng.integers(-1, 4, size=(64, len(wt)))
    bcost, bok = evaluate_assignment(tc, tcounts, torch.tensor(wt), torch.from_numpy(assigns))
    for k, a in enumerate(assigns):
        jcost, jok = jax_evaluate_assignment(jc, counts, jnp.asarray(wt), jnp.asarray(a))
        cost, ok = evaluate_assignment(tc, tcounts, torch.tensor(wt), torch.from_numpy(a))
        assert bool(ok) == bool(jok) == bool(bok[k])
        assert float(cost) == pytest.approx(float(jcost), rel=1e-6) or not bool(jok)
        assert float(bcost[k]) == float(cost) or not bool(ok)
        if (a == 1).any():
            assert not bool(ok)
    jcost, jassign = brute_force_jax(jc, counts, jnp.asarray(wt))
    pcost, passign = brute_force_torch(tc, tcounts, torch.tensor(wt))
    assert pcost == pytest.approx(jcost, rel=1e-5) and np.array_equal(passign, jassign)
    assert 1 not in passign.tolist()


def test_scheduler_and_simulator_copy_bitwise():
    """``tests/test_core_scheduler.py``'s inputs: the co-run simulation and
    the online scheduler's whole event list, the same float64 bits."""
    for ws in ([Workload(fs=512 * KB, rs=64 * KB)] * 3, [Workload(fs=2 * MB, rs=512 * KB)] * 6):
        want = simulate_corun(M1, ws)
        got = tsimulator.simulate_corun(TM1, [_pw(w) for w in ws])
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
    D = _D_of(M1)
    light = [snap_to_grid(Workload(fs=512 * KB, rs=64 * KB)) for _ in range(3)]
    heavy = snap_to_grid(Workload(fs=64 * MB, rs=512 * KB))
    for arrivals in ([(0.0, light[0]), (0.0, light[1]), (0.01, light[2])], [(0.0, heavy)] * 5,
                     _trace(24, gap=3e-5, passes=8, seed=9, heavy=True)):
        jr = OnlineScheduler(ClusterState.empty([M1], D, alpha=1.3)).run(
            [(t, dataclasses.replace(w)) for t, w in arrivals])
        tr = tscheduler.OnlineScheduler(tbinpack.ClusterState.empty([TM1], D, alpha=1.3)).run(
            [(t, _pw(w)) for t, w in arrivals])
        assert [(e.time, e.kind, e.server) for e in jr.events] == [
            (e.time, e.kind, e.server) for e in tr.events]
        assert (jr.makespan, jr.placements, jr.max_observed_degradation) == (
            tr.makespan, tr.placements, tr.max_observed_degradation)


def test_calibrate_copy_bitwise():
    for s in (M1, M2):
        assert tcalibrate.calibrate_alpha(_PORT_SPEC[s]) == calibrate_alpha(s)
    arrivals = [snap_to_grid(w) for w in parse_workloads("(256KB, 1MB), " * 8)]
    D = [_D_of(M1)]
    want = sweep_alpha([M1], D, [[]], arrivals, alphas=(1.0, 1.25, 1.5))
    got = tcalibrate.sweep_alpha([TM1], D, [[]], [_pw(w) for w in arrivals],
                                 alphas=(1.0, 1.25, 1.5))
    assert got == want and tcalibrate.pick_alpha(got) == 1.25


def _refine_cases():
    """``tests/test_refine_placement.py``'s three starting states."""
    cases = []
    rng = np.random.default_rng(3)
    servers = [M1, M2]
    state = ClusterState.empty(servers, [_D_of(s) for s in servers], alpha=1.3)
    ws = [snap_to_grid(Workload(fs=float(rng.choice([256 * KB, 1 * MB, 4 * MB])),
                                rs=float(rng.choice([16 * KB, 64 * KB, 256 * KB]))))
          for _ in range(8)]
    for w in ws:
        state.assignments[0].append(w)
        if not state.check(0).ok:
            state.assignments[0].pop()
            state.assignments[1].append(w)
    cases.append(state)
    state = ClusterState.empty([M1, M1], [_D_of(M1)] * 2, alpha=1.3)
    w = snap_to_grid(Workload(fs=1 * MB, rs=64 * KB))
    state.assignments[0] = [w, w, w]
    cases.append(state)
    rng = np.random.default_rng(11)
    servers = [M1, M2, M1]
    ws = [snap_to_grid(Workload(fs=float(rng.choice([512 * KB, 2 * MB, 16 * MB])),
                                rs=float(rng.choice([8 * KB, 64 * KB, 512 * KB]))))
          for _ in range(9)]
    state = ClusterState.empty(servers, [_D_of(s) for s in servers], alpha=1.3)
    greedy_sequence(state, ws)
    cases.append(state)
    return cases


def _port_state(state):
    return tbinpack.ClusterState(tuple(_PORT_SPEC[s] for s in state.servers), state.D,
                                 state.alphas, [[_pw(w) for w in ws] for ws in state.assignments])


@pytest.mark.parametrize("case", range(3))
def test_refine_copy_and_engine_search(case):
    """``local_search`` (first improvement, float64) bit for bit, and
    ``local_search_engine`` on the tensor search against JAX's: the same
    moves and the same type counts per server."""
    state = _refine_cases()[case]
    want, n = jrefine.local_search(state)
    got, tn = trefine.local_search(_port_state(state))
    assert n == tn and _types(want) == _types(got)
    assert want.total_avg_load() == got.total_avg_load()
    jref, jmoves = jrefine.local_search_engine(state)
    tref, tmoves = trefine.local_search_engine(_port_state(state), device="cpu")
    assert jmoves == tmoves
    assert [sorted(ts) for ts in _types(jref)] == [sorted(ts) for ts in _types(tref)]
    assert tref.feasible() and tref.total_avg_load() <= got.total_avg_load() + 1.0


@pytest.mark.parametrize("scorer", ["cuda", "torch"])
def test_local_search_torch_matches_jax(scorer):
    """A lopsided packing of 8 servers and one from the greedy: the same
    counts and moves as ``local_search_jax``, by the kernel's wrapper (its
    plain version on the CPU) and by the incremental scorer; an evicted
    server receives nothing; ``max_iters`` caps the moves."""
    servers = [M1, M2] * 4
    D = [_D_of(s) for s in servers]
    sc = None if scorer == "cuda" else score_candidates_torch
    rng = np.random.default_rng(0)
    lopsided = np.zeros((8, 230), np.float32)
    for _ in range(24):
        lopsided[rng.integers(0, 3), rng.integers(0, 230)] += 1
    state = ClusterState.empty(servers, D, alpha=1.3)
    greedy_sequence(state, [w for _, w in _trace(24, gap=3e-5, passes=8, seed=9, heavy=True)])
    jc0 = PackedCluster.build(servers, D)
    greedy = np.array(counts_from_assignments(jc0, state.assignments))
    active = np.ones(8, np.float32)
    active[5] = 0.0
    for counts, act, cap in ((lopsided, None, 100), (greedy, None, 100), (lopsided, active, 100),
                             (lopsided, None, 3)):
        jc = PackedCluster.build(servers, D, active=act)
        tc = TorchCluster.build([_PORT_SPEC[s] for s in servers], D, active=act, device="cpu")
        jcounts, jmoves = local_search_jax(jc, jnp.asarray(counts), max_iters=cap)
        tcounts, tmoves = local_search_torch(tc, torch.from_numpy(counts), cap, scorer=sc)
        assert int(tmoves) == int(jmoves)
        assert int(tmoves) > 0 or counts is greedy  # the greedy's packing may be a local optimum
        assert np.array_equal(tcounts.numpy(), np.asarray(jcounts))
        if act is not None:
            assert (tcounts[5] <= torch.from_numpy(counts[5])).all()
    assert int(jmoves) == 3


def test_numpy_backend_equals_jax_numpy_backend():
    """``ConsolidationEngine(backend="numpy")`` is the copied oracle: the
    placements, queue decisions, times and makespan of JAX's numpy backend,
    exactly, with the engine's default device loop placing the same."""
    servers = [M1, M2] * 4
    port_servers = [_PORT_SPEC[s] for s in servers]
    arrivals = _trace(40, gap=3e-5, passes=8, seed=9, heavy=True)
    want = ConsolidationEngine(servers).run(arrivals, backend="numpy")
    got = TorchEngine(port_servers, device="cpu", backend="numpy").run(
        [(t, _pw(w)) for t, w in arrivals])
    assert got.backend == "numpy" and any(got.was_queued)
    for field in ("placements", "was_queued", "place_times", "finish_times", "makespan",
                  "max_observed_degradation"):
        assert getattr(got, field) == getattr(want, field), field
    loop = TorchEngine(port_servers, device="cpu").run(arrivals)
    assert loop.backend == "torch" and loop.placements == got.placements
    assert TorchEngine(port_servers, device="cpu").run(arrivals, "numpy").placements == \
        got.placements
    masked = TorchEngine(port_servers, device="cpu", backend="numpy",
                         active=[True] * 7 + [False])
    with pytest.raises(ValueError, match="mask"):
        masked.run(arrivals)
    with pytest.raises(ValueError, match="backend"):
        TorchEngine(port_servers, device="cpu", backend="jax")
