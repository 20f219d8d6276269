"""Port: the Fig-8 scorer algebra (``repro_torch.core.binpack_torch``).

Each function is held to its ``binpack_jax`` twin on the same seeded inputs,
and the greedy's placements to ``greedy_sequence_jax`` and the float64
``core/binpack.py`` greedy on the paper's Table-II and Fig-9 cases.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import binpack_jax as jb
from repro.core import M1, M2, PAPER_CLUSTER, ClusterState, Workload, greedy_place, greedy_sequence
from repro.core import parse_workloads, profile_pairwise_fast, snap_to_grid, type_index
from repro.core.units import KB, MB
from repro_torch import convert
from repro_torch.core import binpack_torch as tb
from repro_torch.core import M1 as TM1
from repro_torch.core import M2 as TM2
from repro_torch.core import PAPER_CLUSTER as T_PAPER_CLUSTER
from test_core_binpack import SEQUENCES, _D_CACHE, paper_state

#: f32 loads from the same f32 tables; the sums differ only in order
ATOL = 1e-6


def _fields(obj) -> dict:
    return {f.name: (np.asarray(getattr(obj, f.name))
                     if f.name != "degradation_limit" else getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _clusters(m: int, active=None):
    servers = [M1, M2] * (m // 2)
    D = {s: profile_pairwise_fast(s) for s in (M1, M2)}
    Ds = [D[s] for s in servers]
    jc = jb.PackedCluster.build(servers, Ds, alpha=1.3, active=active)
    tc = tb.PackedCluster.build([TM1, TM2] * (m // 2), Ds, alpha=1.3, active=active,
                                device="cpu")
    return jc, tc


def _counts(m: int, T: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    c = (rng.integers(1, 3, size=(m, T)) * (rng.random((m, T)) < 0.02)).astype(np.float32)
    c[0] = 0.0
    return c


def test_packed_cluster_build_equals_jax_and_convert():
    active = np.array([True, False, True, True])
    jc, tc = _clusters(4, active=active)
    carried = convert.cluster_from_numpy(_fields(jc), device="cpu")
    for f in ("D", "rs", "fs", "llc_budget", "resident", "active"):
        want = np.asarray(getattr(jc, f))
        assert np.array_equal(getattr(tc, f).numpy(), want), f
        assert np.array_equal(getattr(carried, f).numpy(), getattr(tc, f).numpy()), f
    assert carried.degradation_limit == tc.degradation_limit == jc.degradation_limit


def test_server_loads_and_scores_match_jax():
    jc, tc = _clusters(6)
    c = _counts(6, tc.T, seed=1)
    wt = np.array([3, 17, 100, 229, 17], np.int32)
    for got, want in zip(tb.server_loads(tc, torch.tensor(c)), jb.server_loads(jc, jnp.asarray(c))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    np.testing.assert_allclose(tb.avg_loads(tc, torch.tensor(c)).numpy(),
                               np.asarray(jb.avg_loads(jc, jnp.asarray(c))), rtol=0, atol=ATOL)
    got = tb.score_candidates_torch(tc, torch.tensor(c), torch.tensor(wt))
    want = jb.score_candidates_jnp(jc, jnp.asarray(c), jnp.asarray(wt))
    for g, w in zip(got, want):
        assert g.shape == (5, 6)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=ATOL)


def test_greedy_choice_with_masked_server_matches_jax():
    active = np.array([True, False, True, True, False, True])
    jc, tc = _clusters(6, active=active)
    c = _counts(6, tc.T, seed=2)
    wt = np.arange(0, 230, 7, dtype=np.int32)
    ca, ma = jb.score_candidates_jnp(jc, jnp.asarray(c), jnp.asarray(wt))
    for objective in ("sum_avg", "min_after"):
        j_srv, j_ok = jb.greedy_choice(jc, jnp.asarray(c), ca, ma, objective)
        t_srv, t_ok = tb.greedy_choice(tc, torch.tensor(c), torch.tensor(np.asarray(ca)),
                                       torch.tensor(np.asarray(ma)), objective)
        assert np.array_equal(t_srv.numpy(), np.asarray(j_srv))
        assert np.array_equal(t_ok.numpy(), np.asarray(j_ok))
        assert not np.isin(t_srv.numpy(), [1, 4]).any()  # masked servers never win
    assert t_ok.any() and (t_srv.numpy() >= 0).any()


@pytest.mark.parametrize("score", [
    [[0.3, 0.3, 0.1, 0.1 + 5e-7, 0.1]],  # within the margin: first index wins
    [[0.3, 0.1 + 2e-6, 0.1, np.inf]],  # outside the margin: the true min wins
    [[np.inf, np.inf, np.inf]],  # nothing feasible: index 0, as in JAX
    [[0.2, 0.2], [0.5, 0.5 - 1e-7]],  # exact and sub-margin ties, two rows
])
def test_argmin_with_margin_ties_match_jax(score):
    s = np.asarray(score, np.float32)
    got = tb.argmin_with_margin(torch.tensor(s)).numpy()
    assert np.array_equal(got, np.asarray(jb.argmin_with_margin(jnp.asarray(s))))


def _paper_clusters(alpha: float):
    servers = list(PAPER_CLUSTER)
    paper_state()  # fills the shared D cache of the JAX test module
    jc = jb.PackedCluster.build(servers, _D_CACHE["D"], alpha=alpha)
    tc = tb.PackedCluster.build(list(T_PAPER_CLUSTER), _D_CACHE["D"], alpha=alpha,
                                device="cpu")
    counts = np.asarray(jb.counts_from_assignments(jc, paper_state(alpha).assignments))
    return jc, tc, counts


_TABLE2 = "(32KB, 1MB)"  # the Table-II walk-through's arriving workload


@pytest.mark.parametrize("alpha", [1.0, 1.3, 1.5])
@pytest.mark.parametrize("seq", SEQUENCES + [_TABLE2])
def test_greedy_sequence_matches_jax_and_oracle(seq, alpha):
    """Table-II and Fig-9 (Table III initial state, three arrival sequences,
    alpha in {1, 1.3, 1.5}): placements bitwise equal to the jitted greedy
    and to the float64 greedy."""
    arrivals = [snap_to_grid(w) for w in parse_workloads(seq)]
    py, _ = greedy_sequence(paper_state(alpha), arrivals)
    jc, tc, counts = _paper_clusters(alpha)
    wt = np.asarray([type_index(w) for w in arrivals], np.int32)
    _, jx = jb.greedy_sequence_jax(jc, jnp.asarray(counts), jnp.asarray(wt))
    final, tp = tb.greedy_sequence(tc, torch.tensor(counts), torch.tensor(wt))
    assert np.array_equal(tp.numpy(), np.asarray(jx))
    assert [int(p) if p >= 0 else None for p in tp.numpy()] == py
    placed = tp.numpy() >= 0
    assert final.sum().item() == counts.sum() + placed.sum()


def test_greedy_step_queues_without_touching_counts():
    """The not-found side of the greedy's masked count update: a workload
    that fits nowhere leaves counts bitwise unchanged and returns QUEUED."""
    servers = [TM1]
    D = profile_pairwise_fast(M1)
    tc = tb.PackedCluster.build(servers, D, alpha=1.0, device="cpu")
    heavy = type_index(snap_to_grid(Workload(fs=64 * MB, rs=512 * KB)))
    c = torch.zeros(1, tc.T)
    out = []
    for _ in range(6):
        new, p = tb.greedy_step(tc, c, torch.tensor([heavy], dtype=torch.int32))
        if int(p) == tb.QUEUED:
            assert torch.equal(new, c)
        out.append(int(p))
        c = new
    state = ClusterState.empty([M1], D, alpha=1.0)
    want = [greedy_place(state, snap_to_grid(Workload(fs=64 * MB, rs=512 * KB)))
            for _ in range(6)]
    assert out == [tb.QUEUED if p is None else p for p in want]
    assert tb.QUEUED in out
