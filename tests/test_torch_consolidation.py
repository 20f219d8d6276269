"""Port: the Q x m candidate scorer (``repro_torch.kernels.consolidation``).

The CUDA kernel runs only on the card (``chip_smoke.py`` holds it against
its plain version there). Here the plain PyTorch version is held to the
Pallas kernel in interpret mode and to the float64 reference, on the same
seeded inputs, and the wrapper's CPU route and argument checks are tested.
"""
import numpy as np
import pytest
import torch

from repro.core import M1, M2
from repro.core import PackedCluster as JaxCluster
from repro.core import profile_pairwise_fast
from repro.kernels.consolidation import consolidation_scores as pallas_scores
from repro.kernels.ref import consolidation_scores_ref
from repro_torch.kernels import _build, ops
from repro_torch.kernels import consolidation as kc

#: f32 scores vs the f32 Pallas kernel and the f64 reference: sums of a few
#: D entries (< 1) and exact byte counts, so 1e-5 absolute is ~100 ulp
ATOL = 1e-5


def _inputs(m: int, Q: int, seed: int):
    """Numpy scorer inputs: profiled D for alternating M1/M2, sparse counts
    with server 0 empty, candidates both present in and absent from counts."""
    rng = np.random.default_rng(seed)
    servers = [M1, M2] * (m // 2)
    D = {s: profile_pairwise_fast(s) for s in (M1, M2)}
    cl = JaxCluster.build(servers, [D[s] for s in servers], alpha=1.3)
    T = cl.T
    counts = (rng.integers(1, 4, size=(m, T)) * (rng.random((m, T)) < 0.05)).astype(np.float32)
    counts[0] = 0.0
    present = np.flatnonzero(counts.sum(0) > 0)
    wtypes = rng.integers(0, T, size=Q).astype(np.int32)
    wtypes[: Q // 2] = rng.choice(present, Q // 2)
    f = {k: np.asarray(getattr(cl, k)) for k in ("D", "rs", "fs", "llc_budget", "resident")}
    return counts, f, wtypes


def _torch_args(counts, f, wtypes):
    fs_res = f["resident"] * f["fs"][None, :]
    return tuple(torch.tensor(np.asarray(x)) for x in
                 (counts, f["D"], f["rs"], fs_res, f["llc_budget"], wtypes))


@pytest.mark.parametrize("m", [2, 16])
@pytest.mark.parametrize("Q", [1, 8, 33])
def test_plain_version_matches_pallas_and_reference(m, Q):
    counts, f, wtypes = _inputs(m, Q, seed=m * 100 + Q)
    cache, maxd = kc.consolidation_scores_torch(*_torch_args(counts, f, wtypes))
    assert cache.shape == maxd.shape == (Q, m)

    fs_res = f["resident"] * f["fs"][None, :]
    p_cache, p_maxd = pallas_scores(counts, f["D"], f["rs"], fs_res, f["llc_budget"],
                                    wtypes, interpret=True)
    r_cache, r_maxd = consolidation_scores_ref(counts, f["D"], f["rs"], f["fs"],
                                               f["llc_budget"], f["resident"], wtypes)
    for want_cache, want_maxd in ((p_cache, p_maxd), (r_cache, r_maxd)):
        np.testing.assert_allclose(cache.numpy(), np.asarray(want_cache), rtol=0, atol=ATOL)
        np.testing.assert_allclose(maxd.numpy(), np.asarray(want_maxd), rtol=0, atol=ATOL)


def test_wrapper_runs_plain_version_on_cpu_and_counts_no_launch():
    args = _torch_args(*_inputs(4, 8, seed=1))
    kc.reset_launches()
    got = kc.consolidation_scores(*args)
    want = kc.consolidation_scores_torch(*args)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert sum(kc.LAUNCHES.values()) == 0  # only a kernel launch counts


def test_ops_modes():
    args = _torch_args(*_inputs(4, 3, seed=2))
    got = ops.greedy_scores(*args, mode="torch")
    want = kc.consolidation_scores_torch(*args)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError):
        ops.greedy_scores(*args, mode="interpret")


def _bad(args, which):
    counts, D, rs, fs_res, budget, wtypes = args
    if which == "dtype":
        wtypes = wtypes.long()
    elif which == "shape":
        D = D[:, :, :-1].contiguous()
    elif which == "contiguity":
        fs_res = fs_res.t().contiguous().t()
    elif which == "types":
        counts, D = torch.zeros(counts.shape[0], 300), torch.zeros(D.shape[0], 300, 300)
        rs, fs_res = torch.zeros(300), torch.zeros(counts.shape[0], 300)
    return counts, D, rs, fs_res, budget, wtypes


@pytest.mark.parametrize("which", ["dtype", "shape", "contiguity", "types"])
def test_kernel_argument_checks(which):
    """What the wrapper refuses before a launch (checked device-independently)."""
    args = _torch_args(*_inputs(4, 3, seed=3))
    kc._check(*args)  # well-formed inputs pass
    with pytest.raises((ValueError, TypeError)):
        kc._check(*_bad(args, which))


def test_build_names_library_by_source_hash():
    assert "consolidation_scores" in _build.sources()
    path = _build.library_path("consolidation_scores")
    assert path == _build.library_path("consolidation_scores")
    assert path.parent == _build.BUILD_DIR and path.suffix == ".so"
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


@pytest.mark.parametrize("Q", [1, 8, kc.CROSSOVER_Q, kc.CROSSOVER_Q + 1, 1024, 4096])
def test_path_choice(Q):
    """Small Q takes the single pass (one launch), larger Q the table path."""
    assert kc.choose_path(Q) == ("single" if Q <= kc.CROSSOVER_Q else "table")
    assert kc.choose_path(Q) in kc.PATHS


@pytest.mark.parametrize("m,want", [(1, 8), (2, 8), (33, 8), (34, 8), (64, 5), (132, 2),
                                    (264, 1), (1024, 1)])
def test_table_shares_fill_the_card(m, want):
    assert kc.table_shares(m) == want
    assert m * want >= 264 or want == 8


@pytest.mark.parametrize("which", ["Q > T", "every type"])
def test_candidates_of_one_type_score_alike(which):
    """Both outputs depend on a candidate only through its type (the table
    path's premise): rows of one type are identical, for Q > T and for a
    batch that holds every type."""
    counts, f, _ = _inputs(6, 1, seed=11)
    T = counts.shape[1]
    rng = np.random.default_rng(12)
    wtypes = (rng.integers(0, T, size=3 * T) if which == "Q > T"
              else np.concatenate([rng.permutation(T), rng.integers(0, T, size=40)]))
    wtypes = wtypes.astype(np.int32)
    cache, maxd = kc.consolidation_scores_torch(*_torch_args(counts, f, wtypes))
    first = {}
    for q, t in enumerate(wtypes.tolist()):
        first.setdefault(t, q)
    assert len(first) < len(wtypes)
    for q, t in enumerate(wtypes.tolist()):
        assert torch.equal(cache[q], cache[first[t]]) and torch.equal(maxd[q], maxd[first[t]])


def test_argument_checks_leave_invalid_types_to_the_kernel():
    """Types outside [0, T) pass the card path's checks: the kernel writes
    NaN for them (both paths), so one bad candidate does not fail a batch."""
    args = _torch_args(*_inputs(4, 3, seed=4))
    T = args[0].shape[1]
    kc._check(*args[:-1], torch.tensor([-1, T, 10 * T, 0], dtype=torch.int32))


class _FakeLib:
    """Records the launchers' arguments in place of the built library."""

    def __init__(self):
        self.calls = []

    def consolidation_scores_launch(self, *args):
        self.calls.append(("single", args))
        return 0

    def consolidation_scores_table_launch(self, *args):
        self.calls.append(("table", args))
        return 0


@pytest.mark.parametrize("path", kc.PATHS)
def test_launch_passes_each_path_its_arguments(path):
    args = _torch_args(*_inputs(4, 40, seed=5))
    m, T = args[0].shape
    lib = _FakeLib()
    cache, maxd = kc.launch(lib, args, path, 0)
    assert cache.shape == maxd.shape == (40, m)
    (fn, got), = lib.calls
    assert fn == path
    assert got[:6] == tuple(x.data_ptr() for x in args)
    if path == "single":
        assert got[8:12] == (m, T, 40, kc.Q_CHUNK)
    else:
        assert got[10:15] == (m, T, 40, kc.table_shares(m), kc.GATHER_BLOCKS)
        assert got[9] - got[8] == 4 * T * m  # two [T, m] float32 tables


def test_wrapper_refuses_an_unknown_path():
    args = _torch_args(*_inputs(4, 3, seed=6))
    with pytest.raises(ValueError, match="path"):
        kc.consolidation_scores(*args, path="dense")
