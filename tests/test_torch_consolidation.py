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
