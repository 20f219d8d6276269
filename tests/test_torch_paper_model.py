"""The rest of the framework-free paper model, copied into ``repro_torch.core``.

Each copied function (Table III parsing, the solo-throughput surface of
Figs 1-2, the TDP predictions of Eqns 1-2, the scalar pairwise profiling
pass, the co-run surface and makespans of Figs 3-5) gives ``repro``'s
result bit for bit on the paper's grid, for M1 and M2; ``repro_torch.core``
exports every name ``repro.core`` does, or its port's counterpart.
"""
import dataclasses
import types

import numpy as np
import pytest

import repro.core as jcore
import repro_torch.core as tcore
from repro.core import M1, M2, contention, simulator, throughput, units, workload
from repro_torch.core import contention as tcontention
from repro_torch.core import simulator as tsimulator
from repro_torch.core import throughput as tthroughput
from repro_torch.core import units as tunits
from repro_torch.core import workload as tworkload

SERVERS = {"M1": (M1, tcore.M1), "M2": (M2, tcore.M2)}

#: examples/quickstart.py's Table III strings (the initial state, then the
#: arrival sequence)
TABLE_III = (
    "(32KB, 64KB), (4KB, 16KB), (16KB, 32MB)",
    "(32KB, 64MB), (512KB, 2MB), (128KB, 512KB)",
    "(256KB, 1MB), (4KB, 2MB), (32KB, 8MB)",
    "(2KB, 32KB), (512KB, 64MB), (8KB, 4MB)",
    "(16KB, 64KB), (32KB, 1MB), (64KB, 64MB), (32KB, 2MB), (8KB, 64MB)",
)

#: about twelve grid types across the LLC, file-cache and disk levels
SUBSET = [(r, f) for r in (4 * units.KB, 64 * units.KB, 512 * units.KB)
          for f in (256 * units.KB, 2 * units.MB, 16 * units.MB, 256 * units.MB)]

#: Fig 3-4's grids (benchmarks/fig34_consolidation.py): FS up to 8 MB, N 1..8
FIG34_FS = [f for f in workload.FS_GRID if f <= 8 * units.MB]
FIG34_N = list(range(1, 9))


def _port_workload(w):
    """The same workload as the port's ``Workload``."""
    return tworkload.Workload(**dataclasses.asdict(w))


def _asdicts(ws):
    return [dataclasses.asdict(w) for w in ws]


@pytest.mark.parametrize("text", TABLE_III)
@pytest.mark.parametrize("op", ["read", "write"])
def test_parse_workloads_bitwise(text, op):
    want = workload.parse_workloads(text, op=op)
    got = tworkload.parse_workloads(text, op=op)
    assert _asdicts(got) == _asdicts(want)
    assert _asdicts(tcore.snap_to_grid(w) for w in got) == _asdicts(
        jcore.snap_to_grid(w) for w in want)
    assert tworkload.total_bytes(got) == workload.total_bytes(want)


def test_parse_size_and_empty_text():
    for text in ("32KB", "64 mb", "1GB", "512", "3K", "2M", "1G", "7B", "1.5MB"):
        assert tunits.parse_size(text) == units.parse_size(text)
    for mod in (workload, tworkload):
        with pytest.raises(ValueError, match="no \\(RS, FS\\) tuples"):
            mod.parse_workloads("no tuples here")


def test_characterize_bitwise():
    rng = np.random.default_rng(5)
    ops = ("read", "write")
    trace = [(ops[int(rng.integers(0, 2))], float(rng.choice([512, 4096, 65536, 1 << 20])))
             for _ in range(200)]
    for fbytes in (64 * units.MB, 3.5 * units.MB):
        want = workload.characterize(trace, fbytes)
        got = tworkload.characterize(trace, fbytes)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for mod in (workload, tworkload):
        with pytest.raises(ValueError, match="empty trace"):
            mod.characterize([], 1.0)


@pytest.mark.parametrize("name", sorted(SERVERS))
@pytest.mark.parametrize("op", ["read", "write"])
def test_solo_throughput_grid_and_runtime_bitwise(name, op):
    """Figs 1-2's surface over the paper's 10 x 23 grid, and AR_i per type."""
    js, ts = SERVERS[name]
    want = throughput.solo_throughput_grid(js, workload.RS_GRID, workload.FS_GRID, op)
    got = tthroughput.solo_throughput_grid(ts, tworkload.RS_GRID, tworkload.FS_GRID, op)
    assert got.shape == (10, 23) and np.array_equal(got, want)
    for jw in workload.grid_types(op)[::7]:
        jw = dataclasses.replace(jw, data_total=3 * jw.fs)
        assert tthroughput.solo_runtime(ts, _port_workload(jw)) == throughput.solo_runtime(js, jw)


@pytest.mark.parametrize("name", sorted(SERVERS))
def test_tdp_predictions_bitwise(name):
    """Eqns 1-2 on Table III's sets, at alpha 1.0 and 1.3, and the critical N
    of identical workloads (the paper's worked example among them)."""
    js, ts = SERVERS[name]
    for text in TABLE_III:
        jws = workload.parse_workloads(text)
        tws = tworkload.parse_workloads(text)
        assert tcontention.tdp_lhs_naive(tws) == contention.tdp_lhs_naive(jws)
        for alpha in (1.0, 1.3):
            assert (tcontention.predict_tdp_hit(ts, tws, alpha)
                    == contention.predict_tdp_hit(js, jws, alpha))
    for rs, fs in [(256 * units.KB, 1280 * units.KB), *SUBSET]:
        for alpha in (1.0, js.llc_tolerance):
            assert (tcontention.predict_tdp_n(ts, rs, fs, alpha)
                    == contention.predict_tdp_n(js, rs, fs, alpha))
    assert contention.predict_tdp_n(M1, 256 * units.KB, 1280 * units.KB) == 4.0


@pytest.mark.parametrize("name", sorted(SERVERS))
def test_profile_pairwise_bitwise_and_against_fast(name):
    """The scalar profiling pass on twelve types: ``repro``'s D bit for bit,
    and the vectorized pass's within 1e-12 (the JAX package's own bound,
    ``tests/test_core_contention.py``)."""
    js, ts = SERVERS[name]
    jsub = [workload.Workload(fs=f, rs=r) for r, f in SUBSET]
    tsub = [tworkload.Workload(fs=f, rs=r) for r, f in SUBSET]
    want = contention.profile_pairwise(js, jsub)
    got = tcontention.profile_pairwise(ts, tsub)
    assert got.shape == (12, 12) and np.array_equal(got, want)
    np.testing.assert_allclose(got, tcontention.profile_pairwise_fast(ts, tsub), atol=1e-12)
    measure, jmeasure = tcontention.measure_pair_simulated(ts), contention.measure_pair_simulated(js)
    assert measure(tsub[3], tsub[7]) == jmeasure(jsub[3], jsub[7]) == want[3, 7]


@pytest.mark.parametrize("name", sorted(SERVERS))
@pytest.mark.parametrize("rs", [64 * units.KB, 256 * units.KB], ids=["rs64KB", "rs256KB"])
def test_corun_grid_and_makespans_bitwise(name, rs):
    """Figs 3-4(a)'s throughput surface over (N, FS), and Fig 5's makespans
    of the same sets consolidated and run in sequence."""
    js, ts = SERVERS[name]
    want = simulator.corun_throughput_grid(js, rs, FIG34_FS, FIG34_N)
    got = tsimulator.corun_throughput_grid(ts, rs, FIG34_FS, FIG34_N)
    assert got.shape == (len(FIG34_N), len(FIG34_FS)) and np.array_equal(got, want)
    for fs in FIG34_FS[::4]:
        for n in (1, 2, 4, 8):
            jws = [workload.Workload(fs=fs, rs=rs, data_total=8 * fs)] * n
            tws = [tworkload.Workload(fs=fs, rs=rs, data_total=8 * fs)] * n
            assert (tsimulator.makespan_consolidated(ts, tws)
                    == simulator.makespan_consolidated(js, jws))
            assert (tsimulator.makespan_sequential(ts, tws)
                    == simulator.makespan_sequential(js, jws))


#: repro.core names whose port carries another name (the JAX suffix becomes
#: the port's) -- and greedy_sequence, which names the device greedy in the
#: port (the oracle's is repro_torch.core.binpack.greedy_sequence)
RENAMED = {"brute_force_jax": "brute_force_torch", "greedy_sequence_jax": "greedy_sequence",
           "local_search_jax": "local_search_torch",
           "score_candidates_jnp": "score_candidates_torch"}
#: repro.core names the port does not have yet (none: core/cluster.py's
#: eight names are ported)
NOT_YET: set = set()


def test_core_exports_cover_repro_core():
    public = {n for n in dir(jcore) if not n.startswith("_")
              and not isinstance(getattr(jcore, n), types.ModuleType)}
    assert NOT_YET <= public and RENAMED.keys() <= public
    missing = sorted(n for n in public - NOT_YET - RENAMED.keys() - {"greedy_sequence"}
                     if not hasattr(tcore, n))
    assert not missing, f"repro_torch.core lacks {missing}"
    assert all(hasattr(tcore, n) for n in RENAMED.values())
    # the oracle's greedy is the copied float64 one, reached through core.binpack
    from repro_torch.core import binpack as tbinpack
    assert tcore.greedy_place is tbinpack.greedy_place
    assert tcore.greedy_sequence is not tbinpack.greedy_sequence
    for name in ("parse_workloads", "characterize", "total_bytes", "solo_throughput_grid",
                 "solo_runtime", "tdp_lhs_naive", "predict_tdp_hit", "predict_tdp_n",
                 "measure_pair_simulated", "profile_pairwise", "corun_throughput_grid",
                 "makespan_consolidated", "makespan_sequential", "brute_force", "first_fit",
                 "best_fit_cache", "run_allocator", "average_min_throughput",
                 "average_min_throughput_simulated", "calibrate_alpha", "pick_alpha",
                 "sweep_alpha", "local_search", "local_search_engine"):
        assert getattr(tcore, name).__module__.startswith("repro_torch.core."), name
    assert dataclasses.asdict(tcore.TPU_V5E_POD256) == dataclasses.asdict(jcore.TPU_V5E_POD256)
