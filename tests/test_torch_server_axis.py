"""Port: the server axis (``repro_torch.distributed.server_axis``) and every
sharded entry point, held to the dense path and to JAX's.

The dense axis is the identity: its collectives return their argument, a
micro-event through it dispatches the aten operators of the unthreaded loop,
and ``run_trace(axis=DENSE)`` gives the unthreaded run's bits. The
pod-hierarchical greedy places bit for bit as the port's flat greedy and as
JAX's ``greedy_sequence_hier`` and ``greedy_sequence_jax`` on tables carried
across with ``convert``. ``shard_local_pools`` keeps every pool inside one
rank, and ``resolve_leaders_device`` elects the host constructor's leaders.

Then 1-, 2- and 4-rank gloo groups (``_torch_shard_ranks.py``, one process
per rank on a ``FileStore``) run JAX's server-axis probe
(``tests/test_sharding_servers.py``: T = 23, m = 8, 24 arrivals, a
4-segment fused loop with the fleet controller, metrics and the recorder):
on every rank, ``run_trace`` and ``run_closed_loop`` must equal the port's
dense run and JAX's dense run in the probe's tolerances -- placements,
routing, masks, split and evict flags, counters and the rings' integer
columns bitwise; bank state rtol 1e-5 / atol 1e-7; the CUSUM state, the
ring floats and the finish times rtol 1e-5 -- and ``greedy_sequence_sharded``,
``greedy_sequence_hier``, ``bank_update_sharded`` and
``cusum_update_sharded`` must equal the dense entries bitwise.

Run alone: ``PYTHONPATH=src python -m pytest -q tests/test_torch_server_axis.py``
(~45 s on 8 CPU cores; most of it the multi-rank groups, whose gloo
collectives cost ~0.2-0.8 ms each).
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_shard_ranks as ranks
from _hyp import given, settings, st
from repro.core import M1, M2
from repro.core import PackedCluster as JaxCluster
from repro.core import counts_from_assignments, greedy_sequence_jax, profile_pairwise_fast
from repro.core import type_index
from repro.core.binpack_jax import greedy_sequence_hier as jax_hier
from repro.core.closed_loop import ClosedLoopConfig as JaxConfig
from repro.core.closed_loop import LoopCarry as JaxCarry
from repro.core.closed_loop import SegmentIn as JaxSegmentIn
from repro.core.closed_loop import run_closed_loop as jax_closed_loop
from repro.core.engine_jax import PackedDynamics as JaxDynamics
from repro.core.engine_jax import run_trace as jax_run_trace
from repro.core.workload import FS_GRID, RS_GRID, Workload, snap_to_grid
from repro.distributed.server_axis import ServerAxis as JaxAxis
from repro.fleet.detect import CusumState as JaxCusum
from repro.obs import metrics as JM
from repro.obs import recorder as JR
from repro.telemetry.estimator import DeviceEstimatorState as JaxBank
from repro.telemetry.log import RingBlock as JaxBlock
from repro_torch import convert
from repro_torch.core import engine_torch, greedy_sequence, greedy_sequence_hier, make_scorer
from repro_torch.core import greedy_sequence_sharded
from repro_torch.core.closed_loop import ClosedLoopConfig, run_closed_loop
from repro_torch.distributed import DENSE, ServerAxis
from repro_torch.distributed import server_axis as sa
from repro_torch.fleet import PooledEstimatorBank, resolve_leaders_device, shard_local_pools
from repro_torch.telemetry import StreamingEstimator
from test_torch_engine import one_intra_op_thread  # noqa: F401  -- autouse
from test_torch_event_loop import _case, _no_host_read
from test_torch_obs import _STEP_OPS, _Count

ROOT = pathlib.Path(__file__).resolve().parents[1]


# -- the dense contract -------------------------------------------------------------

def test_dense_axis_contract():
    assert not DENSE.is_sharded and DENSE.shards == 1 and DENSE.pods == 1
    assert DENSE.local_m(16) == 16 and DENSE.offset(16) == 0 and DENSE.index() == 0
    assert DENSE.validate(16) is DENSE
    ServerAxis(pods=4).validate(16)
    with pytest.raises(ValueError, match="pods"):
        ServerAxis(pods=4).validate(6)  # as JAX's: 6 % 4 != 0
    with pytest.raises(ValueError, match="pods"):
        JaxAxis(pods=4).validate(6)
    x = torch.arange(4.0)
    sa.reset_calls()
    for op in (DENSE.pmin, DENSE.pmax, DENSE.psum, DENSE.any, DENSE.all_gather):
        assert op(x) is x  # no copy, no collective
    tree = (x, {"a": x[:2]})
    assert DENSE.local(tree, 4) is tree and DENSE.gather(tree, 4) is tree
    assert not sa.CALLS
    with pytest.raises(TypeError, match="ServerAxis"):
        sa.check_axis(object())


@pytest.mark.parametrize("scorer,telemetry", list(_STEP_OPS))
def test_dense_axis_adds_no_operator(scorer, telemetry):
    """A micro-event through the dense axis dispatches the aten operators of
    the loop without one (353 with the kernel's scorer)."""
    _, _, tc, td, t, ty, by = _case("heavy_8srv")
    sc = None if scorer == "torch" else make_scorer(scorer)
    counts = []
    for axis in (None, DENSE):
        loop = engine_torch._TraceLoop(tc, td, torch.from_numpy(t), torch.from_numpy(ty),
                                       torch.from_numpy(by), "sum_avg", sc, telemetry, axis=axis)
        probe = _Count()
        with probe:
            loop.step(loop.st)
        counts.append(probe.n)
    assert counts == [_STEP_OPS[(scorer, telemetry)]] * 2


# -- pools ----------------------------------------------------------------------------

@settings(max_examples=20, deadline=None)
@given(st.sampled_from([1, 2, 4]), st.integers(0, 2**31 - 1))
def test_shard_local_pools_stay_local(shards, seed):
    """Every namespaced pool lies inside one rank, for every divisor of m
    (what JAX's test of the same name means to check)."""
    m = 16
    rng = np.random.default_rng(seed)
    local = shard_local_pools([f"p{rng.integers(0, 4)}" for _ in range(m)], m, shards)
    m_local = m // shards
    for s, lab in enumerate(local):
        members = [i for i, other in enumerate(local) if other == lab]
        assert {i // m_local for i in members} == {s // m_local}


def test_shard_local_pools_refuse_a_non_divisor():
    with pytest.raises(ValueError, match="divisible"):
        shard_local_pools(["a"] * 16, 16, 3)


@pytest.mark.parametrize("seed", range(4))
def test_resolve_leaders_equals_host_row_of(seed):
    rng = np.random.default_rng(seed)
    m = 12
    labels = [int(x) for x in rng.integers(0, 4, m)]
    ests = [StreamingEstimator(T=4, scatter="torch", device="cpu") for _ in range(m)]
    host = PooledEstimatorBank(ests, pools=labels).row_of
    got = resolve_leaders_device(DENSE, torch.tensor(labels, dtype=torch.int32))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), host)
    ids = torch.tensor(labels, dtype=torch.int32)
    ids[3] = -1  # a dropped server reads -1
    want = host.copy()
    want[3] = -1
    if labels.index(labels[3]) == 3:  # it led its pool: the next member leads
        rest = [i for i in range(m) if labels[i] == labels[3] and i != 3]
        want[rest] = rest[0] if rest else -1
    assert np.array_equal(resolve_leaders_device(DENSE, ids).numpy(), want)


class _TwoRanks:
    """A stand-in process group of two ranks (layout only: no collective)."""

    def size(self):
        return 2

    def rank(self):
        return 1


def test_pooled_bank_namespaces_pools_by_rank():
    """``PooledEstimatorBank(axis=)`` keeps every pool inside one rank: the
    same labels on both halves of the fleet make a pool per half."""
    labels = ["a", "b", "a", "b", "a", "b", "a", "b"]
    ests = lambda: [StreamingEstimator(T=4, scatter="torch", device="cpu")  # noqa: E731
                    for _ in labels]
    axis = ServerAxis(group=_TwoRanks())
    assert axis.is_sharded and axis.shards == 2 and axis.offset(4) == 4
    assert list(PooledEstimatorBank(ests(), pools=labels).row_of) == [0, 1, 0, 1, 0, 1, 0, 1]
    sharded = PooledEstimatorBank(ests(), pools=labels, axis=axis).row_of
    assert list(sharded) == [0, 1, 0, 1, 4, 5, 4, 5]
    assert list(PooledEstimatorBank(ests(), pools=labels, axis=DENSE).row_of) == \
        [0, 1, 0, 1, 0, 1, 0, 1]
    with pytest.raises(ValueError, match="divisible"):
        ServerAxis(group=_TwoRanks()).validate(7)
    with pytest.raises(ValueError, match="pods"):
        ServerAxis(group=_TwoRanks(), pods=3).validate(6)


# -- the pod-hierarchical greedy ----------------------------------------------------------

def _small_cluster(m, seed):
    """JAX's test cluster (``test_sharding_servers._small_cluster``) and its
    tables carried to the port."""
    rng = np.random.default_rng(seed)
    jitter = rng.uniform(0.9, 1.1, m)
    servers = [dataclasses.replace([M1, M2][i % 2], llc_bytes=[M1, M2][i % 2].llc_bytes * jitter[i])
               for i in range(m)]
    D2 = [profile_pairwise_fast(M1), profile_pairwise_fast(M2)]
    jc = JaxCluster.build(servers, D2 * (m // 2), alpha=1.3)
    fields = {f.name: (np.asarray(getattr(jc, f.name)) if f.name != "degradation_limit"
                       else getattr(jc, f.name)) for f in dataclasses.fields(jc)}
    return jc, convert.cluster_from_numpy(fields, device="cpu")


def _four_greedies(jc, tc, wtypes, pods):
    """(port hier, port flat, JAX hier, JAX flat): (placements, counts)."""
    m = tc.m
    c0 = counts_from_assignments(jc, [[] for _ in range(m)])
    wt = torch.from_numpy(wtypes)
    zeros = torch.zeros((m, tc.T))
    ph = greedy_sequence_hier(tc, zeros, wt, ServerAxis(pods=pods))
    pf = greedy_sequence(tc, zeros, wt)
    jh = jax_hier(jc, c0, jnp.asarray(wtypes), JaxAxis(pods=pods))
    jf = greedy_sequence_jax(jc, c0, jnp.asarray(wtypes))
    return [(np.asarray(p), np.asarray(c)) for c, p in (ph, pf, jh, jf)]


@pytest.mark.parametrize("pods", [2, 4, 8])
def test_hier_decisions_match_flat_and_jax(pods):
    """Placements and final counts bitwise: port hier == port flat == JAX
    hier == JAX flat (JAX's ``test_hier_decisions_match_dense``)."""
    jc, tc = _small_cluster(16, seed=5)
    rng = np.random.default_rng(9)
    wl = [snap_to_grid(Workload(fs=float(rng.choice(FS_GRID[:18])), rs=float(rng.choice(RS_GRID))))
          for _ in range(48)]
    wtypes = np.asarray([type_index(w) for w in wl], np.int32)
    runs = _four_greedies(jc, tc, wtypes, pods)
    for p, c in runs[1:]:
        assert np.array_equal(runs[0][0], p)
        assert np.array_equal(runs[0][1], c)
    assert (runs[0][0] >= 0).sum() > 0


@settings(max_examples=5, deadline=None)
@given(st.integers(0, 2**31 - 1))
def test_hier_decisions_match_flat_and_jax_prop(seed):
    jc, tc = _small_cluster(8, seed=seed)
    rng = np.random.default_rng(seed)
    wtypes = rng.integers(0, tc.T, 24).astype(np.int32)
    runs = _four_greedies(jc, tc, wtypes, 4)
    for p, c in runs[1:]:
        assert np.array_equal(runs[0][0], p) and np.array_equal(runs[0][1], c)


def test_hier_from_a_half_full_fleet_with_col0():
    """The supplied ``counts @ D`` seed: the second half of a sequence from
    the first half's counts places as the flat greedy does."""
    _, tc = _small_cluster(16, seed=3)
    wt = torch.from_numpy(np.random.default_rng(4).integers(0, tc.T, 64).astype(np.int32))
    half, _ = greedy_sequence(tc, torch.zeros((16, tc.T)), wt[:32])
    col0 = torch.einsum("mt,mtu->mu", half, tc.D)
    cf, pf = greedy_sequence(tc, half, wt[32:])
    ch, ph = greedy_sequence_hier(tc, half, wt[32:], ServerAxis(pods=4), col0=col0)
    assert torch.equal(pf, ph) and torch.equal(cf, ch)
    assert int((half > 0).sum()) > 0 and int((pf >= 0).sum()) > 0


# -- a one-rank gloo group in this process --------------------------------------------------

@pytest.fixture
def gloo_axis():
    """A one-rank gloo group on a HashStore (``over_process_group`` on the
    CPU), destroyed after the test."""
    assert not dist.is_initialized()
    axis = ServerAxis.over_process_group(device="cpu")
    try:
        yield axis
    finally:
        dist.destroy_process_group()


def test_one_rank_group_calls_its_collectives(gloo_axis):
    """A one-rank group is not dense: every collective is called (and
    tallied); the results are the dense ones."""
    ax = gloo_axis
    assert ax.is_sharded and ax.shards == 1 and ax.offset(8) == 0
    assert ServerAxis.over_process_group(pods=2, device="cpu").group is ax.group
    sa.reset_calls()
    x = torch.tensor([3.0, -1.0])
    assert torch.equal(ax.pmin(x), x) and ax.pmin(x) is not x
    assert torch.equal(ax.all_gather(x), x) and bool(ax.any(torch.tensor(True)))
    assert sa.CALLS == {"pmin": 2, "all_gather": 1, "any": 1}
    _, tc = _small_cluster(8, seed=1)
    wt = torch.from_numpy(np.random.default_rng(2).integers(0, tc.T, 16).astype(np.int32))
    zeros = torch.zeros((8, tc.T))
    sa.reset_calls()
    c, p = greedy_sequence_sharded(tc, zeros, wt, ax)
    assert sa.CALLS["pmin"] == 2 * 16 and sa.CALLS["all_gather"] == 1
    cf, pf = greedy_sequence(tc, zeros, wt)
    assert torch.equal(p, pf) and torch.equal(c, cf)
    ch, ph = greedy_sequence_hier(tc, zeros, wt, dataclasses.replace(ax, pods=2))
    assert torch.equal(ph, pf) and torch.equal(ch, cf)
    with pytest.raises(TypeError, match="ServerAxis"):
        run_closed_loop(None, [], None, None, None, None, ClosedLoopConfig(axis="servers"))


@pytest.mark.parametrize("flags", [{}, dict(telemetry=True, metrics=True, record=True)],
                         ids=["flags off", "flags on"])
def test_collectives_per_micro_event(gloo_axis, flags):
    """JAX's sites, counted: per micro-event 7 ``pmin`` s (the finish time,
    its slot and owner-broadcast time, the scorer's two, the finished
    slot's arrival and type) and 2 ``any`` s (slots busy before the step
    and after the drain), one ``any`` per block (done); with the plane on,
    5 more ``pmin`` s (two headrooms, two CUSUM levels, the slowdown's
    solo rate) and 2 gathered score rows; per run one ``pmax`` (max_deg),
    3 ``psum`` s of the telemetry and the per-server columns' gather."""
    a = ranks.probe_arrays()
    cluster, dyn = ranks.cluster_dyn(a)
    t = lambda k: torch.from_numpy(a[k])  # noqa: E731
    sa.reset_calls()
    tr = engine_torch.run_trace(cluster, dyn, t("arr_time"), t("arr_type"), t("arr_bytes"),
                                scorer=make_scorer("cuda"), axis=gloo_axis, **flags)
    blocks = tr.stats.host_syncs
    steps = blocks * tr.stats.block_steps
    want = {"pmin": 7 * steps, "any": 2 * steps + blocks, "pmax": 1}
    if flags:
        want.update(pmin=12 * steps, all_gather=2 * steps + 1, psum=3)
    assert dict(sa.CALLS) == want


def test_sharded_run_trace_localizes_the_recorder_context(gloo_axis):
    """A global recorder context (pair exposure, CUSUM levels, pool rows)
    goes to each rank as its own rows; the ring equals the dense run's."""
    a = ranks.probe_arrays()
    cluster, dyn = ranks.cluster_dyn(a)
    rng = np.random.default_rng(3)
    m, T = ranks.M, ranks.T
    ctx = engine_torch.obs_recorder.RecCtx(
        n_pair=torch.from_numpy(rng.uniform(0, 5, (m, T, T)).astype(np.float32)),
        row_of=torch.from_numpy(ranks.leader_rows([i // 2 for i in range(m)])),
        cusum=torch.from_numpy(rng.uniform(0, 1, m).astype(np.float32)),
        pool_row=torch.arange(m, dtype=torch.int32), segment=torch.tensor(2, dtype=torch.int32))
    t = lambda k: torch.from_numpy(a[k])  # noqa: E731
    runs = [engine_torch.run_trace(cluster, dyn, t("arr_time"), t("arr_type"), t("arr_bytes"),
                                   record=True, rec_ctx=ctx, axis=ax)
            for ax in (None, gloo_axis)]
    assert torch.equal(runs[0].rec.block.ints, runs[1].rec.block.ints)
    assert torch.equal(runs[0].rec.block.floats, runs[1].rec.block.floats)
    assert bool((runs[0].rec.block.floats[:, 3] > 0).any())  # pair exposure sampled


def test_sharded_block_makes_no_host_read(monkeypatch, gloo_axis):
    """The sharded loop's blocks, collectives included, read nothing back
    to the host; the run equals the dense one."""
    _, _, tc, td, t, ty, by = _case("heavy_8srv")
    args = (tc, td, torch.from_numpy(t), torch.from_numpy(ty), torch.from_numpy(by), "sum_avg",
            make_scorer("cuda"), True)
    loop = engine_torch._TraceLoop(*args, axis=gloo_axis)
    for _ in range(64):
        with _no_host_read(monkeypatch):
            loop.block()
        if loop.status.tolist()[0]:
            break
    assert loop.status.tolist()[0] and bool(loop.st.was_queued.any())
    dense = engine_torch._TraceLoop(*args).run()
    assert torch.equal(loop.st.placement, dense.placement)
    assert torch.equal(loop.st.finish_time, dense.finish_time)


# -- 1-, 2- and 4-rank groups on JAX's probe -------------------------------------------------

@pytest.fixture(scope="module")
def probe():
    return ranks.probe_arrays()


@pytest.fixture(scope="module")
def port_dense(probe):
    return ranks.run_entries(None, probe)


@pytest.fixture(scope="module")
def jax_dense(probe):
    """JAX's dense ``run_trace`` and fused loop on the probe's arrays."""
    a = probe
    m, T, cap = ranks.M, ranks.T, ranks.RING_CAP
    cluster = JaxCluster(**{k: jnp.asarray(a[k]) for k in
                            ("D", "rs", "fs", "llc_budget", "resident", "active")})
    dyn = JaxDynamics(**{k: jnp.asarray(a[k]) for k in
                         ("solo", "base_lost", "log_keep", "log_lost", "comp_bytes",
                          "tol_budget")})
    rt = jax_run_trace(cluster, dyn, jnp.asarray(a["arr_time"]), jnp.asarray(a["arr_type"]),
                       jnp.asarray(a["arr_bytes"]), telemetry=True, metrics=True, record=True)
    bank = JaxBank(L_t=jnp.zeros((m, T, T)), log_b=jnp.zeros((m, T)),
                   n_pair_t=jnp.zeros((m, T, T)), n_base=jnp.zeros((m, T)),
                   n_obs=jnp.zeros((m,), jnp.int32))
    ring = JaxBlock(ints=jnp.full((cap, 2), -1, jnp.int32), scalars=jnp.zeros((cap, 6)),
                    co=jnp.zeros((cap, T)))
    row_map = jnp.asarray(a["row_map"])
    R = ranks.N_SEG
    carry0 = JaxCarry(
        bank=bank, det=JaxCusum.zeros(m), row_map=row_map, read_row=row_map,
        active=jnp.ones((m,), bool), seen=jnp.int32(0), req_type=jnp.zeros((R,), jnp.int32),
        req_bytes=jnp.ones((R,), jnp.float32), req_n=jnp.int32(0), ring=ring,
        ring_ptr=jnp.int32(0), ring_total=jnp.int32(0), metrics=JM.zeros(m), rec=JR.init(64))
    xs = JaxSegmentIn(arr_time=jnp.asarray(a["x_time"]), arr_type=jnp.asarray(a["x_type"]),
                      arr_bytes=jnp.asarray(a["x_bytes"]),
                      dyn_idx=jnp.zeros((ranks.S_CAP,), jnp.int32),
                      seg_valid=jnp.ones((ranks.S_CAP,), bool))
    Lp_t = jnp.full((m, T, T), float(np.log1p(-0.05)), jnp.float32)
    cfg = JaxConfig(fleet=True, metrics=True, record=True, warmup_segments=1, cusum_h=0.5)
    carry, ys = jax_closed_loop(cluster, jax.tree_util.tree_map(lambda x: x[None], dyn), Lp_t,
                                jnp.asarray(a["logb"]), carry0, xs, cfg)
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    return to_np(rt), to_np(carry), to_np(ys)


def _spawn(world: int, where: pathlib.Path) -> list[dict]:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")]))
    env.pop("PYTHONSTARTUP", None)
    procs = [subprocess.Popen([sys.executable, str(ROOT / "tests" / "_torch_shard_ranks.py"),
                               str(r), str(world), str(where)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} of {world}:\n{logs[r][-3000:]}"
    return [dict(np.load(where / f"rank{r}.npz")) for r in range(world)]


#: the fields held bitwise to the port's dense run; every other field is
#: held to the probe's tolerances
_EXACT = ("rt.placement", "rt.was_queued", "rt.deadlock", "rt.stats", "rt.metrics.counters",
          "rt.metrics.hist", "rt.metrics.gauges", "rt.rec.block.ints", "rt.rec.total",
          "rt.rec.ptr", "cl.row_map", "cl.read_row", "cl.active", "cl.seen", "cl.req_n",
          "cl.ring.ints", "cl.ring_total", "cl.metrics.counters", "cl.rec.block.ints",
          "cl.rec.total", "ys.placement", "ys.was_queued", "ys.split_fired", "ys.evict_fired",
          "ys.evict_route", "ys.active_after", "ys.used", "ys.n_valid", "ys.n_requeued",
          "g.placement", "g.counts", "h.placement", "h.counts", "bank.L_t", "bank.log_b",
          "bank.n_pair_t", "bank.n_base", "bank.n_obs", "bank.used", "cusum.stat",
          "cusum.level", "cusum.n", "cusum.pool_level", "cusum.pool_n", "cusum.used")


def _close(got, want, name, rtol=1e-5, atol=1e-7):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=name)


@pytest.mark.parametrize("world", [1, 2, 4])
def test_ranks_match_dense_and_jax(world, tmp_path, probe, port_dense, jax_dense):
    jrt, jc, jy = jax_dense
    got_all = _spawn(world, tmp_path)
    labels = shard_local_pools(list(probe["pool_labels"]), ranks.M, world)
    leaders = ranks.leader_rows(labels)
    leaders[ranks.M - 1] = -1
    for r, got in enumerate(got_all):
        tag = f"rank {r} of {world}"
        assert np.array_equal(got["leaders"], leaders), tag
        for name in _EXACT:
            assert np.array_equal(got[name], port_dense[name]), f"{tag}: {name}"
        for name, want in port_dense.items():
            if name not in _EXACT and name != "leaders":
                _close(got[name], want, f"{tag}: {name}", atol=1e-6)
        # JAX's dense run: the probe's own comparisons
        assert np.array_equal(got["rt.placement"], jrt.placement), tag
        assert np.array_equal(got["rt.was_queued"], jrt.was_queued), tag
        _close(got["rt.finish_time"], jrt.finish_time, tag)
        _close(got["rt.obs_logr"], jrt.obs_logr, tag, atol=1e-6)
        assert np.array_equal(got["rt.metrics.counters"], jrt.metrics.counters), tag
        assert np.array_equal(got["rt.rec.block.ints"], jrt.rec.block.ints), tag
        assert int(got["rt.rec.total"]) == int(jrt.rec.total), tag
        _close(got["rt.rec.block.floats"], jrt.rec.block.floats, tag, atol=1e-6)
        for name in ("placement", "was_queued", "split_fired", "evict_fired"):
            assert np.array_equal(got[f"ys.{name}"], getattr(jy, name)), f"{tag}: {name}"
        for name in ("row_map", "active"):
            assert np.array_equal(got[f"cl.{name}"], getattr(jc, name)), f"{tag}: {name}"
        _close(got["cl.bank.log_b"], jc.bank.log_b, tag)
        _close(got["cl.bank.L_t"], jc.bank.L_t, tag)
        _close(got["cl.det.stat"], jc.det.stat, tag, atol=1e-6)
        _close(got["cl.det.level"], jc.det.level, tag, atol=1e-6)
        assert np.array_equal(got["cl.ring.ints"], jc.ring.ints), tag
        assert int(got["cl.rec.total"]) == int(jc.rec.total), tag
        assert np.array_equal(got["cl.rec.block.ints"], jc.rec.block.ints), tag
        _close(got["cl.rec.block.floats"], jc.rec.block.floats, tag, atol=1e-6)
        assert np.array_equal(got["cl.metrics.counters"], jc.metrics.counters), tag
        _close(got["cl.metrics.per_server"], jc.metrics.per_server, tag, atol=1e-6)
    # the probe acts: evictions requeue work, splits re-route
    assert port_dense["ys.evict_fired"].any() and port_dense["ys.split_fired"].any()
