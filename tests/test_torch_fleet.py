"""Port: the fleet-health control plane (``repro_torch.fleet``) against JAX's.

The same observation blocks, made with numpy from a seed, go through the
JAX package's detector, pooled bank and controller and through the port's:
the CUSUM state is chunk-invariant bit for bit in the port and within 1e-5
of JAX's, pool routing and actions are identical, ``fleet_step`` (whose
action loops are ``kernels.fleet_actions``' plain version on the CPU)
decides exactly as JAX's, and the gradual-decay scenario evicts, masks and
requeues as JAX's ``AdaptiveEngine(fleet=...)`` does. The copied numpy
modules (criteria, fault tolerance) answer as JAX's, and each kernel
wrapper passes its C launcher the arguments its signature declares.
"""
import ctypes
import functools
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hyp import given, settings, st
from repro.configs.base import MeshConfig
from repro.core import M1, M2, AdaptiveEngine
from repro.core.criteria import DEGRADATION_LIMIT, check_consolidation, eviction_rate_floor
from repro.distributed import fault_tolerance as jft
from repro.fleet import DriftDetector as JaxDetector
from repro.fleet import FleetController as JaxController
from repro.fleet import PooledEstimatorBank as JaxPool
from repro.fleet.controller import fleet_step as jax_fleet_step
from repro.fleet.detect import CusumState as JaxCusum
from repro.telemetry import StreamingEstimator as JaxEstimator
from repro.telemetry import block_from_log as jax_block_from_log
from repro.telemetry import gradual_decay
from repro.telemetry.estimator import DeviceEstimatorState as JaxBankState
from repro_torch.configs import MeshConfig as TMesh
from repro_torch.core import M1 as TM1
from repro_torch.core import M2 as TM2
from repro_torch.core import AdaptiveEngine as TorchAdaptive
from repro_torch.core import criteria as tcriteria
from repro_torch.core.workload import FS_GRID, RS_GRID, Workload
from repro_torch.distributed import fault_tolerance as tft
from repro_torch.fleet import CusumState, DriftDetector, FleetController, PooledEstimatorBank
from repro_torch.fleet.controller import fleet_step
from repro_torch.kernels import cusum as kcu
from repro_torch.kernels import fleet_actions as kfa
from repro_torch.telemetry import RingBlock, StreamingEstimator, block_from_log
from repro_torch.telemetry import gradual_decay as tgradual_decay
from repro_torch.telemetry.estimator import DeviceEstimatorState
from test_fleet import T, _obs_log, _rand_refs
from test_torch_engine import one_intra_op_thread  # noqa: F401  -- autouse
from test_torch_telemetry import _to_port

#: float state of the port against JAX's (decisions are held exactly)
ATOL = 1e-5


def _pblock(jblock) -> RingBlock:
    """A JAX ``RingBlock`` carried to the port (the same packed layout)."""
    return RingBlock(*(torch.from_numpy(np.array(a)) for a in jblock))


def _pslice(block: RingBlock, lo: int, hi: int) -> RingBlock:
    return RingBlock(*(a[lo:hi] for a in block))


def _blocks(log):
    """The JAX block of a JAX log and the port's block of the same log."""
    return jax_block_from_log(log), block_from_log(_to_port(log))


def _port_estimators(n, **overrides):
    kw = dict(T=T, prior_D=0.0, lr=0.5, decay=0.995, confidence_floor=2.0, scatter="torch",
              device="cpu")
    kw.update(overrides)
    return [StreamingEstimator(**kw) for _ in range(n)]


def _jax_estimators(n):
    return [JaxEstimator(T=T, prior_D=0.0, lr=0.5, decay=0.995, confidence_floor=2.0,
                         scatter="jnp") for _ in range(n)]


def _assert_state_close(port_state, jax_state, atol=ATOL):
    for a, b, name in zip(port_state, jax_state, CusumState._fields):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=atol, rtol=0, err_msg=name)


# --- CUSUM -------------------------------------------------------------------

def _check_cusum_chunk_invariance(seed, splits):
    """Split-vs-merged blocks leave the port's detector state bitwise equal,
    and within 1e-5 of JAX's on the merged block (voided rows and a server
    out of range drop on both)."""
    rng = np.random.default_rng(seed)
    m = 3
    log_b, L_t = _rand_refs(rng, m)
    row_map = np.asarray([0, 0, 2], np.int32)  # a pool of two + a solo row
    jblock = jax_block_from_log(_obs_log(rng, m=m, B=64, shift=np.array([0.0, -0.4, 0.1])))
    scalars = np.asarray(jblock.scalars).copy()
    scalars[::11, 3] = 0.0
    ints = np.asarray(jblock.ints).copy()
    ints[::13, 1] = m + 5
    jblock = jblock._replace(scalars=jnp.asarray(scalars), ints=jnp.asarray(ints))
    block = _pblock(jblock)
    tlog_b, tL_t = torch.from_numpy(np.array(log_b)), torch.from_numpy(np.array(L_t))

    merged = DriftDetector(m=m, device="cpu")
    split = DriftDetector(m=m, device="cpu")
    assert merged.update(block, tlog_b, tL_t, row_map) > 0
    bounds = np.linspace(0, 64, splits + 1).astype(int)
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        split.update(_pslice(block, lo, hi), tlog_b, tL_t, row_map)
    for a, b, name in zip(merged.state, split.state, CusumState._fields):
        assert torch.equal(a, b), name
    jfresh = JaxDetector(m=m)
    used_j = jfresh.update(jblock, log_b, L_t, row_map)
    fresh = DriftDetector(m=m, device="cpu")
    assert fresh.update(block, tlog_b, tL_t, row_map) == used_j
    _assert_state_close(fresh.state, jfresh.state)


def test_cusum_chunk_invariance():
    _check_cusum_chunk_invariance(0, splits=4)


@settings(max_examples=3, deadline=None)
@given(st.integers(min_value=1, max_value=10_000))
def test_cusum_chunk_invariance_property(seed):
    _check_cusum_chunk_invariance(seed, splits=1 + seed % 6)


def test_cusum_empty_block_is_identity():
    rng = np.random.default_rng(1)
    det = DriftDetector(m=2, device="cpu")
    log_b, L_t = _rand_refs(rng, 2)
    _, block = _blocks(_obs_log(rng, m=2))
    det.update(block, torch.from_numpy(np.array(log_b)), torch.from_numpy(np.array(L_t)),
               np.arange(2, dtype=np.int32))
    before = [a.clone() for a in det.state]
    used = det.update(_pslice(block, 0, 0), torch.from_numpy(np.array(log_b)),
                      torch.from_numpy(np.array(L_t)), np.arange(2, dtype=np.int32))
    assert used == 0
    for a, b in zip(before, det.state):
        assert torch.equal(a, b)


def test_cusum_detects_divergence_and_failure_level():
    """JAX's scenario on both detectors, block for block: a shifted server
    fires the split flag, then the failure flag, on both alike."""
    rng = np.random.default_rng(2)
    m = 4
    log_b, L_t = _rand_refs(rng, m)
    tlog_b, tL_t = torch.from_numpy(np.array(log_b)), torch.from_numpy(np.array(L_t))
    row_map = np.zeros(m, np.int32)
    det, jdet = DriftDetector(m=m, device="cpu"), JaxDetector(m=m)
    shift = np.array([0.0, 0.0, 0.0, np.log(0.25)])
    for k in range(7):
        jblock, block = _blocks(_obs_log(rng, m=m, shift=None if k < 4 else shift))
        assert det.update(block, tlog_b, tL_t, row_map) == jdet.update(jblock, log_b, L_t,
                                                                       row_map)
        assert np.array_equal(det.split_flags(), jdet.split_flags()), k
        assert np.array_equal(det.fail_flags(), jdet.fail_flags()), k
        _assert_state_close(det.state, jdet.state)
    assert det.split_flags()[3] or det.fail_flags()[3]
    assert det.fail_flags()[3] and not det.fail_flags()[:3].any()
    np.testing.assert_allclose(det.level_hat(), jdet.level_hat(), atol=ATOL)


def test_cusum_scan_plain_version_is_the_wrapper_on_cpu():
    """On CPU tensors the wrapper is the plain version, bit for bit, and
    neither writes its inputs."""
    g = torch.Generator().manual_seed(3)
    m, B = 5, 40
    state = kcu.CusumState(torch.rand(m, 2, generator=g), torch.randn(m, generator=g),
                            torch.rand(m, generator=g) * 4, torch.randn(m, generator=g),
                            torch.rand(m, generator=g) * 2)
    keep = [a.clone() for a in state]
    args = (torch.randint(0, m, (B,), generator=g, dtype=torch.int32),
            torch.randint(0, m, (B,), generator=g, dtype=torch.int32),
            torch.randn(B, generator=g), torch.rand(B, generator=g) < 0.7)
    got = kcu.cusum_scan(state, *args, k=0.25, level_decay=0.9)
    want = kcu.cusum_scan_torch(state, *args, k=0.25, level_decay=0.9)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(torch.equal(a, b) for a, b in zip(state, keep))
    assert not torch.equal(got.level, state.level)


# --- pooling ------------------------------------------------------------------

def test_pooled_bank_routes_members_to_one_row():
    """A pooled update equals one estimator consuming every member's rows,
    and the pool's estimates match JAX's pool on the same blocks."""
    rng = np.random.default_rng(3)
    logs = [_obs_log(rng, m=3, B=64) for _ in range(4)]
    pool = PooledEstimatorBank(_port_estimators(3), pools=["a", "a", "a"])
    jpool = JaxPool(_jax_estimators(3), pools=["a", "a", "a"])
    solo = _port_estimators(1)[0]
    for log in logs:
        jblock, block = _blocks(log)
        used = pool.update_device(block)
        assert used == jpool.update_device(jblock)
        merged = block._replace(ints=torch.stack(
            [block.wtype, torch.zeros_like(block.server)], dim=1))
        assert used == solo.update_device(merged)
    lead = pool.estimator_for(2)
    assert lead is pool.estimator_for(0) is pool.estimator_for(1)
    np.testing.assert_allclose(lead.L.numpy(), solo.L.numpy(), atol=1e-6)
    np.testing.assert_allclose(lead.log_b.numpy(), solo.log_b.numpy(), atol=1e-6)
    assert lead.n_obs == solo.n_obs
    np.testing.assert_allclose(lead.L.numpy(), np.asarray(jpool.estimator_for(2).L), atol=ATOL)


def test_pool_split_then_reseed_equivalence():
    """The split-out row carries exactly the pool posterior at split time,
    then diverges only with its own telemetry, as in JAX's pool."""
    rng = np.random.default_rng(4)
    pool = PooledEstimatorBank(_port_estimators(3), pools=[0, 0, 0])
    jpool = JaxPool(_jax_estimators(3), pools=[0, 0, 0])
    for _ in range(5):
        jblock, block = _blocks(_obs_log(rng, m=3))
        pool.update_device(block)
        jpool.update_device(jblock)
    snap = pool.estimator_for(2).export_posterior()
    assert pool.split(2) and jpool.split(2)
    assert pool.members(2) == jpool.members(2) == (2,)
    assert pool.members(0) == jpool.members(0) == (0, 1)
    est2, est0 = pool.estimator_for(2), pool.estimator_for(0)
    assert est2 is not est0
    assert torch.equal(est2.L, est0.L) and torch.equal(est2.n_pair, est0.n_pair)
    assert torch.equal(snap.log_b.double(), est2.log_b)

    log = _obs_log(rng, m=3, shift=np.array([0.0, 0.0, -0.5]))
    only2 = log.select(np.asarray(log.server) == 2)
    jblock, block = _blocks(only2)
    pool_L_before = est0.L.clone()
    pool.update_device(block)
    jpool.update_device(jblock)
    assert torch.equal(pool.estimator_for(0).L, pool_L_before)
    assert not torch.allclose(pool.estimator_for(2).L, pool_L_before, atol=1e-4)
    np.testing.assert_allclose(pool.estimator_for(2).L.numpy(),
                               np.asarray(jpool.estimator_for(2).L), atol=ATOL)
    assert not pool.split(2)
    est2.seed_from(snap)
    assert torch.equal(est2.L, est0.L)


def test_pool_leader_split_and_drop_migrate_the_pool():
    """A leader split moves the pool to its next member (recorded for the
    detector, which moves its centering row along); a non-leader drop keeps
    reads on the live row; a leader drop migrates the survivors first -- on
    both packages alike."""
    rng = np.random.default_rng(5)
    pool = PooledEstimatorBank(_port_estimators(3), pools=[0, 0, 0])
    jpool = JaxPool(_jax_estimators(3), pools=[0, 0, 0])
    jblock, block = _blocks(_obs_log(rng, m=3))
    pool.update_device(block)
    jpool.update_device(jblock)
    lead_L = pool.estimator_for(0).L.clone()
    assert pool.split(0) and jpool.split(0)
    assert pool.last_migration == jpool.last_migration == (0, 1)
    assert pool.members(0) == (0,) and pool.members(1) == (1, 2)
    assert torch.equal(pool.estimator_for(1).L, lead_L)
    assert torch.equal(pool.estimator_for(0).L, lead_L)

    det = DriftDetector(m=3, device="cpu")
    log_b, L_t = _rand_refs(rng, 3)
    _, block = _blocks(_obs_log(rng, m=3))
    det.update(block, torch.from_numpy(np.array(log_b)), torch.from_numpy(np.array(L_t)),
               np.zeros(3, np.int32))
    lvl0 = float(det.state.pool_level[0])
    assert lvl0 != 0.0
    det.move_pool_row(0, 1)
    assert float(det.state.pool_level[1]) == lvl0 and float(det.state.pool_level[0]) == 0.0

    drop = PooledEstimatorBank(_port_estimators(3), pools=[0, 0, 0])
    jdrop = JaxPool(_jax_estimators(3), pools=[0, 0, 0])
    jblock, block = _blocks(_obs_log(rng, m=3, B=60))
    drop.update_device(block)
    jdrop.update_device(jblock)
    drop.drop(1)
    jdrop.drop(1)
    assert drop.last_migration is None and drop.members(1) == ()
    est = drop.estimator_for(1)
    assert est is drop.estimator_for(0)
    jblock, block = _blocks(_obs_log(rng, m=3, B=60))
    used = drop.update_device(block)
    assert used == jdrop.update_device(jblock) < 60
    assert est is drop.estimator_for(1)
    drop.drop(0)
    jdrop.drop(0)
    assert drop.last_migration == jdrop.last_migration == (0, 2)
    assert np.array_equal(drop.row_of, jdrop.row_of)
    assert np.array_equal(drop._read_row, jdrop._read_row)


# --- fleet_step: the device policy against JAX's ------------------------------

def _step_case(case: str, seed: int = 0):
    """A bank, detector state and routing of m = 6 servers in two pools
    (rows 0 and 3) arranged so that ``case`` fires: 'quiet' nothing, 'split'
    a member and a leader split, 'level' a level-route eviction of a pool
    leader, 'base' a base-route eviction of a solo server, 'warmup' the same
    as 'level' with act_ok False, 'last' all but one server already gone."""
    rng = np.random.default_rng(seed)
    m = 6
    f32 = np.float32
    bank = dict(L_t=rng.normal(-0.05, 0.02, (m, T, T)).astype(f32),
                log_b=rng.normal(0.0, 0.2, (m, T)).astype(f32),
                n_pair_t=rng.uniform(0.0, 3.0, (m, T, T)).astype(f32),
                n_base=rng.uniform(0.0, 0.2, (m, T)).astype(f32),
                n_obs=np.arange(m, dtype=np.int32) + 5)
    priors = bank["log_b"] + rng.normal(0.0, 0.01, (m, T)).astype(f32)
    det = dict(stat=rng.uniform(0.0, 1.0, (m, 2)).astype(f32),
               level=rng.normal(0.0, 0.02, m).astype(f32),
               n=np.full(m, 6.0, f32),
               pool_level=rng.normal(0.0, 0.1, m).astype(f32),
               pool_n=rng.uniform(1.0, 5.0, m).astype(f32))
    row_map = np.asarray([0, 0, 0, 3, 3, 3], np.int32)
    read_row = row_map.copy()
    active = np.ones(m, bool)
    act_ok = True
    if case == "split":
        det["stat"][1, 0] = 3.0  # a member
        det["stat"][3, 1] = 2.5  # a leader
    elif case in ("level", "warmup"):
        det["level"][3] = np.log(0.2) * 0.1 * 6.0  # level_hat = log 0.2
        det["stat"][3, 0] = 2.5  # splits first, then evicts
        act_ok = case == "level"
    elif case == "base":
        row_map[5] = read_row[5] = 5  # solo
        bank["n_base"][5] = 1.0
        bank["log_b"][5] = priors[5] + np.log(0.3)
    elif case == "last":
        row_map[1:] = -1
        active[1:] = False
        det["level"][0] = np.log(0.1) * 0.1 * 6.0
    return bank, priors, det, row_map, read_row, active, act_ok


@pytest.mark.parametrize("case", ["quiet", "split", "level", "base", "warmup", "last"])
def test_fleet_step_matches_jax(case):
    """``fleet_step`` on the same state in both packages: the same actions,
    routing and mask exactly, the same bank gather, float state within
    1e-5. On the CPU its two loops are ``kernels.fleet_actions``' plain
    versions."""
    bank, priors, det, row_map, read_row, active, act_ok = _step_case(case)
    kw = dict(h=2.0, level_decay=0.9, fail_floor=0.5, min_exposure=4.0)
    want = jax_fleet_step(JaxBankState(*(jnp.asarray(bank[f]) for f in JaxBankState._fields)),
                          JaxCusum(*(jnp.asarray(det[f]) for f in JaxCusum._fields)),
                          jnp.asarray(row_map), jnp.asarray(read_row), jnp.asarray(active),
                          jnp.asarray(priors), jnp.asarray(act_ok), **kw)
    got = fleet_step(DeviceEstimatorState(*(torch.from_numpy(bank[f].copy())
                                            for f in DeviceEstimatorState._fields)),
                     CusumState(*(torch.from_numpy(det[f].copy()) for f in CusumState._fields)),
                     torch.from_numpy(row_map), torch.from_numpy(read_row),
                     torch.from_numpy(active), torch.from_numpy(priors),
                     torch.tensor(act_ok), **kw)
    for name in ("row_map", "read_row", "active", "split_fired", "evict_fired", "evict_route"):
        assert np.array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name))), name
    for name in ("split_stat", "evict_stat"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   atol=ATOL, err_msg=name)
    _assert_state_close(got.det, want.det)
    for a, b, name in zip(got.bank, want.bank, DeviceEstimatorState._fields):
        assert np.array_equal(a.numpy(), np.asarray(b)), name
    fired = {"quiet": (0, 0), "split": (2, 0), "level": (1, 1), "base": (0, 1),
             "warmup": (0, 0), "last": (0, 0)}[case]
    assert (int(got.split_fired.sum()), int(got.evict_fired.sum())) == fired


# --- the controller and the engine --------------------------------------------

def test_eviction_threshold_is_shared():
    """The copied criteria and straggler monitor read the one conversion of
    the Eqn-4 limit, as JAX's do."""
    assert tcriteria.DEGRADATION_LIMIT == DEGRADATION_LIMIT
    assert tcriteria.eviction_rate_floor() == eviction_rate_floor()
    assert DriftDetector(m=2, device="cpu").fail_floor == eviction_rate_floor()
    assert FleetController().fail_floor == eviction_rate_floor()
    with pytest.raises(ValueError):
        tcriteria.eviction_rate_floor(1.5)
    mons = (tft.HeartbeatMonitor(n_hosts=3), jft.HeartbeatMonitor(n_hosts=3))
    for mon in mons:
        for h in range(2):
            for t in range(10):
                mon.heartbeat(h, now=t, step_time=1.0)
        for t in range(10):
            mon.heartbeat(2, now=t, step_time=2.0)  # exactly the 2x boundary
    assert mons[0].stragglers() == mons[1].stragglers() == [2]
    assert mons[0].stragglers(limit=0.6) == mons[1].stragglers(limit=0.6) == []


@pytest.mark.parametrize("scenario", ["dead", "straggler", "multi_pod", "single_pod", "noop",
                                      "batch"])
def test_fault_tolerance_copy_matches_jax(scenario):
    """``tests/test_fault_tolerance.py``'s scenarios through both copies."""
    def run(ft, Mesh):
        if scenario == "dead":
            mon = ft.HeartbeatMonitor(n_hosts=4, timeout_s=10.0)
            for h in range(4):
                mon.heartbeat(h, now=0.0)
            mon.heartbeat(0, now=50.0)
            return sorted(mon.dead_hosts(now=55.0))
        if scenario == "straggler":
            mon = ft.HeartbeatMonitor(n_hosts=4)
            for h in range(3):
                for t in range(10):
                    mon.heartbeat(h, now=t, step_time=1.0)
            for t in range(10):
                mon.heartbeat(3, now=t, step_time=1.9)
            first = mon.stragglers()
            for t in range(10, 20):
                mon.heartbeat(3, now=t, step_time=2.5)
            return first, mon.stragglers()
        if scenario in ("multi_pod", "single_pod"):
            mesh = Mesh(multi_pod=True, pods=2) if scenario == "multi_pod" else Mesh()
            plan = ft.plan_elastic_remesh(mesh, lost_hosts=[33], hosts_per_pod=32)
            return (plan.reason, plan.new.multi_pod, plan.new.n_devices, plan.new.data,
                    plan.new.model, plan.lost_fraction)
        if scenario == "noop":
            return ft.plan_elastic_remesh(Mesh(), [])
        old, new = Mesh(multi_pod=True, pods=2), Mesh()
        return (ft.scale_batch_for_mesh(256, old, new, keep_global=True),
                ft.scale_batch_for_mesh(256, old, new, keep_global=False))

    assert run(tft, TMesh) == run(jft, MeshConfig)


def test_fleet_controller_on_blocks_matches_jax():
    """Both controllers fed the same blocks: a failing sibling is evicted
    and the lone survivor never is (a sick fleet beats an empty one); the
    events, row maps and mask match JAX's segment for segment."""
    rng = np.random.default_rng(12)
    fleet, jfleet = FleetController(warmup_segments=0), JaxController(warmup_segments=0)
    fleet.bind([TM1, TM1], _port_estimators(2))
    jfleet.bind([M1, M1], _jax_estimators(2))
    for k in range(10):
        shift = np.array([0.0, -2.0]) if k < 4 else np.array([-2.0, -2.0])
        jblock, block = _blocks(_obs_log(rng, m=2, shift=shift))
        used, evs = fleet.observe(block, segment=k)
        jused, jevs = jfleet.observe(jblock, segment=k)
        assert used == jused
        assert [(e.kind, e.server) for e in evs] == [(e.kind, e.server) for e in jevs], k
        assert np.array_equal(fleet.pool.row_of, jfleet.pool.row_of)
        _assert_state_close(fleet.detector.state, jfleet.detector.state)
        if k == 3:
            assert fleet.evicted() == (1,)
    assert fleet.evicted() == jfleet.evicted() == (1,)
    assert fleet.active_mask().tolist() == [True, False]
    assert not fleet.monitor.hosts[1].alive and fleet.monitor.hosts[0].alive


def test_warmup_counts_controller_segments_not_caller_indices():
    """Burn-in happens once per controller lifetime: a second run that
    numbers its segments from 0 again still acts, as in JAX."""
    rng = np.random.default_rng(13)
    fleet = FleetController(warmup_segments=2)
    fleet.bind([TM1, TM1, TM1], _port_estimators(3))
    for k in range(2):
        fleet.observe(block_from_log(_to_port(_obs_log(rng, m=3))), segment=k)
    assert fleet.evicted() == () and fleet._segments_seen == 2
    for k in range(3):
        fleet.observe(block_from_log(_to_port(_obs_log(
            rng, m=3, shift=np.array([0.0, 0.0, -2.0])))), segment=k)
        if fleet.evicted():
            break
    assert fleet.evicted() == (2,)


def test_fleet_controller_binds_once():
    fleet = FleetController()
    TorchAdaptive([TM1, TM1], fleet=fleet, scatter="torch", device="cpu")
    with pytest.raises(RuntimeError, match="bound"):
        TorchAdaptive([TM1, TM1], fleet=fleet, scatter="torch", device="cpu")
    with pytest.raises(RuntimeError, match="bind"):
        FleetController().active_mask()
    # the recorder's context (item 7) is ported: JAX's fields on the bound
    # fleet, and an unbound controller refuses it as JAX's does
    ctx = fleet.recorder_ctx(3)
    assert tuple(ctx.n_pair.shape) == (2, 230, 230) and int(ctx.segment) == 3
    assert ctx.row_of.tolist() == ctx.pool_row.tolist() == fleet.pool._read_row.tolist()
    assert torch.equal(ctx.cusum, fleet.detector.state.stat.amax(1))
    jfleet = JaxController(mesh=MeshConfig())
    AdaptiveEngine([M1, M1], fleet=jfleet)
    jctx = jfleet.recorder_ctx(3)
    for got, want in zip(ctx, jctx):
        assert np.array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(RuntimeError, match="bind"):
        FleetController().recorder_ctx(0)
    # same-spec servers pool: two M1 and one M2 make two pools
    mixed = FleetController()
    TorchAdaptive([TM1, TM2, TM1], fleet=mixed, scatter="torch", device="cpu")
    assert mixed.pool.row_of.tolist() == [0, 1, 0]


@functools.cache
def _decay_runs():
    """``tests/test_fleet.py``'s gradual-decay trace through JAX's and the
    port's ``AdaptiveEngine(fleet=...)`` on the host-alternating path."""
    segments, failing = 6, 1
    rng = np.random.default_rng(11)
    seg, t = [], 0.0
    for _ in range(14):
        fs = float(rng.choice(FS_GRID[10:14]))
        w = Workload(fs=fs, rs=float(rng.choice(RS_GRID[5:8])), data_total=fs * 6)
        t += float(rng.exponential(2e-5))
        seg.append((t, w))
    arrivals = [(t + k * 10.0, w) for k in range(segments) for t, w in seg]
    jfleet = JaxController(mesh=MeshConfig())
    jeng = AdaptiveEngine([M1] * 3, prior=0.0, decay=0.997, fleet=jfleet,
                          drift=gradual_decay([M1] * 3, server=failing, rate=0.65, start=1,
                                              segments=segments))
    jres = jeng.run(arrivals, segments=segments)
    fleet = FleetController(mesh=TMesh())
    eng = TorchAdaptive([TM1] * 3, prior=0.0, decay=0.997, fleet=fleet, scatter="torch",
                        scorer="torch", device="cpu",
                        drift=tgradual_decay([TM1] * 3, server=failing, rate=0.65, start=1,
                                             segments=segments))
    res = eng.run(arrivals, segments=segments)
    return len(seg), failing, (eng, fleet, res), (jeng, jfleet, jres)


def test_gradual_decay_eviction_end_to_end():
    """A server decaying toward zero is evicted in the same segment as in
    JAX, receives no placements afterwards, its in-flight work is requeued
    into the next chunk, and the fault-tolerance plane is told; every
    segment places and queues as JAX's, with D within 1e-5."""
    n_seg, failing, (eng, fleet, res), (jeng, jfleet, jres) = _decay_runs()
    assert eng.stream and eng.bank is None  # the controller owns the bank
    for k, (a, b) in enumerate(zip(res.segments, jres.segments)):
        assert a.placements == b.placements and a.was_queued == b.was_queued, k
    assert res.n_obs == jres.n_obs
    events = [(e.kind, e.server, e.segment) for evs in res.health for e in evs]
    assert events == [(e.kind, e.server, e.segment) for evs in jres.health for e in evs]
    evicts = fleet.events_of("evict")
    assert len(evicts) == 1 and evicts[0].server == failing
    k_ev = evicts[0].segment
    assert k_ev < len(res.segments) - 1
    after = [p for r in res.segments[k_ev + 1:] for p in r.placements]
    assert after and all(p != failing for p in after)
    on_failing = sum(1 for p in res.segments[k_ev].placements if p == failing)
    assert on_failing > 0
    assert len(res.segments[k_ev + 1].placements) == n_seg + on_failing
    assert not fleet.monitor.hosts[failing].alive
    assert len(fleet.plans) == len(jfleet.plans) == 1 and fleet.plans[0].lost_fraction > 0
    assert fleet.active_mask().tolist() == [True, False, True]
    assert fleet.current_D()[failing].shape == (T, T)
    np.testing.assert_allclose(np.stack([d.numpy() for d in fleet.current_D()]),
                               np.stack(jfleet.current_D()), atol=ATOL)
    _assert_state_close(fleet.detector.state, jfleet.detector.state)


def _rack_trace(n, seed, gap=1e-4, passes=8):
    """``chip_smoke.py``'s heavy arrival trace: exponential gaps, FS 4-128
    MB, RS 32-512 KB, each moving ``passes`` times its file size."""
    rng = np.random.default_rng(seed)
    out, t = [], 0.0
    for _ in range(n):
        fs = float(rng.choice(FS_GRID[12:18]))
        w = Workload(fs=fs, rs=float(rng.choice(RS_GRID[5:])), data_total=fs * passes)
        t += float(rng.exponential(gap))
        out.append((t, w))
    return out


def test_rack_gradual_decay_evictions_match_jax():
    """``chip_smoke.py`` phase 14's rack (64 servers, M1/M2 alternating,
    prior 0.0, server 5 in a gradual decay over 8 segments of 256), cut to
    its first 4 segments: JAX's controller splits and evicts the same
    servers in the same segments as the port's -- the decaying server and
    the healthy ones the cold prior leaves unsure -- and both place alike,
    with D and the CUSUM state within 1e-5."""
    m, segments, n_seg, failing = 64, 4, 256, 5
    arrivals = _rack_trace(segments * n_seg, seed=13)
    jfleet = JaxController(mesh=MeshConfig())
    jservers = [M1, M2] * (m // 2)
    jeng = AdaptiveEngine(jservers, prior=0.0, decay=0.997, fleet=jfleet,
                          ring_capacity=2 * n_seg,
                          drift=gradual_decay(jservers, server=failing, rate=0.65, start=1,
                                              segments=8))
    jres = jeng.run(arrivals, segments=segments)
    fleet = FleetController(mesh=TMesh())
    servers = [TM1, TM2] * (m // 2)
    eng = TorchAdaptive(servers, prior=0.0, decay=0.997, fleet=fleet, ring_capacity=2 * n_seg,
                        scatter="torch", scorer="torch", device="cpu",
                        drift=tgradual_decay(servers, server=failing, rate=0.65, start=1,
                                             segments=8))
    res = eng.run(arrivals, segments=segments)
    events = [(e.kind, e.server, e.segment) for evs in res.health for e in evs]
    assert events == [(e.kind, e.server, e.segment) for evs in jres.health for e in evs]
    evicted = [s for kind, s, _ in events if kind == "evict"]
    assert failing in evicted and len(evicted) > 1
    for k, (a, b) in enumerate(zip(res.segments, jres.segments)):
        assert a.placements == b.placements and a.was_queued == b.was_queued, k
    assert res.n_obs == jres.n_obs
    assert np.array_equal(fleet.pool.row_of, jfleet.pool.row_of)
    assert np.array_equal(fleet.active_mask(), jfleet.active_mask())
    np.testing.assert_allclose(np.stack([d.numpy() for d in fleet.current_D()]),
                               np.stack(jfleet.current_D()), atol=ATOL)
    _assert_state_close(fleet.detector.state, jfleet.detector.state)


# --- the kernels' launch arguments --------------------------------------------

def _c_signature(source: str, name: str) -> list:
    """The parameter types of ``int <name>(...)`` in csrc/<source>.cu, as
    ctypes types."""
    src = (pathlib.Path(kcu.__file__).parent / "csrc" / f"{source}.cu").read_text()
    params = re.search(rf"\nint {name}\(([^)]*)\)", src).group(1)
    kinds = {"void*": ctypes.c_void_p, "int": ctypes.c_int, "float": ctypes.c_float,
             "cudaStream_t": ctypes.c_void_p}
    out = []
    for p in params.split(","):
        words = p.replace("const", "").replace("*", " * ").split()[:-1]
        typ = " ".join(words).replace(" *", "*")
        out.append(kinds["void*" if typ.endswith("*") else typ])
    return out


class _FakeLib:
    """Records each launcher's arguments in place of the built library."""

    def __init__(self, ret=0):
        self.calls = []
        for name in ("cusum_scan_launch", "fleet_split_launch", "fleet_evict_launch"):
            setattr(self, name, self._fn(name, ret))
        self.cusum_scan_error_string = self.fleet_actions_error_string = (
            lambda err: b"invalid configuration argument")
        self.fleet_actions_max_servers = lambda: 14000

    def _fn(self, name, ret):
        calls = self.calls

        class Fn:
            def __call__(self, *args):
                calls.append((name, args))
                return ret
        return Fn()


def test_launchers_get_the_arguments_their_signatures_declare():
    m, B = 5, 12
    g = torch.Generator().manual_seed(4)
    state = kcu.CusumState(torch.zeros(m, 2), torch.zeros(m), torch.zeros(m), torch.zeros(m),
                            torch.zeros(m))
    rows = (torch.randint(0, m, (B,), generator=g, dtype=torch.int32),
            torch.randint(0, m, (B,), generator=g, dtype=torch.int32), torch.randn(B, generator=g),
            torch.ones(B, dtype=torch.bool))
    lib = kcu.bind(_FakeLib())
    out = kcu.launch(lib, state, *rows, k=0.25, level_decay=0.9, stream=7)
    (name, args), = lib.calls
    sig = _c_signature("cusum_scan", name)
    assert lib.cusum_scan_launch.argtypes == sig and len(args) == len(sig)
    # out of place: the caller's own rows and state in, new tensors out
    assert args[:4] == tuple(x.data_ptr() for x in rows)
    assert args[4:9] == tuple(a.data_ptr() for a in state)
    assert args[9:14] == tuple(a.data_ptr() for a in out)
    assert not {a.data_ptr() for a in out} & {a.data_ptr() for a in state}
    assert args[15:] == (B, m, m, 0.25, 0.9, 1.0 - 0.9, 7)  # args[14]: the keys' scratch

    i32 = dict(dtype=torch.int32)
    rm, ident = torch.zeros(m, **i32), torch.arange(m, **i32)
    flags = torch.zeros(m, dtype=torch.bool)
    ctl = torch.ones(2, **i32)
    lib = kfa.bind(_FakeLib())
    s_in = (flags, rm, rm, ident, state.stat, state.pool_level, state.pool_n)
    sp = kfa.launch_split(lib, *s_in, ctl, 3)
    e_in = (flags, flags, state.level, sp.row_map, sp.read_row, sp.src_of, flags, sp.stat,
            state.level, state.n, sp.pool_level, sp.pool_n)
    ev = kfa.launch_evict(lib, *e_in, ctl, 3)
    (n1, a1), (n2, a2) = lib.calls
    for name, args, ins, out_t in ((n1, a1, s_in, sp), (n2, a2, e_in, ev)):
        sig = _c_signature("fleet_actions", name)
        assert getattr(lib, name).argtypes == sig and len(args) == len(sig)
        n_in = len(ins)
        assert args[:n_in] == tuple(a.data_ptr() for a in ins)
        assert args[n_in:n_in + len(out_t)] == tuple(a.data_ptr() for a in out_t)
        assert not {a.data_ptr() for a in out_t} & {a.data_ptr() for a in ins}
        assert args[-3:] == (ctl.data_ptr(), m, 3)
    with pytest.raises(RuntimeError, match=r"invalid configuration argument \(9\)"):
        kcu.launch(kcu.bind(_FakeLib(ret=9)), state, *rows, k=0.25, level_decay=0.9, stream=0)
    with pytest.raises(RuntimeError, match=r"evict launch failed"):
        kfa.launch_evict(kfa.bind(_FakeLib(ret=9)), flags, flags, state.level, rm, rm, ident,
                         flags, state.stat, state.level, state.n, state.pool_level,
                         state.pool_n, ctl, 0)


def test_wrappers_check_their_inputs():
    m = 4
    state = kcu.CusumState(torch.zeros(m, 2), torch.zeros(m), torch.zeros(m), torch.zeros(m),
                            torch.zeros(m))
    rows = (torch.zeros(3, dtype=torch.int32), torch.zeros(3, dtype=torch.int32), torch.zeros(3),
            torch.ones(3, dtype=torch.bool))
    with pytest.raises(TypeError, match="resid"):
        kcu.cusum_scan(state, *rows[:2], rows[2].double(), rows[3], k=0.25, level_decay=0.9)
    with pytest.raises(ValueError, match="stat"):
        kcu.cusum_scan(state._replace(stat=torch.zeros(m, 3)), *rows, k=0.25, level_decay=0.9)
    i32 = dict(dtype=torch.int32)
    with pytest.raises(ValueError, match="ctl"):
        kfa.split_loop(torch.zeros(m, dtype=torch.bool), torch.zeros(m, **i32),
                       torch.zeros(m, **i32), torch.arange(m, **i32), state.stat,
                       state.pool_level, state.pool_n, torch.ones(3, **i32))
    assert check_consolidation(M1, [], np.zeros((T, T))).ok
    assert tcriteria.check_consolidation(TM1, [], np.zeros((T, T))).ok
