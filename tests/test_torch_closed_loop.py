"""Port: the fused closed loop (``AdaptiveEngine.run(device_loop=True)``,
``repro_torch.core.closed_loop``) against the port's host-alternating path
and JAX's fused loop.

``tests/test_closed_loop.py``'s cases run four ways from one trace made with
numpy from a seed: the port's host-alternating path and its fused loop,
which must agree exactly (decisions, events, routing, masks, ring) and on
the same bits of D and detector state (the fused loop blends D in float64
as the host path does), and JAX's fused loop, whose decisions the port's
must equal with D and the CUSUM state within 1e-5. The fused segment body
reads nothing back to the host (the event loop's one read per block aside).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hyp import given, settings, st
from repro.configs.base import MeshConfig
from repro.core import M1, AdaptiveEngine
from repro.fleet import FleetController as JaxController
from repro.telemetry import gradual_decay, stochastic_congestion
from repro.telemetry.estimator import DeviceEstimatorState as JaxState
from repro.telemetry.estimator import _update_bank as jax_update_bank
from repro.telemetry.log import RingBlock as JaxBlock
from repro.telemetry.log import _ring_write_masked as jax_ring_write_masked
from repro_torch.configs import MeshConfig as TMesh
from repro_torch.core import M1 as TM1
from repro_torch.core import AdaptiveEngine as TorchAdaptive
from repro_torch.core import closed_loop, engine as tengine
from repro_torch.fleet import FleetController
from repro_torch.kernels import cusum as kcu
from repro_torch.kernels import fleet_actions as kfa
from repro_torch.obs import metrics as TMetrics
from repro_torch.telemetry import RingBlock, ring_write_masked
from repro_torch.telemetry import gradual_decay as tgradual_decay
from repro_torch.telemetry import stochastic_congestion as tstochastic_congestion
from repro_torch.telemetry.estimator import DeviceEstimatorState, _bank_core
from test_closed_loop import _events, _replay, _segment
from test_torch_engine import one_intra_op_thread  # noqa: F401  -- autouse
from test_torch_event_loop import _no_host_read

#: float state of the port against JAX's (decisions are held exactly)
ATOL = 1e-5


def _port_run(arrivals, segments, *, drift=None, m=3, decay=0.997, device_loop=False,
              fleet=True):
    servers = [TM1] * m
    ctl = FleetController(mesh=TMesh()) if fleet else None
    eng = TorchAdaptive(servers, prior=0.0, decay=decay, drift=drift(servers) if drift else None,
                        fleet=ctl, stream=True, ring_capacity=256, scatter="torch",
                        scorer="torch", device="cpu")
    return eng, ctl, eng.run(arrivals, segments=segments, device_loop=device_loop)


def _jax_run(arrivals, segments, *, drift=None, m=3, decay=0.997, fleet=True):
    ctl = JaxController(mesh=MeshConfig()) if fleet else None
    eng = AdaptiveEngine([M1] * m, prior=0.0, decay=decay,
                         drift=drift([M1] * m) if drift else None, fleet=ctl, stream=True,
                         ring_capacity=256)
    return eng, ctl, eng.run(arrivals, segments=segments, device_loop=True)


def _state(fleet, eng):
    est = fleet.pool.bank if fleet is not None else eng.bank
    return est.stacked_state()


def _assert_port_paths_equal(host, dev):
    """The port's two paths: the same decisions and the same bits."""
    (h_eng, h_fleet, h_res), (d_eng, d_fleet, d_res) = host, dev
    for k, (a, b) in enumerate(zip(h_res.segments, d_res.segments)):
        assert a.placements == b.placements and a.was_queued == b.was_queued, k
        assert a.finish_times == b.finish_times and a.makespan == b.makespan, k
    assert _events(h_res) == _events(d_res)
    assert h_res.n_obs == d_res.n_obs and h_res.t_starts == d_res.t_starts
    assert h_eng.ring.total == d_eng.ring.total and h_eng.ring.ptr == d_eng.ring.ptr
    for a, b in zip(h_eng.ring.view(), d_eng.ring.view()):
        assert torch.equal(a, b)
    for a, b in zip(_state(h_fleet, h_eng), _state(d_fleet, d_eng)):
        assert torch.equal(a, b)
    if h_fleet is not None:
        assert np.array_equal(h_fleet.pool.row_of, d_fleet.pool.row_of)
        assert np.array_equal(h_fleet.pool._read_row, d_fleet.pool._read_row)
        assert np.array_equal(h_fleet.active_mask(), d_fleet.active_mask())
        assert len(h_fleet.plans) == len(d_fleet.plans)
        assert h_fleet._segments_seen == d_fleet._segments_seen
        for a, b in zip(h_fleet.detector.state, d_fleet.detector.state):
            assert torch.equal(a, b)
        for a, b in zip(h_fleet.current_D(), d_fleet.current_D()):
            assert torch.equal(a, b)


def _assert_matches_jax(port, jax_run):
    """The port's fused loop against JAX's: decisions exact, float state
    within 1e-5."""
    (p_eng, p_fleet, p_res), (j_eng, j_fleet, j_res) = port, jax_run
    for k, (a, b) in enumerate(zip(p_res.segments, j_res.segments)):
        assert list(a.placements) == list(b.placements), k
        assert list(a.was_queued) == list(b.was_queued), k
        for x, y in zip(a.finish_times, b.finish_times):
            assert x == pytest.approx(y, rel=1e-4)
    assert _events(p_res) == _events(j_res)
    assert list(p_res.n_obs) == list(j_res.n_obs)
    assert p_eng.ring.total == j_eng.ring.total
    if p_fleet is None:
        return
    assert np.array_equal(p_fleet.pool.row_of, j_fleet.pool.row_of)
    assert np.array_equal(p_fleet.pool._read_row, j_fleet.pool._read_row)
    assert np.array_equal(p_fleet.active_mask(), j_fleet.active_mask())
    assert len(p_fleet.plans) == len(j_fleet.plans)
    np.testing.assert_allclose(np.stack([d.numpy() for d in p_fleet.current_D()]),
                               np.stack(j_fleet.current_D()), atol=ATOL)
    for a, b in zip(p_fleet.detector.state, j_fleet.detector.state):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)


def _congestion(servers):
    mod = tstochastic_congestion if servers[0] is TM1 else stochastic_congestion
    return mod(servers, rate=0.3, seed=5, segments=6, servers=[1, 2])


def _decay(servers):
    mod = tgradual_decay if servers[0] is TM1 else gradual_decay
    return mod(servers, server=1, rate=0.65, start=1, segments=6)


CASES = {
    "stationary": (11, 12, 6, None),
    "stochastic_congestion": (7, 12, 6, _congestion),
    "eviction_timing": (11, 14, 6, _decay),
}


@functools.cache
def _four_ways(case: str):
    seed, n_seg, segments, drift = CASES[case]
    arrivals = _replay(_segment(seed, n_seg), segments)
    host = _port_run(arrivals, segments, drift=drift)
    dev = _port_run(arrivals, segments, drift=drift, device_loop=True)
    return n_seg, host, dev, _jax_run(arrivals, segments, drift=drift)


@pytest.mark.parametrize("case", list(CASES))
def test_fused_loop_equals_host_path_and_jax(case):
    n_seg, host, dev, jax_run = _four_ways(case)
    _assert_port_paths_equal(host, dev)
    _assert_matches_jax(dev, jax_run)
    assert dev[2].total_obs > 0


def test_eviction_timing_and_requeue():
    """The decaying server is evicted in the same segment on every path, and
    its in-flight work lands at the head of the next segment."""
    n_seg, host, dev, jax_run = _four_ways("eviction_timing")
    evs = _events(dev[2])
    evicts = [(s, seg) for kind, s, seg in evs if kind == "evict"]
    assert evicts and evicts[0][0] == 1, evs
    k_ev = evicts[0][1]
    for _, _, res in (host, dev, jax_run):
        nxt = res.segments[k_ev + 1]
        on_failing = sum(1 for p in res.segments[k_ev].placements if p == 1)
        assert len(nxt.placements) == n_seg + on_failing > n_seg
        assert 1 not in [p for r in res.segments[k_ev + 1:] for p in r.placements]
    # every segment's event loop read the host at most once per block
    for r in dev[2].segments:
        assert r.stats is not None and r.stats.host_syncs >= 1
        assert r.stats.host_syncs <= -(-(4 * 2 * n_seg + 8) // r.stats.block_steps)


@settings(max_examples=3, deadline=None)
@given(st.integers(min_value=0, max_value=10_000), st.integers(1, 8), st.integers(1, 3))
def test_chunk_invariance(seed, segments, n_seg):
    """For arbitrary (segments, jobs per segment) chunkings of a stream the
    port's fused loop places as its host path, on the same bits, and as
    JAX's fused loop."""
    arrivals = _replay(_segment(seed, n_seg), segments)
    host = _port_run(arrivals, segments)
    dev = _port_run(arrivals, segments, device_loop=True)
    _assert_port_paths_equal(host, dev)
    _assert_matches_jax(dev, _jax_run(arrivals, segments))


def test_fused_loop_without_fleet_is_the_stream():
    """``stream=True`` without a controller: the fused loop is the stream's
    banked refresh per segment, on the same bits as the host path, and
    places as JAX's fused loop."""
    arrivals = _replay(_segment(5, 10), 3)
    host = _port_run(arrivals, 3, fleet=False)
    dev = _port_run(arrivals, 3, fleet=False, device_loop=True)
    _assert_port_paths_equal(host, dev)
    _assert_matches_jax(dev, _jax_run(arrivals, 3, fleet=False))


def test_sparse_bank_tables_match_dense():
    """The fused loop's indexed table update against the dense form and
    JAX's ``_update_bank``, at decay 1.0 and below."""
    m, T, B = 4, 230, 12
    fleet = FleetController(mesh=TMesh())
    TorchAdaptive([TM1] * m, prior=0.0, fleet=fleet, scatter="torch", device="cpu")
    bank = fleet.pool.bank.stacked_state()
    rng = np.random.default_rng(0)
    ints = np.stack([rng.integers(0, T, B), rng.integers(0, m, B)], 1).astype(np.int32)
    co = rng.random((B, T)).astype(np.float32)
    sc = np.concatenate([rng.random((B, 4)) + 0.5, co.sum(1, keepdims=True),
                         (co * co).sum(1, keepdims=True)], 1).astype(np.float32)
    sc[:, 2] = 0.2  # lost_frac within the filter
    block = RingBlock(torch.from_numpy(ints), torch.from_numpy(sc), torch.from_numpy(co))
    jblock = JaxBlock(jnp.asarray(ints), jnp.asarray(sc), jnp.asarray(co))
    jstate = JaxState(*(jnp.asarray(a.numpy()) for a in bank))
    for decay in (1.0, 0.997):
        hyp = dict(lr=0.6, decay=decay, step_damp=0.5, solo_eps=0.05, max_lost_frac=0.5)
        dense, n_d = _bank_core(bank, block, scatter="torch", **hyp)
        sparse, n_s = _bank_core(bank, block, scatter="torch", sparse_tables=True, **hyp)
        want, n_j = jax_update_bank(jstate, jblock, use_pallas=False, interpret=False,
                                    sparse_tables=True, **hyp)
        assert int(n_d) == int(n_s) == int(n_j) > 0
        for name, a, b, c in zip(DeviceEstimatorState._fields, sparse, dense, want):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, err_msg=name)
            np.testing.assert_allclose(a.numpy(), np.asarray(c), atol=ATOL, err_msg=name)


def test_ring_write_masked_matches_jax():
    """The masked modular write with a device row count: wraps, drops rows
    past the count, and matches JAX's ``_ring_write_masked``."""
    rng = np.random.default_rng(1)
    cap, n, T = 8, 6, 5
    buf = [rng.integers(-1, 9, (cap, 2)).astype(np.int32), rng.random((cap, 6)).astype(np.float32),
           rng.random((cap, T)).astype(np.float32)]
    blk = [rng.integers(0, 9, (n, 2)).astype(np.int32), rng.random((n, 6)).astype(np.float32),
           rng.random((n, T)).astype(np.float32)]
    for ptr, n_valid in ((5, 4), (0, 6), (7, 0), (3, 6)):
        got = ring_write_masked(RingBlock(*map(torch.from_numpy, buf)),
                                RingBlock(*map(torch.from_numpy, blk)),
                                torch.tensor(ptr, dtype=torch.int32),
                                torch.tensor(n_valid, dtype=torch.int32))
        want = jax_ring_write_masked(JaxBlock(*map(jnp.asarray, buf)),
                                     JaxBlock(*map(jnp.asarray, blk)), jnp.int32(ptr),
                                     jnp.int32(n_valid))
        for a, b in zip(got, want):
            assert np.array_equal(a.numpy(), np.asarray(b)), (ptr, n_valid)


def test_fused_segment_makes_no_host_read(monkeypatch):
    """Everything a segment does besides its event loop -- assembling the
    arrivals, the bank refresh, the CUSUM scan, fleet_step with both action
    loops, D, the requeue compaction and the ring write -- runs under the
    host-read guard, and builds no tensor from host data (on the card that
    is a copy that waits for the device); the run's decisions are unchanged
    by it."""
    def refuse(*args, **kwargs):
        raise AssertionError("a tensor built from host data inside a segment")

    guarded = []
    for name in ("_assemble", "_fold_segment"):
        orig = getattr(closed_loop, name)

        def wrapped(*args, _orig=orig, _name=name, **kwargs):
            with monkeypatch.context() as mp, _no_host_read(monkeypatch):
                for ctor in ("tensor", "as_tensor", "from_numpy"):
                    mp.setattr(torch, ctor, refuse)
                out = _orig(*args, **kwargs)
            guarded.append(_name)
            return out
        monkeypatch.setattr(closed_loop, name, wrapped)
    kcu.reset_launches()
    kfa.reset_launches()
    _, _, dev, _ = _four_ways("eviction_timing")
    arrivals = _replay(_segment(11, 14), 6)
    got = _port_run(arrivals, 6, drift=_decay, device_loop=True)
    assert guarded.count("_assemble") == guarded.count("_fold_segment") == 8  # S_cap
    assert [r.placements for r in got[2].segments] == [r.placements for r in dev[2].segments]
    assert _events(got[2]) == _events(dev[2])
    # the CPU runs the kernels' plain versions: no launch is counted
    assert not kcu.LAUNCHES and not kfa.LAUNCHES


def test_device_loop_rejects_what_it_cannot_run(monkeypatch):
    eng = TorchAdaptive([TM1] * 2, prior=0.0, stream=True, scatter="torch", device="cpu")
    arrivals = _replay(_segment(3, 3), 2)
    with pytest.raises(ValueError, match="divisible"):
        eng.run(arrivals, segments=4, device_loop=True)
    with pytest.raises(ValueError, match="on_segment"):
        eng.run(arrivals, segments=2, device_loop=True, on_segment=lambda *a: None)
    with pytest.raises(ValueError, match="ring capacity"):
        TorchAdaptive([TM1] * 2, stream=True, ring_capacity=4, scatter="torch",
                      device="cpu").run(arrivals, segments=2, device_loop=True)
    plain = TorchAdaptive([TM1] * 2, prior=0.0, scatter="torch", device="cpu")
    with pytest.raises(ValueError, match="stream"):
        plain.run(arrivals, segments=2, device_loop=True)
    for e in eng.estimators[1:]:
        monkeypatch.setattr(e, "confidence_floor", 3.0)
    with pytest.raises(ValueError, match="confidence_floor"):
        eng.run(arrivals, segments=2, device_loop=True)
    # metrics and record (item 7) now run on the fused loop, as on the host
    # path; the confidence_floor check still refuses them first
    for flag in ("metrics", "record"):
        with pytest.raises(ValueError, match="confidence_floor"):
            eng.run(arrivals, segments=2, device_loop=True, **{flag: True})
    ok = TorchAdaptive([TM1] * 2, prior=0.0, stream=True, scatter="torch", device="cpu")
    res = ok.run(arrivals, segments=2, device_loop=True, metrics=True, record=True)
    host = TorchAdaptive([TM1] * 2, prior=0.0, stream=True, scatter="torch",
                         device="cpu").run(arrivals, segments=2, metrics=True, record=True)
    assert [r.placements for r in res.segments] == [r.placements for r in host.segments]
    # every counter but d_cols_refreshed, which only the fused loop keeps
    # (JAX's device-only extra)
    shared = [i for i, name in enumerate(TMetrics.COUNTERS) if name != "d_cols_refreshed"]
    assert torch.equal(res.metrics.counters[shared], host.metrics.counters[shared])
    assert TMetrics.counter_value(res.metrics, "d_cols_refreshed") > 0
    assert torch.equal(res.decisions.state.block.ints, host.decisions.state.block.ints)


def test_engine_cache_survives_mask_change(monkeypatch):
    """The segment-engine cache keys on specs alone: an eviction swaps the
    mask on the world's cached engine (``set_D(active=)``), which keeps its
    event loops, and rebuilds no dynamics table."""
    builds = []
    orig = tengine.PackedDynamics.build

    def counting(specs, *a, **kw):
        builds.append(tuple(specs))
        return orig(specs, *a, **kw)

    monkeypatch.setattr(tengine.PackedDynamics, "build", staticmethod(counting))
    eng, _, res = _port_run(_replay(_segment(11, 14), 6), 6, drift=_decay)
    assert any(ev.kind == "evict" for evs in res.health for ev in evs)
    worlds = {tuple(eng.drift.specs_at(eng.servers, k)) for k in range(6)}
    assert len(builds) == len(set(builds)) == len(worlds)
    assert len(eng._engine_cache) == len(worlds)

    eng, fleet, _ = _port_run(_replay(_segment(3, 3), 1), 1)
    e0 = eng.engine_for_segment(1)
    loops = dict(e0._loops)
    assert loops
    fleet._active[1] = False
    e1 = eng.engine_for_segment(2)
    assert e1 is e0 and len(eng._engine_cache) == 1
    assert e1.cluster.active.tolist() == [1.0, 0.0, 1.0]
    res = e1.run(_replay(_segment(3, 3), 1), telemetry="device")
    assert 1 not in res.placements
    assert e1._loops == loops
