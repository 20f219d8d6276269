"""Port: the device-resident observation stream (``repro_torch.telemetry``:
``RingBlock``, ``rows_from_trace``, ``block_from_log``, ``ObservationRing``,
``StreamingEstimator.update_device``, ``EstimatorBank``) and the adaptive
loop's stream mode (``AdaptiveEngine(stream=True)``,
``ConsolidationEngine.run(telemetry='device')``).

The same seeded inputs go through the JAX package and the port on the CPU:
blocks and rings must hold the same rows, the fused float32 updates must
land where JAX's land (atol 1e-5, as ``tests/test_telemetry.py`` holds JAX's
device path to its host path) and where the port's own float64 host path
lands, and stream mode must place as JAX's stream mode in every segment,
consume the same observations and leave estimates within 1e-4.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import M1, M2, AdaptiveEngine, ConsolidationEngine, Workload
from repro.telemetry import EstimatorBank as JaxBank
from repro.telemetry import StreamingEstimator as JaxEstimator
from repro.telemetry.estimator import _update_bank as jax_update_bank
from repro.telemetry.log import ObservationRing as JaxRing
from repro.telemetry.log import block_from_log as jax_block_from_log
from repro.telemetry.log import rows_from_trace as jax_rows_from_trace
from repro_torch.core import AdaptiveEngine as TorchAdaptive
from repro_torch.core import ConsolidationEngine as TorchEngine
from repro_torch.telemetry import (EstimatorBank, ObservationRing, RingBlock,
                                   StreamingEstimator, block_from_log, rows_from_trace)
from repro_torch.telemetry.estimator import DeviceEstimatorState
from test_engine import _trace
from test_telemetry import _POOL, T, _obs_batch
from test_torch_engine import one_intra_op_thread  # noqa: F401  -- autouse
from test_torch_telemetry import CASES, PORT, _both_traces, _to_port

#: the fused float32 step against JAX's and against the float64 host path
ATOL = 1e-5
#: engine-level estimates, stream mode against JAX's stream mode
ENGINE_ATOL = 1e-4
FIELDS = ("L", "log_b", "n_pair", "n_base")


def _assert_block_close(got: RingBlock, want, rtol=0.0, atol=0.0):
    assert got.rows == int(want.ints.shape[0]) and got.T == int(want.co.shape[1])
    assert got.ints.dtype == torch.int32 and got.scalars.dtype == got.co.dtype == torch.float32
    np.testing.assert_array_equal(got.ints.numpy(), np.asarray(want.ints))
    np.testing.assert_allclose(got.scalars.numpy(), np.asarray(want.scalars), rtol=rtol,
                               atol=atol)
    np.testing.assert_allclose(got.co.numpy(), np.asarray(want.co), rtol=rtol, atol=atol)


def _assert_estimators_close(got, want, atol=ATOL):
    for f in FIELDS:
        g = getattr(got, f)
        np.testing.assert_allclose(g.numpy() if torch.is_tensor(g) else g,
                                   np.asarray(getattr(want, f)), atol=atol, rtol=0, err_msg=f)
    assert got.n_obs == want.n_obs


# --- blocks and the ring ---------------------------------------------------------

@pytest.mark.parametrize("m,B", [(1, 64), (3, 96), (5, 7)])
def test_block_from_log_matches_jax(m, B):
    log = _obs_batch(np.random.default_rng(m * 100 + B), m=m, B=B)
    got = block_from_log(_to_port(log))
    _assert_block_close(got, jax_block_from_log(log), atol=1e-6)
    assert bool(got.valid.all())
    np.testing.assert_allclose(got.co_sum.numpy(), log.co_counts.sum(axis=1), rtol=1e-6)
    np.testing.assert_allclose(got.co_sq.numpy(), (log.co_counts ** 2).sum(axis=1), rtol=1e-6)


@pytest.mark.parametrize("case", ["queue_drain", "heavy_8srv"])
def test_rows_from_trace_matches_jax(case):
    """The same trace arrays through both functions: masks, types and
    servers identical, float32 values within a few ulps."""
    servers, kw = CASES[case]
    jt, _, ty, _ = _both_traces(servers, _trace(**kw))
    want = jax_rows_from_trace(jt, jnp.asarray(ty))
    trace = type("Trace", (), {k: torch.from_numpy(np.array(getattr(jt, k))) for k in (
        "placement", "place_time", "finish_time", "obs_co", "obs_lost", "obs_logr")})
    got = rows_from_trace(trace, torch.from_numpy(ty))
    _assert_block_close(got, want, rtol=1e-6, atol=1e-6)
    assert bool(got.valid.any())
    # the host sequence route of the arrival types gives the same rows
    assert torch.equal(rows_from_trace(trace, ty.tolist()).ints, got.ints)


def test_voided_rows_keep_their_slot():
    """A never-placed arrival is a row with ``valid`` false and -1 type and
    server, not a dropped row."""
    servers, kw = CASES["heavy_8srv"]
    jt, _, ty, _ = _both_traces(servers, _trace(**kw))
    trace = type("Trace", (), {k: torch.from_numpy(np.array(getattr(jt, k))) for k in (
        "placement", "place_time", "finish_time", "obs_co", "obs_lost", "obs_logr")})
    trace.placement = trace.placement.clone()
    trace.placement[::5] = -1
    blk = rows_from_trace(trace, torch.from_numpy(ty))
    assert blk.rows == len(ty)
    assert not bool(blk.valid[::5].any())
    assert bool((blk.wtype[::5] == -1).all()) and bool((blk.server[::5] == -1).all())
    assert bool((blk.duration[::5] == 0).all())


def test_engine_telemetry_device_matches_jax():
    servers, kw = CASES["queue_drain"]
    arrivals = _trace(**kw)
    jx = ConsolidationEngine(servers).run(arrivals, backend="jax", telemetry="device")
    pt = TorchEngine([PORT[s] for s in servers], device="cpu").run(arrivals,
                                                                   telemetry="device")
    assert pt.placements == jx.placements
    assert pt.observations is None and pt.stream_block is not None
    # integrals of f32 clock differences, divided by durations (see
    # tests/test_torch_telemetry.py's clock-ulp note)
    _assert_block_close(pt.stream_block, jx.stream_block, rtol=1e-5, atol=1e-6)
    host = TorchEngine([PORT[s] for s in servers], device="cpu").run(arrivals, telemetry="host")
    assert host.stream_block is None and len(host.observations) == int(
        pt.stream_block.valid.sum())
    empty = TorchEngine([PORT[M1]], device="cpu").run([], telemetry="device")
    assert empty.stream_block is None and empty.observations is None
    with pytest.raises(ValueError):
        TorchEngine([PORT[M1]], device="cpu").run([], telemetry="ring")


def _void_every_other(blk):
    scalars = blk.scalars.clone()
    scalars[::2, 3] = 0.0
    return blk._replace(scalars=scalars)


def test_observation_ring_wrap_validity_and_oversize_match_jax():
    rng = np.random.default_rng(1)
    logs = [_obs_batch(rng, B=40) for _ in range(4)]
    ring, jring = ObservationRing(96, T, device="cpu"), JaxRing(capacity=96, T=T)
    for log in logs:
        blk = ring.push(block_from_log(_to_port(log)))
        jring.push(jax_block_from_log(log))
        assert blk.rows == 40
    assert len(ring) == 96 and ring.total == 160 and ring.ptr == 160 % 96
    assert (ring.ptr, ring.total) == (jring.ptr, jring.total)
    _assert_block_close(ring.view(), jring.view(), atol=1e-6)
    held = ring.host_log()
    want = jring.host_log()
    np.testing.assert_array_equal(held.wtype.numpy(), want.wtype)
    np.testing.assert_allclose(held.geo_rate.numpy(), want.geo_rate, rtol=1e-6)
    np.testing.assert_allclose(held.co_counts.numpy(), want.co_counts, atol=1e-6)
    # invalid rows occupy slots but leave the host view
    blk = _void_every_other(block_from_log(_to_port(_obs_batch(rng, B=10))))
    ring2 = ObservationRing(16, T, device="cpu")
    ring2.push(blk)
    assert len(ring2) == 10 and len(ring2.host_log()) == 5
    # never-written slots read as invalid rows of type -1
    assert not bool(ring2.view().valid[10:].any()) and bool((ring2.view().wtype[10:] == -1).all())
    # oversize pushes keep the newest capacity rows
    big = _obs_batch(rng, B=20)
    ring3, jring3 = ObservationRing(8, T, device="cpu"), JaxRing(capacity=8, T=T)
    kept = ring3.push(block_from_log(_to_port(big)))
    jring3.push(jax_block_from_log(big))
    assert len(ring3) == 8 and ring3.total == 8 and kept.rows == 8
    np.testing.assert_array_equal(kept.wtype.numpy(), big.wtype[-8:])
    _assert_block_close(ring3.view(), jring3.view(), atol=1e-6)
    # an empty push is a no-op
    ring3.push(block_from_log(_to_port(_obs_batch(rng, B=0))))
    assert ring3.total == 8
    with pytest.raises(ValueError):
        ObservationRing(0, T, device="cpu")


def test_ring_push_trace_wraps_like_push():
    servers, kw = CASES["heavy_8srv"]
    jt, _, ty, _ = _both_traces(servers, _trace(**kw))
    trace = type("Trace", (), {k: torch.from_numpy(np.array(getattr(jt, k))) for k in (
        "placement", "place_time", "finish_time", "obs_co", "obs_lost", "obs_logr")})
    a, b = ObservationRing(50, T, device="cpu"), ObservationRing(50, T, device="cpu")
    for _ in range(3):
        a.push_trace(trace, torch.from_numpy(ty))
        b.push(rows_from_trace(trace, torch.from_numpy(ty)))
    assert (a.ptr, a.total) == (b.ptr, b.total) == ((3 * len(ty)) % 50, 3 * len(ty))
    for x, y in zip(a.view(), b.view()):
        assert torch.equal(x, y)


# --- the fused update ------------------------------------------------------------

@pytest.mark.parametrize("decay", [1.0, 0.995])
def test_update_device_matches_jax_and_host(decay):
    rng = np.random.default_rng(0)
    kw = dict(T=T, prior_D=0.0, lr=0.5, decay=decay, confidence_floor=2.0)
    host = StreamingEstimator(scatter="numpy", device="cpu", **kw)
    dev = StreamingEstimator(scatter="torch", device="cpu", **kw)
    jdev = JaxEstimator(scatter="numpy", **kw)
    for _ in range(12):
        log = _obs_batch(rng)
        used_h = host.update(_to_port(log))
        used_d = dev.update_device(block_from_log(_to_port(log)))
        assert used_h == used_d == jdev.update_device(jax_block_from_log(log))
    _assert_estimators_close(dev, jdev)
    _assert_estimators_close(dev, host)
    np.testing.assert_allclose(dev.estimate_D().numpy(), np.asarray(jdev.estimate_D()),
                               atol=ATOL)
    np.testing.assert_allclose(dev.estimate_D().numpy(), host.estimate_D().numpy(), atol=ATOL)
    # the canonical fields are float64 tensors on the estimator's device
    assert dev.L.dtype == torch.float64 and isinstance(dev.n_obs, int)


def test_update_device_server_filter_and_lazy_pull():
    """``server`` takes the rows of one server; an unsynced call returns the
    device count; reading one field pulls only that field."""
    rng = np.random.default_rng(4)
    kw = dict(T=T, prior_D=0.1, lr=0.5, decay=0.997, confidence_floor=2.0)
    log = _obs_batch(rng, m=3, B=96)
    for s in range(3):
        est = StreamingEstimator(scatter="torch", device="cpu", **kw)
        jest = JaxEstimator(scatter="numpy", **kw)
        used = est.update_device(block_from_log(_to_port(log)), server=s, sync=False)
        assert torch.is_tensor(used)
        assert int(used) == jest.update_device(jax_block_from_log(log), server=s)
        assert est._stale == set(est._FIELDS)
        est.log_b  # noqa: B018 -- a read pulls its own field
        assert "log_b" not in est._stale and "L" in est._stale
        _assert_estimators_close(est, jest)


def test_update_device_then_host_update_continues_from_device_state():
    """The two paths interleave: a host update after a device update starts
    from the pulled float32 state, as JAX's does."""
    rng = np.random.default_rng(6)
    kw = dict(T=T, prior_D=0.0, lr=0.6, decay=0.995, confidence_floor=2.0)
    est = StreamingEstimator(scatter="numpy", device="cpu", **kw)
    jest = JaxEstimator(scatter="numpy", **kw)
    for step in range(4):
        log = _obs_batch(rng)
        if step % 2:
            est.update(_to_port(log))
            jest.update(log)
        else:
            est.update_device(block_from_log(_to_port(log)))
            jest.update_device(jax_block_from_log(log))
    _assert_estimators_close(est, jest)
    # a host write drops the device mirror, which is rebuilt from it
    est.n_pair = est.n_pair * 0.0
    assert est._dev is None
    assert not est.device_state().n_pair_t.any()


def test_export_posterior_and_seed_from():
    rng = np.random.default_rng(8)
    kw = dict(T=T, prior_D=0.0, lr=0.5, decay=0.995, confidence_floor=2.0)
    src = StreamingEstimator(scatter="torch", device="cpu", **kw)
    for _ in range(3):
        src.update_device(block_from_log(_to_port(_obs_batch(rng))))
    snap = src.export_posterior()
    dst = StreamingEstimator(scatter="torch", device="cpu", **dict(kw, prior_D=0.3))
    dst.seed_from(snap)
    for f in FIELDS:
        assert torch.equal(getattr(dst, f), getattr(src, f)), f
    assert dst.n_obs == src.n_obs
    # the prior stays the seeded estimator's own
    assert not torch.equal(dst._L_prior, src._L_prior)
    log = _obs_batch(rng)
    src.update_device(block_from_log(_to_port(log)))
    dst.update_device(block_from_log(_to_port(log)))
    for f in ("L", "n_pair"):
        assert torch.equal(getattr(dst, f), getattr(src, f)), f


# --- the bank --------------------------------------------------------------------

def _banks(m, kw):
    return (EstimatorBank([StreamingEstimator(scatter="torch", device="cpu", **kw)
                           for _ in range(m)]),
            JaxBank([JaxEstimator(scatter="numpy", **kw) for _ in range(m)]))


def _jax_bank_update(jbank, block, row_map, sparse_tables):
    """JAX's banked update, with its ``sparse_tables`` form (which its bank's
    method does not expose) driven through ``_update_bank``."""
    if not sparse_tables:
        return jbank.update_device(block, row_map=row_map)
    from repro.telemetry.estimator import _remap_rows

    if row_map is not None:
        block = _remap_rows(block, jnp.asarray(row_map, jnp.int32))
    new, used = jax_update_bank(jbank.stacked_state(), block, sparse_tables=True,
                                **jbank._hypers)
    jbank._stacked, jbank._dirty = new, True
    return int(used)


@pytest.mark.parametrize("pooled", [False, True], ids=["per_server", "row_map"])
@pytest.mark.parametrize("sparse_tables", [False, True], ids=["dense", "sparse"])
def test_estimator_bank_matches_jax_bank_and_host(pooled, sparse_tables):
    m = 3
    rng = np.random.default_rng(2)
    kw = dict(T=T, prior_D=0.0, lr=0.5, decay=0.995, confidence_floor=2.0)
    bank, jbank = _banks(m, kw)
    hosts = [StreamingEstimator(scatter="numpy", device="cpu", **kw) for _ in range(m)]
    # pooling: servers 0 and 1 share row 0, server 2 is evicted (-1),
    # server 3 (past the map) drops too
    row_map = np.asarray([0, 0, -1], np.int32) if pooled else None
    for _ in range(6):
        log = _obs_batch(rng, m=m + pooled, B=96)
        used_b = bank.update_device(block_from_log(_to_port(log)), row_map=row_map,
                                    sparse_tables=sparse_tables)
        used_j = _jax_bank_update(jbank, jax_block_from_log(log), row_map, sparse_tables)
        if pooled:
            pool = np.isin(log.server, [0, 1])
            pooled_log = dataclasses.replace(log, server=np.zeros_like(log.server))
            used_h = hosts[0].update(_to_port(pooled_log.select(pool)))
        else:
            used_h = sum(hosts[s].update(_to_port(log.for_server(s))) for s in range(m))
        assert used_b == used_j == used_h
    for s in range(m):
        _assert_estimators_close(bank.estimators[s], jbank.estimators[s])
        _assert_estimators_close(bank.estimators[s], hosts[s])


def test_bank_stacked_state_flush_and_copy_row():
    m = 4
    rng = np.random.default_rng(3)
    kw = dict(T=T, prior_D=0.0, lr=0.5, decay=0.995, confidence_floor=2.0)
    bank, jbank = _banks(m, kw)
    log = _obs_batch(rng, m=m, B=128)
    bank.update_device(block_from_log(_to_port(log)), sync=False)
    jbank.update_device(jax_block_from_log(log))
    # between updates the stacked state is the live copy; members flush lazily
    assert bank._dirty and bank.estimators[1]._stale == set()
    st = bank.stacked_state()
    assert isinstance(st, DeviceEstimatorState) and tuple(st.L_t.shape) == (m, T, T)
    assert st.L_t.dtype == torch.float32 and st.n_obs.dtype == torch.int32
    np.testing.assert_allclose(st.L_t.numpy(), np.asarray(jbank.stacked_state().L_t),
                               atol=ATOL)
    bank.copy_row(2, 0)
    jbank.copy_row(2, 0)
    for s in range(m):
        _assert_estimators_close(bank.estimators[s], jbank.estimators[s])
    assert torch.equal(bank.estimators[0].L, bank.estimators[2].L)
    assert not bank._dirty  # the reads flushed
    # a member's host update invalidates the stacked copy; the next banked
    # update restacks from the members
    log2 = _obs_batch(rng, m=m, B=64)
    bank.estimators[3].update(_to_port(log2.for_server(3)))
    jbank.estimators[3].update(log2.for_server(3))
    assert bank._stacked is None
    log3 = _obs_batch(rng, m=m, B=64)
    bank.update_device(block_from_log(_to_port(log3)))
    jbank.update_device(jax_block_from_log(log3))
    for s in range(m):
        _assert_estimators_close(bank.estimators[s], jbank.estimators[s])
    with pytest.raises(IndexError):
        bank.copy_row(0, m)
    with pytest.raises(ValueError):
        EstimatorBank([StreamingEstimator(T=T, scatter="torch", device="cpu"),
                       StreamingEstimator(T=T, lr=0.1, scatter="torch", device="cpu")])
    with pytest.raises(ValueError):
        EstimatorBank([])


def test_bank_of_one_is_the_single_estimator():
    rng = np.random.default_rng(11)
    kw = dict(T=T, prior_D=0.2, lr=0.5, decay=0.99, confidence_floor=2.0)
    single = StreamingEstimator(scatter="torch", device="cpu", **kw)
    bank = EstimatorBank([StreamingEstimator(scatter="torch", device="cpu", **kw)])
    for _ in range(3):
        log = _obs_batch(rng, m=2, B=64)
        assert single.update_device(block_from_log(_to_port(log)), server=0) == \
            bank.update_device(block_from_log(_to_port(log.for_server(0))))
    # the same rows in the same order: equal up to the plain contraction's
    # blocking over a longer batch
    for f in FIELDS:
        np.testing.assert_allclose(getattr(single, f).numpy(),
                                   getattr(bank.estimators[0], f).numpy(), atol=1e-6, err_msg=f)
    assert single.n_obs == bank.estimators[0].n_obs


# --- the adaptive loop in stream mode ---------------------------------------------

def _stream_arrivals(seed=7, n=20, k=4):
    rng = np.random.default_rng(seed)
    seg, t = [], 0.0
    for _ in range(n):
        w = _POOL[int(rng.integers(len(_POOL)))]
        t += float(rng.exponential(2e-5))
        seg.append((t, Workload(fs=w.fs, rs=w.rs, data_total=w.fs * 6)))
    return [(t + j * 10.0, w) for j in range(k) for t, w in seg]


@pytest.mark.parametrize("prior", [0.0, "profiled"])
def test_adaptive_stream_mode_matches_jax_stream_mode(prior):
    servers = [M1, M2]
    arrivals = _stream_arrivals()
    kw = dict(prior=prior, decay=0.996)
    jax_eng = AdaptiveEngine(servers, scatter="jnp", stream=True, ring_capacity=256, **kw)
    port = TorchAdaptive([PORT[s] for s in servers], scatter="torch", stream=True,
                         ring_capacity=256, device="cpu", **kw)
    jr, pr = jax_eng.run(arrivals, segments=4), port.run(arrivals, segments=4)
    assert pr.n_obs == jr.n_obs and pr.total_obs > 0
    for k, (a, b) in enumerate(zip(pr.segments, jr.segments)):
        assert a.placements == b.placements, k
        assert a.was_queued == b.was_queued, k
        assert a.observations is None and a.stream_block is not None
    assert port.ring.total == jax_eng.ring.total == len(arrivals)
    for s in range(len(servers)):
        np.testing.assert_allclose(port.estimators[s].estimate_D().numpy(),
                                   np.asarray(jax_eng.estimators[s].estimate_D()),
                                   atol=ENGINE_ATOL)
        np.testing.assert_allclose(port.estimators[s].log_b.numpy(),
                                   np.asarray(jax_eng.estimators[s].log_b), atol=ENGINE_ATOL)
        assert port.estimators[s].n_obs == jax_eng.estimators[s].n_obs


def test_adaptive_stream_mode_matches_host_mode_and_tiny_ring():
    """Stream mode lands where the port's host-alternating loop lands; a
    ring smaller than a segment bounds the history, never the update."""
    servers = [PORT[M1], PORT[M2]]
    arrivals = _stream_arrivals()
    kw = dict(prior=0.0, decay=0.996, device="cpu")
    host = TorchAdaptive(servers, scatter="torch", **kw)
    stream = TorchAdaptive(servers, scatter="torch", stream=True, ring_capacity=256, **kw)
    rh, rs = host.run(arrivals, segments=4), stream.run(arrivals, segments=4)
    assert rs.n_obs == rh.n_obs
    for a, b in zip(rs.segments, rh.segments):
        assert a.placements == b.placements
    for s in range(2):
        np.testing.assert_allclose(stream.estimators[s].estimate_D().numpy(),
                                   host.estimators[s].estimate_D().numpy(), atol=ENGINE_ATOL)
    tiny = TorchAdaptive(servers, scatter="torch", stream=True, ring_capacity=8, **kw)
    jtiny = AdaptiveEngine([M1, M2], prior=0.0, decay=0.996, scatter="jnp", stream=True,
                           ring_capacity=8)
    rt, jt = tiny.run(arrivals, segments=4), jtiny.run(arrivals, segments=4)
    assert rt.n_obs == rh.n_obs == jt.n_obs
    assert len(tiny.ring) == 8 and tiny.ring.total == 4 * 8 == jtiny.ring.total
    _assert_block_close(tiny.ring.view(), jtiny.ring.view(), rtol=1e-5, atol=1e-6)
    # the bank is the stream's one estimator refresh per segment
    assert stream.bank is not None and host.bank is None and host.ring is None
