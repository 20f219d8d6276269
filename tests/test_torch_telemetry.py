"""Port: telemetry in the event loop, the observation log, the streaming
estimator and the drift schedules (``repro_torch.telemetry``).

The event loop's telemetry integrals, the log built from them and the
estimator's update are held to the JAX package on the same inputs; the
estimator's own contracts (prior fallback, chunk invariance, confidence
half-life) are re-run on the port; drift schedules give the same specs.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import M1, M2, ConsolidationEngine
from repro.core import PackedCluster as JaxCluster
from repro.core import PackedDynamics as JaxDynamics
from repro.core import profile_pairwise_fast, run_trace as jax_run_trace, type_index
from repro.telemetry import ObservationLog as JaxLog
from repro.telemetry import StreamingEstimator as JaxEstimator
from repro.telemetry import drift as jdrift
from repro.telemetry.log import observations_from_trace as jax_observations
from repro_torch import convert
from repro_torch.core import M1 as TM1
from repro_torch.core import M2 as TM2
from repro_torch.core import ConsolidationEngine as TorchEngine
from repro_torch.core import run_trace
from repro_torch.telemetry import ObservationLog, StreamingEstimator
from repro_torch.telemetry import drift as tdrift
from repro_torch.telemetry import observations_from_trace
from test_engine import _trace
from test_telemetry import T, _pair_trace, _synthetic_batch, _truth
from test_torch_engine import one_intra_op_thread  # noqa: F401  -- autouse

PORT = {M1: TM1, M2: TM2}
LOG_FIELDS = [f.name for f in dataclasses.fields(JaxLog)]


def _fields(obj):
    return {f.name: (np.asarray(getattr(obj, f.name)) if f.name != "degradation_limit"
                     else getattr(obj, f.name)) for f in dataclasses.fields(obj)}


def _to_port(log: JaxLog) -> ObservationLog:
    return ObservationLog(**{k: torch.from_numpy(np.array(getattr(log, k)))
                             for k in LOG_FIELDS})


def _assert_log_equal(got: ObservationLog, want: JaxLog, rtol: float, atol: float = 0.0):
    for k in LOG_FIELDS:
        g, w = getattr(got, k).numpy(), np.asarray(getattr(want, k))
        assert g.shape == w.shape, k
        if k in ("wtype", "server"):
            assert g.dtype == np.int32 and np.array_equal(g, w), k
        else:
            assert g.dtype == np.float64, k
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=k)


# --- telemetry in the event loop ---------------------------------------------

# the traces of tests/test_engine.py (times normalized to the first arrival)
CASES = {
    "16srv_64": ([M1, M2] * 8, dict(n=64, gap=1e-3)),
    "queue_drain": ([M1, M2] * 8, dict(n=64, gap=2e-5, passes=8, seed=3, heavy=True)),
    "epoch": ([M1, M2] * 8, dict(n=48, gap=1e-3, seed=11)),
    "heavy_8srv": ([M1, M2] * 4, dict(n=40, gap=3e-5, passes=8, seed=9, heavy=True)),
}


def _both_traces(servers, arrivals):
    jc = JaxCluster.build(servers, [profile_pairwise_fast(s) for s in servers])
    jd = JaxDynamics.build(servers)
    tc = convert.cluster_from_numpy(_fields(jc), device="cpu")
    td = convert.dynamics_from_numpy(_fields(jd), device="cpu")
    times = np.asarray([a for a, _ in arrivals], np.float64)
    t = (times - times.min()).astype(np.float32)
    ty = np.asarray([type_index(w) for _, w in arrivals], np.int32)
    by = np.asarray([w.data_total for _, w in arrivals], np.float32)
    jt = jax_run_trace(jc, jd, t, ty, by, telemetry=True)
    tt = run_trace(tc, td, torch.tensor(t), torch.tensor(ty), torch.tensor(by),
                   telemetry=True)
    return jt, tt, ty, by


@pytest.mark.parametrize("case", list(CASES))
def test_run_trace_telemetry_matches_jax(case):
    servers, kw = CASES[case]
    jt, tt, _, _ = _both_traces(servers, _trace(**kw))
    assert np.array_equal(tt.placement.numpy(), np.asarray(jt.placement))
    assert np.array_equal(tt.was_queued.numpy(), np.asarray(jt.was_queued))
    n = len(jt.placement)
    assert tuple(tt.obs_co.shape) == (n, 230) and tuple(tt.obs_logr.shape) == (n,)
    assert np.asarray(jt.obs_logr).all()  # every arrival ran
    if kw.get("heavy"):
        assert float(np.asarray(jt.obs_co).sum()) > 0  # co-runs happened
    # the integrals sum f32 clock differences: placements and event order
    # are identical, but an event time that XLA and PyTorch round one ulp
    # apart moves an integral by that ulp times the co-resident count, so
    # the relative bound gets an absolute term of a few ulps of the clock
    clock_ulp = float(np.spacing(np.float32(np.asarray(jt.makespan))))
    for k, rtol in (("obs_co", 1e-6), ("obs_lost", 1e-6), ("obs_logr", 1e-5)):
        np.testing.assert_allclose(getattr(tt, k).numpy(), np.asarray(getattr(jt, k)),
                                   rtol=rtol, atol=8 * clock_ulp, err_msg=k)


def test_run_trace_without_telemetry_leaves_zeros():
    servers, kw = CASES["heavy_8srv"]
    jc = JaxCluster.build(servers, [profile_pairwise_fast(s) for s in servers])
    tc = convert.cluster_from_numpy(_fields(jc), device="cpu")
    td = convert.dynamics_from_numpy(_fields(JaxDynamics.build(servers)), device="cpu")
    arr = _trace(**kw)
    t = torch.tensor([a for a, _ in arr], dtype=torch.float32)
    ty = torch.tensor([type_index(w) for _, w in arr], dtype=torch.int32)
    by = torch.tensor([w.data_total for _, w in arr], dtype=torch.float32)
    off, on = run_trace(tc, td, t, ty, by), run_trace(tc, td, t, ty, by, telemetry=True)
    assert torch.equal(off.placement, on.placement)
    assert torch.equal(off.finish_time, on.finish_time)
    assert not off.obs_co.any() and not off.obs_lost.any() and not off.obs_logr.any()
    assert on.obs_co.any()


# --- the observation log -----------------------------------------------------

@pytest.mark.parametrize("case", ["queue_drain", "heavy_8srv"])
def test_observations_from_trace_matches_jax(case):
    servers, kw = CASES[case]
    jt, _, ty, by = _both_traces(servers, _trace(**kw))
    want = jax_observations(jt, ty, by)
    assert len(want) > 0
    # the same trace arrays through both functions: float64 arithmetic
    trace = type("Trace", (), {k: torch.from_numpy(np.array(getattr(jt, k))) for k in (
        "placement", "place_time", "finish_time", "obs_co", "obs_lost", "obs_logr")})
    _assert_log_equal(observations_from_trace(trace, torch.from_numpy(ty),
                                              torch.from_numpy(by)), want, rtol=1e-12)
    # a host sequence of Python floats keeps float64 on its way in
    _assert_log_equal(observations_from_trace(trace, ty.tolist(), by.tolist()), want,
                      rtol=1e-12)


def test_engine_observations_match_jax():
    servers, kw = CASES["queue_drain"]
    arrivals = _trace(**kw)
    jx = ConsolidationEngine(servers).run(arrivals, backend="jax", telemetry=True)
    pt = TorchEngine([PORT[s] for s in servers], device="cpu").run(arrivals, telemetry=True)
    assert pt.placements == jx.placements
    # the log divides the integrals by durations; 1e-6 absolute is a
    # millionth of a co-resident workload (see the clock-ulp note above)
    _assert_log_equal(pt.observations, jx.observations, rtol=1e-5, atol=1e-6)
    merged = ObservationLog.merge([pt.observations.for_server(s) for s in range(16)])
    assert len(merged) == len(pt.observations)
    empty = TorchEngine([TM1], device="cpu").run([], telemetry=True).observations
    assert len(empty) == 0 and empty.T == 230


# --- the streaming estimator -------------------------------------------------

def _engine_logs(rounds=3):
    engine = ConsolidationEngine([M1], D=profile_pairwise_fast(M1))
    return [engine.run(_pair_trace(M1, 5 + 17 * r), backend="jax", telemetry=True).observations
            for r in range(rounds)]


def _synthetic_logs(seed, batches=4):
    solo, L, _ = _truth(M1)
    rng = np.random.default_rng(seed)
    pool_idx = rng.choice(T, size=8, replace=False)
    logs = [_synthetic_batch(rng, pool_idx, solo, L, B=48, noise=0.01)
            for _ in range(batches)]
    logs[1] = dataclasses.replace(logs[1], lost_frac=np.where(
        np.arange(48) % 5 == 0, 0.9, 0.0))  # some dropped past the TDP
    return solo, logs


def _assert_estimators_close(port, jax_est, rtol, atol=0.0):
    for k in ("L", "log_b", "n_pair", "n_base"):
        np.testing.assert_allclose(getattr(port, k).numpy(), np.asarray(getattr(jax_est, k)),
                                   rtol=rtol, atol=atol, err_msg=k)
    assert port.n_obs == jax_est.n_obs
    np.testing.assert_allclose(port.estimate_D().numpy(), jax_est.estimate_D(),
                               rtol=rtol, atol=atol)
    np.testing.assert_allclose(port.estimate_solo().numpy(), jax_est.estimate_solo(),
                               rtol=rtol, atol=atol)
    assert torch.equal(port.observed_mask(), torch.from_numpy(jax_est.observed_mask()))


@pytest.mark.parametrize("source", ["synthetic", "engine"])
@pytest.mark.parametrize("port_scatter,jax_scatter,rtol,atol", [
    ("numpy", "numpy", 1e-12, 0.0),
    ("torch", "jnp", 1e-5, 1e-9),
])
def test_estimator_update_matches_jax(source, port_scatter, jax_scatter, rtol, atol):
    if source == "synthetic":
        solo, logs = _synthetic_logs(seed=2)
    else:
        solo, logs = None, _engine_logs()
    kw = dict(T=T, prior_D=0.05, prior_solo=solo, lr=0.6, decay=0.995,
              confidence_floor=2.0)
    jax_est = JaxEstimator(**kw, scatter=jax_scatter)
    port = StreamingEstimator(**kw, scatter=port_scatter, device="cpu")
    for log in logs:
        assert port.update(_to_port(log)) == jax_est.update(log)
    assert port.n_obs > 0 and float(port.n_pair.sum()) > 0
    _assert_estimators_close(port, jax_est, rtol, atol)


def test_estimator_prior_fallback_below_confidence_floor():
    prior = np.full((T, T), 0.2)
    est = StreamingEstimator(T=T, prior_D=prior, scatter="numpy", device="cpu")
    np.testing.assert_allclose(est.estimate_D().numpy(), prior, atol=1e-7)
    assert not est.observed_mask().any()
    assert est.update(ObservationLog.empty(T, device="cpu")) == 0


def _check_chunking_invariance(seed, splits=8):
    """The port's copy of tests/test_telemetry.py's split-vs-merged check:
    the confidence state is exactly chunk-invariant, the point estimates to
    first order."""
    solo, L, _ = _truth(M1)
    rng = np.random.default_rng(seed)
    pool_idx = rng.choice(T, size=8, replace=False)
    kw = dict(T=T, prior_D=0.0, prior_solo=solo, lr=0.6, decay=0.995,
              confidence_floor=2.0, scatter="numpy", device="cpu")
    merged_est, split_est = StreamingEstimator(**kw), StreamingEstimator(**kw)
    for _ in range(30):  # identical warm-up on both replicas
        batch = _to_port(_synthetic_batch(rng, pool_idx, solo, L, B=64, noise=0.005))
        merged_est.update(batch)
        split_est.update(batch)
    tail = [_to_port(_synthetic_batch(rng, pool_idx, solo, L, B=32, noise=0.005))
            for _ in range(splits)]
    merged_est.update(ObservationLog.merge(tail))
    for b in tail:
        split_est.update(b)
    np.testing.assert_allclose(merged_est.n_pair.numpy(), split_est.n_pair.numpy(),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(merged_est.n_base.numpy(), split_est.n_base.numpy(),
                               rtol=1e-12, atol=1e-12)
    assert merged_est.n_obs == split_est.n_obs
    np.testing.assert_allclose(merged_est.estimate_D().numpy(),
                               split_est.estimate_D().numpy(), atol=0.01)
    np.testing.assert_allclose(np.log(merged_est.estimate_solo().numpy()),
                               np.log(split_est.estimate_solo().numpy()), atol=0.01)


@pytest.mark.parametrize("seed", [0, 7])
def test_estimator_chunking_invariance(seed):
    _check_chunking_invariance(seed)


def test_confidence_half_life_independent_of_chunking():
    solo, L, _ = _truth(M1)
    rng = np.random.default_rng(3)
    pool_idx = rng.choice(T, size=6, replace=False)
    kw = dict(T=T, prior_D=0.0, prior_solo=solo, lr=0.5, decay=0.99,
              scatter="numpy", device="cpu")
    a, b = StreamingEstimator(**kw), StreamingEstimator(**kw)
    seed_batch = _to_port(_synthetic_batch(rng, pool_idx, solo, L, B=64))
    a.update(seed_batch)
    b.update(seed_batch)
    cont = [_to_port(_synthetic_batch(rng, pool_idx, solo, L, B=16)) for _ in range(4)]
    a.update(ObservationLog.merge(cont))
    for c in cont:
        b.update(c)
    np.testing.assert_allclose(float(a.n_pair.sum()), float(b.n_pair.sum()), rtol=1e-12)


def test_estimator_scatter_backends_and_device():
    with pytest.raises(ValueError, match="CUDA"):
        StreamingEstimator(T=T, device="cpu")  # the default scatter is the kernel
    with pytest.raises(ValueError):
        StreamingEstimator(T=T, scatter="jnp", device="cpu")
    est = StreamingEstimator(T=T, scatter="torch", device="cpu")
    assert est.L.dtype == torch.float64 and est.L.device.type == "cpu"


# --- drift -------------------------------------------------------------------

def _schedules(mod, base):
    return {
        "congestion": mod.congestion_at(base, 2, server=0, factor=0.4),
        "degradation": mod.degradation_at(base, 1, server=1, factor=0.5),
        "stochastic": mod.stochastic_congestion(base, 0.4, seed=3, segments=6),
        "decay": mod.gradual_decay(base, 1, rate=0.05, start=2, segments=6),
        "merged": mod.merge_schedules(
            mod.congestion_at(base, 3, server=1, factor=0.6),
            mod.DriftSchedule((mod.DriftEvent(1, 0, mod.perturb_spec(base[0], 0.1, seed=4)),))),
    }


@pytest.mark.parametrize("name", ["congestion", "degradation", "stochastic", "decay",
                                  "merged"])
def test_drift_specs_at_match_jax(name):
    jax_base, port_base = [M1, M2, M1], [TM1, TM2, TM1]
    js, ps = _schedules(jdrift, jax_base)[name], _schedules(tdrift, port_base)[name]
    assert len(js.events) == len(ps.events) > 0
    assert js.first_segment == ps.first_segment
    for seg in range(6):
        for j, p in zip(js.specs_at(jax_base, seg), ps.specs_at(port_base, seg)):
            assert type(p).__module__.startswith("repro_torch")
            assert dataclasses.asdict(p) == dataclasses.asdict(j)
        assert [(e.segment, e.server) for e in ps.changes_at(seg)] == \
            [(e.segment, e.server) for e in js.changes_at(seg)]
