"""Port: the adaptive loop (``repro_torch.core.AdaptiveEngine``) on its
host-alternating path.

The port and the JAX ``AdaptiveEngine`` run one replayed trace under a
congestion drift: every segment must place and queue identically, consume
the same observations, and leave the same estimated D. The profiled prior
places like the true-D oracle from the first segment, segment engines are
cached, the modes not ported yet raise, and an estimator's state carried
across from JAX computes the same next update.
"""
import numpy as np
import pytest
import torch

from repro.core import (M1, M2, AdaptiveEngine, ConsolidationEngine, Workload,
                        profile_pairwise_fast)
from repro.telemetry import StreamingEstimator as JaxEstimator
from repro.telemetry import drift as jdrift
from repro_torch import convert
from repro_torch.core import M1 as TM1
from repro_torch.core import M2 as TM2
from repro_torch.core import AdaptiveEngine as TorchAdaptive
from repro_torch.core import ConsolidationEngine as TorchEngine
from repro_torch.telemetry import ObservationLog, StreamingEstimator
from repro_torch.telemetry import drift as tdrift
from test_telemetry import _POOL, T, _pair_trace, _replayed_trace
from test_torch_telemetry import _to_port

#: estimated D after each segment, port vs JAX (float64 estimators fed logs
#: whose integrals agree to f32 clock rounding)
D_ATOL = 1e-5


def _segment(seed=5, n=24):
    """A heavy 24-arrival segment of the keep-regime pool, so that arrivals
    co-run and the criterion-1 queue fills."""
    rng = np.random.default_rng(seed)
    seg, t = [], 0.0
    for _ in range(n):
        w = _POOL[int(rng.integers(len(_POOL)))]
        t += float(rng.exponential(2e-5))
        seg.append((t, Workload(fs=w.fs, rs=w.rs, data_total=w.fs * 8)))
    return seg


def _snapshots(store):
    def on_segment(k, res, engine):
        store.append([np.array(d.cpu().numpy() if torch.is_tensor(d) else d)
                      for d in engine.current_D()])
    return on_segment


@pytest.mark.parametrize("scorer", ["torch", "cuda"])
def test_adaptive_engine_matches_jax_under_drift(scorer):
    K, drift_at = 4, 2
    arrivals = _replayed_trace(_segment(), K)
    jax_eng = AdaptiveEngine([M1, M2], prior=0.0, decay=0.9956, scatter="numpy",
                             drift=jdrift.congestion_at([M1, M2], drift_at, server=0, factor=0.4))
    port = TorchAdaptive([TM1, TM2], prior=0.0, decay=0.9956, scatter="numpy",
                         scorer=scorer, device="cpu",
                         drift=tdrift.congestion_at([TM1, TM2], drift_at, server=0, factor=0.4))
    jD, pD = [], []
    jr = jax_eng.run(arrivals, segments=K, on_segment=_snapshots(jD))
    pr = port.run(arrivals, segments=K, on_segment=_snapshots(pD))
    assert len(pr.segments) == K and pr.t_starts == jr.t_starts
    assert sum(sum(r.was_queued) for r in pr.segments) > 0  # the queue was used
    for k in range(K):
        assert pr.segments[k].placements == jr.segments[k].placements, k
        assert pr.segments[k].was_queued == jr.segments[k].was_queued, k
        assert pr.n_obs[k] == jr.n_obs[k] > 0, k
        assert pr.durations[k] == pytest.approx(jr.durations[k], rel=1e-3)
        for s in range(2):
            np.testing.assert_allclose(pD[k][s], jD[k][s], atol=D_ATOL, rtol=0)
    assert pr.total_obs == jr.total_obs >= K * 24 // 2
    assert pr.makespans == pytest.approx(jr.makespans, rel=1e-3)
    # the drift reached the ground truth: server 0's world changed at drift_at
    assert port.engine_for_segment(drift_at).servers[0].name.endswith(":cong0.4")
    # the estimate moved off the optimistic prior
    assert float(port.estimators[0].n_pair.sum()) > 0
    assert float(port.current_D()[0].max()) > 0


def test_adaptive_engine_profiled_prior_matches_oracle_immediately():
    servers = [TM1, TM2]
    seg = _pair_trace(M1, seed=9, n_arrivals=16)
    adaptive = TorchAdaptive(servers, prior="profiled", scatter="numpy", device="cpu")
    res = adaptive.run(seg, segments=1)
    oracle = TorchEngine(servers, D=[profile_pairwise_fast(s) for s in (M1, M2)],
                         device="cpu")
    want = oracle.run(sorted(seg, key=lambda tw: tw[0]))
    assert res.segments[0].placements == want.placements
    assert res.segments[0].makespan == pytest.approx(want.makespan, rel=1e-6)


def test_adaptive_engine_caches_segment_engines():
    servers = [TM1, TM2]
    plain = TorchAdaptive(servers, prior=0.0, scatter="numpy", device="cpu")
    e0 = plain.engine_for_segment(0)
    e1 = plain.engine_for_segment(1)
    assert e0 is e1  # no drift: one engine, D refreshed in place
    plain.estimators[0].n_pair = torch.full((T, T), 10.0, dtype=torch.float64)
    plain.estimators[0].L = torch.log1p(-torch.full((T, T), 0.3, dtype=torch.float64))
    e2 = plain.engine_for_segment(2)
    assert e2 is e0
    np.testing.assert_allclose(e2.cluster.D[0].numpy(),
                               plain.estimators[0].estimate_D().numpy(), atol=1e-6)

    drift = tdrift.congestion_at(servers, 2, server=0, factor=0.4)
    drifted = TorchAdaptive(servers, prior=0.0, drift=drift, scatter="numpy", device="cpu")
    d0, d1 = drifted.engine_for_segment(0), drifted.engine_for_segment(1)
    d2, d3 = drifted.engine_for_segment(2), drifted.engine_for_segment(3)
    assert d0 is d1 and d2 is not d1 and d2 is d3
    assert d0._dyn is not None and d2._dyn is not None  # cached, not lazy


def test_cluster_build_casts_any_D_form_alike():
    """Estimated D arrives as float64 tensors, profiled D as numpy: every
    form, and a list mixing them, gives the same float32 tables bitwise."""
    from repro_torch.core.binpack_torch import PackedCluster

    servers = [TM1, TM2]
    rng = np.random.default_rng(11)
    D64 = [rng.uniform(0.0, 0.6, (T, T)) for _ in servers]
    want = PackedCluster.build(servers, D64, device="cpu").D
    for D in ([d.astype(np.float32) for d in D64],
              [torch.from_numpy(d) for d in D64],
              [D64[0], torch.from_numpy(D64[1])]):
        got = PackedCluster.build(servers, D, device="cpu").D
        assert got.dtype == torch.float32 and torch.equal(got, want)
    shared = PackedCluster.build(servers, torch.from_numpy(D64[0]), device="cpu").D
    assert torch.equal(shared[1], want[0])


def test_unported_modes_raise():
    with pytest.raises(NotImplementedError, match="4a"):
        TorchAdaptive([TM1], stream=True, scatter="numpy", device="cpu")
    with pytest.raises(NotImplementedError, match="item 5"):
        TorchAdaptive([TM1], fleet=object(), scatter="numpy", device="cpu")
    eng = TorchAdaptive([TM1], scatter="numpy", device="cpu")
    for flag in ("device_loop", "metrics", "record"):
        with pytest.raises(NotImplementedError, match=flag):
            eng.run([], segments=1, **{flag: True})
    with pytest.raises(NotImplementedError):
        TorchEngine([TM1], device="cpu").run([], telemetry="device")
    with pytest.raises(ValueError):
        TorchAdaptive([TM1], prior="learned", scatter="numpy", device="cpu")


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchAdaptive([TM1])
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchAdaptive([TM1], scatter="numpy")
    with pytest.raises(RuntimeError, match="CUDA"):
        StreamingEstimator(T=T, scatter="torch")
    with pytest.raises(RuntimeError, match="CUDA"):
        ObservationLog.empty(T)


def test_estimator_state_carried_across():
    """A JAX estimator warmed on one log, carried across with
    ``estimator_from_numpy``, then both updated on a second log."""
    engine = ConsolidationEngine([M1], D=profile_pairwise_fast(M1))
    logs = [engine.run(_pair_trace(M1, seed), backend="jax", telemetry=True).observations
            for seed in (21, 38)]
    kw = dict(T=T, prior_D=0.1, lr=0.7, decay=0.99, confidence_floor=3.0,
              max_lost_frac=0.4, step_damp=0.25, solo_eps=0.1)
    jax_est = JaxEstimator(**kw, scatter="numpy")
    jax_est.update(logs[0])
    state = {k: np.asarray(getattr(jax_est, k)) for k in convert.ESTIMATOR_STATE}
    state["n_obs"] = jax_est.n_obs
    state.update({k: kw[k] for k in convert.ESTIMATOR_HYPERS})
    port = convert.estimator_from_numpy(state, scatter="numpy", device="cpu")
    assert (port.lr, port.decay, port.step_damp) == (0.7, 0.99, 0.25)
    np.testing.assert_array_equal(port.estimate_D().numpy(), jax_est.estimate_D())
    assert port.update(_to_port(logs[1])) == jax_est.update(logs[1]) > 0
    for k in ("L", "log_b", "n_pair", "n_base"):
        np.testing.assert_allclose(getattr(port, k).numpy(), getattr(jax_est, k),
                                   rtol=1e-12, atol=1e-15, err_msg=k)
    np.testing.assert_allclose(port.estimate_D().numpy(), jax_est.estimate_D(),
                               rtol=1e-12, atol=1e-15)
    assert port.n_obs == jax_est.n_obs
    with pytest.raises(KeyError):
        convert.estimator_from_numpy({"L": state["L"]}, scatter="numpy", device="cpu")
