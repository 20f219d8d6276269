"""Port: the decision flight recorder and regret attribution
(``repro_torch.obs.recorder``, ``repro_torch.obs.explain``) against
``repro.obs``.

The ring keeps the last on-rows oldest first whatever wraps, and refuses an
adopt of another capacity; ``record=True`` changes no decision; the ring
reconstructs every placement; the recorded rows equal JAX's on the same
trace (integer columns exactly, float columns within 1e-5, candidate ids
wherever the score gap exceeds 1e-6: the ranks within a near-tie follow
last-bit differences); the host-alternating path and the
fused loop record the same rows; attribution telescopes to each segment's
regret; the fused segment body with both flags on makes no host read; and
``python -m repro_torch.obs --selfcheck`` exits 0 on the CPU.
"""
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hyp import given, settings, st
from repro.configs.base import MeshConfig
from repro.core import M1, M2, AdaptiveEngine, ConsolidationEngine
from repro.core import run_trace as jax_run_trace
from repro.fleet import FleetController as JaxController
from repro.obs import recorder as JR
from repro_torch.configs import MeshConfig as TMesh
from repro_torch.core import M1 as TM1
from repro_torch.core import M2 as TM2
from repro_torch.core import AdaptiveEngine as TorchAdaptive
from repro_torch.core import ConsolidationEngine as TorchEngine
from repro_torch.core import closed_loop, make_scorer, run_trace
from repro_torch.fleet import FleetController
from repro_torch.obs import explain
from repro_torch.obs import recorder as R
from test_closed_loop import _replay, _segment
from test_obs_recorder import _dense_arrivals
from test_torch_engine import one_intra_op_thread  # noqa: F401  -- autouse
from test_torch_event_loop import _case, _no_host_read

ROOT = pathlib.Path(__file__).resolve().parents[1]
INT_COLS = ("arrival", "segment", "server", "kind", "qdepth", "pool_row")
FLOAT_COLS = ("time", "headroom", "margin", "n_pair_min", "cusum", "score")
#: a candidate id beyond the winner is held to JAX's only where the scores
#: around it are further apart than the scheduler's tie margin
TIE = 1e-6


def _cols(state):
    ring = R.DecisionRing(state.capacity)
    ring.adopt(state)
    return ring.columns()


def _jcols(state):
    ring = JR.DecisionRing(int(state.block.ints.shape[0]))
    ring.adopt(state)
    return ring.columns()


def _assert_rows_match(got: dict, want: dict) -> None:
    """Integer columns exactly, float columns within 1e-5 (inf where JAX's
    is), candidate ids wherever the neighbouring scores differ by more than
    the tie margin."""
    assert len(got["arrival"]) == len(want["arrival"]) > 0
    for name in INT_COLS:
        assert np.array_equal(got[name], want[name]), name
    for name in FLOAT_COLS:
        assert np.array_equal(np.isfinite(got[name]), np.isfinite(want[name])), name
        fin = np.isfinite(want[name])
        np.testing.assert_allclose(got[name][fin], want[name][fin], atol=1e-5, rtol=1e-5,
                                   err_msg=name)
    # a slot's id is held where its score is further than the tie margin
    # from both neighbours' (inf slots, -1 on both sides, always); the last
    # slot's lower neighbour lies outside the ring, so only inf holds it
    sc = want["score"]
    with np.errstate(invalid="ignore"):
        apart = ~(np.abs(np.diff(sc, axis=1)) <= TIE)  # inf - inf is nan: apart
    clear = np.ones_like(sc, bool)
    clear[:, 1:] &= apart
    clear[:, :-1] &= apart
    clear[:, -1] &= ~np.isfinite(sc[:, -1])
    clear |= ~np.isfinite(sc)
    assert np.array_equal(got["cand"][clear], want["cand"][clear])


# -- ring semantics ------------------------------------------------------------

def _write(rec, i: int, on: bool, segment: int):
    k = R.REC_TOPK
    s = lambda v, dt=torch.int32: torch.tensor(v, dtype=dt)  # noqa: E731
    f = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    return R.record_row(
        rec, on=torch.tensor(on), arrival=s(i), segment=s(segment), server=s(i % 3),
        kind=s(i % 2), qdepth=s(i % 4), pool_row=s(i % 3),
        cand=torch.arange(k, dtype=torch.int32) + i,
        scores=torch.arange(k, dtype=torch.float32) + 0.5 * i, t=f(0.25 * i),
        headroom=f(0.125 * i), margin=f(float(i)), n_pair_min=f(-1.0), cusum=f(0.0))


@settings(max_examples=15, deadline=None)
@given(cap=st.integers(1, 8), ons=st.lists(st.booleans(), min_size=0, max_size=24))
def test_ring_keeps_last_on_rows_oldest_first(cap, ons):
    """Whatever on/off writes cross the capacity, the decoded ring is the
    last min(cap, n_on) on-rows in write order, and off-rows leave no trace:
    as JAX's ring on the same writes."""
    rec, expect = R.init(cap), []
    jrec = JR.init(cap)
    for i, on in enumerate(ons):
        rec = _write(rec, i, on, segment=i // 3)
        jrec = JR.record_row(
            jrec, on=jnp.asarray(on), arrival=i, segment=i // 3, server=i % 3, kind=i % 2,
            qdepth=i % 4, pool_row=i % 3, cand=jnp.arange(R.REC_TOPK, dtype=jnp.int32) + i,
            scores=jnp.arange(R.REC_TOPK, dtype=jnp.float32) + 0.5 * i, t=0.25 * i,
            headroom=0.125 * i, margin=float(i), n_pair_min=-1.0, cusum=0.0)
        if on:
            expect.append(i)
    expect = expect[-cap:]
    cols = _cols(rec)
    assert len(cols["arrival"]) == len(expect)
    np.testing.assert_array_equal(cols["arrival"], expect)
    np.testing.assert_array_equal(cols["segment"], [i // 3 for i in expect])
    np.testing.assert_allclose(cols["time"], [0.25 * i for i in expect])
    for i, row in zip(expect, cols["cand"]):
        np.testing.assert_array_equal(row, np.arange(R.REC_TOPK) + i)
    assert np.array_equal(rec.block.ints.numpy(), np.asarray(jrec.block.ints))
    assert np.array_equal(rec.block.floats.numpy(), np.asarray(jrec.block.floats))
    assert (int(rec.ptr), int(rec.total)) == (int(jrec.ptr), int(jrec.total))


def test_ring_adopt_rejects_capacity_mismatch():
    ring = R.DecisionRing(4)
    with pytest.raises(ValueError, match="capacity"):
        ring.adopt(R.init(8))
    with pytest.raises(ValueError, match="capacity"):
        R.init(0)


def test_row_helpers_equal_jax():
    """``top_candidates`` (a stable sort, ties to the lowest index, -1 past
    the feasible and past the fleet), ``tie_margin`` and
    ``pair_exposure_min`` on the same inputs as JAX's."""
    rng = np.random.default_rng(0)
    rows = [np.array([0.3, 0.1, np.inf, 0.1, 0.2], np.float32),
            np.array([np.inf, np.inf], np.float32), np.array([0.5], np.float32),
            rng.random(9).astype(np.float32)]
    for row in rows:
        cand, sc = R.top_candidates(torch.from_numpy(row))
        jcand, jsc = JR.top_candidates(jnp.asarray(row))
        assert np.array_equal(cand.numpy(), np.asarray(jcand))
        assert np.array_equal(sc.numpy(), np.asarray(jsc))
        assert float(R.tie_margin(sc)) == float(JR.tie_margin(jsc))
    T = 7
    n_pair = rng.random((T, T)).astype(np.float32)
    for counts, wtype in (([0, 1, 0, 2, 0, 0, 0], 1), ([0, 1, 0, 0, 0, 0, 0], 1),
                          ([1, 0, 0, 0, 0, 0, 3], 6)):
        c = np.asarray(counts, np.float32)
        got = R.pair_exposure_min(torch.from_numpy(n_pair), torch.from_numpy(c),
                                  torch.tensor([wtype]))
        want = JR.pair_exposure_min(jnp.asarray(n_pair), jnp.asarray(c), jnp.int32(wtype))
        assert float(got) == float(want)


# -- decision identity and provenance -------------------------------------------

@pytest.mark.parametrize("case,scorer", [("heavy_8srv", "torch"), ("queue_drain", "cuda")])
def test_recorded_rows_equal_jax(case, scorer):
    jc, jd, tc, td, t, ty, by = _case(case)
    jt = jax_run_trace(jc, jd, t, ty, by, record=True)
    sc = None if scorer == "torch" else make_scorer(scorer)
    args = (tc, td, torch.from_numpy(t), torch.from_numpy(ty), torch.from_numpy(by))
    pt = run_trace(*args, scorer=sc, record=True)
    assert pt.rec.capacity == 2 * len(t)
    got, want = _cols(pt.rec), _jcols(jt.rec)
    assert set(got) == set(want)
    _assert_rows_match(got, want)
    assert (got["kind"] == R.KIND_DRAIN).any() and (got["kind"] == R.KIND_QUEUED).any()


def test_record_on_off_decision_identity_and_reconstruction():
    """``record=True`` changes no decision, time or makespan; the ring
    reconstructs every placement and holds a queue row per queued arrival;
    a ring passed in is continued; JAX's ring on the same run is the
    port's."""
    engine = TorchEngine([TM1, TM2], device="cpu")
    arrivals = _dense_arrivals()
    base = engine.run(arrivals)
    rec = engine.run(arrivals, record=True)
    assert base.decisions is None and rec.decisions is not None
    for name in ("placements", "was_queued", "finish_times", "makespan"):
        assert getattr(base, name) == getattr(rec, name), name
    ring = R.DecisionRing(rec.decisions.capacity)
    ring.adopt(rec.decisions)
    assert explain.check_reconstruction(ring, [rec.placements]) == []
    cols = ring.columns()
    assert {int(a) for a, k in zip(cols["arrival"], cols["kind"]) if k == R.KIND_QUEUED} == {
        a for a, q in enumerate(rec.was_queued) if q}
    jrec = ConsolidationEngine([M1, M2], backend="jax").run(arrivals, record=True)
    _assert_rows_match(cols, _jcols(jrec.decisions))
    again = engine.run(arrivals, record=True, rec=rec.decisions)
    assert int(again.decisions.total) == 2 * int(rec.decisions.total)
    with pytest.raises(ValueError, match="record"):
        TorchEngine([TM1, TM2], device="cpu", backend="numpy").run(arrivals, record=True)


def _fleet_runs(segments=4, n_seg=10):
    arrivals = _replay(_segment(11, n_seg), segments)
    out = []
    for device_loop in (False, True):
        eng = TorchAdaptive([TM1] * 3, prior=0.0, decay=1.0, stream=True,
                            fleet=FleetController(mesh=TMesh()), ring_capacity=256,
                            scatter="torch", scorer="torch", device="cpu")
        out.append(eng.run(arrivals, segments=segments, device_loop=device_loop,
                           record=True, metrics=True))
    jeng = AdaptiveEngine([M1] * 3, prior=0.0, decay=1.0, stream=True,
                          fleet=JaxController(mesh=MeshConfig()), ring_capacity=256)
    return out[0], out[1], jeng.run(arrivals, segments=segments, record=True)


def test_host_and_fused_record_the_same_rows_as_jax():
    """``tests/test_obs_recorder.py``'s parity case: the port's two paths
    write the same ring (the context sampled from the live objects on one,
    from the carry on the other), and JAX's host path the same rows."""
    host, fused, jres = _fleet_runs()
    h, f = host.decisions.columns(), fused.decisions.columns()
    for name in INT_COLS + ("cand",):
        assert np.array_equal(h[name], f[name]), name
    for name in FLOAT_COLS:
        np.testing.assert_allclose(h[name], f[name], rtol=1e-5, atol=1e-6, err_msg=name)
    _assert_rows_match(h, jres.decisions.columns())
    assert (h["n_pair_min"] >= 0).any() and (h["segment"] == 3).any()
    for res in (host, fused):
        assert explain.check_reconstruction(res.decisions,
                                            [r.placements for r in res.segments]) == []


def test_attribution_sums_to_regret_and_reconstructs():
    """The telescoping-replay gate on the canned recorded adaptive run: per
    decision deltas sum to each segment's regret within 1e-5, and the
    replay reconstructs every recorded placement, as JAX's does."""
    from repro_torch.obs.__main__ import _attribute, _canned_adaptive

    eng, res, chunks = _canned_adaptive(torch.device("cpu"), segments=2, per_seg=8)
    atts, recon = _attribute(eng, res, chunks)
    assert len(atts) == 2 and recon == []
    assert explain.check_exactness(atts) == []
    for att in atts:
        assert len(att.decisions) > 0
        assert abs(sum(d.delta for d in att.decisions) - att.regret) <= 1e-5
        assert {d.bucket for d in att.decisions} <= {"aligned", "estimation", "queueing",
                                                    "detection"}


def test_fused_body_with_both_flags_makes_no_host_read(monkeypatch):
    """The fused segment body (``_assemble``, ``_fold_segment``) with
    metrics and record on, under the host-read guard, building no tensor
    from host data; decisions as the unflagged fused run."""
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
    arrivals = _replay(_segment(11, 10), 3)
    runs = []
    for flags in (dict(metrics=True, record=True), dict()):
        eng = TorchAdaptive([TM1] * 3, prior=0.0, decay=0.997, stream=True,
                            fleet=FleetController(mesh=TMesh()), ring_capacity=256,
                            scatter="torch", scorer="torch", device="cpu")
        runs.append(eng.run(arrivals, segments=3, device_loop=True, **flags))
    assert guarded.count("_fold_segment") == 8  # S_cap of both runs
    assert [r.placements for r in runs[0].segments] == [r.placements for r in runs[1].segments]
    assert runs[0].metrics is not None and len(runs[0].decisions) > 0


def test_selfcheck_cli_exits_zero():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-m", "repro_torch.obs", "--selfcheck", "--device",
                          "cpu"], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.count(" ok") == 5


@pytest.mark.parametrize("scorer", ["torch", "cuda"])
def test_block_with_both_flags_makes_no_host_read(monkeypatch, scorer):
    """Every block of the event loop with ``metrics`` and ``record`` on runs
    under the host-read guard (as a CUDA graph must capture it), and the
    run's frame and ring equal a whole run's."""
    from repro_torch.core import engine_torch

    _, _, tc, td, t, ty, by = _case("heavy_8srv")
    sc = None if scorer == "torch" else make_scorer(scorer)
    args = (tc, td, torch.from_numpy(t), torch.from_numpy(ty), torch.from_numpy(by))
    loop = engine_torch._TraceLoop(*args, "sum_avg", sc, True, metrics=True, record=True)
    loop._reset()
    for _ in range(-(-(4 * len(t) + 8) // loop.S)):
        with _no_host_read(monkeypatch):
            loop.block()
        if loop.status.tolist()[0]:
            break
    want = run_trace(*args, scorer=sc, telemetry=True, metrics=True, record=True)
    for a, b in zip(loop.mf, want.metrics):
        assert torch.equal(a, b)
    assert torch.equal(loop.rec.block.ints, want.rec.block.ints)
    assert torch.equal(loop.rec.block.floats, want.rec.block.floats)
