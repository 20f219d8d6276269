"""The example twins (``examples/torch_*.py``) against the JAX examples.

Each twin runs on the CPU at smoke size, and its printed decisions --
placements, queue decisions, the chosen alpha, the adaptive loop's
per-segment placements and observation counts -- equal those of the JAX
example run in the same test. The serving twin's admission is held to the
JAX serving module's ``admission_check`` (placements and metric frame), not to its
tokens: JAX's serving entry raises on the CPU
(``tests/test_system.py::test_serve_generates``). The training twin is held
to what the JAX example prints of itself: the restart resumes and runs 20
steps (its numerics are ``tests/test_torch_train.py``'s). No twin imports JAX or the
JAX package, and each refuses to run without a card unless ``--device cpu``
is given.
"""
import ast
import contextlib
import importlib.util
import io
import os
import pathlib
import re
import runpy
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
TWINS = ("torch_quickstart", "torch_closed_loop_adaptive", "torch_serve_with_admission",
         "torch_train_end_to_end")


def _load(name: str, alias: str):
    spec = importlib.util.spec_from_file_location(alias, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _printed(fn, *args, **kwargs):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(*args, **kwargs)
    return result, out.getvalue().splitlines()


@pytest.mark.parametrize("name", TWINS)
def test_twin_imports_neither_jax_nor_repro(name):
    tree = ast.parse((EXAMPLES / f"{name}.py").read_text())
    roots = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    roots |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module}
    assert not roots & {"jax", "jaxlib", "repro"}
    code = (f"import importlib.util, sys; spec = importlib.util.spec_from_file_location('t', "
            f"{str(EXAMPLES / (name + '.py'))!r}); spec.loader.exec_module("
            f"importlib.util.module_from_spec(spec)); "
            f"bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
            f"'repro')); print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("name", TWINS)
def test_twin_refuses_without_a_card(name, monkeypatch):
    mod = _load(name, f"twin_{name}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main([])


def test_quickstart_twin_matches_jax():
    """The JAX quickstart's every printed line, then the twin's extras (the
    device greedy, alpha, local search) against the JAX package's functions."""
    from repro.core import PAPER_CLUSTER, ClusterState, profile_pairwise_fast, snap_to_grid
    from repro.core import parse_workloads
    from repro.core.binpack import greedy_sequence
    from repro.core.calibrate import calibrate_alpha, pick_alpha, sweep_alpha
    from repro.core.refine import local_search, local_search_engine

    _, want = _printed(runpy.run_path, str(EXAMPLES / "quickstart.py"))
    twin = _load("torch_quickstart", "twin_quickstart")
    got, lines = _printed(twin.main, ["--device", "cpu"])
    assert [line for line in lines if not line.startswith(
        ("device greedy", "calibrated alpha", "local search"))] == want
    assert got["device_placements"] == got["placements"]
    assert f"device greedy on cpu: {got['placements']}  agrees" in lines

    servers = list(PAPER_CLUSTER)
    D = [profile_pairwise_fast(s) for s in servers]
    initial = [[snap_to_grid(w) for w in parse_workloads(t)] for t in twin.INITIAL]
    arrivals = [snap_to_grid(w) for w in parse_workloads(twin.ARRIVALS)]
    sweep = sweep_alpha(servers, D, initial, arrivals)
    assert got["sweep"] == sweep and got["alpha"] == pick_alpha(sweep)
    assert got["alpha_m1"] == calibrate_alpha(servers[0])
    state = ClusterState.empty(servers, D, alpha=1.3)
    state.assignments = [list(a) for a in initial]
    placements, queued = greedy_sequence(state, arrivals)
    assert placements == got["placements"] and len(queued) == got["queued"]
    refined, moves = local_search(state)
    assert (moves, refined.total_avg_load()) == (got["moves"], got["refined_load"])
    refined_dev, moves_dev = local_search_engine(state)
    assert moves_dev == got["moves_device"]
    assert got["refined_device_load"] == pytest.approx(refined_dev.total_avg_load(), abs=1e-9)


def _numbers(line: str) -> list[float]:
    return [float(x) for x in re.findall(r"[-+]?\d+\.?\d*(?:e[-+]?\d+)?", line)]


def test_closed_loop_adaptive_twin_matches_jax():
    """Four segments with the drift at segment 2: every segment's placements
    and queue decisions equal JAX's, the table's observation counts equal
    and its durations agree to 1e-3 relative (the engine's makespan
    contract, tests/test_engine.py)."""
    jax_ex = _load("closed_loop_adaptive", "jax_closed_loop_adaptive")
    jax_ex.SEGMENTS, jax_ex.DRIFT_AT = 4, 2
    runs = []

    class Recording(jax_ex.AdaptiveEngine):
        def run(self, *args, **kwargs):
            runs.append(super().run(*args, **kwargs))
            return runs[-1]

    jax_ex.AdaptiveEngine = Recording
    _, want = _printed(jax_ex.main)
    twin = _load("torch_closed_loop_adaptive", "twin_closed_loop_adaptive")
    got, lines = _printed(twin.main, ["--device", "cpu", "--segments", "4", "--drift-at", "2"])
    (jres,) = runs
    assert len(got.segments) == len(jres.segments) == 4
    for g, w in zip(got.segments, jres.segments):
        assert g.placements == w.placements and g.was_queued == w.was_queued
    assert got.n_obs == jres.n_obs
    table = [i for i, line in enumerate(want) if line.startswith("seg")][0]
    assert lines[table] == want[table]
    for g, w in zip(lines[table + 1:table + 5], want[table + 1:table + 5]):
        assert g.split()[:2] == w.split()[:2]  # segment and phase
        gn, wn = _numbers(g), _numbers(w)
        assert gn[-1] == wn[-1]  # observations consumed
        np.testing.assert_allclose(gn, wn, rtol=1e-3, atol=1e-3)
    # the estimator's observations and confident pairs, its error to the truth
    gn, wn = _numbers(lines[-1]), _numbers(want[-1])
    assert gn[1:3] == wn[1:3]
    np.testing.assert_allclose(gn, wn, rtol=1e-3, atol=1e-3)


def test_serve_twin_admission_matches_jax(monkeypatch):
    """On the JAX serving module's hosts (TPU_V5E_HOST) the twin's admission
    placements and metric frame equal JAX's ``admission_check``; on the
    port's own H100 hosts its placements equal the JAX engine's on the same
    spec. Then the SMOKE model serves 4 x 16 tokens."""
    from repro.core import ConsolidationEngine as JaxEngine
    from repro.core import ServerSpec as JaxSpec
    from repro.core import Workload as JaxWorkload
    from repro.core.units import KB, MB
    from repro.launch.serve import admission_check as jax_admission
    import dataclasses

    from repro_torch.core import H100_HOST, TPU_V5E_HOST
    from repro_torch.launch import serve

    twin = _load("torch_serve_with_admission", "twin_serve")
    seen = []
    orig = serve.admission_check

    def on_tpu_hosts(arch, n, **kw):
        seen.append(orig(arch, n, host=TPU_V5E_HOST, **kw))
        return seen[-1]

    monkeypatch.setattr(serve, "admission_check", on_tpu_hosts)
    tokens, lines = _printed(twin.main, ["--device", "cpu"])
    (placements, frame), = seen
    want_p, want_f = jax_admission("tinyllama-1.1b", 4, metrics=True)
    assert placements == want_p and f"hosts {want_p}" in lines[0]
    assert np.array_equal(frame.counters.numpy(), np.asarray(want_f.counters))
    assert np.array_equal(frame.hist.numpy(), np.asarray(want_f.hist))
    assert tuple(tokens.shape) == (4, 16)

    monkeypatch.setattr(serve, "admission_check", orig)
    _, lines = _printed(twin.main, ["--device", "cpu"])
    spec = JaxSpec(**dataclasses.asdict(H100_HOST))
    stream = JaxWorkload(fs=64 * MB, rs=256 * KB, name="serve:tinyllama-1.1b")
    res = JaxEngine([spec, spec]).run([(0.0, stream)] * 4)
    want_h100 = [None if q else p for p, q in zip(res.placements, res.was_queued)]
    assert lines[0] == f"consolidation admission: 4 stream(s) -> hosts {want_h100}"


def test_train_twin_resumes_after_the_crash():
    """The training twin on the CPU: 40 steps with checkpoints at 20 and 40,
    then a restart that resumes from step 40 and runs the 20 steps to 60,
    with finite losses that fall over the first run, as the JAX example's
    printout says of itself."""
    twin = _load("torch_train_end_to_end", "twin_train")
    losses, lines = _printed(twin.main, ["--device", "cpu"])
    assert len(losses) == 20 and all(np.isfinite(losses))
    assert "resumed from step 40" in lines
    assert lines[-1] == "resumed run executed 20 steps (expected 20)"
    first = next(line for line in lines if line.startswith("final loss"))
    assert first.endswith("improved: True"), first
