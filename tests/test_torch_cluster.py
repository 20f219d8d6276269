"""Fleet packing (``repro_torch.core.cluster``) against JAX's
``repro.core.cluster``: the JAX tests' seven cases run on both modules,
placements and reports bit for bit equal on random fleets, the H100 chip's
own constants, and the example twin's placements against the JAX
example's."""
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import repro.core.cluster as jcluster
import repro_torch.core.cluster as tcluster
from repro_torch.launch import roofline

ROOT = pathlib.Path(__file__).resolve().parents[1]
MODULES = {"jax": jcluster, "torch": tcluster}


def _job(m, name="j", flops=1e15, bytes_=2e14, coll=1e13, hbm=4 * 2**30):
    return m.JobProfile(name=name, flops=flops, bytes_accessed=bytes_,
                        collective_bytes=coll, hbm_bytes=hbm, chips=256)


def case_step_time_is_max_of_terms(m):
    j = _job(m)
    t = j.step_time()
    assert t == pytest.approx(max(
        j.flops / (256 * 197e12), j.bytes_accessed / (256 * 819e9),
        j.collective_bytes / (256 * 50e9)))


def case_demands_sum_to_at_most_count(m):
    d = _job(m).demands()
    assert max(d.values()) == pytest.approx(1.0)
    assert all(0 <= v <= 1 for v in d.values())


def case_pack_respects_hbm_budget(m):
    fleet = m.FleetState.empty([m.PodSpec(name="p0")])
    big = _job(m, hbm=m.HBM_BYTES)
    placements, fleet = m.pack_jobs(fleet, [big, big])
    assert placements[0] == 0
    assert placements[1] is None


def case_pack_respects_degradation_rule(m):
    fleet = m.FleetState.empty([m.PodSpec(name="p0")], model="additive")
    jobs = [_job(m, name=f"j{i}", hbm=2 * 2**30) for i in range(6)]
    placements, fleet = m.pack_jobs(fleet, jobs)
    d = fleet.degradations(0)
    assert d.size == 0 or d.max() < 0.5
    assert any(p is None for p in placements)


def case_roofline_model_detects_saturation(m):
    jobs = [_job(m), _job(m)]
    d = m.roofline_degradations(jobs)
    assert np.all(d > 0.4)
    assert np.all(m.roofline_degradations([_job(m)]) == 0.0)


def case_additive_matches_pairwise_at_n2(m):
    a, b = _job(m, "a"), _job(m, "b", flops=1e14)
    d = m.additive_degradations([a, b])
    assert d[1] == pytest.approx(m.pair_degradation(a, b))
    assert d[0] == pytest.approx(m.pair_degradation(b, a))


def case_report_shapes(m):
    fleet = m.FleetState.empty([m.PodSpec(name="p0"), m.PodSpec(name="p1")])
    jobs = [_job(m, name=f"j{i}", flops=2e13, hbm=2**30) for i in range(4)]
    m.pack_jobs(fleet, jobs)
    rows = m.fleet_throughput_report(fleet)
    assert len(rows) == sum(len(a) for a in fleet.assignments)
    for r in rows:
        assert r["eff_steps_per_s"] <= r["solo_steps_per_s"] + 1e-9


CASES = [case_step_time_is_max_of_terms, case_demands_sum_to_at_most_count,
         case_pack_respects_hbm_budget, case_pack_respects_degradation_rule,
         case_roofline_model_detects_saturation, case_additive_matches_pairwise_at_n2,
         case_report_shapes]


@pytest.mark.parametrize("module", sorted(MODULES))
@pytest.mark.parametrize("case", CASES, ids=lambda f: f.__name__[5:])
def test_jax_cluster_cases(case, module):
    """tests/test_core_cluster.py's seven cases, on each module."""
    case(MODULES[module])


def _random_jobs(m, rng, n):
    return [m.JobProfile(name=f"job{i}", flops=float(10 ** rng.uniform(13, 16)),
                         bytes_accessed=float(10 ** rng.uniform(12, 15)),
                         collective_bytes=float(10 ** rng.uniform(10, 14)),
                         hbm_bytes=float(rng.uniform(0.5, 9) * 2**30),
                         chips=int(rng.choice([64, 128, 256])))
            for i in range(n)]


@pytest.mark.parametrize("model", ["additive", "roofline"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_placements_and_reports_bitwise_equal(model, seed):
    out = {}
    for name, m in MODULES.items():
        rng = np.random.default_rng(seed)
        jobs = _random_jobs(m, rng, 24)
        pods = [m.PodSpec(name=f"pod{i}", chips=256) for i in range(5)]
        placements, fleet = m.pack_jobs(m.FleetState.empty(pods, model=model), jobs)
        out[name] = (placements, m.fleet_throughput_report(fleet),
                     [j.step_time() for j in jobs], [j.demands() for j in jobs],
                     [fleet.avg_load(p) for p in range(len(pods))])
    assert out["torch"] == out["jax"]
    assert any(p is not None for p in out["jax"][0]) and any(p is None for p in out["jax"][0])


def test_module_constants_are_jax_tpu_defaults():
    for name in ("PEAK_FLOPS", "HBM_BW", "ICI_BW", "HBM_BYTES"):
        assert getattr(tcluster, name) == getattr(jcluster, name)
    assert tcluster.PodSpec(name="p") == tcluster.PodSpec(
        name="p", chips=256, hbm_budget=256 * jcluster.HBM_BYTES)
    assert {f.name for f in dataclasses.fields(jcluster.JobProfile)} < {
        f.name for f in dataclasses.fields(tcluster.JobProfile)}


def test_h100_step_time_uses_its_own_constants():
    c = tcluster.H100_SXM
    assert (c.peak_flops, c.hbm_bw, c.link_bw, c.hbm_bytes) == (989e12, 3.35e12, 450e9, 80e9)
    assert (c.peak_flops, c.hbm_bw, c.link_bw, c.hbm_bytes) == (
        roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW, roofline.HBM_BYTES)
    tpu = _job(tcluster, flops=1e17, bytes_=1e14, coll=1e12)
    h100 = dataclasses.replace(tpu, chip=c)
    assert h100.step_time() == max(1e17 / (256 * 989e12), 1e14 / (256 * 3.35e12),
                                   1e12 / (256 * 450e9))
    assert tpu.step_time() / h100.step_time() == pytest.approx(989 / 197)
    d = dataclasses.replace(_job(tcluster, flops=1e13, bytes_=1e15, coll=1e15), chip=c).demands()
    assert d["ici_bw"] == pytest.approx(1e15 / (256 * 450e9) / (1e15 / (256 * 450e9)))
    pod = tcluster.h100_pod("g", chips=128)
    assert (pod.chips, pod.hbm_budget) == (128, 128 * 80e9)
    fleet = tcluster.FleetState.empty([pod])
    big = dataclasses.replace(_job(tcluster, hbm=80e9), chips=128, chip=c)
    placements, _ = tcluster.pack_jobs(fleet, [big, big])
    assert placements == [0, None]


def _run(script: pathlib.Path, *args) -> list[str]:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, str(script), *args], env=env, capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stdout + out.stderr
    return out.stdout.splitlines()


def test_example_twin_matches_jax_example(tmp_path):
    """On the synthetic profiles (no artifacts), the twin's TPU section is
    the JAX example's output line for line; its H100 section packs the same
    jobs onto four 256-card pods."""
    jax_lines = _run(ROOT / "examples" / "consolidate_tpu_fleet.py")
    twin = _run(ROOT / "examples" / "torch_consolidate_tpu_fleet.py", "--artifacts",
                str(tmp_path / "none"))
    assert twin[:len(jax_lines)] == jax_lines
    assert jax_lines[0] == "(no dry-run artifacts; using synthetic job profiles)"
    rest = twin[len(jax_lines):]
    assert rest[1].startswith("=== the same jobs on four pods of 256 H100")
    assert rest[2] == "10 jobs -> 4 pods"
    assert all(line.startswith("  h100pod") for line in rest[16:] if line)
