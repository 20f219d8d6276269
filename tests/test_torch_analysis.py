"""The port's purity audit (``repro_torch.analysis``), on the CPU.

Each rule of each pass flags a planted violation (the cases of
``tests/test_analysis.py`` where they carry over), the registry covers the
JAX package's and every kernel source, the cuobjdump parser reads a sample
recorded from the card, and ``python -m repro_torch.analysis --device cpu``
exits 0 on the tree with its baseline, with zero builds on every rerun of
the capture scenario.
"""
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch.analysis import (BASELINE_PATH, Finding, load_baseline, load_baseline_reasons,
                                  new_findings, write_baseline)
from repro_torch.analysis import ast_rules, capture, dispatch_audit, kernel_budget, registry
from repro_torch.analysis.registry import (CPU_SHAPES, JAX_COUNTERPARTS, KERNEL_COVERAGE,
                                           REGISTRY, TIER_DEVICE, TIER_DEVICE_F64, TIER_HOST,
                                           BuildCtx, HotEntry)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
#: cuobjdump --dump-resource-usage of three of the built libraries
#: (consolidation_scores, cusum_scan, flash_attention), recorded on the card
#: (H100 80GB HBM3, CUDA 12.8 toolkit)
SAMPLE = ROOT / "tests" / "torch_cuobjdump_sample.txt"


def test_finding_key_ignores_detail():
    """Baseline keys must survive rewording: detail is excluded."""
    a = Finding("ast", "traced-branch", "x.py:3", "old wording")
    b = Finding("ast", "traced-branch", "x.py:3", "new wording")
    assert a.key() == b.key() == "ast:traced-branch:x.py:3"


def test_baseline_round_trip_keeps_reasons(tmp_path):
    path = tmp_path / "baseline.json"
    a = Finding("dispatch", "float64-leak", "e", "why not")
    write_baseline([a], path)
    assert load_baseline_reasons(path)[a.key()].startswith("unreviewed: why not")
    path.write_text(json.dumps({"findings": {a.key(): "kept"}}))
    write_baseline([a, Finding("ast", "host-item", "f.py:1")], path)
    reasons = load_baseline_reasons(path)
    assert reasons[a.key()] == "kept" and set(reasons) == {a.key(), "ast:host-item:f.py:1"}
    assert new_findings([a, Finding("ast", "host-item", "g.py:2")], set(reasons)) == [
        Finding("ast", "host-item", "g.py:2")]


def test_checked_in_baseline_gives_every_key_a_reason():
    reasons = load_baseline_reasons()
    assert BASELINE_PATH.parent.name == "analysis" and reasons
    assert not (ROOT / "analysis-baseline.json").samefile(BASELINE_PATH)
    for key, why in reasons.items():
        assert why.strip() and "\n" not in why and not why.startswith("unreviewed"), key


# -- the registry ---------------------------------------------------------------------------

def test_every_jax_entry_has_a_counterpart():
    from repro.analysis.jaxpr_audit import PALLAS_COVERAGE
    from repro.analysis.jaxpr_audit import REGISTRY as JAX_REGISTRY
    names = {e.name for e in REGISTRY}
    assert len(names) == len(REGISTRY)
    assert set(JAX_COUNTERPARTS) == {e.name for e in JAX_REGISTRY}
    assert set(JAX_COUNTERPARTS.values()) <= names
    # every Pallas file's kernel has a CUDA source, and every source a launching entry
    assert len(PALLAS_COVERAGE) == 5 and len(KERNEL_COVERAGE) == 7
    assert set(KERNEL_COVERAGE) == {p.stem for p in (ROOT / "src/repro_torch/kernels/csrc")
                                    .glob("*.cu")}
    assert {e.kernel for e in REGISTRY if e.kernel} == set(KERNEL_COVERAGE)
    for entry in REGISTRY:
        assert entry.tier in (TIER_DEVICE, TIER_DEVICE_F64, TIER_HOST)
        assert entry.tier == TIER_DEVICE or entry.note, entry.name


def test_card_shapes_are_production():
    rack, fleet = registry.CARD_SHAPES
    assert (rack.m, fleet.m) == (64, 1024) and (rack.B, fleet.B) == (512, 8192)
    assert registry.T == 230


# -- dispatch walk --------------------------------------------------------------------------

def _walk(fn, *args, tier=TIER_DEVICE, device=CPU):
    entry = HotEntry("test.planted", tier, lambda ctx: (fn, args))
    findings, info = dispatch_audit.audit_entry(entry, BuildCtx(device, CPU_SHAPES[0]))
    return {f.rule: f for f in findings}, info


def test_device_tier_rejects_callback():
    """Every form of host read in a device-tier entry is a host-callback."""
    x = torch.arange(4.0)
    for read in (lambda x: x.sum().item(), lambda x: bool(x.any()), lambda x: float(x[0]),
                 lambda x: x.tolist(), lambda x: x.numpy(), lambda x: int(x.argmax())):
        rules, _ = _walk(read, x)
        assert set(rules) == {"host-callback"}, rules
    rules, _ = _walk(lambda x: x.sum().item(), x, tier=TIER_HOST)
    assert rules == {}


def test_dynamic_shape_flagged():
    x = torch.tensor([0.5, -1.0, 2.0])
    for op in (lambda x: torch.nonzero(x), lambda x: x[x > 0], lambda x: torch.unique(x),
               lambda x: torch.masked_select(x, x > 0),
               lambda x: torch.repeat_interleave(torch.tensor([1, 2]))):
        rules, _ = _walk(op, x)
        assert "dynamic-shape" in rules, rules
    # fixed-shape forms of the same work are clean
    for op in (lambda x: torch.where(x > 0, x, 0.0), lambda x: x[torch.tensor([0, 2])],
               lambda x: torch.sort(x).values,
               lambda x: torch.repeat_interleave(torch.tensor([1, 2]), output_size=3)):
        rules, info = _walk(op, x)
        assert rules == {} and info["ops"] > 0


def test_float64_leak_on_device_tier_only():
    x = torch.ones(3)
    rules, _ = _walk(lambda x: x.double() * 2, x)
    assert "float64-leak" in rules and "`aten._to_copy" in rules["float64-leak"].detail
    assert "test_torch_analysis" not in rules["float64-leak"].detail  # sites are the port's
    for tier in (TIER_DEVICE_F64, TIER_HOST):
        assert _walk(lambda x: x.double() * 2, x, tier=tier)[0] == {}


def test_host_sync_rule_resets_the_mode(monkeypatch):
    """On the card the entry runs again under the sync debug mode "error";
    a synchronizing call there is a host-sync finding, and the mode goes
    back to "default" whatever happened (simulated here: the planted call
    raises what the mode raises)."""
    modes = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)

    def planted(x):
        if modes and modes[-1] == "error":
            raise RuntimeError("called a synchronizing CUDA operation")
        return x + 1

    rules, info = _walk(planted, torch.ones(2), device=torch.device("cuda"))
    assert set(rules) == {"host-sync"} and info["host_sync"] is False
    assert modes == ["error", "default"]
    rules, _ = _walk(lambda x: x + 1, torch.ones(2), device=torch.device("cuda"))
    assert rules == {} and modes[-1] == "default"


def test_one_rank_axis_is_made_and_destroyed():
    import torch.distributed as dist
    assert not dist.is_initialized()
    with dispatch_audit.one_rank_axis(CPU) as axis:
        ax = axis()
        assert ax.is_sharded and ax.shards == 1 and axis() is ax
    assert not dist.is_initialized()


# -- AST rules ------------------------------------------------------------------------------

def _rules(src: str, **kw) -> set:
    return {f.rule for f in ast_rules.lint_source(src, **kw)}


def test_ast_traced_branch():
    assert "traced-branch" in _rules("""
        def f(x):
            if x > 0:
                return x
            return -x
    """)
    assert "traced-branch" in _rules("""
        def f(x):
            return x if x.any() else -x
    """)


def test_ast_traced_branch_static_ok():
    """Branches on host parameters, shape metadata, identity and
    keyword-only configuration never flag."""
    assert _rules("""
        def f(self, x, mode, on=None, *, causal=True):
            if mode == "fast" and self.metrics:
                return x
            m, n = x.shape
            if m > n or len(x) > 2 or x.dim() == 2 or x.device.type == "cpu":
                return x.T
            if on is None or causal:
                on = x > 0
            return x
    """, static={"mode"}, host_attrs={"metrics"}) == set()


def test_ast_np_on_traced():
    assert "np-on-traced" in _rules("""
        def f(x):
            return np.asarray(x).sum()
    """)


def test_ast_host_item_and_coercion():
    rules = _rules("""
        def f(x):
            a = x.sum().item()
            b = float(x[0])
            c = x.tolist() + x.cpu().numpy() + x.to("cpu")
            return a + b + c
    """)
    assert rules == {"host-item", "host-coercion"}


def test_ast_self_attributes():
    """A method's ``self.<attr>`` is a tensor unless it is a host attribute."""
    src = """
        def f(self, st):
            if self.metrics and self.n > 1:
                st = st + self.status
            return self.status.tolist()
    """
    assert _rules(src, host_attrs={"metrics", "n"}) == {"host-item"}
    assert _rules(src, host_attrs={"n"}) == {"host-item", "traced-branch"}


def test_ast_keyword_tensors():
    """A keyword-only parameter declared ``traced`` is a tensor (record_row's)."""
    src = """
        def f(rec, *, on):
            if on:
                rec = rec + 1
            return rec
    """
    assert _rules(src) == set() and _rules(src, traced={"on"}) == {"traced-branch"}


def test_ast_taint_propagates_through_assignment():
    assert "traced-branch" in _rules("""
        def f(x):
            y = x * 2
            z = y + 1
            while z > 0:
                z = z - 1
            return z
    """)
    assert _rules("""
        def f(x):
            y = x * 2
            y = y.shape[0]
            if y > 1:
                return x
            return x + (sum(p.data_ptr() for p in (x, x)) > 0)
    """) == set()


def test_ast_stale_ring_view():
    assert "stale-ring-view" in _rules("""
        def f(ring, block):
            v = ring.view()
            ring.push(block)
            return v.co.sum()
    """)


def test_ast_ring_view_before_push_ok():
    assert "stale-ring-view" not in _rules("""
        def f(ring, block, x):
            v = ring.view()
            total = v.co.sum()
            ring.push(block)
            w = x.view(-1)
            ring.push(block)
            return total + w
    """)


def test_kernel_uncovered(tmp_path):
    """A planted kernel source, and a wrapper loading an unregistered name,
    are each flagged; the tree's sources and loads are all covered."""
    kernels, csrc = tmp_path / "kernels", tmp_path / "kernels" / "csrc"
    csrc.mkdir(parents=True)
    (csrc / "cusum_scan.cu").write_text("// covered\n")
    (csrc / "planted.cu").write_text("__global__ void k() {}\n")
    (kernels / "cusum.py").write_text("from . import _build\nlib = _build.load('cusum_scan')\n")
    (kernels / "planted.py").write_text("from . import _build\nlib = _build.load('planted')\n")
    cover = {"cusum_scan": "kernels/cusum.py"}
    findings, sites = ast_rules.kernel_coverage_findings(kernels, csrc, cover, root=tmp_path)
    assert sites == 2
    assert sorted(f.where for f in findings) == ["kernels/csrc/planted.cu", "kernels/planted.py:2"]
    assert {f.rule for f in findings} == {"kernel-uncovered"}
    tree, tree_sites = ast_rules.kernel_coverage_findings()
    assert tree == [] and tree_sites >= 7


def test_registered_bodies_resolve():
    """Every body an entry names is found, with the block's eleven methods."""
    bodies = list(ast_rules.registered_bodies())
    names = {b.qualname for b in bodies}
    for method in ("block", "step", "place_if", "advance", "apply_delta", "pick_types",
                   "drain_branch", "finish_branch", "arrive_branch"):
        assert f"repro_torch.core.engine_torch:_TraceLoop.{method}" in names
    run = ast_rules.resolve_body("repro_torch.core.engine_torch:_TraceLoop.run",
                                 host_attrs=registry.LOOP_HOST_ATTRS)
    # the block's status read, and the branch on it, lie in ``run``, outside the
    # registered bodies
    assert {f.rule for f in ast_rules.lint_body(run)} == {"host-item", "traced-branch"}


# -- kernel resource budget -----------------------------------------------------------------

def test_cuobjdump_parser_on_recorded_sample():
    usage = kernel_budget.parse_resource_usage(SAMPLE.read_text())
    assert len(usage) == 25  # 3 scorer kernels, 2 scan instances, 20 flash instances
    table = next(k for k in usage if "score_table_kernel" in k["function"])
    assert (table["registers"], table["shared"], table["local"], table["stack"]) == (32, 6468, 0, 0)
    assert max(k["registers"] for k in usage) == 255
    assert sorted({k["stack"] for k in usage}) == [0, 8, 16]
    assert all(k["local"] == 0 and k["constant"] > 0 for k in usage)
    # within the register and shared-memory budget; four flash kernels spill
    # to their stack frame (ptxas reported the same spills at the build)
    found = kernel_budget.budget_findings("sample", usage)
    assert [f.rule for f in found] == ["kernel-spill"] * 4
    assert all("flash_attention" in f.where for f in found)
    assert kernel_budget._short("void (anonymous namespace)::k<false>(int const*, float)") == "k<false>"


def test_kernel_budget_and_spill_flagged():
    usage = [{"function": "ok", "registers": 96, "shared": 48 * 1024, "stack": 0, "local": 0},
             {"function": "fat", "registers": 256, "shared": 0, "stack": 0, "local": 0},
             {"function": "wide", "registers": 32, "shared": 48 * 1024 + 4, "stack": 0,
              "local": 0},
             {"function": "spill", "registers": 255, "shared": 0, "stack": 8, "local": 0},
             {"function": "array", "registers": 40, "shared": 0, "stack": 0, "local": 16}]
    found = {(f.where, f.rule) for f in kernel_budget.budget_findings("k", usage)}
    assert found == {("k:fat", "kernel-budget"), ("k:wide", "kernel-budget"),
                     ("k:spill", "kernel-spill"), ("k:array", "kernel-spill")}


# -- capture guard --------------------------------------------------------------------------

def test_capture_guard_counts_a_planted_rebuild(monkeypatch):
    """An engine cache that forgets its engine every segment rebuilds the
    engine, its dynamics and its loop per segment: the warm run's rule
    fires, where the unplanted run builds each once."""
    from repro_torch.core.engine import AdaptiveEngine

    arrivals = capture._audit_arrivals(12)
    eng = capture._small_adaptive_engine(CPU)
    with capture.CaptureGuard(eng) as clean:
        eng.run(arrivals, segments=3)
    clean.assert_max(1)
    assert clean.deltas["engine_torch._TraceLoop"] == 1

    forget = AdaptiveEngine.engine_for_segment

    def rebuilding(self, segment):
        self._engine_cache.clear()
        self._dyn_cache.clear()
        return forget(self, segment)

    monkeypatch.setattr(AdaptiveEngine, "engine_for_segment", rebuilding)
    eng = capture._small_adaptive_engine(CPU)
    with capture.CaptureGuard(eng) as planted:
        eng.run(arrivals, segments=3)
    for name in ("engine.ConsolidationEngine", "engine_torch._TraceLoop",
                 "engine_torch.PackedDynamics.build"):
        assert planted.deltas[name] == 3, planted.deltas
    with pytest.raises(AssertionError, match="capture guard"):
        planted.assert_max(1)
    guards = {key: clean for key, *_ in capture.RULES}
    guards["warm"] = planted
    rules = {f.rule for f in capture.findings_from_guards(guards, 3)}
    # the clean guard's one build of each kind breaks only the zero-build rules
    assert "per-segment-retrace" in rules and "metrics-retrace" not in rules


def test_every_capture_rule_fires_on_its_guard():
    quiet, one = capture.CaptureGuard(), capture.CaptureGuard()
    quiet.deltas, one.deltas = {"engine_torch._TraceLoop": 0}, {"engine_torch._TraceLoop": 2}
    for key, limit, rule, _ in capture.RULES:
        guards = {k: quiet for k, *_ in capture.RULES}
        guards[key] = one
        found = capture.findings_from_guards(guards, 3)
        assert [f.rule for f in found] == [rule] and found[0].where == "engine_torch._TraceLoop"


# -- the CLI on the tree --------------------------------------------------------------------

@pytest.fixture(scope="module")
def cli_report(tmp_path_factory):
    """``python -m repro_torch.analysis --device cpu --json`` on the tree."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    env.pop("PYTHONSTARTUP", None)
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis", "--device", "cpu",
                          "--json"], env=env, capture_output=True, text=True, timeout=300,
                         cwd=tmp_path_factory.mktemp("cli"))
    return out.returncode, json.loads(out.stdout), out.stderr


def test_cli_exits_zero_on_the_tree(cli_report):
    rc, report, err = cli_report
    assert rc == 0, (report["new"], err[-2000:])
    assert report["new"] == [] and set(report["baselined"]) == load_baseline()
    stats = report["stats"]
    assert stats["passes"] == ["dispatch", "ast", "capture (no graphs on the CPU)"]
    assert set(stats["skipped"]) == {"host-sync", "kernel-budget"}
    assert set(stats["dispatch"]) == {e.name for e in REGISTRY}
    assert stats["ast"]["bodies"] >= 40 and stats["ast"]["kernel_sources"] == 7
    # the only findings on the tree are the baselined float64 blend of full_D
    assert {f["rule"] for f in report["findings"]} == {"float64-leak"}


def test_adaptive_rerun_builds_zero_loops_and_engines(cli_report):
    """Every rerun of the scenario (plain, device loop, metrics, record,
    sharded) builds nothing; each warm run builds each thing at most once."""
    cap = cli_report[1]["stats"]["capture"]
    for key in ("rerun", "device_rerun", "metrics_rerun", "metrics_device_rerun",
                "recorder_rerun", "recorder_device_rerun", "sharded_rerun"):
        assert cap[key] == {}, (key, cap[key])
    for key in ("warm", "metrics_warm", "recorder_warm"):
        assert cap[key]["engine.ConsolidationEngine"] == 1
        assert cap[key]["engine_torch._TraceLoop"] == 1
    assert cap["device_warm"]["AdaptiveEngine._closed_loops"] == 1


def test_analysis_imports_neither_jax_nor_repro():
    """In a fresh interpreter (this test process has jax loaded by conftest)."""
    code = ("import sys, repro_torch.analysis.__main__, repro_torch.analysis.capture, "
            "repro_torch.analysis.ast_rules, repro_torch.analysis.dispatch_audit, "
            "repro_torch.analysis.kernel_budget, repro_torch.analysis.registry; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'));"
            " print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_cli_raises_without_a_card(monkeypatch):
    from repro_torch.analysis.__main__ import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--no-capture"])
