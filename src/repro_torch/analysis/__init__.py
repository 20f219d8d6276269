"""Device-purity audit of the port's hot path (counterpart of ``repro.analysis``).

The consolidation hot path promises no host read between a block's status
reads, no shape that depends on data, float32 on the device, kernels within
Hopper's budgets, and no rebuilt loop or recaptured graph once warm. Nothing
in the code keeps those promises by itself: a per-segment ``int(used)`` or a
boolean-mask index creeps back in behind a helper, a kernel edit spills, a
cache key starts churning. This package checks them, pass by pass, and
reports what breaks them as :class:`Finding` s held against a baseline.

The JAX package's three passes have no jaxpr or ``jit`` to work on here, so
each becomes what it means on PyTorch and CUDA:

  ``dispatch_audit``  runs one eager call of each registered hot entry
                      (``registry.REGISTRY``) under a ``TorchDispatchMode``
                      that records every aten operation: host reads
                      (``host-callback``), data-dependent output shapes
                      (``dynamic-shape``) and float64 outputs on a device
                      tier (``float64-leak``). On the card the same call runs
                      again under ``torch.cuda.set_sync_debug_mode("error")``
                      (``host-sync``), which catches synchronizing copies the
                      dispatcher does not see.
  ``kernel_budget``   the TPU's VMEM budget becomes the Hopper kernels'
                      registers, static shared memory and local memory, read
                      by ``cuobjdump --dump-resource-usage`` from each built
                      library (``kernel-budget``, ``kernel-spill``).
  ``ast_rules``       a lint of the registered bodies' source: host reads,
                      coercions, numpy and Python branches on tensors, stale
                      ring views, and kernel sources no registry entry
                      covers (``kernel-uncovered``).
  ``capture``         retracing becomes rebuilding: a guard counts event
                      loops built, CUDA graphs captured, dynamics tables and
                      engines built around a fixed multi-segment
                      ``AdaptiveEngine`` scenario, at most one per shape on a
                      warm run and none on a rerun.

``python -m repro_torch.analysis`` runs every pass and fails on any finding
not in the baseline (``baseline.json`` beside this file, each key with a
one-line reason; the JAX package's ``analysis-baseline.json`` is its own).
:func:`preflight` is the same gate for a benchmark: a number taken over an
impure hot path is not a measurement of the system the contracts describe.
It runs on the card unless ``device='cpu'`` is named; the card-only passes
(``host-sync``, the kernel resource pass and real graph captures) are then
skipped, and the report says which passes ran.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import time
from typing import Iterable, Sequence

import torch

from ..device import resolve_device

#: the port's checked-in baseline (not the JAX package's analysis-baseline.json)
BASELINE_PATH = pathlib.Path(__file__).resolve().parent / "baseline.json"


@dataclasses.dataclass(frozen=True)
class Finding:
    """One invariant violation, stable enough to baseline.

    ``key()`` identifies a finding across runs (pass + rule + location);
    ``detail`` is human context and deliberately excluded from the key so a
    reworded message does not un-baseline an old finding.
    """

    analysis: str  # which pass: 'dispatch' | 'sync' | 'ast' | 'kernel' | 'capture'
    rule: str  # machine-readable rule id, e.g. 'host-callback'
    where: str  # entry-point name, file:line, or kernel
    detail: str = ""

    def key(self) -> str:
        return f"{self.analysis}:{self.rule}:{self.where}"

    def render(self) -> str:
        msg = f"[{self.analysis}/{self.rule}] {self.where}"
        return f"{msg} -- {self.detail}" if self.detail else msg


def load_baseline_reasons(path: "pathlib.Path | str | None" = None) -> dict[str, str]:
    """Baselined finding keys with the reason each was accepted (empty
    when no file exists)."""
    p = pathlib.Path(path) if path is not None else BASELINE_PATH
    if not p.exists():
        return {}
    return dict(json.loads(p.read_text()).get("findings", {}))


def load_baseline(path: "pathlib.Path | str | None" = None) -> set[str]:
    """The set of baselined finding keys (empty when no file exists)."""
    return set(load_baseline_reasons(path))


def write_baseline(findings: Sequence[Finding], path: "pathlib.Path | str | None" = None) -> None:
    """Write the findings' keys as the baseline. A key already there keeps
    its reason; a new one gets its finding's detail, marked unreviewed."""
    p = pathlib.Path(path) if path is not None else BASELINE_PATH
    old = load_baseline_reasons(p)
    keys = {f.key(): f.detail for f in findings}
    out = {k: old.get(k) or f"unreviewed: {keys[k]}" for k in sorted(keys)}
    p.write_text(json.dumps({"findings": out}, indent=2) + "\n")


def new_findings(findings: Iterable[Finding], baseline: set[str]) -> list[Finding]:
    """Findings not explained by the baseline (the failure set)."""
    return [f for f in findings if f.key() not in baseline]


def run_all(device: "str | torch.device | None" = None,
            capture: bool = True) -> tuple[list[Finding], dict]:
    """Run every pass on ``device`` (None: the card, raising without one);
    returns (findings, stats), stats naming the passes that ran."""
    from . import ast_rules, dispatch_audit, kernel_budget
    from . import capture as capture_mod

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    findings: list[Finding] = []
    stats: dict = {"device": str(dev), "passes": [], "skipped": {}, "seconds": {}}

    def timed(name: str, run) -> None:
        start = time.perf_counter()
        findings.extend(run())
        stats["seconds"][name] = round(time.perf_counter() - start, 3)
        stats["passes"].append(name)

    timed("dispatch" + (" + host-sync" if on_card else ""),
          lambda: dispatch_audit.run_dispatch_audit(dev, stats=stats))
    timed("ast", lambda: ast_rules.run_ast_rules(stats=stats))
    if on_card:
        timed("kernel-budget", lambda: kernel_budget.run_kernel_budget(stats=stats))
    else:
        for name in ("host-sync", "kernel-budget"):
            stats["skipped"][name] = "card-only pass (--device cpu)"
    if capture:
        timed("capture" if on_card else "capture (no graphs on the CPU)",
              lambda: capture_mod.run_capture_audit(dev, stats=stats))
    else:
        stats["skipped"]["capture"] = "--no-capture"
    return findings, stats


def preflight(baseline: "pathlib.Path | str | None" = None,
              device: "str | torch.device | None" = None, capture: bool = True) -> None:
    """Refuse to proceed (SystemExit) on unbaselined findings.

    A benchmark calls this before measuring anything: a number taken over
    an impure hot path (a host read, a rebuilt loop, a spilling kernel) is
    not a measurement of the system the contracts describe.
    """
    findings, _ = run_all(device=device, capture=capture)
    fresh = new_findings(findings, load_baseline(baseline))
    if fresh:
        for f in fresh:
            print(f"analysis preflight: {f.render()}")
        raise SystemExit(
            f"analysis preflight: {len(fresh)} unbaselined finding(s); "
            "refusing to benchmark an impure hot path "
            "(run `python -m repro_torch.analysis` for the report)")
