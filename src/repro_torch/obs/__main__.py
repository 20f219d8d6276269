"""CLI: run reports, regret attribution, and the obs-plane selfcheck.

Copied from ``repro/obs/__main__.py`` onto the port's engines; every mode
runs on the card unless ``--device cpu`` asks for the CPU.

  python -m repro_torch.obs              render a run report from a small
                                   canned consolidation run (2 servers,
                                   metrics on)
  python -m repro_torch.obs --json       same, as a JSON snapshot
  python -m repro_torch.obs --explain    record a canned stationary adaptive run
                                   with the decision flight recorder, replay
                                   it against the true dynamics, and render
                                   the per-decision timeline + per-segment
                                   regret attribution + worst-decisions
                                   tables (``obs.explain``); exit 1 if the
                                   ring fails to reconstruct the run or the
                                   attribution does not sum to the regret
  python -m repro_torch.obs --selfcheck  verify the histogram/percentile math, the
                                   chunk-invariant merge, counter exactness
                                   against a host-visible engine result, the
                                   report render, decision-ring provenance
                                   (record=True leaves decisions bit-
                                   identical and the ring reconstructs every
                                   placement), and attribution exactness;
                                   exit 1 on any failure
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from . import metrics as M
from . import report


def _log_tol(spec: M.HistSpec) -> float:
    """Percentile agreement tolerance in log space: 1.5 bin widths (one bin
    of quantization plus interpolation slack at bin boundaries)."""
    return 1.5 * np.log(spec.bin_ratio())


def _check_percentiles(failures: "list[str]") -> None:
    rng = np.random.default_rng(0)
    for spec in M.HISTOGRAMS:
        # log-uniform samples strictly inside the spec's range
        lo, hi = spec.lo * spec.bin_ratio(), spec.hi / spec.bin_ratio()
        vals = np.exp(rng.uniform(np.log(lo), np.log(hi), size=4096))
        frame = M.observe(M.zeros(1), spec.name, vals.astype(np.float32))
        est = M.percentiles(frame, spec.name, (50.0, 95.0, 99.0))
        ref = np.percentile(vals, [50.0, 95.0, 99.0])
        err = np.abs(np.log(est) - np.log(ref))
        if not (err <= _log_tol(spec)).all():
            failures.append(
                f"percentiles[{spec.name}]: est {est} vs numpy {ref} "
                f"(log error {err}, tol {_log_tol(spec):.4f})")


def _check_merge(failures: "list[str]") -> None:
    rng = np.random.default_rng(1)
    spec = M.HISTOGRAMS[0]
    vals = np.exp(rng.uniform(np.log(spec.lo), np.log(spec.hi),
                              size=999)).astype(np.float32)
    whole = M.observe(M.zeros(2), spec.name, vals)
    whole = M.count(whole, "events", 999)
    parts = M.zeros(2)
    for chunk in np.array_split(vals, 7):
        part = M.observe(M.zeros(2), spec.name, chunk)
        part = M.count(part, "events", len(chunk))
        parts = M.merge(parts, part)
    if not (np.array_equal(np.asarray(whole.hist), np.asarray(parts.hist))
            and np.array_equal(np.asarray(whole.counters),
                               np.asarray(parts.counters))):
        failures.append("merge: split-and-merge frame != single-pass frame "
                        "(chunk invariance broken)")


def _backends(device) -> dict:
    """The scorer and scatter backends for ``device``: the CUDA kernels on
    the card, the plain PyTorch versions on the CPU."""
    on_card = str(device).startswith("cuda")
    return dict(scorer="cuda" if on_card else "torch",
                scatter="cuda" if on_card else "torch")


def _canned_arrivals():
    from ..core.workload import FS_GRID, RS_GRID, Workload, snap_to_grid

    arrivals = []
    for i in range(12):
        w = snap_to_grid(Workload(
            fs=FS_GRID[(5 * i) % len(FS_GRID)], rs=RS_GRID[i % len(RS_GRID)],
            data_total=48e6))
        arrivals.append((0.5 * i, w))
    return arrivals


def _canned_run(device):
    from ..core.engine import ConsolidationEngine
    from ..core.server import M1, M2

    engine = ConsolidationEngine([M1, M2], scorer=_backends(device)["scorer"],
                                 device=device)
    return engine.run(_canned_arrivals(), metrics=True)


def _check_engine_counters(failures: "list[str]", device) -> None:
    res = _canned_run(device)
    frame = res.metrics
    oracle = {
        "arrivals": len(res.placements),
        "placements": sum(1 for p in res.placements if p is not None),
        "queued": sum(1 for q in res.was_queued if q),
        "finishes": sum(1 for t in res.finish_times if np.isfinite(t)),
        "deadlocks": 0,
    }
    for name, want in oracle.items():
        got = M.counter_value(frame, name)
        if got != want:
            failures.append(f"counter[{name}]: frame says {got}, "
                            f"host result says {want}")
    per_server = M.server_values(frame, "placements")
    for s in range(2):
        want = sum(1 for p in res.placements if p == s)
        if int(per_server[s]) != want:
            failures.append(f"per_server placements[{s}]: frame says "
                            f"{int(per_server[s])}, host result says {want}")
    # every placement contributes exactly one waiting-time/headroom sample
    for hist in ("waiting_time", "headroom"):
        total = int(M.hist_counts(frame, hist).sum())
        if total != oracle["placements"]:
            failures.append(f"hist[{hist}]: {total} samples != "
                            f"{oracle['placements']} placements")
    try:
        text = report.render_report(res, title="selfcheck")
    except Exception as e:  # pragma: no cover - render must not throw
        failures.append(f"render_report raised {e!r}")
        return
    for needle in ("counters:", "percentiles:", "per-server:", "waiting_time"):
        if needle not in text:
            failures.append(f"render_report output missing {needle!r}")


#: gap between the canned stationary segments (each segment restarts from an
#: empty cluster, so this only keeps the trace clock readable)
_SEG_GAP = 60.0


def _canned_adaptive(device, segments: int = 3, per_seg: int = 10):
    """A stationary adaptive run with the flight recorder on: the same
    heavy LLC-resident workload mixture replayed per segment (the
    benchmarks/adaptive_regret.py recipe at small scale, near-simultaneous
    arrivals so co-run pressure is real), scheduler learning from a cold
    optimistic prior. Returns (engine, result, per-segment chunks in the
    trace order the recorded arrival ids index)."""
    from ..core.engine import AdaptiveEngine
    from ..core.server import M1, M2
    from ..core.workload import FS_GRID, RS_GRID, Workload, snap_to_grid

    rng = np.random.default_rng(3)
    seg, t = [], 0.0
    for _ in range(per_seg):
        fs = float(rng.choice(FS_GRID[10:15]))
        w = snap_to_grid(Workload(fs=fs, rs=float(rng.choice(RS_GRID[5:8])),
                                  data_total=fs * 8))
        t += float(rng.exponential(2e-5))
        seg.append((t, w))
    arrivals = [(t + k * _SEG_GAP, w) for k in range(segments)
                for t, w in seg]
    eng = AdaptiveEngine([M1, M2], prior=0.0, decay=0.997, device=device,
                         **_backends(device))
    res = eng.run(arrivals, segments=segments, record=True)
    ordered = sorted(arrivals, key=lambda tw: tw[0])
    bounds = np.linspace(0, len(ordered), segments + 1).astype(int)
    chunks = [ordered[bounds[k]:bounds[k + 1]] for k in range(segments)]
    return eng, res, chunks


def _attribute(eng, res, chunks):
    """Run obs.explain over a recorded adaptive run; returns
    (attributions, reconstruction failures)."""
    from ..core.contention import profile_pairwise_fast
    from . import explain

    cache = {}
    for s in eng.servers:
        if s not in cache:
            cache[s] = profile_pairwise_fast(s)
    true_D = [cache[s] for s in eng.servers]
    atts = explain.attribute_run(
        res.decisions, chunks, lambda k: eng.servers, lambda k: true_D,
        alpha=eng.alpha, objective=eng.objective, durations=res.durations)
    recon = explain.check_reconstruction(
        res.decisions, [r.placements for r in res.segments])
    return atts, recon


def _check_recorder(failures: "list[str]", device) -> None:
    """record=True must not change one decision, and the ring must be a
    faithful record: one commit row per placement, queue rows for queued
    arrivals, nothing else."""
    from ..core.engine import ConsolidationEngine
    from ..core.server import M1, M2
    from . import explain
    from .recorder import DecisionRing

    arrivals = _canned_arrivals()
    engine = ConsolidationEngine([M1, M2], scorer=_backends(device)["scorer"],
                                 device=device)
    base = engine.run(arrivals)
    rec = engine.run(arrivals, record=True)
    if list(base.placements) != list(rec.placements):
        failures.append("recorder: record=True changed placements "
                        f"({base.placements} vs {rec.placements})")
    if list(base.was_queued) != list(rec.was_queued):
        failures.append("recorder: record=True changed queueing behaviour")
    if rec.decisions is None:
        failures.append("recorder: record=True returned no decision ring")
        return
    ring = DecisionRing(rec.decisions.capacity, device)
    ring.adopt(rec.decisions)
    for f in explain.check_reconstruction(ring, [rec.placements]):
        failures.append(f"recorder: {f}")
    queued_rows = {int(a) for a, kind in zip(ring.columns()["arrival"],
                                             ring.columns()["kind"])
                   if int(kind) == 2}
    want_queued = {a for a, q in enumerate(rec.was_queued) if q}
    if queued_rows != want_queued:
        failures.append(f"recorder: queue rows {sorted(queued_rows)} != "
                        f"queued arrivals {sorted(want_queued)}")


def _check_attribution(failures: "list[str]", device) -> None:
    """The telescoping-replay gate: per-decision deltas sum to each
    segment's regret within 1e-5 and the ring reconstructs the run."""
    from . import explain

    eng, res, chunks = _canned_adaptive(device, segments=2, per_seg=8)
    atts, recon = _attribute(eng, res, chunks)
    if len(atts) != 2:
        failures.append(
            f"attribution: expected 2 attributed segments, got {len(atts)}")
    failures.extend(f"attribution: {f}" for f in explain.check_exactness(atts))
    failures.extend(f"attribution: {f}" for f in recon)


def selfcheck(device="cuda") -> int:
    from ..device import resolve_device

    device = resolve_device(device)
    failures: list[str] = []
    for name, check in (("percentiles-vs-numpy", _check_percentiles),
                        ("merge-chunk-invariance", _check_merge),
                        ("engine-counter-exactness", _check_engine_counters),
                        ("recorder-ring-provenance", _check_recorder),
                        ("attribution-exactness", _check_attribution)):
        before = len(failures)
        if check in (_check_percentiles, _check_merge):
            check(failures)
        else:
            check(failures, device)
        status = "ok" if len(failures) == before else "FAIL"
        print(f"obs selfcheck: {name:<28} {status}")
    for f in failures:
        print(f"  FAIL: {f}", file=sys.stderr)
    return 1 if failures else 0


def main(argv: "list[str] | None" = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="metrics-plane run reports and selfcheck")
    parser.add_argument("--selfcheck", action="store_true",
                        help="verify histogram/merge/counter/recorder/"
                             "attribution invariants")
    parser.add_argument("--explain", action="store_true",
                        help="record a canned stationary adaptive run and "
                             "render its regret attribution")
    parser.add_argument("--json", action="store_true",
                        help="print the metric snapshot as JSON")
    parser.add_argument("--device", default="cuda",
                        help="where the engines run (default: the card)")
    args = parser.parse_args(argv)
    if args.selfcheck:
        return selfcheck(args.device)
    if args.explain:
        return explain_main(json_out=args.json, device=args.device)
    from ..device import resolve_device

    res = _canned_run(resolve_device(args.device))
    if args.json:
        print(json.dumps(M.snapshot(res.metrics), indent=2))
    else:
        print(report.render_report(res, title="canned consolidation run"))
    return 0


def explain_main(json_out: bool = False, device="cuda") -> int:
    """``--explain``: the flight-recorder post-mortem, end to end."""
    from ..device import resolve_device
    from . import explain

    eng, res, chunks = _canned_adaptive(resolve_device(device))
    atts, recon = _attribute(eng, res, chunks)
    exact = explain.check_exactness(atts)
    if json_out:
        print(json.dumps({
            "segments": [{
                "segment": a.segment,
                "duration_oracle": a.duration_oracle,
                "duration_forced": a.duration_forced,
                "regret": a.regret,
                "replay_gap": a.replay_gap,
                "by_bucket": a.by_bucket,
                "decisions": [vars(d) for d in a.decisions],
            } for a in atts],
            "reconstruction_failures": recon,
            "exactness_failures": exact,
        }, indent=2))
    else:
        n_dec = sum(len(a.decisions) for a in atts)
        print("== decision flight recorder: regret attribution "
              "(canned stationary adaptive run) ==\n")
        print(f"segments: {len(atts)}   recorded decisions: "
              f"{len(res.decisions)}   attributed: {n_dec}\n")
        print("per-decision timeline:")
        print(explain.render_timeline(atts))
        print("\nper-segment attribution (deltas telescope to the regret):")
        print(explain.render_attribution(atts))
        print("\nworst 10 decisions (by attributed regret):")
        print(report.worst_decisions_table(atts))
        status = "ok" if not recon else "FAIL"
        print(f"\nring reconstructs every placement of the run: {status}")
    for f in recon + exact:
        print(f"  FAIL: {f}", file=sys.stderr)
    return 1 if (recon or exact) else 0


if __name__ == "__main__":
    sys.exit(main())
