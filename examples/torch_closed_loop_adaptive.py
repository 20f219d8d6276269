"""Closed-loop consolidation without a profiling pass, on the PyTorch port.

    PYTHONPATH=src python examples/torch_closed_loop_adaptive.py [--device cuda|cpu]
        [--segments 10] [--drift-at 5]

The twin of ``examples/closed_loop_adaptive.py`` on ``repro_torch``, which
imports nothing of JAX. The paper's scheduler needs a 52 900-pair offline
profiling run before it can place anything. This example starts from *zero
interference knowledge* (the optimistic uniform prior), lets the
``AdaptiveEngine`` place arrival segments from its current estimate, and
watches the streaming estimator recover the D-matrix from completion
telemetry alone -- then congests a server mid-run
(``telemetry.drift.congestion_at``) and watches the loop notice and recover.

The simulator remains the ground truth throughout: the engine's placements
are scored against *estimated* dynamics, the outcomes it observes come from
the *true* (possibly drifted) server specs. Engines, estimators and their
pair-statistic scatter run on the card unless ``--device cpu`` is given
(then the scatter is its plain PyTorch version); without a card the script
refuses to run.
"""
import argparse

import numpy as np

from repro_torch.core import (
    M1,
    M2,
    AdaptiveEngine,
    ConsolidationEngine,
    Workload,
    profile_pairwise_fast,
    snap_to_grid,
)
from repro_torch.core.workload import FS_GRID, RS_GRID
from repro_torch.device import resolve_device
from repro_torch.telemetry import congestion_at

SEGMENTS, DRIFT_AT, SEG_GAP = 10, 5, 10.0


def stationary_segment(seed=3, n=32, gap=2e-5, passes=8):
    rng = np.random.default_rng(seed)
    out, t = [], 0.0
    for _ in range(n):
        fs = float(rng.choice(FS_GRID[10:15]))
        w = snap_to_grid(
            Workload(fs=fs, rs=float(rng.choice(RS_GRID[5:8])), data_total=fs * passes))
        t += float(rng.exponential(gap))
        out.append((t, w))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--segments", type=int, default=SEGMENTS)
    ap.add_argument("--drift-at", type=int, default=DRIFT_AT)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    segments, drift_at = args.segments, args.drift_at

    servers = [M1, M2]
    seg = stationary_segment()
    arrivals = [(t + k * SEG_GAP, w) for k in range(segments) for t, w in seg]
    drift = congestion_at(servers, drift_at, server=0, factor=0.4)

    # decay is per observation-unit; each server's estimator sees ~16 of a
    # segment's 32 completions, so 0.9935^16 ~ 0.9 of old evidence kept per
    # segment -- fast enough forgetting to re-converge after the drift
    scatter = "cuda" if device.type == "cuda" else "torch"
    adaptive = AdaptiveEngine(servers, prior=0.0, drift=drift, decay=0.9935, scatter=scatter,
                              device=device)

    # the oracle re-profiles instantly at every drift (what telemetry replaces)
    mk_oracle = {}

    def oracle_duration(k):
        specs = drift.specs_at(servers, k)
        if specs not in mk_oracle:
            oracle = ConsolidationEngine(
                list(specs), D=[profile_pairwise_fast(s) for s in specs], device=device)
            mk_oracle[specs] = oracle.run(seg, backend="torch").makespan - seg[0][0]
        return mk_oracle[specs]

    print(f"{segments} segments x {len(seg)} arrivals on [M1, M2]; "
          f"server 0's shared bandwidth congests to 40% at segment {drift_at} "
          f"(on {device})\n")
    print("seg  phase        adaptive   oracle    regret   observations")

    def report(k, res, eng):
        dur = res.makespan - (seg[0][0] + k * SEG_GAP)
        mk = oracle_duration(k)
        phase = ("drift!" if k == drift_at
                 else "post-drift" if k > drift_at else "stationary")
        n_obs = sum(e.n_obs for e in eng.estimators)
        print(f"{k:3d}  {phase:<11s}  {dur:8.4f}  {mk:7.4f}  "
              f"{(dur / mk - 1) * 100:+6.1f}%   {n_obs}")

    result = adaptive.run(arrivals, segments=segments, on_segment=report)

    est = adaptive.estimators[0]
    truth = profile_pairwise_fast(drift.specs_at(servers, segments - 1)[0])
    mask = est.observed_mask().cpu().numpy()
    err = np.abs(est.estimate_D().cpu().numpy() - truth)[mask]
    print(f"\nserver-0 estimator: {est.n_obs} observations, "
          f"{mask.sum()} confident pairs, |D_hat - D_true| mean "
          f"{err.mean():.4f} / max {err.max():.4f} (post-drift truth)")
    return result


if __name__ == "__main__":
    main()
