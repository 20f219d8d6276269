"""``python -m repro_torch.analysis``: run every pass, emit the report.

    python -m repro_torch.analysis [--baseline PATH] [--write-baseline]
                                   [--no-capture] [--json] [--device cuda|cpu]

Exit status is the JAX package's contract: 0 when every finding is
explained by the baseline, 1 otherwise. ``--write-baseline`` writes the
current findings into the baseline file (a key already there keeps its
reason; a new one is marked unreviewed) and exits 0; ``--no-capture`` skips
the capture guard, the one pass that runs whole adaptive runs. The audit
runs on the card unless ``--device cpu`` is given, and raises without one;
on the CPU the card-only passes (``host-sync``, the kernel resource pass,
real graph captures) are skipped and the report says so.
"""
from __future__ import annotations

import argparse
import json
import sys

from . import BASELINE_PATH, load_baseline, new_findings, run_all, write_baseline


def main(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="device-purity audit of the port: dispatch, host-sync, kernel budget, "
                    "AST and capture passes")
    ap.add_argument("--baseline", default=None, metavar="PATH",
                    help=f"baseline JSON (default: {BASELINE_PATH.name} in the package)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="write the current findings as the new baseline and exit 0")
    ap.add_argument("--no-capture", action="store_true",
                    help="skip the capture guard pass")
    ap.add_argument("--json", action="store_true",
                    help="emit the full machine-readable report on stdout")
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="where the entries run (default: the card)")
    args = ap.parse_args(argv)

    findings, stats = run_all(device=args.device, capture=not args.no_capture)
    baseline = load_baseline(args.baseline)
    fresh = new_findings(findings, baseline)

    report = {
        "findings": [vars(f) for f in findings],
        "new": [f.key() for f in fresh],
        "baselined": sorted(baseline),
        "stats": stats,
    }
    if args.json:
        print(json.dumps(report, indent=2, default=str))
    else:
        for f in findings:
            mark = "NEW " if f in fresh else "base"
            print(f"[{mark}] {f.render()}")
        ast_stats = stats.get("ast", {})
        print(f"audited {len(stats.get('dispatch', {}))} hot entries on {stats['device']}, "
              f"{ast_stats.get('bodies', 0)} bodies, {ast_stats.get('kernel_sources', 0)} "
              f"kernel sources: {len(findings)} finding(s), {len(fresh)} new; passes: "
              f"{', '.join(stats['passes'])}"
              + "".join(f"; skipped {k} ({v})" for k, v in stats["skipped"].items()))

    if args.write_baseline:
        write_baseline(findings, args.baseline)
        print(f"baseline written ({len(findings)} finding(s))")
        return 0
    return 1 if fresh else 0


if __name__ == "__main__":
    sys.exit(main())
