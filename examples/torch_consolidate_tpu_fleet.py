"""The paper's algorithm at fleet scale on the PyTorch port: pack (arch x
shape) serving jobs onto pods, using resource vectors from the port's dry
run, first onto four TPU v5e pods and then onto four pods of 256 H100s.

    PYTHONPATH=src python examples/torch_consolidate_tpu_fleet.py [--artifacts DIR]

The twin of ``examples/consolidate_tpu_fleet.py`` on ``repro_torch.core``,
which imports nothing of JAX. It reads ``artifacts/dryrun_torch/`` (run
``python -m repro_torch.launch.dryrun --all`` to make it) and falls back
to the JAX example's synthetic job profiles where that holds none. The
packing runs on the host: no card is needed.
"""
import argparse
import dataclasses
import json
import pathlib

from repro_torch.core import FleetState, JobProfile, PodSpec, fleet_throughput_report, pack_jobs
from repro_torch.core.cluster import H100_SXM, h100_pod

ART = pathlib.Path(__file__).resolve().parents[1] / "artifacts" / "dryrun_torch"


def load_jobs(art: pathlib.Path) -> list[JobProfile]:
    """The decode and prefill cells of the single-pod mesh, as whole-job
    resource vectors (per-device counts times the devices)."""
    jobs = []
    if art.exists():
        for f in sorted(art.glob("*__decode_32k__single.json")) + sorted(
                art.glob("*__prefill_32k__single.json")):
            rec = json.loads(f.read_text())
            if "skip" in rec:
                continue
            jobs.append(JobProfile(
                name=rec["cell"], flops=rec["flops"] * rec["chips"],
                bytes_accessed=rec["bytes_accessed"] * rec["chips"],
                collective_bytes=rec["collective_bytes"] * rec["chips"],
                hbm_bytes=rec["peak_memory_per_device"], chips=rec["chips"],
            ))
    if not jobs:
        print("(no dry-run artifacts; using synthetic job profiles)")
        jobs = [JobProfile(name=f"svc{i}", flops=3e15 * (1 + i % 3),
                           bytes_accessed=4e14, collective_bytes=2e13,
                           hbm_bytes=(2 + i % 4) * 2**30, chips=256)
                for i in range(10)]
    return jobs


def report(jobs: list[JobProfile], pods: list[PodSpec]) -> list[int | None]:
    fleet = FleetState.empty(pods, model="additive")
    placements, fleet = pack_jobs(fleet, jobs)
    print(f"{len(jobs)} jobs -> {len(pods)} pods")
    for job, p in zip(jobs, placements):
        print(f"  {job.name[:48]:48s} -> {'pod %d' % p if p is not None else 'QUEUED (criteria)'}")
    print("\nper-pod report:")
    for row in fleet_throughput_report(fleet):
        print(f"  {row['pod']}: {row['job'][:40]:40s} degradation={row['degradation']:5.1%} "
              f"eff={row['eff_steps_per_s']:.2f} steps/s (solo {row['solo_steps_per_s']:.2f})")
    return placements


def main(argv=None) -> dict[str, list[int | None]]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--artifacts", default=str(ART), help="the dry run's artifact folder")
    args = ap.parse_args(argv)
    jobs = load_jobs(pathlib.Path(args.artifacts))
    tpu = report(jobs, [PodSpec(name=f"pod{i}") for i in range(4)])
    print("\n=== the same jobs on four pods of 256 H100 SXM cards ===")
    h100_jobs = [dataclasses.replace(j, chip=H100_SXM) for j in jobs]
    h100 = report(h100_jobs, [h100_pod(f"h100pod{i}") for i in range(4)])
    return {"tpu": tpu, "h100": h100}


if __name__ == "__main__":
    main()
