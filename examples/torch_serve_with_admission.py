"""Serving example on the PyTorch port: batched prefill+decode for a small
model, gated by the paper's consolidation admission (criteria of §V on the
serving hosts).

    PYTHONPATH=src python examples/torch_serve_with_admission.py [--device cuda|cpu]

The twin of ``examples/serve_with_admission.py`` on ``repro_torch.launch.serve``,
which imports nothing of JAX. Admission runs with the ``repro_torch.obs``
metrics plane on, so the serving entry prints a p50/p99 waiting-time and slowdown
table next to the placements -- the paper's utilization-floor criterion
reported as a live serving SLO -- then serves the SMOKE tinyllama (attention
through the hand-written CUDA flash kernel on the card, its plain version on
the CPU). It runs on the card unless ``--device cpu`` is given; without a
card it refuses to run.
"""
import argparse

from repro_torch.launch.serve import main as serve


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    return serve(["--arch", "tinyllama-1.1b", "--smoke", "--requests", "4", "--prompt-len", "32",
                  "--gen", "16", "--device", args.device])


if __name__ == "__main__":
    main()
