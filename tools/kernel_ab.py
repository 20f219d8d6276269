"""Time two checkouts' kernels on one card, in turns:

    python3 tools/kernel_ab.py PARENT_ROOT [CHANGE_ROOT]

CHANGE_ROOT defaults to this checkout. Runs parent, change, change, parent,
each in a process of its own (the two checkouts' packages share a name).
Each run times, through the wrappers' default calls (which both checkouts
have), ``consolidation_scores`` at m = 64, Q = 1, 8, 1024 and m = 1024,
Q = 1, 8, 4096, and ``flash_attention`` in bf16 at the serving rows of
``chip_smoke.FLASH_SHAPES`` (tinyllama-1.1b and jamba-v0.1-52b, prefill and
decode@511). The timer (``device_ms``), the inputs (``kernel_inputs``,
``candidate_types``) and the shapes are this checkout's ``chip_smoke.py``
ones, so both sides are timed as its phases 3, 5 and 8 time them. Prints
each run's device ms, then per shape the mean of each side and change /
parent. Needs one CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parents[1]
#: (m, Q) of the scorer; the labels of chip_smoke.FLASH_SHAPES timed in bf16
SCORES = [(64, 1), (64, 8), (64, 1024), (1024, 1), (1024, 8), (1024, 4096)]
FLASH = ("prefill", "decode@511", "jamba prefill", "jamba decode@511")


def measure(root: pathlib.Path) -> dict:
    """Device ms of each shape by the kernels of the checkout at ``root``."""
    sys.path[:0] = [str(root / "src"), str(HERE)]
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.core import kernel_args
    from repro_torch.kernels import consolidation as kc
    from repro_torch.kernels import flash_attention as kf

    dev = torch.device("cuda")
    out = {}
    for m, Q in SCORES:
        rng = np.random.default_rng(cs.SEED)
        cl, counts = cs.kernel_inputs(m, dev, rng)
        args = kernel_args(cl, counts, cs.candidate_types(counts, Q, rng))
        out[f"scores m={m} Q={Q}"] = cs.device_ms(lambda: kc.consolidation_scores(*args))
    gen = torch.Generator(dev).manual_seed(cs.SEED + 3)
    for label, B, Sq, Skv, H, Hkv, dh, causal, off, win in cs.FLASH_SHAPES:
        if label not in FLASH:
            continue
        q = torch.randn(B, Sq, H, dh, generator=gen, device=dev).bfloat16()
        k, v = (torch.randn(B, Skv, Hkv, dh, generator=gen, device=dev).bfloat16()
                for _ in range(2))
        kw = dict(causal=causal, q_offset=off, window=win)
        out[f"flash {label}"] = cs.device_ms(lambda: kf.flash_attention(q, k, v, **kw))
    return out


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--measure":
        print(json.dumps({"root": sys.argv[2], "ms": measure(pathlib.Path(sys.argv[2]))}))
        return 0
    if len(sys.argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 2
    parent = pathlib.Path(sys.argv[1]).resolve()
    change = (pathlib.Path(sys.argv[2]) if len(sys.argv) == 3 else HERE).resolve()
    runs = []
    for side, root in (("parent", parent), ("change", change), ("change", change),
                       ("parent", parent)):
        proc = subprocess.run([sys.executable, __file__, "--measure", str(root)],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode:
            print(proc.stdout, proc.stderr, file=sys.stderr)
            return proc.returncode
        ms = json.loads(proc.stdout.strip().splitlines()[-1])["ms"]
        runs.append((side, ms))
        print(f"[ab] {side} {root}: " + "; ".join(f"{k} {v:.5f}" for k, v in ms.items()),
              flush=True)
    for label in runs[0][1]:
        p = statistics.mean(ms[label] for side, ms in runs if side == "parent")
        c = statistics.mean(ms[label] for side, ms in runs if side == "change")
        print(f"[ab] {label}: parent {p:.5f} ms, change {c:.5f} ms, change/parent {c / p:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
