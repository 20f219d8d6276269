"""How often does torch.profiler's trace lose kernel records?

    python3 tools/profiler_loss.py [WINDOWS]

Serves ``jamba-v0.1-52b`` as ``chip_smoke.py``'s phase 13 does (16 layers,
bf16 weights drawn on the card from its seed, 8 requests of 512 prompt
tokens) and profiles its prefill WINDOWS times (default 40) through
``chip_smoke.device_busy``, the profiler window the smoke's shares come
from. Prints, per window, the device kernels the trace saw and its
``mamba_scan_kernel`` launches against the wrapper's count, then how many
windows lost a counted launch and the spread of the kernel totals (every
window launches the same kernels, so a total below the largest is a window
whose trace lost records). Needs one CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import collections
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profiler_loss: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.kernels import mamba_scan as km
    from repro_torch.launch import serve

    windows = int(sys.argv[1]) if len(sys.argv) > 1 else 40
    model, lm, prompts, _ = serve.prepare(cs.jamba_served(), requests=8, prompt_len=512,
                                          seed=cs.SEED, device=torch.device("cuda"))
    serve.generate(model, lm, prompts, 2)  # warm-up: the builds, cuBLAS, the allocator
    rows = []
    for i in range(windows):
        km.reset_launches()
        _, named, _, n = cs.device_busy(lambda: serve.generate(model, lm, prompts, 1),
                                        ("mamba_scan_kernel",))
        rows.append((n, named["mamba_scan_kernel"][1], sum(km.LAUNCHES.values())))
        print(f"window {i}: {n} device kernels, mamba_scan_kernel {rows[-1][1]} seen of "
              f"{rows[-1][2]} counted", flush=True)
    top = max(n for n, _, _ in rows)
    print(f"{windows} windows: {sum(seen != want for _, seen, want in rows)} lost a counted "
          f"mamba_scan launch, {sum(n < top for n, _, _ in rows)} saw fewer than {top} "
          f"kernels; totals {dict(collections.Counter(n for n, _, _ in rows))}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
