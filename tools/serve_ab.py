"""Serving times of source trees side by side on one card.

    python3 tools/serve_ab.py [--runs R] TREE [TREE ...]

Serves ``jamba-v0.1-52b`` as ``chip_smoke.py``'s phase 13 does (its
published widths cut to 16 layers, bf16 weights drawn on the card from seed
0, 8 requests of 512 prompt tokens, 32 generated) from each TREE's ``src``
in turn, each in a process of its own: a TREE is a checkout of the repo,
such as a parent commit unpacked with ``git archive`` beside this one. Each
process serves once to warm up, then R times (default 3), and prints the
prefill ms and the mean decode ms per step of each run, then the device
kernels per decode step that torch.profiler sees over 8 decode steps, then
the wall of one synchronized call of the model's first MoE layer at the
decode's input ([8, 1, D], one group) and at the prefill's ([8, 512, D],
a group per request), median of 200 calls, and the device kernels of one
call. Name the trees in an order such as A B B A, so that a drift of the
card over the call falls on both. Needs one CUDA card; imports nothing of
JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import statistics
import subprocess
import sys
import time


def child(tree: pathlib.Path, runs: int) -> dict:
    """Serve from ``tree``'s package and return its numbers."""
    sys.path.insert(0, str(tree / "src"))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    cfg = dataclasses.replace(get_config("jamba-v0.1-52b"), n_layers=16,
                              param_dtype=torch.bfloat16)
    model, lm, prompts, *extras = serve.prepare(cfg, requests=8, prompt_len=512, seed=0,
                                                device=torch.device("cuda"))
    serve.generate(model, lm, prompts, 2)  # warm-up: the builds, cuBLAS, the allocator
    prefill, decode = [], []
    for _ in range(runs):
        run = serve.generate(model, lm, prompts, 32)
        prefill.append(1e3 * run.prefill_s)
        decode.append(1e3 * statistics.mean(run.decode_s))
    cache = model.init_cache(8, 512 + 32, device=prompts.device)
    _, cache = model.prefill(lm, {"tokens": prompts}, cache)
    tok = run.tokens
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(8):
            _, cache = model.decode_step(lm, cache, tok[:, i:i + 1])
        torch.cuda.synchronize()
    kernels = sum(e.device_type == torch.autograd.DeviceType.CUDA for e in prof.events())
    out = {"tree": str(tree), "prefill_ms": prefill, "decode_ms_per_step": decode,
           "kernels_per_decode_step": kernels / 8}
    moe = next(m for m in lm.modules() if type(m).__name__ == "MoE")
    gen = torch.Generator(prompts.device).manual_seed(1)
    for name, shape, group in (("decode", (8, 1), "batch"), ("prefill", (8, 512), "seq")):
        x = torch.randn(*shape, cfg.d_model, generator=gen, device=prompts.device)
        x = x.to(cfg.compute_dtype)
        for _ in range(20):
            moe(x, group=group)
        walls = []
        for _ in range(200):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            moe(x, group=group)
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            moe(x, group=group)
            torch.cuda.synchronize()
        out[f"moe_{name}_ms"] = statistics.median(walls)
        out[f"moe_{name}_kernels"] = sum(e.device_type == torch.autograd.DeviceType.CUDA
                                         for e in prof.events())
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", type=pathlib.Path)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--child", type=pathlib.Path, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        print(json.dumps(child(args.child.resolve(), args.runs)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available() or not args.trees:
        print("serve_ab: needs a CUDA card and at least one tree", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(smi.strip().splitlines()[0] if smi.strip() else "nvidia-smi: no reading")
    for tree in args.trees:
        out = subprocess.run([sys.executable, __file__, "--child", str(tree), "--runs",
                              str(args.runs)], capture_output=True, text=True)
        if out.returncode:
            print(out.stdout, out.stderr, file=sys.stderr)
            return out.returncode
        r = json.loads(out.stdout.strip().splitlines()[-1])
        print(f"{r['tree']}: prefill ms {[round(x, 3) for x in r['prefill_ms']]}, decode ms per "
              f"step {[round(x, 3) for x in r['decode_ms_per_step']]} (median "
              f"{statistics.median(r['decode_ms_per_step']):.3f}), device kernels per decode "
              f"step {r['kernels_per_decode_step']:.1f}; one MoE layer: decode "
              f"{r['moe_decode_ms']:.4f} ms in {r['moe_decode_kernels']} kernels, prefill "
              f"{r['moe_prefill_ms']:.4f} ms in {r['moe_prefill_kernels']} kernels", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
