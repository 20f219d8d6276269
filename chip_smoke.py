"""Smoke run of the PyTorch/CUDA port on one GPU: ``python3 chip_smoke.py``.

Drives the port's main paths on the card -- the online consolidation
engine (``repro_torch.core.ConsolidationEngine``) with the hand-written CUDA
candidate scorer, the adaptive loop (``repro_torch.core.AdaptiveEngine``)
whose streaming D-estimators take their pair statistics from the
hand-written CUDA scatter, and the serving driver
(``repro_torch.launch.serve``) with a dense LM, which attends through the
hand-written CUDA flash attention, with RWKV6, whose WKV recurrence runs
through the hand-written CUDA scan, and with the Jamba hybrid, whose Mamba
layers run their selective scan through the hand-written CUDA
``mamba_scan`` and whose attention layers take a sliding window in the
flash kernel -- in thirteen phases:

  1. environment: torch and CUDA versions, the card's name and power limit;
  2. build: nvcc builds every kernel under ``src/repro_torch/kernels/csrc``;
  3. kernel vs plain version: ``consolidation_scores`` by both of its paths
     (the single pass and the table path, whose outputs must be bitwise
     equal) against ``consolidation_scores_torch`` on the same inputs (64
     servers, Q = 1, 8, 16, 32, 64, 128, 512, 1024, 4096, on either side of
     the crossover; max abs error <= 1e-5 on both outputs), with median
     device times of each path;
  4. main path, rack scale: 64 servers, 1024 arrivals through the engine;
     the kernel route must place exactly as the plain-version route, the
     criterion-1 queue and a full queue rescan must occur, and a small trace
     must place exactly as the port does on the CPU;
  5. main path, fleet scale: 1024 servers, 4096 arrivals: the kernel by both
     paths against its plain version at this width, at Q = 1, 8 and the
     rescans' Q = 4096 (<= 1e-5, the paths bitwise equal),
     then the engine with the kernel route, which must place exactly as the
     plain-version route on the same trace;
  6. pair_scatter vs plain version: ``pair_scatter`` against
     ``pair_scatter_torch`` at B = 0, 1, 7, 300, 4096, T = 32, 230 and
     K = 1 (1-D), 1, 2, 3 (atol 2e-5, rtol 1e-5), and against the float64
     reference at one shape, with device times beside the ``index_add_``
     scatter-add form at B = 4096, T = 230, K = 2;
  7. adaptive loop, rack scale, ``scorer='cuda'`` and ``scatter='cuda'``:
     64 servers, 8 segments of 256 arrivals from the uniform prior 0.0, a
     congestion drift at segment 4; then 3 segments of 512 arrivals from
     the profiled prior, a drift at segment 1, where every segment must
     queue and rescan its whole queue. In both, every estimator update is
     replayed on shadow estimators with the plain scatter, whose tables
     must agree after every segment (so every launch is held to the plain
     version at the shape it ran), and the launches must be exactly the
     updates that had a co-run. Segment 0 of the first must place as the
     plain engine on the prior D, and a small adaptive run on the card,
     which queues, must equal the same run on the CPU;
  8. flash_attention vs plain version: ``flash_attention`` against
     ``flash_attention_torch`` in bf16 (atol/rtol 2e-2) and f32 (2e-5) at
     the serving prefill (B 8, Sq 512, Skv 672, H 32, Hkv 4, dh 64), decode
     at q_offset 0, 511 and 542 of the 672-row cache, a ragged Sq = 17, a
     non-causal shape, the llama3.2 width (H 24, Hkv 8, dh 128), dh 16
     and 32, jamba's width (H 32, Hkv 8, dh 128) with sliding windows of
     64 and 256 at the prefill and 64 at decode@511, and f32 q on a bf16
     cache at dh 64, 128, 16 and 32 and under a window; every bf16 call
     must run a tensor-core entry (the split one at decode, whose outputs
     must be bitwise equal on a rerun) and every f32-q call the CUDA-core
     one; device times of the kernel, the plain version and
     ``scaled_dot_product_attention`` (the library call, never used by the
     port), beside the bound;
  9. serving, ``tinyllama-1.1b`` at full width with weights drawn on the
     card: admission of 8 streams on two H100 hosts through the CUDA
     scorer, then 8 requests of 512 prompt tokens and 32 greedy tokens by
     the kernel route, which must launch flash_attention 22 x 32 times, all
     on the tensor-core entries; a
     teacher-forced replay on the plain route must give the same logits
     (within 2e-2 of their scale) and argmax wherever the top-2 gap is
     wider; prefill ms, decode ms per step, tokens/s, peak memory and the
     kernel's share of device time under ``torch.profiler``; at the JAX
     package's init scale (near one-hot softmaxes), the prefill's logits by
     the kernel, plain and float64-attention routes, and every layer's
     kernel attention held to the plain version on the same inputs; a SMOKE
     run at float32 compute must give the same tokens on the card as on
     the CPU;
 10. rwkv6_scan vs plain version: ``rwkv6_scan`` against
     ``rwkv6_scan_torch`` (atol 5e-4, rtol 1e-3 on y and the final state)
     at the serving prefill (B 8, S 512, H 64, dh 64, bf16 r/k/v), decode
     (S 1) from a nonzero state, ragged S = 17 and 33, the SMOKE head size
     dh 16 and float32 r/k/v, both against the float64 recurrence at
     S = 33; device times of the kernel and the plain version beside the
     bound (no library call computes WKV6);
 11. serving, ``rwkv6-7b`` at full width with weights drawn on the card
     and the decay's ``w_base`` / ``w_lora_b`` perturbed (at the init they
     make the decay uniform): admission of 8 streams on two H100 hosts,
     then 8 requests of 512 prompt tokens and 32 greedy tokens by the kernel
     route, which must launch rwkv6_scan 32 x 32 times; a shadow rerun
     holds every one of those launches to the plain version on its own
     inputs; the teacher-forced plain-route replay is measured beside a
     witness with the WKV in float64 (this random model amplifies last-bit
     differences, so no limit holds there); at float32 compute, decode
     steps from one state must agree across the routes (1e-4 of the
     logits' scale); prefill ms, decode ms per step, tokens/s, peak memory
     and the kernel's share of device time; a SMOKE run at float32 compute
     with the same tokens on the card as on the CPU;
 12. mamba_scan vs plain versions: the model entry (delta, u, strided B
     and C, A) against ``mamba_selective_scan_torch`` (the JAX model's
     chunked scan) and the contract entry (da, dbu [B, S, E, N]) against
     ``mamba_scan_torch`` (the sequential loop), atol and rtol 1e-4, at the
     served prefill (B 8, S 512, E 8192, N 16, bf16 u/B/C), decode (S 1)
     from a nonzero state, a ragged S = 33 and E = 96 (both against the
     float64 recurrence), the SMOKE state N = 4 and float32 u/B/C at N = 8;
     device times of the kernel and the plain versions beside the bound (no
     library call computes the selective scan);
 13. serving, ``jamba-v0.1-52b`` at its published widths cut to 16 of 32
     layers with bf16 weights (52.1 GB, drawn on the card): admission of 8
     streams on two H100 hosts, then 8 requests of 512 prompt tokens and 32
     greedy tokens by the kernel route, which must launch mamba_scan 14 x 32
     and flash_attention 2 x 32 times (on the tensor-core entries); a
     shadow rerun holds every one of
     those launches to its plain version on its own inputs; the
     teacher-forced plain-route replay is measured beside a witness with
     attention and the scan in float64 on three prompt seeds (MoE routing
     flips on last-bit differences, so no limit holds there), in which
     each kernel, launch by launch, must lie no further from float64 than
     twice its plain version (flash: outputs over one bf16 ulp; the scan:
     largest error); at float32 compute on a
     one-period cut (8 layers, 53.2 GB), decode steps from one state must
     agree across the routes (1e-4 of the logits' scale); prefill ms,
     decode ms per step, tokens/s, peak memory, device kernels per decode
     step and both kernels' shares of device time; a SMOKE run at float32
     compute with an 80-token prompt (past SMOKE's window of 64) with the
     same tokens on the card as on the CPU.

Then a JSON line with each kernel's numbers, the ``nvidia-smi`` name/power
line, and a last JSON line ``{"ok": true, "device": {...}}``. Any failed
check raises, so the script exits nonzero; without a CUDA device, or
without the repository beside it, it exits nonzero before printing a result.
Imports nothing of JAX and nothing of the JAX package ``repro``.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SEED = 0
#: published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, fp32 non-tensor,
#: dense bf16 tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12
TOL = 1e-5
#: pair_scatter vs its plain version: f32 sums of B products in a different
#: order (tests/test_kernels.py's bound for the Pallas kernel)
SCATTER_ATOL, SCATTER_RTOL = 2e-5, 1e-5
#: flash_attention vs its plain version (tests/test_kernels.py's bounds for
#: the Pallas kernel): a bf16 output rounds once, f32 sums run in another order
FLASH_TOL = {"bfloat16": 2e-2, "float32": 2e-5}


class CheckFailed(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def trace(n: int, gap: float, *, passes: int = 8, seed: int = 3, heavy: bool = True):
    """Seeded arrival trace [(time, workload)]: heavy workloads arriving with
    exponential gaps, each moving ``passes`` times its file size."""
    import numpy as np
    from repro_torch.core import FS_GRID, RS_GRID, Workload, snap_to_grid

    rng = np.random.default_rng(seed)
    fs_pool = FS_GRID[12:18] if heavy else FS_GRID[:18]
    rs_pool = RS_GRID[5:] if heavy else RS_GRID
    out, t = [], 0.0
    for _ in range(n):
        fs = float(rng.choice(fs_pool))
        w = snap_to_grid(
            Workload(fs=fs, rs=float(rng.choice(rs_pool)), data_total=fs * passes))
        t += float(rng.exponential(gap))
        out.append((t, w))
    return out


def rack(m: int):
    from repro_torch.core import M1, M2
    return [M1, M2] * (m // 2)


def plain_scorer(cluster, counts, wtypes):
    """The kernel's plain PyTorch version behind the shared scorer interface."""
    from repro_torch.core import kernel_args
    from repro_torch.kernels.consolidation import consolidation_scores_torch
    return consolidation_scores_torch(*kernel_args(cluster, counts, wtypes))


def kernel_inputs(m: int, device, rng):
    """Scorer inputs at the main path's widths: D profiled for the rack, sparse
    seeded counts with server 0 empty."""
    import numpy as np
    import torch
    from repro_torch.core import PackedCluster, profile_pairwise_fast

    servers = rack(m)
    D = {s: profile_pairwise_fast(s) for s in set(servers)}
    cl = PackedCluster.build(servers, [D[s] for s in servers], device=device)
    T = cl.T
    counts = rng.integers(1, 4, size=(m, T)) * (rng.random((m, T)) < 0.04)
    counts[0] = 0
    return cl, torch.tensor(counts, dtype=torch.float32, device=device)


def candidate_types(counts, Q: int, rng):
    """Q candidate types, half drawn from types present somewhere, half from
    types present nowhere, or from all types where every type is present on
    some server (as at fleet width; each is still absent from most)."""
    import numpy as np
    import torch

    present = np.flatnonzero(counts.cpu().numpy().sum(0) > 0)
    absent = np.setdiff1d(np.arange(counts.shape[1]), present)
    if absent.size == 0:
        absent = np.arange(counts.shape[1])
    half = Q // 2
    w = np.concatenate([rng.choice(absent, Q - half), rng.choice(present, half)])
    return torch.tensor(rng.permutation(w), dtype=torch.int32, device=counts.device)


def bound_ms(counts, wtypes) -> tuple[float, str]:
    """Least time for one call: every input byte the function needs read once
    (per server, the D rows of the types present there or scored there;
    counts, fs_resident, rs, budget, wtypes) and both outputs written once,
    over HBM bandwidth; against the least fp32 work over the fp32 peak: col0
    and comp0 per server, 5 T operations per (distinct candidate type,
    server) -- both outputs depend on a candidate only through its type --
    and one gathered value per output."""
    import numpy as np

    c = counts.cpu().numpy()
    m, T = c.shape
    Q = int(wtypes.shape[0])
    cand = np.zeros(T, bool)
    cand[wtypes.cpu().numpy()] = True
    rows = int(((c > 0) | cand[None, :]).sum())  # distinct D rows needed
    nnz = int((c > 0).sum())
    nbytes = 4 * (rows * T + 2 * m * T + T + m + Q + 2 * Q * m)
    flops = 2 * nnz * T + 2 * m * T + 5 * int(cand.sum()) * m * T + 2 * Q * m
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def call_ms(fn, reps: int = 20) -> float:
    """Median time of one call as the engine pays it: CUDA events around each
    call, so the host's launch work shows when it exceeds the device's."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps: int = 20) -> float:
    """Device time of one call: ``reps`` calls captured in a CUDA graph and
    replayed back to back (median of 5 replays, over ``reps``)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    times = []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def phase_env():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    print(f"[1 env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} | {smi_line}")
    return smi_line


def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    logs = _build.build()
    dt = time.perf_counter() - t0
    ptxas = [ln.strip() for log in logs.values() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"[2 build] {len(logs)}/{len(_build.sources())} sources built in {dt:.2f} s; "
          + " | ".join(ptxas))


#: the scorer's device kernels as torch.profiler names them: the single
#: pass, and the table path's two passes
SCORE_KERNELS = ("score_kernel", "score_table_kernel", "score_gather_kernel")


def score_counts() -> dict:
    """Launches of each of SCORE_KERNELS, from the wrapper's counts."""
    from repro_torch.kernels import consolidation as kc

    single = sum(n for (path, _), n in kc.LAUNCHES.items() if path == "single")
    table = sum(kc.LAUNCHES.values()) - single
    return {"score_kernel": single, "score_table_kernel": table, "score_gather_kernel": table}


def kernel_error(args, label: str) -> float:
    """Max abs error of the kernel against its plain version on ``args``,
    over both outputs, by both paths, whose outputs must be bitwise equal;
    fails above TOL or on a non-finite score."""
    import torch
    from repro_torch.kernels import consolidation as kc

    want = kc.consolidation_scores_torch(*args)
    single, table = (kc.consolidation_scores(*args, path=p) for p in kc.PATHS)
    check(all(torch.equal(a, b) for a, b in zip(single, table)),
          f"{label}: the single pass and the table path differ")
    err = max(float((g - w).abs().max()) for g, w in zip(single, want))
    check(all(bool(torch.isfinite(g).all()) for g in single), f"{label}: non-finite scores")
    check(err <= TOL, f"{label}: kernel vs plain max abs err {err:.3g} > {TOL}")
    return err


def score_row(args, counts, label: str, plain: str | None = "device") -> dict:
    """The kernel against its plain version on ``args`` (both paths, bitwise
    equal), and device ms of the wrapper's own path, of each path and of the
    plain version (``plain``: "device", "call" -- per call only, where a CUDA
    graph of its temporaries would not fit -- or None), per call with the
    host launch in brackets, beside the bound."""
    from repro_torch.kernels import consolidation as kc

    Q = int(args[-1].shape[0])
    row = dict(max_abs_err=kernel_error(args, label), path=kc.choose_path(Q))
    for p in kc.PATHS:
        fn = lambda p=p: kc.consolidation_scores(*args, path=p)  # noqa: E731
        row[f"{p}_ms"], row[f"{p}_call_ms"] = device_ms(fn), call_ms(fn)
    row["ms"], row["call_ms"] = row[f"{row['path']}_ms"], row[f"{row['path']}_call_ms"]
    fn = lambda: kc.consolidation_scores_torch(*args)  # noqa: E731
    if plain == "device":
        row["plain_ms"] = device_ms(fn, reps=5)
    if plain:
        row["plain_call_ms"] = call_ms(fn, reps=5)
    row["bound_ms"], row["bound_by"] = bound_ms(counts, args[-1])
    return row


def describe_scores(Q: int, r: dict) -> str:
    plain = (f" plain {r['plain_ms']:.5f} ({r['plain_call_ms']:.4f})" if "plain_ms" in r
             else f" plain ({r['plain_call_ms']:.4f})" if "plain_call_ms" in r else "")
    return (f"Q={Q} err={r['max_abs_err']:.3g} path {r['path']}: single {r['single_ms']:.5f} "
            f"({r['single_call_ms']:.4f}) table {r['table_ms']:.5f} ({r['table_call_ms']:.4f})"
            f"{plain} bound {r['bound_ms']:.5f} by {r['bound_by']}")


def phase_kernel(device) -> dict:
    import numpy as np
    from repro_torch.core import kernel_args
    from repro_torch.kernels import consolidation as kc

    rng = np.random.default_rng(SEED)
    cl, counts = kernel_inputs(64, device, rng)
    rows = {}
    # 512: the adaptive queue run's full rescans; the crossover lies among
    # 16..128; 4096: the fleet's Q at rack width
    qs = sorted({1, 8, 16, kc.CROSSOVER_Q, 2 * kc.CROSSOVER_Q, 128, 512, 1024, 4096})
    for Q in qs:
        args = kernel_args(cl, counts, candidate_types(counts, Q, rng))
        rows[Q] = score_row(args, counts, f"m=64 Q={Q}")
    print(f"[3 kernel] consolidation_scores vs plain, m=64 T=230, both paths bitwise equal, "
          f"crossover Q={kc.CROSSOVER_Q}; device ms (per call with host launch): "
          + "; ".join(describe_scores(Q, r) for Q, r in rows.items()))
    return rows


def drive(engine, arrivals, device):
    """One timed run of the main path: (result, wall seconds, launches by (path, Q),
    peak device bytes). The launch counts are zeroed just before the run."""
    import gc

    import torch
    from repro_torch.kernels import consolidation as kc

    if device.type == "cuda":
        gc.collect()  # free earlier phases' graphs before the peak is reset
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    kc.reset_launches()
    t0 = time.perf_counter()
    res = engine.run(arrivals)
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(sorted(kc.LAUNCHES.items()))
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    return res, wall, launches, peak


def describe(res, wall, launches, peak) -> str:
    s, n = res.stats, len(res.placements)
    return (f"wall {wall:.3f} s, {s.events} micro-events, {s.host_syncs} host syncs, "
            f"{s.drain_full_scans} full rescans, {1e6 * wall / n:.1f} us/decision, "
            f"queued {sum(res.was_queued)}/{n}, makespan {res.makespan:.6f} s, "
            f"kernel launches by (path, Q) {launches}, peak device memory {peak / 2**20:.1f} MiB")


def count_syncs(fn) -> int:
    """Synchronizing CUDA calls made by ``fn`` (the trace's copy to the card,
    the loop's reads, the result copies), as torch's sync debug mode reports
    them."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def device_busy(fn, names=SCORE_KERNELS) -> tuple[float, dict, float, int]:
    """What torch.profiler saw of ``fn`` on the device: (seconds of all
    device kernels, {name: (seconds, launches)} of the kernels whose name
    contains each of ``names``, wall seconds of the profiled call, number of
    device kernels). Kernel times are self device times on one stream, so
    they do not overlap; the wall includes the profiler's overhead."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # one synchronized launch first: launches right after the tracer
        # starts can go unrecorded
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    seconds = lambda evs: 1e-6 * sum(e.self_device_time_total for e in evs)  # noqa: E731
    named = {}
    for name in names:
        hits = [e for e in kernels if name in e.name]
        named[name] = (seconds(hits), len(hits))
    return seconds(kernels), named, wall, len(kernels)


def kernel_shares(busy: float, named: dict, wall: float, counted: dict, label: str) -> str:
    """The profiled shares as text; fails unless the trace saw each kernel
    exactly as often as its wrapper counted launches."""
    if busy <= 0:
        return "the profiler saw no device time: busy share not measured"
    parts = [f"device busy {100 * busy / wall:.2f} % of the wall"]
    for name, (sec, n) in named.items():
        check(n == counted[name], f"{label}: the profiler saw {n} {name} launches, "
              f"the wrapper counted {counted[name]}")
        if n == 0:
            continue
        parts.append(f"{name} {sec:.4f} s in {n} launches = {100 * sec / wall:.2f} % of the "
                     f"wall, {100 * sec / busy:.2f} % of device kernel time")
    return "; ".join(parts)


def first_divergence(a, b):
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)


def check_same_route(res, other, label: str) -> float:
    """Fails unless ``other`` placed and queued exactly as ``res``, with its
    makespan within TOL relative; returns the relative makespan difference."""
    rel = abs(other.makespan - res.makespan) / other.makespan
    check(other.placements == res.placements,
          f"{label}: kernel and plain routes diverge at arrival "
          f"{first_divergence(other.placements, res.placements)}")
    check(other.was_queued == res.was_queued, f"{label}: queue decisions differ from plain")
    check(rel <= TOL, f"{label}: makespan differs from plain by {rel:.3g} relative")
    return rel


def check_outputs(res, n: int, label: str) -> None:
    check(len(res.placements) == n, f"{label}: {len(res.placements)} placements for {n}")
    check(all(p is not None for p in res.placements), f"{label}: an arrival never ran")
    check(all(t < float("inf") for t in res.finish_times), f"{label}: unfinished work")
    check(res.makespan > 0.0, f"{label}: empty makespan")


def phase_rack(device, m: int = 64, n: int = 1024, small=(16, 64)) -> int:
    """Drives the rack-scale main path; returns its kernel launch count."""
    from repro_torch.core import ConsolidationEngine
    from repro_torch.kernels import consolidation as kc

    servers = rack(m)
    arrivals = trace(n, gap=1e-4)
    eng = ConsolidationEngine(servers, scorer="cuda", device=device)
    eng.run(trace(64, gap=1e-4, seed=1))  # warm-up: library load, allocator, cuBLAS

    res, wall, launches, peak = drive(eng, arrivals, device)
    print(f"[4 rack] m={m} n={n} scorer=cuda: " + describe(res, wall, launches, peak))
    check_outputs(res, n, "rack cuda")
    check(sum(res.was_queued) > 0, "rack: the criterion-1 queue was never used")
    check(res.stats.drain_full_scans > 0, "rack: no drain rescanned the whole queue")
    n_launch = sum(launches.values())

    plain = ConsolidationEngine(servers, D=eng.D, scorer=plain_scorer, device=device)
    pres, pwall, _, _ = drive(plain, arrivals, device)
    rel = check_same_route(res, pres, "rack")

    if device.type == "cuda":
        # the first 256 arrivals only: parsing the trace of the whole run
        # takes minutes of host time
        kc.reset_launches()
        busy, named, pwall_prof, _ = device_busy(lambda: eng.run(arrivals[:256]), SCORE_KERNELS)
        share = kernel_shares(busy, named, pwall_prof, score_counts(), "rack")
        print(f"[4 rack] profiled rerun of the first 256 arrivals: device kernels {busy:.4f} s "
              f"of {pwall_prof:.3f} s wall; {share}")

    fast = ConsolidationEngine(servers, D=eng.D, scorer="torch", device=device)
    tres, twall, _, _ = drive(fast, arrivals, device)
    match = tres.placements == res.placements
    print(f"[4 rack] plain route: identical placements and queue decisions, makespan "
          f"rel diff {rel:.3g}, wall {pwall:.3f} s | scorer=torch: placements_match="
          f"{match} first divergence "
          f"{first_divergence(tres.placements, res.placements)}, wall {twall:.3f} s")

    # a small trace on the CPU, as a reference the card's run must reproduce
    ms, ns = small
    small_arr = trace(ns, gap=2e-5)
    ref = ConsolidationEngine(rack(ms), scorer="cuda", device="cpu").run(small_arr)
    small_eng = ConsolidationEngine(rack(ms), scorer="cuda", device=device)
    got = small_eng.run(small_arr)
    flagged = (count_syncs(lambda: small_eng.run(small_arr))
               if device.type == "cuda" else "not measured")
    check(got.placements == ref.placements and got.was_queued == ref.was_queued,
          "small trace: card and CPU runs place differently")
    check(abs(got.makespan - ref.makespan) <= 1e-3 * ref.makespan,
          "small trace: card and CPU makespans differ")
    print(f"[4 rack] small trace m={ms} n={ns}: card run == CPU run "
          f"(queued {sum(got.was_queued)}, makespan {got.makespan:.6f} s); "
          f"synchronizing calls flagged by torch's sync debug mode in a rerun: "
          f"{flagged}, of which loop reads {got.stats.host_syncs}")
    return n_launch


def phase_fleet(device, m: int = 1024, n: int = 4096) -> dict:
    """The kernel by both paths against its plain version at fleet width, at
    Q = 1, 8 and the full rescans' Q = n, then the fleet-scale main path by
    the kernel route and by the plain-version route on the same trace.
    Returns the kernel checks' numbers by Q."""
    import numpy as np
    from repro_torch.core import ConsolidationEngine, kernel_args

    rng = np.random.default_rng(SEED + 1)
    cl, counts = kernel_inputs(m, device, rng)
    rows = {}
    for Q in (1, 8, n):  # the rescans' Q = n, and the engine's small Q at this width
        args = kernel_args(cl, counts, candidate_types(counts, Q, rng))
        rows[Q] = score_row(args, counts, f"m={m} Q={Q}", plain="call" if Q == n else None)
    del cl, counts, args
    print(f"[5 fleet] consolidation_scores vs plain, m={m} T=230, both paths bitwise equal; "
          f"device ms (per call with host launch): "
          + "; ".join(describe_scores(Q, r) for Q, r in rows.items()))

    servers = rack(m)
    arrivals = trace(n, gap=1e-4 * 64 / m)
    eng = ConsolidationEngine(servers, scorer="cuda", device=device)
    eng.run(trace(64, gap=1e-4 * 64 / m, seed=1))  # warm-up at this width
    res, wall, launches, peak = drive(eng, arrivals, device)
    check_outputs(res, n, "fleet")
    check(res.stats.drain_full_scans > 0, "fleet: no drain rescanned the whole queue")
    print(f"[5 fleet] m={m} n={n} scorer=cuda: " + describe(res, wall, launches, peak))

    plain = ConsolidationEngine(servers, D=eng.D, scorer=plain_scorer, device=device)
    pres, pwall, _, ppeak = drive(plain, arrivals, device)
    rel = check_same_route(res, pres, "fleet")
    print(f"[5 fleet] plain route: identical placements and queue decisions, makespan "
          f"rel diff {rel:.3g}, wall {pwall:.3f} s, peak device memory "
          f"{ppeak / 2**20:.1f} MiB")
    return rows


def scatter_inputs(B: int, T: int, K: int | None, device, rng):
    """Seeded scatter inputs: types drawn from [-1, T + 2), so padding and
    past-the-table rows are there to be dropped; K=None gives 1-D vals."""
    import numpy as np
    import torch

    types = rng.integers(-1, T + 2, size=B).astype(np.int32)
    cbar = (rng.random((B, T)) * 2).astype(np.float32)
    vals = rng.normal(size=B if K is None else (K, B)).astype(np.float32)
    return tuple(torch.from_numpy(x).to(device) for x in (types, cbar, vals))


def close_err(got, want, label: str) -> float:
    """Max abs difference over the output pairs; fails past
    SCATTER_ATOL + SCATTER_RTOL * |want|, on a shape mismatch or a
    non-finite value."""
    import torch

    err = 0.0
    for g, w in zip(got, want):
        check(tuple(g.shape) == tuple(w.shape), f"{label}: shape {tuple(g.shape)} "
              f"!= {tuple(w.shape)}")
        check(bool(torch.isfinite(g).all()), f"{label}: non-finite output")
        diff = (g.double() - w.double()).abs()
        ok = bool((diff <= SCATTER_ATOL + SCATTER_RTOL * w.double().abs()).all())
        err = max(err, float(diff.max()) if diff.numel() else 0.0)
        check(ok, f"{label}: kernel vs reference max abs err {err:.3g}")
    return err


def index_add_form(types, cbar, vals):
    """pair [K, T, T] by the scatter-add the JAX package lowers to on a GPU
    (``repro/telemetry/estimator.py:292-300``): the contributions
    ``cbar[b] * vals[k, b]`` index-added into target-major rows, with a dump
    row for dropped types. Timed as the library call; the port never calls
    it."""
    import torch

    K, T = vals.shape[0], cbar.shape[1]
    tt = torch.where((types >= 0) & (types < T), types, T).long()
    acc = torch.zeros((K, T + 1, T), dtype=torch.float32, device=cbar.device)
    acc.index_add_(1, tt, cbar[None] * vals[:, :, None])
    return acc[:, :T].transpose(1, 2)


def scatter_bound_ms(types, T: int, K: int) -> tuple[float, str]:
    """Least time for one call on these inputs: the rows whose type is in
    range (their cbar rows and K values) and all types read once, both
    outputs written once, over HBM bandwidth; against 2 K T fp32 operations
    per row in range over the fp32 peak."""
    B = int(types.shape[0])
    rows = int(((types >= 0) & (types < T)).sum())
    nbytes = 4 * (rows * T + B + K * rows + K * T * T + K * T)
    flops = 2 * K * rows * T
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def phase_pair_scatter(device) -> dict:
    """``pair_scatter`` against its plain version at every listed shape and
    against the float64 reference at one; times at B=4096, T=230, K=2."""
    import numpy as np
    import torch
    from repro_torch.kernels import telemetry as kt
    from repro_torch.kernels.ref import pair_scatter_ref

    rng = np.random.default_rng(SEED + 2)
    errs = []
    for T in (32, 230):
        for B in (0, 1, 7, 300, 4096):
            for K in (None, 1, 2, 3):
                args = scatter_inputs(B, T, K, device, rng)
                errs.append(close_err(kt.pair_scatter(*args), kt.pair_scatter_torch(*args),
                                      f"pair_scatter B={B} T={T} K={K or '1-D'}"))
    args = scatter_inputs(300, 230, 2, device, rng)
    ref = [torch.from_numpy(x).to(device)
           for x in pair_scatter_ref(*(a.cpu().numpy() for a in args))]
    err_ref = close_err(kt.pair_scatter(*args), ref, "pair_scatter vs float64 reference")

    B, T, K = 4096, 230, 2
    args = scatter_inputs(B, T, K, device, rng)
    lib_err = close_err([index_add_form(*args)], [kt.pair_scatter(*args)[0]],
                        "index_add_ form vs kernel")
    row = dict(max_abs_err=max(errs), ref_err=err_ref, lib_err=lib_err, B=B, T=T, K=K)
    row["bound_ms"], row["bound_by"] = scatter_bound_ms(args[0].cpu(), T, K)
    if device.type == "cuda":
        row.update(ms=device_ms(lambda: kt.pair_scatter(*args)),
                   plain_ms=device_ms(lambda: kt.pair_scatter_torch(*args)),
                   library_ms=device_ms(lambda: index_add_form(*args)),
                   call_ms=call_ms(lambda: kt.pair_scatter(*args)))
        times = (f"device ms kernel {row['ms']:.5f} (per call {row['call_ms']:.4f}), plain "
                 f"{row['plain_ms']:.5f}, index_add_ form {row['library_ms']:.5f}")
    else:
        times = "times not measured off the card"
    print(f"[6 pair_scatter] vs plain at {len(errs)} shapes (B 0..4096, T 32/230, K 1-D/1/2/3): "
          f"max abs err {row['max_abs_err']:.3g}; vs float64 ref (B=300 T=230 K=2) "
          f"{err_ref:.3g}; at B={B} T={T} K={K}: {times}, bound {row['bound_ms']:.5f} ms "
          f"by {row['bound_by']}; index_add_ form vs kernel max abs err {lib_err:.3g}")
    return row


def estimator_gap(est, snap) -> float:
    """Max abs difference of an estimator's L, log_b and n_pair from a
    snapshot of another's."""
    return max(float((a - b).abs().max()) for a, b in zip((est.L, est.log_b, est.n_pair), snap))


def adaptive_run(servers, arrivals, segments: int, drift, prior, device, label: str):
    """One timed adaptive run at rack width with ``scorer='cuda'`` and
    ``scatter='cuda'``, the launch counts zeroed just before it and read just
    after. Every estimator update is replayed on shadow estimators with the
    plain scatter, whose tables must agree after every segment, and the
    scatter launches must be exactly the updates that had a co-run.
    Returns (result, wall, per-segment walls, scatter launches by shape,
    scorer launches by (path, Q), peak, shadow gap)."""
    import gc

    import numpy as np
    import torch
    from repro_torch.core import AdaptiveEngine
    from repro_torch.kernels import consolidation as kc
    from repro_torch.kernels import telemetry as kt

    on_card = device.type == "cuda"
    eng = AdaptiveEngine(servers, drift=drift, scorer="cuda", scatter="cuda", device=device,
                         prior=prior, decay=0.997)
    snaps, seg_wall = [], []

    def on_segment(k, res, engine):
        seg_wall.append(time.perf_counter())
        snaps.append([(e.L.clone(), e.log_b.clone(), e.n_pair.clone())
                      for e in engine.estimators])

    if on_card:
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    kc.reset_launches()
    kt.reset_launches()
    t0 = time.perf_counter()
    res = eng.run(arrivals, segments=segments, on_segment=on_segment)
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    scatter_launches = collections.Counter(kt.LAUNCHES)
    score_launches = dict(sorted(kc.LAUNCHES.items()))
    peak = torch.cuda.max_memory_allocated() if on_card else 0

    n = len(arrivals)
    check(len(res.segments) == segments, f"{label}: a segment is missing")
    for r in res.segments:
        check_outputs(r, n // segments, f"{label} segment")
    check(res.total_obs >= n // 2, f"{label}: only {res.total_obs} of {n} observations used")
    check(score_launches, f"{label}: never launched consolidation_scores")
    check(scatter_launches, f"{label}: never launched pair_scatter")

    # shadow estimators with the plain scatter, fed the same per-server logs
    shadow = [dataclasses.replace(e, scatter="torch") for e in eng.estimators]
    expected: collections.Counter = collections.Counter()
    worst = 0.0
    for k, seg in enumerate(res.segments):
        for s, est in enumerate(shadow):
            log = seg.observations.for_server(s)
            kept = log.co_counts[log.lost_frac <= est.max_lost_frac]
            n_co = int((kept.sum(dim=1) > est.solo_eps).sum())
            if n_co:
                expected[(n_co, kept.shape[1], 2)] += 1
            est.update(log)
            worst = max(worst, estimator_gap(est, snaps[k][s]))
        check(worst <= TOL, f"{label}: kernel and plain estimators differ by {worst:.3g} "
              f"after segment {k}")
    check(scatter_launches == expected,
          f"{label}: {sum(scatter_launches.values())} pair_scatter launches, "
          f"{sum(expected.values())} per-server updates with a co-run")
    walls = np.diff([t0] + seg_wall)
    return res, wall, walls, scatter_launches, score_launches, peak, worst


def describe_adaptive(label, res, wall, walls, scatter_launches, score_launches, peak,
                      worst) -> str:
    sizes = sorted(b for b, _, _ in scatter_launches)
    return (f"[7 adaptive] {label}: wall {wall:.3f} s, {res.total_obs} observations; per "
            f"segment wall s {[round(float(w), 3) for w in walls]}, simulated durations s "
            f"{[round(d, 6) for d in res.durations]}, micro-events "
            f"{[r.stats.events for r in res.segments]}, queued "
            f"{[sum(r.was_queued) for r in res.segments]}, full rescans "
            f"{[r.stats.drain_full_scans for r in res.segments]}\n"
            f"[7 adaptive] {label}: launches pair_scatter {sum(scatter_launches.values())} "
            f"(= per-server updates with a co-run; B {sizes[0]}..{sizes[-1]}, "
            f"{len(scatter_launches)} shapes), consolidation_scores by (path, Q) {score_launches}; "
            f"shadow estimators (plain scatter) within {worst:.3g} after every segment; peak "
            f"device memory {peak / 2**20:.1f} MiB")


def phase_adaptive(device, m: int = 64, segments: int = 8, per_segment: int = 256,
                   queue=(3, 512), small=(2, 3, 16)) -> dict:
    """Drives the adaptive loop (the second main path) at rack width twice:
    from the uniform prior 0.0 under a congestion drift, and from the
    profiled prior at twice the arrivals per segment, where the criterion-1
    queue fills and drains rescan it. Every scatter launch is held to the
    plain version through shadow estimators. Returns launch counts."""
    import numpy as np
    from repro_torch.core import AdaptiveEngine, ConsolidationEngine
    from repro_torch.kernels import consolidation as kc
    from repro_torch.kernels import telemetry as kt
    from repro_torch.telemetry import congestion_at

    on_card = device.type == "cuda"
    kw = dict(prior=0.0, decay=0.997)

    # a small run on the card against the same run on the CPU (plain scatter)
    ms, ks, ns = small
    small_arr = trace(ks * ns, gap=2e-4, seed=5)
    cpu = AdaptiveEngine(rack(ms), scatter="torch", device="cpu", **kw)
    card = AdaptiveEngine(rack(ms), device=device, **kw)
    want, got = cpu.run(small_arr, segments=ks), card.run(small_arr, segments=ks)
    for k in range(ks):
        check(got.segments[k].placements == want.segments[k].placements
              and got.segments[k].was_queued == want.segments[k].was_queued,
              f"small adaptive run: card and CPU place differently in segment {k}")
    gap = max(estimator_gap(c, (e.L.to(device), e.log_b.to(device), e.n_pair.to(device)))
              for c, e in zip(card.estimators, cpu.estimators))
    check(gap <= TOL, f"small adaptive run: card and CPU estimates differ by {gap:.3g}")
    check(got.n_obs == want.n_obs and got.total_obs > 0, "small adaptive run: observations differ")
    queued = sum(sum(r.was_queued) for r in got.segments)
    check(queued > 0, "small adaptive run: the criterion-1 queue was never used")
    print(f"[7 adaptive] small run m={ms} {ks}x{ns}: card run == CPU run (placements, "
          f"{queued} queue decisions, {got.total_obs} observations; estimator tables within "
          f"{gap:.3g})")

    # prior 0.0 under drift: at 4 arrivals per server per segment the learned
    # D never predicts a 50 % degradation, so this run does not queue
    servers = rack(m)
    n = segments * per_segment
    arrivals = trace(n, gap=1e-4)
    drift = congestion_at(servers, segments // 2, server=0, factor=0.4)
    label = f"m={m} {segments}x{per_segment} prior 0.0 drift at {segments // 2}"
    out = adaptive_run(servers, arrivals, segments, drift, 0.0, device, label)
    res, scatter_launches, score_launches = out[0], out[3], out[4]
    print(describe_adaptive(label, *out))

    # segment 0 places as the plain engine on the prior D (uniform 0)
    base = ConsolidationEngine(servers, D=np.zeros((230, 230)), scorer="cuda", device=device)
    b0 = base.run(arrivals[:per_segment])
    check(b0.placements == res.segments[0].placements
          and b0.was_queued == res.segments[0].was_queued,
          "adaptive: segment 0 places differently from the plain engine on the prior D")
    print("[7 adaptive] segment 0 == plain engine on the prior D")

    # the profiled prior at 8 arrivals per server per segment: the
    # criterion-1 queue fills, so drains score at Q = 8 and rescan the whole
    # queue on estimated D with telemetry on; congestion from segment 1
    kq, nq = queue
    q_arrivals = trace(kq * nq, gap=1e-4, seed=7)
    q_drift = congestion_at(servers, 1, server=0, factor=0.4)
    q_label = f"m={m} {kq}x{nq} profiled prior drift at 1"
    q_out = adaptive_run(servers, q_arrivals, kq, q_drift, "profiled", device, q_label)
    q_res, q_scatter, q_score = q_out[0], q_out[3], q_out[4]
    q_queued = [sum(r.was_queued) for r in q_res.segments]
    check(all(q > 0 for q in q_queued), f"{q_label}: a segment never queued ({q_queued})")
    check(all(r.stats.drain_full_scans > 0 for r in q_res.segments),
          f"{q_label}: a segment's drains never rescanned the whole queue")
    check(any(q == 8 for _, q in q_score), f"{q_label}: no drain scored at Q = 8")
    print(describe_adaptive(q_label, *q_out))

    if on_card:
        # one segment of a fresh run under the profiler: the device's share
        prof = AdaptiveEngine(servers, drift=drift, scorer="cuda", scatter="cuda",
                              device=device, **kw)
        kc.reset_launches()
        kt.reset_launches()
        busy, named, pwall, _ = device_busy(
            lambda: prof.run(arrivals[:per_segment], segments=1),
            ("pair_scatter_kernel", *SCORE_KERNELS))
        share = kernel_shares(busy, named, pwall, {
            "pair_scatter_kernel": sum(kt.LAUNCHES.values()), **score_counts()}, "adaptive")
        print(f"[7 adaptive] profiled rerun of segment 0: device kernels {busy:.4f} s of "
              f"{pwall:.3f} s wall; {share}")

    return dict(scatter=sum(scatter_launches.values()) + sum(q_scatter.values()),
                score=sum(score_launches.values()) + sum(q_score.values()))

#: (label, B, Sq, Skv, H, Hkv, dh, causal, q_offset, window): the serving
#: paths' shapes (tinyllama-1.1b and jamba-v0.1-52b, 8 requests, prompt
#: 512, 32 tokens, a 672-row padded cache), sliding windows narrower than
#: the rows a query sees (jamba's 32,768 never bites at 672 rows), the
#: edges the paths do not reach, and the head dims of the other instances
FLASH_SHAPES = [
    ("prefill", 8, 512, 672, 32, 4, 64, True, 0, 0),
    ("decode@0", 8, 1, 672, 32, 4, 64, True, 0, 0),
    ("decode@511", 8, 1, 672, 32, 4, 64, True, 511, 0),
    ("decode@542", 8, 1, 672, 32, 4, 64, True, 542, 0),
    ("ragged Sq=17", 8, 17, 672, 32, 4, 64, True, 0, 0),
    ("non-causal", 2, 128, 300, 32, 4, 64, False, 0, 0),
    ("llama3.2 prefill", 8, 512, 672, 24, 8, 128, True, 0, 0),
    ("llama3.2 decode@542", 8, 1, 672, 24, 8, 128, True, 542, 0),
    ("SMOKE width dh=16", 2, 33, 70, 4, 2, 16, True, 20, 0),
    ("dh=32", 2, 33, 70, 4, 2, 32, True, 20, 0),
    ("jamba prefill", 8, 512, 672, 32, 8, 128, True, 0, 32768),
    ("jamba decode@511", 8, 1, 672, 32, 8, 128, True, 511, 32768),
    ("window 64 prefill", 8, 512, 672, 32, 8, 128, True, 0, 64),
    ("window 256 prefill", 8, 512, 672, 32, 8, 128, True, 0, 256),
    ("window 64 decode@511", 8, 1, 672, 32, 8, 128, True, 511, 64),
]


def flash_bound_ms(B, Sq, Skv, H, Hkv, dh, causal, q_offset, q_size, kv_size,
                   window: int = 0) -> tuple[float, str]:
    """Least time for one call on these inputs: q and out, and the k/v rows
    some query sees, moved once over HBM bandwidth; against 4 dh flops per
    (query, head, visible kv row) over the dense peak of q's dtype (bf16
    tensor cores, or fp32 without TF32)."""
    from repro_torch.kernels.flash_attention import first_visible_row, visible_rows

    rows = visible_rows(Sq, Skv, causal, q_offset) - first_visible_row(q_offset, window)

    def seen_by(i: int) -> int:
        hi = min(Skv, q_offset + i + 1) if causal else Skv
        return hi - (max(0, q_offset + i - window + 1) if window else 0)

    seen = sum(seen_by(i) for i in range(Sq))
    nbytes = 2 * B * Sq * H * dh * q_size + 2 * B * rows * Hkv * dh * kv_size
    flops = 4 * B * H * dh * seen
    peak = BF16_FLOPS if q_size == 2 else FP32_FLOPS
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def sdpa_form(q, k, v, causal: bool, q_offset: int, window: int = 0):
    """The same function by ``scaled_dot_product_attention`` on [B, H, S, dh]
    views (GQA through ``enable_gqa``), with an explicit boolean mask where
    the causal diagonal is offset or a window bites. Timed as the library
    call; the port never calls it."""
    import torch
    import torch.nn.functional as F

    Sq, Skv = q.shape[1], k.shape[1]
    mask = None
    q_pos = (q_offset + torch.arange(Sq, device=q.device))[:, None]
    kv_pos = torch.arange(Skv, device=q.device)[None, :]
    if causal and (q_offset or window):
        mask = q_pos >= kv_pos
    if window:
        mask = (kv_pos > q_pos - window) if mask is None else mask & (kv_pos > q_pos - window)
    out = F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask,
        is_causal=causal and mask is None, enable_gqa=True)
    return out.transpose(1, 2)


def phase_flash(device) -> dict:
    """``flash_attention`` against ``flash_attention_torch`` at every
    FLASH_SHAPES shape in bf16 and f32 (and f32 q on a bf16 cache at dh 64,
    128 and 32), windows included, with device times of the kernel, the
    plain version and SDPA, and the bound. Returns the rows by (label,
    dtype)."""
    import torch
    from repro_torch.kernels import flash_attention as kf

    gen = torch.Generator(device).manual_seed(SEED + 3)
    cases = [(shape, dt, dt) for shape in FLASH_SHAPES for dt in ("bfloat16", "float32")]
    # f32 q on a bf16 cache (a float32-compute model's decode), at dh 64, 128, 16 and 32
    # and with a window
    cases += [(FLASH_SHAPES[i], "float32", "bfloat16") for i in (2, 7, 8, 9, 14)]
    rows = {}
    for (label, B, Sq, Skv, H, Hkv, dh, causal, off, win), qdt, kvdt in cases:
        q = torch.randn(B, Sq, H, dh, generator=gen, device=device).to(getattr(torch, qdt))
        k, v = (torch.randn(B, Skv, Hkv, dh, generator=gen, device=device)
                .to(getattr(torch, kvdt)) for _ in range(2))
        kw = dict(causal=causal, q_offset=off, window=win)
        kf.reset_launches()
        got = kf.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        entries = {key[0] for key in kf.LAUNCHES}
        want_entry = ("simt" if qdt == "float32" else "mma_split" if Sq == 1 else "mma")
        check(entries == {want_entry}, f"flash {label} {qdt}/{kvdt}: ran entries {entries}, "
              f"want {want_entry}")
        if Sq == 1:  # the split entry's fixed-order combine: bitwise equal run to run
            again = kf.flash_attention(q, k, v, **kw)
            check(torch.equal(got, again), f"flash {label} {qdt}/{kvdt}: two runs differ")
        want = kf.flash_attention_torch(q, k, v, **kw)
        tol = FLASH_TOL[qdt]
        diff = (got.double() - want.double()).abs()
        err = float(diff.max())
        check(bool(torch.isfinite(got).all()), f"flash {label} {qdt}: non-finite output")
        check(bool((diff <= tol + tol * want.double().abs()).all()),
              f"flash {label} {qdt}/{kvdt}: kernel vs plain max abs err {err:.3g} > {tol}")
        row = dict(max_abs_err=err, tol=tol, entry=want_entry,
                   ms=device_ms(lambda: kf.flash_attention(q, k, v, **kw)),
                   plain_ms=device_ms(lambda: kf.flash_attention_torch(q, k, v, **kw)))
        if qdt == kvdt:
            lib = sdpa_form(q, k, v, causal, off, win)
            row["library_err"] = float((lib.double() - want.double()).abs().max())
            row["library_ms"] = device_ms(lambda: sdpa_form(q, k, v, causal, off, win))
        else:
            row["library_err"] = row["library_ms"] = None  # SDPA takes one dtype
        row["bound_ms"], row["bound_by"] = flash_bound_ms(
            B, Sq, Skv, H, Hkv, dh, causal, off, q.element_size(), k.element_size(), win)
        row["shape"] = (f"B={B} Sq={Sq} Skv={Skv} H={H} Hkv={Hkv} dh={dh} "
                        f"{'causal' if causal else 'non-causal'} q_offset={off} window={win} "
                        f"{qdt}/{kvdt}")
        rows[(label, qdt if qdt == kvdt else f"{qdt}/{kvdt}")] = row
        lib_text = ("SDPA n/a" if row["library_ms"] is None else
                    f"SDPA {row['library_ms']:.5f} (err {row['library_err']:.3g})")
        print(f"[8 flash] {label} {qdt}/{kvdt}: entry {want_entry}, err {err:.3g} (tol {tol}), "
              f"{'bitwise equal on a rerun, ' if Sq == 1 else ''}device ms kernel "
              f"{row['ms']:.5f} plain {row['plain_ms']:.5f} {lib_text} bound "
              f"{row['bound_ms']:.5f} by {row['bound_by']}")
    return rows


def bf16_ulps(got, want):
    """|got - want| in bf16 ulps of the larger magnitude, elementwise."""
    import torch

    a, b = got.double(), want.double()
    mag = torch.maximum(a.abs(), b.abs()).clamp_min(2.0 ** -126)
    return (a - b).abs() / torch.exp2(torch.floor(torch.log2(mag)) - 7)


def attention64(q, k, v, *, causal: bool = True, q_offset: int = 0, window: int = 0,
                mode=None):
    """Attention in float64 on the model layout (``attention_ref``), cast to
    q's dtype: a third summation order for the witnesses below. A window
    is taken only where it masks nothing (no query reaches past it)."""
    import torch
    from repro_torch.kernels.ref import attention_ref

    check(not window or q_offset + q.shape[1] <= window,
          f"attention64: a window of {window} would mask rows at q_offset {q_offset}")
    B, Sq, H, dh = q.shape
    G = H // k.shape[2]
    flat = lambda x: x.transpose(1, 2).reshape(B * H, x.shape[1], dh)  # noqa: E731
    out = attention_ref(flat(q), flat(k.repeat_interleave(G, dim=2)),
                        flat(v.repeat_interleave(G, dim=2)), causal=causal,
                        q_offset=q_offset, dtype=torch.float64)
    return out.reshape(B, H, Sq, dh).transpose(1, 2)


def jax_scale_witness(cfg, prompts, device) -> dict:
    """The serving prefill on weights at the JAX package's init scale, whose
    stacked draw takes the layer count as a layer weight's fan-in (std
    1/sqrt(22) for tinyllama, not 1/sqrt(2048)), so that its softmaxes are
    near one-hot. Every layer's attention on the kernel route's own inputs
    is computed three ways: the kernel, the plain version (float32) and
    float64, and the kernel must be within the phase-8 tolerance of the
    plain version wherever the plain version is within it of float64. The
    last-position logits of three whole routes are read against each
    other: kernel, plain, and plain with float64 attention. A gap between
    the kernel and plain routes that the two plain routes show too is the
    model's amplification of last-bit differences, not the kernel's."""
    import math

    import torch
    from repro_torch.kernels import ops
    from repro_torch.models.api import build_model
    from repro_torch.models.params import materialize
    from repro_torch.models.transformer import TransformerLM

    model = build_model(cfg)
    infos = model.param_infos()
    params = materialize(infos, torch.Generator(device).manual_seed(SEED))
    for blk, leaves in infos["layers"].items():
        for name, info in leaves.items():
            if info.init == "normal" and info.scale is None:  # fan-in: dim 1 -> n_layers
                params["layers"][blk][name].mul_(math.sqrt(info.shape[1] / info.shape[0]))
    lm = TransformerLM(cfg, params)
    del params
    tol = FLASH_TOL["bfloat16"]
    real = ops.gqa_flash_attention
    layers = []

    def checked(q, k, v, *, causal=True, q_offset=0, window=0, mode="cuda"):
        out = real(q, k, v, causal=causal, q_offset=q_offset, window=window, mode=mode)
        plain = real(q, k, v, causal=causal, q_offset=q_offset, window=window, mode="torch")
        ref = attention64(q, k, v, causal=causal, q_offset=q_offset, window=window).double()
        far = lambda x, y: (x.double() - y).abs() > tol + tol * y.abs()  # noqa: E731
        plain_far = far(plain, ref)
        layers.append(dict(
            kernel_ulps=float(bf16_ulps(out, plain).max()),
            over_1ulp=int((bf16_ulps(out, plain) > 1).sum()),
            kernel_far=int(far(out, plain.double()).sum()),
            kernel_far_where_plain_near=int((far(out, plain.double()) & ~plain_far).sum()),
            plain_far_from_f64=int(plain_far.sum()),
            kernel_vs_f64_ulps=float(bf16_ulps(out, ref).max()),
            plain_vs_f64_ulps=float(bf16_ulps(plain, ref).max())))
        return out

    def prefill_logits():
        cache = model.init_cache(prompts.shape[0], prompts.shape[1] + 1, device=device)
        return model.prefill(lm, {"tokens": prompts}, cache)[0][:, -1, :].float()

    try:
        ops.gqa_flash_attention = checked
        kern = prefill_logits()
        ops.gqa_flash_attention = attention64
        plain64 = prefill_logits()
    finally:
        ops.gqa_flash_attention = real
    lm.mode = "torch"
    plain = prefill_logits()
    del lm
    gap = lambda a, b: float((a - b).abs().max()) / float(b.abs().max())  # noqa: E731
    out = dict(kernel_vs_plain=gap(kern, plain), plain_vs_plain64=gap(plain, plain64),
               kernel_vs_plain64=gap(kern, plain64),
               layer_kernel_ulps=max(r["kernel_ulps"] for r in layers),
               layer_over_1ulp=sum(r["over_1ulp"] for r in layers),
               layer_kernel_far=sum(r["kernel_far"] for r in layers),
               layer_plain_far=sum(r["plain_far_from_f64"] for r in layers),
               layer_kernel_vs_f64_ulps=max(r["kernel_vs_f64_ulps"] for r in layers),
               layer_plain_vs_f64_ulps=max(r["plain_vs_f64_ulps"] for r in layers))
    n_out = prompts.shape[0] * prompts.shape[1] * cfg.n_heads * cfg.d_head * cfg.n_layers
    print(f"[9 serve] JAX init scale, prefill: last-position logits kernel vs plain route "
          f"{out['kernel_vs_plain']:.4g} of their scale, plain vs plain with float64 attention "
          f"{out['plain_vs_plain64']:.4g}, kernel vs float64 {out['kernel_vs_plain64']:.4g}")
    print(f"[9 serve] JAX init scale, each layer's attention on the kernel route's inputs, "
          f"{n_out} outputs over {len(layers)} layers: kernel vs plain max "
          f"{out['layer_kernel_ulps']:.4g} bf16 ulps, {out['layer_over_1ulp']} outputs over "
          f"1 ulp, {out['layer_kernel_far']} beyond the phase-8 tolerance; plain vs float64 "
          f"max {out['layer_plain_vs_f64_ulps']:.4g} ulps ({out['layer_plain_far']} beyond "
          f"it), kernel vs float64 max {out['layer_kernel_vs_f64_ulps']:.4g} ulps")
    for i, r in enumerate(layers):
        check(r["kernel_far_where_plain_near"] == 0,
              f"JAX init scale, layer {i}: the kernel is beyond the phase-8 tolerance of the "
              f"plain version at {r['kernel_far_where_plain_near']} outputs where the plain "
              f"version is within it of float64")
    check(all(math.isfinite(v) for v in out.values()), f"JAX init scale: {out}")
    return out


def replay_gaps(model, lm, prompts, run, tol: float) -> list[tuple[float, int, int]]:
    """Teacher-forced replay of the forward calls of ``run`` (the kernel
    route's tokens) through ``lm``, set to its other route. Per
    call: (max |diff| of the last-position logits over the kernel route's
    max |.|, the rows whose argmax differs, those of them whose top-2 gap
    in the kernel route is wider than ``tol`` of the scale)."""
    requests, n_gen = run.tokens.shape
    cache = model.init_cache(requests, prompts.shape[1] + n_gen, device=prompts.device)
    out = []
    for t in range(n_gen):
        if t == 0:
            logits, cache = model.prefill(lm, {"tokens": prompts}, cache)
        else:
            logits, cache = model.decode_step(lm, cache, run.tokens[:, t - 1:t])
        plain, kern = logits[:, -1, :].float(), run.logits[t].float()
        out.append(logit_gap(plain, kern, tol))
    return out


def logit_gap(other, kern, tol: float) -> tuple[float, int, int]:
    """(max |other - kern| over max |kern|, rows whose argmax differs, those
    of them whose top-2 gap in ``kern`` is wider than ``tol`` of the scale)."""
    scale = float(kern.abs().max())
    top2 = kern.topk(2, dim=-1).values
    wide = (top2[:, 0] - top2[:, 1]) > tol * scale
    differ = other.argmax(-1) != kern.argmax(-1)
    return (float((other - kern).abs().max()) / scale, int(differ.sum()),
            int((differ & wide).sum()))


def by_entry(launches: dict) -> dict:
    """Launch counts summed by their key's first element (entry or path)."""
    out: collections.Counter = collections.Counter()
    for key, n in launches.items():
        out[key[0]] += n
    return dict(out)


def launch_counts(name: str, km):
    """The launch counts of a kernel module with one device kernel, by name."""
    return lambda: {name: sum(km.LAUNCHES.values())}


#: flash_attention's device kernels as torch.profiler names them, by entry
FLASH_KERNELS = {"simt": ("flash_attention_kernel",), "mma": ("flash_attention_mma_kernel",),
                 "mma_split": ("flash_attention_split_kernel", "flash_attention_combine_kernel")}


def flash_counts() -> dict:
    """Launches of each of flash_attention's device kernels, from the
    wrapper's counts by entry."""
    from repro_torch.kernels import flash_attention as kf

    out = {name: 0 for names in FLASH_KERNELS.values() for name in names}
    for key, n in kf.LAUNCHES.items():
        for name in FLASH_KERNELS[key[0]]:
            out[name] += n
    return out


def profile_serving(model, lm, prompts, run, kernels: dict, tag: str) -> dict:
    """Prints each kernel's share of device time under torch.profiler, for
    one prefill and then 8 decode steps of ``run``'s tokens; ``kernels``
    maps a kernel module to a function that gives its device kernels'
    launches by name, from its ``LAUNCHES`` (which must match what the trace
    saw). Returns the device kernels per decode step and the busy shares."""
    from repro_torch.launch import serve

    def counted():
        return {name: n for counts in kernels.values() for name, n in counts().items()}

    def reset():
        for km in kernels:
            km.reset_launches()

    requests, n_gen = run.tokens.shape
    reset()
    names = tuple(counted())
    busy_p, named_p, wall_p, n_p = device_busy(lambda: serve.generate(model, lm, prompts, 1),
                                               names)
    share_p = kernel_shares(busy_p, named_p, wall_p, counted(), f"{tag} prefill")
    cache = model.init_cache(requests, prompts.shape[1] + n_gen, device=prompts.device)
    _, cache = model.prefill(lm, {"tokens": prompts}, cache)

    def decode8():
        c = dict(cache)
        for i in range(8):
            _, c = model.decode_step(lm, c, run.tokens[:, i:i + 1])

    reset()
    busy_d, named_d, wall_d, n_d = device_busy(decode8, names)
    share_d = kernel_shares(busy_d, named_d, wall_d, counted(), f"{tag} decode")
    print(f"[{tag}] profiled prefill: {n_p} device kernels, {busy_p:.5f} s of {wall_p:.4f} s "
          f"wall; {share_p}\n[{tag}] profiled 8 decode steps: {n_d} device kernels "
          f"({n_d / 8:.1f} per step), {busy_d:.5f} s of {wall_d:.4f} s wall; {share_d}")
    return dict(kernels_per_decode_step=n_d / 8, prefill_busy=busy_p / wall_p if wall_p else 0.0,
                decode_busy=busy_d / wall_d if wall_d else 0.0)


def smoke_card_matches_cpu(arch: str, device, tag: str, adjust=None,
                           prompt_len: int = 16) -> None:
    """The SMOKE model of ``arch`` at float32 compute, weights and prompts
    drawn on the CPU (then passed to ``adjust(lm, generator)`` if given):
    8 greedy tokens for 2 requests of ``prompt_len`` must be the same on the
    card as on the CPU."""
    import dataclasses as dc

    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    smoke = dc.replace(get_config(arch, smoke=True), compute_dtype=torch.float32)
    s_model, s_lm, s_prompts = serve.prepare(smoke, requests=2, prompt_len=prompt_len,
                                             seed=SEED, device="cpu")
    if adjust is not None:
        adjust(s_lm, torch.Generator().manual_seed(SEED))
    want = serve.generate(s_model, s_lm, s_prompts, 8).tokens
    got = serve.generate(s_model, s_lm.to(device), s_prompts.to(device), 8).tokens
    check(torch.equal(got.cpu(), want), f"{arch} SMOKE f32: card tokens {got.tolist()} != CPU "
          f"{want.tolist()}")
    print(f"[{tag}] SMOKE {arch} at f32 compute, 2 x ({prompt_len} + 8): card tokens == CPU tokens "
          f"{want[0].tolist()}")


def phase_serve(device, smoke: bool = False, requests: int = 8, prompt_len: int = 512,
                n_gen: int = 32) -> dict:
    """The serving path at full width: admission of 8 streams on H100_HOST
    through the CUDA scorer, then ``tinyllama-1.1b`` (22 layers, d_model
    2048, weights drawn on the card from SEED) serving 8 requests of 512
    prompt tokens and 32 generated tokens by the kernel route. The flash
    launches must be 22 x 32; a teacher-forced replay on the plain route
    must give the same logits (2e-2 of their scale) and the same argmax
    where the top-2 gap is wider than that; ``jax_scale_witness`` runs
    the prefill at the JAX init scale; a SMOKE run at f32 compute must give
    the card the CPU's tokens. Returns the path's numbers.
    ``smoke`` and the sizes shrink it for a rehearsal on the CPU."""
    import gc

    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import H100_HOST
    from repro_torch.kernels import consolidation as kc
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.launch import serve

    tol = 2e-2
    on_card = device.type == "cuda"
    kc.reset_launches()
    placements = serve.admission_check("tinyllama-1.1b", requests, host=H100_HOST, device=device)
    check(all(p is not None for p in placements), f"admission queued a stream: {placements}")
    check(sum(kc.LAUNCHES.values()) > 0 or not on_card,
          "admission never launched consolidation_scores")
    print(f"[9 serve] admission of {requests} streams on 2 x {H100_HOST.name}: {placements}, "
          f"consolidation_scores launches {sum(kc.LAUNCHES.values())}")

    cfg = get_config("tinyllama-1.1b", smoke=smoke)
    model, lm, prompts = serve.prepare(cfg, requests=requests, prompt_len=prompt_len, seed=SEED,
                                       device=device)
    n_params = sum(p.numel() for p in lm.parameters())
    serve.generate(model, lm, prompts, 2)  # warm-up: cuBLAS handles, allocator
    if on_card:
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    kf.reset_launches()
    run = serve.generate(model, lm, prompts, n_gen, keep_logits=True)
    launches = dict(kf.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    n_launch = sum(launches.values())
    check(n_launch == cfg.n_layers * n_gen or not on_card,
          f"serving launched flash_attention {n_launch} times, want {cfg.n_layers} x {n_gen}")
    check(all(key[0] in ("mma", "mma_split") for key in launches),
          f"serving's flash launches left the tensor-core entries: {sorted(launches)}")
    check(tuple(run.tokens.shape) == (requests, n_gen), f"tokens {tuple(run.tokens.shape)}")
    check(bool(((run.tokens >= 0) & (run.tokens < cfg.vocab)).all()), "token out of the vocab")
    decode_ms = [1e3 * t for t in run.decode_s]
    total = run.prefill_s + sum(run.decode_s)
    print(f"[9 serve] {cfg.name} {n_params / 1e9:.3f} B params, {requests} requests x prompt "
          f"{prompt_len} + {n_gen} tokens: prefill {1e3 * run.prefill_s:.3f} ms, decode "
          f"{statistics.mean(decode_ms):.3f} ms/step (median {statistics.median(decode_ms):.3f}, "
          f"min {min(decode_ms):.3f}, max {max(decode_ms):.3f}), {requests * n_gen / total:.1f} "
          f"tokens/s over {total:.3f} s, peak device memory {peak / 2**30:.3f} GiB; "
          f"flash_attention launches {n_launch} over {len(launches)} shapes, by entry "
          f"{by_entry(launches)}")

    # the plain route, teacher-forced on the kernel route's tokens
    lm.mode = "torch"
    gaps = replay_gaps(model, lm, prompts, run, tol)
    lm.mode = None
    for t, (rel, _, wide_flips) in enumerate(gaps):
        check(rel <= tol, f"step {t}: plain and kernel routes' logits differ by {rel:.3g} of "
              f"their scale")
        check(wide_flips == 0, f"step {t}: argmax differs where the top-2 gap exceeds {tol} "
              f"of the scale")
    worst_rel, flips = max(g[0] for g in gaps), sum(g[1] for g in gaps)
    check(sum(kf.LAUNCHES.values()) == n_launch, "the plain route launched the kernel")
    print(f"[9 serve] plain route teacher-forced over {n_gen} steps: logits within {worst_rel:.3g} "
          f"of their scale (tol {tol}); argmax differs in {flips} of {requests * n_gen} "
          f"places, none where the top-2 gap exceeds the tolerance")

    # the kernel's share of device time, prefill alone and 8 decode steps
    if not on_card:
        return dict(launches=n_launch, prefill_ms=1e3 * run.prefill_s,
                    decode_ms=statistics.mean(decode_ms), worst_rel=worst_rel)
    profile_serving(model, lm, prompts, run, {kf: flash_counts}, "9 serve")

    del lm
    gc.collect()
    witness = jax_scale_witness(cfg, prompts, device)

    # a SMOKE model at float32 compute: the card's tokens are the CPU's
    smoke_card_matches_cpu("tinyllama-1.1b", device, "9 serve")
    return dict(launches=n_launch, prefill_ms=1e3 * run.prefill_s,
                decode_ms=statistics.mean(decode_ms), worst_rel=worst_rel, witness=witness)


#: rwkv6_scan vs its plain version and the float64 recurrence (tests/test_kernels.py's
#: bounds for the Pallas kernel): float32 sums over dh terms and the tokens' decays
RWKV_ATOL, RWKV_RTOL = 5e-4, 1e-3
#: (label, B, S, H, dh, r/k/v dtype, nonzero s0): the serving path's shapes
#: (rwkv6-7b, 8 requests, prompt 512: the prefill from a zero state, decode
#: from the prefill's), ragged S, the SMOKE head size and float32 r/k/v
RWKV_SHAPES = [
    ("prefill", 8, 512, 64, 64, "bfloat16", False),
    ("decode", 8, 1, 64, 64, "bfloat16", True),
    ("ragged S=17", 8, 17, 64, 64, "bfloat16", True),
    ("ragged S=33", 8, 33, 64, 64, "bfloat16", True),
    ("SMOKE dh=16", 2, 33, 4, 16, "bfloat16", True),
    ("SMOKE dh=16 decode", 2, 1, 4, 16, "float32", True),
    ("f32", 2, 65, 8, 64, "float32", True),
]


def rwkv_inputs(B, S, H, dh, dtype, nonzero_s0, gen, device):
    """Seeded WKV inputs on ``device``: r, k, v ~ N(0, 1) in ``dtype``,
    wlog = -exp(0.5 N(0, 1)) per channel and token, u ~ 0.1 N(0, 1), s0
    ~ N(0, 1) or zeros."""
    import torch

    rand = lambda *shape: torch.randn(*shape, generator=gen, device=device)  # noqa: E731
    dt = getattr(torch, dtype)
    r, k, v = (rand(B, S, H, dh).to(dt) for _ in range(3))
    wlog = -torch.exp(0.5 * rand(B, S, H, dh))
    u = 0.1 * rand(H, dh)
    s0 = rand(B, H, dh, dh) if nonzero_s0 else torch.zeros(B, H, dh, dh, device=device)
    return r, k, v, wlog, u, s0


def rwkv_err(got, want, label: str) -> float:
    """Max abs difference over (y, sT); fails past RWKV_ATOL + RWKV_RTOL *
    |want|, on a shape mismatch or a non-finite value."""
    import torch

    err = 0.0
    for g, w in zip(got, want):
        check(tuple(g.shape) == tuple(w.shape) and g.dtype == torch.float32,
              f"{label}: {g.dtype} {tuple(g.shape)} != float32 {tuple(w.shape)}")
        check(bool(torch.isfinite(g).all()), f"{label}: non-finite output")
        diff = (g.double() - w.double()).abs()
        err = max(err, float(diff.max()))
        check(bool((diff <= RWKV_ATOL + RWKV_RTOL * w.double().abs()).all()),
              f"{label}: max abs err {err:.3g} beyond atol {RWKV_ATOL} rtol {RWKV_RTOL}")
    return err


def rwkv_bound_ms(B, S, H, dh, rkv_size) -> tuple[float, str]:
    """Least time for one call on these inputs: r, k, v (``rkv_size`` bytes
    each), wlog, u and s0 read once, y and sT written once, over HBM
    bandwidth; against 4 dh^2 fp32 operations per (b, h, token) (two
    multiply-adds per state entry: the output's and the update's) over the
    fp32 peak."""
    n = B * S * H * dh
    nbytes = 3 * n * rkv_size + 4 * n + 4 * H * dh + 2 * 4 * B * H * dh * dh + 4 * n
    flops = 4 * B * S * H * dh * dh
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def rwkv_ref64(r, k, v, wlog, u, s0):
    """``rwkv6_ref`` in float64 on the [B * H, S, dh] fold, back in the
    model layout."""
    from repro_torch.kernels.ref import rwkv6_ref

    B, S, H, dh = r.shape
    fold = lambda x: x.double().permute(0, 2, 1, 3).reshape(B * H, S, dh)  # noqa: E731
    y, sT = rwkv6_ref(fold(r), fold(k), fold(v), fold(wlog), u.double().repeat(B, 1),
                      s0.double().reshape(B * H, dh, dh))
    return y.reshape(B, H, S, dh).permute(0, 2, 1, 3), sT.reshape(B, H, dh, dh)


def phase_rwkv_scan(device) -> dict:
    """``rwkv6_scan`` against ``rwkv6_scan_torch`` at every RWKV_SHAPES
    shape, both against ``rwkv6_ref`` in float64 at the ragged S = 33,
    with device times of the kernel and the plain version beside the bound
    (no PyTorch call computes WKV6). Returns the rows by label."""
    import torch
    from repro_torch.kernels import rwkv6_scan as ks

    on_card = device.type == "cuda"
    gen = torch.Generator(device).manual_seed(SEED + 4)
    rows = {}
    for label, B, S, H, dh, dtype, nonzero in RWKV_SHAPES:
        args = rwkv_inputs(B, S, H, dh, dtype, nonzero, gen, device)
        got = ks.rwkv6_scan(*args)
        if on_card:
            torch.cuda.synchronize()
        want = ks.rwkv6_scan_torch(*args)
        err = rwkv_err(got, want, f"rwkv6_scan {label}")
        row = dict(max_abs_err=err, shape=f"B={B} S={S} H={H} dh={dh} {dtype} r/k/v, "
                   f"{'nonzero' if nonzero else 'zero'} s0")
        if label == "ragged S=33":
            ref = rwkv_ref64(*args)
            row["ref_err"] = max(rwkv_err(got, ref, f"rwkv6_scan {label} vs float64"),
                                 rwkv_err(want, ref, f"rwkv6_scan_torch {label} vs float64"))
        row["bound_ms"], row["bound_by"] = rwkv_bound_ms(B, S, H, dh, args[0].element_size())
        row["library_ms"] = None
        if on_card:
            row["ms"] = device_ms(lambda: ks.rwkv6_scan(*args))
            row["plain_ms"] = device_ms(lambda: ks.rwkv6_scan_torch(*args),
                                        reps=5 if S > 64 else 20)
        rows[label] = row
        times = (f"device ms kernel {row['ms']:.5f} plain {row['plain_ms']:.5f}" if on_card
                 else "device ms not measured")
        ref_text = f", vs float64 {row['ref_err']:.3g}" if "ref_err" in row else ""
        print(f"[10 rwkv6_scan] {label} ({row['shape']}): err {err:.3g}{ref_text} (atol "
              f"{RWKV_ATOL} rtol {RWKV_RTOL}), {times}, bound {row['bound_ms']:.5f} by "
              f"{row['bound_by']}, library none")
    return rows


def perturb_decay(lm, gen) -> None:
    """In every layer of an RWKV LM, ``w_base`` uniform on [-6, 1] and
    ``w_lora_b`` ~ N(0, 0.1^2), drawn from ``gen`` in place of the init's
    constant -2 and zeros, under which the decay is the same in every
    channel and at every token."""
    for layer in lm.layers:
        layer.time.w_base.uniform_(-6.0, 1.0, generator=gen)
        layer.time.w_lora_b.normal_(0.0, 0.1, generator=gen)
        layer.time.refresh()


def rwkv_f64(r, k, v, wlog, u, s0, *, mode=None):
    """The WKV by ``rwkv6_ref`` in float64, cast back to float32: a third
    summation order for the witness below (``ops.rwkv6_wkv``'s signature)."""
    y, sT = rwkv_ref64(r, k, v, wlog, u, s0)
    return y.float(), sT.float()


def shadow_rerun(model, lm, prompts, run) -> dict:
    """``run``'s forward calls once more on the kernel route, teacher-forced
    on its tokens, with every WKV launch held to the plain version on the
    kernel route's own inputs (phase 10's tolerance): each launch of the
    served run is checked at the shape and on the values it ran. Returns
    the launches checked, the largest error, and the largest gap of the
    rerun's logits from the served run's."""
    from repro_torch.kernels import ops

    real = ops.rwkv6_wkv
    errs = []

    def checked(r, k, v, wlog, u, s0, *, mode="cuda"):
        out = real(r, k, v, wlog, u, s0, mode=mode)
        plain = real(r, k, v, wlog, u, s0, mode="torch")
        errs.append(rwkv_err(out, plain, f"served WKV launch {len(errs)} ({tuple(r.shape)})"))
        return out

    try:
        ops.rwkv6_wkv = checked
        gaps = replay_gaps(model, lm, prompts, run, 0.0)
    finally:
        ops.rwkv6_wkv = real
    return dict(launches=len(errs), max_abs_err=max(errs), rerun_gap=max(g[0] for g in gaps))


def rwkv_witness(model, lm, prompts, kern_logits) -> dict:
    """The serving prefill's last-position logits by three routes: the
    kernel's (``kern_logits``), the plain version's and the WKV in float64.
    A gap between the kernel and plain routes that the plain route shows
    against float64 too is the model's amplification of last-bit
    differences, not the kernel's."""
    from repro_torch.kernels import ops

    def logits():
        cache = model.init_cache(prompts.shape[0], prompts.shape[1] + 1, device=prompts.device)
        return model.prefill(lm, {"tokens": prompts}, cache)[0][:, -1, :].float()

    real = ops.rwkv6_wkv
    lm.mode = "torch"
    plain = logits()
    lm.mode = None
    try:
        ops.rwkv6_wkv = rwkv_f64
        plain64 = logits()
    finally:
        ops.rwkv6_wkv = real
    gap = lambda a, b: float((a - b).abs().max()) / float(b.abs().max())  # noqa: E731
    return dict(kernel_vs_plain=gap(kern_logits, plain), plain_vs_f64=gap(plain, plain64),
                kernel_vs_f64=gap(kern_logits, plain64))


def twin_decode_gaps(model, lm, prompts, tol: float,
                     steps: int = 8) -> list[tuple[float, int, int]]:
    """A kernel-route prefill, then ``steps`` greedy decode steps, each run
    also on the plain route (``lm.mode`` 'torch') from a copy of the
    same state: ``logit_gap`` of the plain step's logits from the kernel
    step's, per step."""
    import torch

    requests, prompt_len = prompts.shape
    cache = model.init_cache(requests, prompt_len + steps, device=prompts.device)
    logits, cache = model.prefill(lm, {"tokens": prompts}, cache)
    gaps = []
    for _ in range(steps):
        tok = logits[:, -1, :].float().argmax(-1)[:, None]
        twin = {k: v.clone() if isinstance(v, torch.Tensor) else v for k, v in cache.items()}
        lm.mode = "torch"
        plain, _ = model.decode_step(lm, twin, tok)
        lm.mode = None
        logits, cache = model.decode_step(lm, cache, tok)
        gaps.append(logit_gap(plain[:, -1, :].float(), logits[:, -1, :].float(), tol))
    return gaps


def f32_decode_check(cfg, device, requests: int, prompt_len: int) -> float:
    """The served model at float32 compute (the same seeded masters and
    decay): decode steps from one state by both routes (``twin_decode_gaps``)
    must agree within 1e-4 of the logits' scale (float32 sums in another
    order through 32 layers), and in argmax wherever the top-2 gap is
    wider. Returns the largest gap."""
    import dataclasses as dc

    import torch
    from repro_torch.launch import serve

    tol = 1e-4
    f32 = dc.replace(cfg, compute_dtype=torch.float32)
    model, lm, prompts = serve.prepare(f32, requests=requests, prompt_len=prompt_len, seed=SEED,
                                       device=device)
    perturb_decay(lm, torch.Generator(device).manual_seed(SEED + 5))
    gaps = twin_decode_gaps(model, lm, prompts, tol)
    for t, (rel, _, wide_flips) in enumerate(gaps):
        check(rel <= tol, f"f32 decode step {t} from one state: plain and kernel routes' logits "
              f"differ by {rel:.3g} of their scale (tol {tol})")
        check(wide_flips == 0, f"f32 decode step {t}: argmax differs where the top-2 gap "
              f"exceeds {tol} of the scale")
    return max(g[0] for g in gaps)


def phase_serve_rwkv(device, smoke: bool = False, requests: int = 8, prompt_len: int = 512,
                     n_gen: int = 32) -> dict:
    """The RWKV6 serving path at full width: admission of 8 streams on
    H100_HOST through the CUDA scorer, then ``rwkv6-7b`` (32 layers, d_model
    4096, weights drawn on the card from SEED, the decay's ``w_base`` and
    ``w_lora_b`` perturbed by ``perturb_decay``, bf16 compute over float32
    masters) serving 8 requests of 512 prompt tokens and 32 generated
    tokens by the kernel route. The rwkv6_scan launches must be 32 x 32.

    This random model amplifies last-bit differences through its 32 layers
    (a WKV output near zero, divided by its own RMS in the group norm): two
    correct routes give logits far apart. So every launch of the served run
    is held to the plain version on its own inputs (``shadow_rerun``); the
    teacher-forced plain-route replay is measured beside ``rwkv_witness``,
    not held to a limit; at float32 compute, decode steps from one state
    must agree across the routes (``f32_decode_check``); a SMOKE run at f32
    compute must give the card the CPU's tokens. Returns the path's
    numbers. ``smoke`` and the sizes shrink it for a rehearsal on the CPU."""
    import gc
    import math

    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import H100_HOST
    from repro_torch.kernels import consolidation as kc
    from repro_torch.kernels import rwkv6_scan as ks
    from repro_torch.launch import serve

    tol = 2e-2
    on_card = device.type == "cuda"
    if on_card:
        gc.collect()
        torch.cuda.empty_cache()
    kc.reset_launches()
    placements = serve.admission_check("rwkv6-7b", requests, host=H100_HOST, device=device)
    check(all(p is not None for p in placements), f"admission queued a stream: {placements}")
    check(sum(kc.LAUNCHES.values()) > 0 or not on_card,
          "admission never launched consolidation_scores")
    print(f"[11 serve rwkv] admission of {requests} streams on 2 x {H100_HOST.name}: "
          f"{placements}, consolidation_scores launches {sum(kc.LAUNCHES.values())}")

    cfg = get_config("rwkv6-7b", smoke=smoke)
    model, lm, prompts = serve.prepare(cfg, requests=requests, prompt_len=prompt_len, seed=SEED,
                                       device=device)
    perturb_decay(lm, torch.Generator(device).manual_seed(SEED + 5))
    n_params = sum(p.numel() for p in lm.parameters())
    serve.generate(model, lm, prompts, 2)  # warm-up: cuBLAS handles, allocator, the build
    if on_card:
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    ks.reset_launches()
    run = serve.generate(model, lm, prompts, n_gen, keep_logits=True)
    launches = dict(ks.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    n_launch = sum(launches.values())
    check(n_launch == cfg.n_layers * n_gen or not on_card,
          f"serving launched rwkv6_scan {n_launch} times, want {cfg.n_layers} x {n_gen}")
    check(tuple(run.tokens.shape) == (requests, n_gen), f"tokens {tuple(run.tokens.shape)}")
    check(bool(((run.tokens >= 0) & (run.tokens < cfg.vocab)).all()), "token out of the vocab")
    check(all(bool(torch.isfinite(x.float()).all()) for x in run.logits), "non-finite logits")
    decode_ms = [1e3 * t for t in run.decode_s]
    total = run.prefill_s + sum(run.decode_s)
    state_bytes = sum(math.prod(i.shape) * i.dtype.itemsize
                      for i in model.cache_infos(requests, 1).values())
    print(f"[11 serve rwkv] {cfg.name} {n_params / 1e9:.3f} B params, {requests} requests x "
          f"prompt {prompt_len} + {n_gen} tokens: prefill {1e3 * run.prefill_s:.3f} ms, decode "
          f"{statistics.mean(decode_ms):.3f} ms/step (median {statistics.median(decode_ms):.3f}, "
          f"min {min(decode_ms):.3f}, max {max(decode_ms):.3f}), {requests * n_gen / total:.1f} "
          f"tokens/s over {total:.3f} s, peak device memory {peak / 2**30:.3f} GiB (states "
          f"{state_bytes / 1e6:.1f} MB); rwkv6_scan launches {n_launch} over {len(launches)} "
          f"shapes {sorted(launches)}")

    shadow = shadow_rerun(model, lm, prompts, run)
    check(shadow["launches"] == cfg.n_layers * n_gen,
          f"the shadow rerun checked {shadow['launches']} launches")
    print(f"[11 serve rwkv] shadow rerun of the {n_gen} calls: all {shadow['launches']} WKV "
          f"launches within atol {RWKV_ATOL} rtol {RWKV_RTOL} of the plain version on their own "
          f"inputs, max abs err {shadow['max_abs_err']:.3g}; rerun logits vs the served run's "
          f"{shadow['rerun_gap']:.3g} of their scale")

    # the plain route, teacher-forced on the kernel route's tokens: measured
    before = sum(ks.LAUNCHES.values())
    lm.mode = "torch"
    gaps = replay_gaps(model, lm, prompts, run, tol)
    lm.mode = None
    check(sum(ks.LAUNCHES.values()) == before, "the plain route launched the kernel")
    witness = rwkv_witness(model, lm, prompts, run.logits[0].float())
    witness["bf16_decode_from_one_state"] = max(
        g[0] for g in twin_decode_gaps(model, lm, prompts, tol))
    check(all(math.isfinite(v) for v in witness.values()), f"witness: {witness}")
    print(f"[11 serve rwkv] plain route teacher-forced over {n_gen} calls (measured, not held "
          f"to {tol}): logits {gaps[0][0]:.4g} of their scale apart at the prefill, "
          f"{max(g[0] for g in gaps[1:]) if n_gen > 1 else 0.0:.4g} at most over the decode "
          f"steps; argmax differs in {sum(g[1] for g in gaps)} of {requests * n_gen} places, "
          f"{sum(g[2] for g in gaps)} of them where the top-2 gap exceeds {tol} of the scale. "
          f"Witness at the prefill: kernel vs plain {witness['kernel_vs_plain']:.4g}, plain vs "
          f"WKV in float64 {witness['plain_vs_f64']:.4g}, kernel vs float64 "
          f"{witness['kernel_vs_f64']:.4g}; 8 bf16 decode steps each from one state by both "
          f"routes: logits up to {witness['bf16_decode_from_one_state']:.4g} apart")
    out = dict(launches=n_launch, prefill_ms=1e3 * run.prefill_s,
               decode_ms=statistics.mean(decode_ms), replay_gaps=[g[0] for g in gaps],
               witness=witness, shadow_err=shadow["max_abs_err"], peak_gib=peak / 2**30)
    if not on_card:
        return out

    profile_serving(model, lm, prompts, run, {ks: launch_counts("rwkv6_scan_kernel", ks)},
                    "11 serve rwkv")
    del lm, run
    gc.collect()
    torch.cuda.empty_cache()
    out["f32_decode_gap"] = f32_decode_check(cfg, device, requests, prompt_len)
    print(f"[11 serve rwkv] float32 compute, 8 decode steps each from one state by both routes: "
          f"logits within {out['f32_decode_gap']:.3g} of their scale (tol 1e-4), argmax equal "
          f"wherever the top-2 gap is wider")
    gc.collect()
    torch.cuda.empty_cache()
    smoke_card_matches_cpu("rwkv6-7b", device, "11 serve rwkv", adjust=perturb_decay)
    return out


#: mamba_scan vs its plain versions and the float64 recurrence: float32
#: products that the kernel fuses into FMAs, expf against torch's exp, and y's
#: sum over N in another order, through up to 512 steps whose decays (< 1)
#: keep old errors from growing
MAMBA_ATOL, MAMBA_RTOL = 1e-4, 1e-4
#: (label, B, S, E, N, u/B/C dtype, nonzero h0): the served path's shapes
#: (jamba-v0.1-52b, 8 requests, prompt 512: the prefill from a zero state,
#: decode from the prefill's), a ragged S and E, the SMOKE width and float32
MAMBA_SHAPES = [
    ("prefill", 8, 512, 8192, 16, "bfloat16", False),
    ("decode", 8, 1, 8192, 16, "bfloat16", True),
    ("ragged S=33 E=96", 2, 33, 96, 16, "bfloat16", True),
    ("SMOKE N=4", 2, 33, 128, 4, "bfloat16", True),
    ("f32 N=8", 2, 65, 200, 8, "float32", True),
]


def mamba_inputs(B, S, E, N, dtype, nonzero_h0, gen, device):
    """Seeded model-entry inputs on ``device``: delta = softplus(N(0, 1))
    float32, u ~ N(0, 1) in ``dtype``, B and C as strided views of one
    [B, S, 8 + 2N] projection in ``dtype`` (as the Mamba block's ``xdbc``),
    A = -exp(0.5 N(0, 1)) float32, h0 ~ N(0, 1) or zeros."""
    import torch
    import torch.nn.functional as F

    rand = lambda *shape: torch.randn(*shape, generator=gen, device=device)  # noqa: E731
    dt = getattr(torch, dtype)
    delta = F.softplus(rand(B, S, E))
    u = rand(B, S, E).to(dt)
    xdbc = rand(B, S, 8 + 2 * N).to(dt)
    bm, cm = xdbc[..., 8:8 + N], xdbc[..., 8 + N:]
    A = -torch.exp(0.5 * rand(E, N))
    h0 = rand(B, E, N) if nonzero_h0 else torch.zeros(B, E, N, device=device)
    return delta, u, bm, cm, A, h0


def contract_inputs(delta, u, bm, cm, A, h0):
    """The contract entry's inputs formed from the model entry's, as the JAX
    model forms them: da = exp(delta * A), dbu = (delta * u) * B, c = C, all
    float32."""
    import torch

    da = torch.exp(delta[..., None] * A)
    dbu = (delta * u.float())[..., None] * bm.float()[:, :, None, :]
    return da, dbu, cm.float().contiguous(), h0


def mamba_err(got, want, label: str) -> float:
    """Max abs difference over (y, hT); fails past MAMBA_ATOL + MAMBA_RTOL *
    |want|, on a shape or dtype mismatch or a non-finite value."""
    import torch

    err = 0.0
    for g, w in zip(got, want):
        check(tuple(g.shape) == tuple(w.shape) and g.dtype == torch.float32,
              f"{label}: {g.dtype} {tuple(g.shape)} != float32 {tuple(w.shape)}")
        check(bool(torch.isfinite(g).all()), f"{label}: non-finite output")
        diff = (g.double() - w.double()).abs()
        err = max(err, float(diff.max()))
        check(bool((diff <= MAMBA_ATOL + MAMBA_RTOL * w.double().abs()).all()),
              f"{label}: max abs err {err:.3g} beyond atol {MAMBA_ATOL} rtol {MAMBA_RTOL}")
    return err


def mamba_bound_ms(B, S, E, N, ubc_size, model: bool) -> tuple[float, str]:
    """Least time for one call on these inputs, each input read once and
    each output written once over HBM bandwidth, against its fp32
    operations over the fp32 peak. The model entry reads delta (4 bytes),
    u, B and C (``ubc_size`` each), A and h0, writes y and hT, and does 6
    operations per (b, t, e, n): delta * A, its exp, the decay's product,
    (delta u) * B, the sum, and y's multiply-add. The contract entry reads
    da and dbu [B, S, E, N] and c, h0 (4 bytes each), writes y and hT, and
    does 4 operations per (b, t, e, n)."""
    states = 2 * 4 * B * E * N + 4 * B * S * E  # h0, hT, y
    if model:
        nbytes = states + B * S * E * (4 + ubc_size) + 2 * B * S * N * ubc_size + 4 * E * N
        flops = 6 * B * S * E * N
    else:
        nbytes = states + 2 * 4 * B * S * E * N + 4 * B * S * N
        flops = 4 * B * S * E * N
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def mamba_ref64(da, dbu, c, h0):
    """``mamba_ref`` in float64, from h0."""
    from repro_torch.kernels.ref import mamba_ref

    return mamba_ref(da.double(), dbu.double(), c.double(), h0.double())


def phase_mamba_scan(device) -> dict:
    """Both entries of ``mamba_scan`` against their plain versions at every
    MAMBA_SHAPES shape (the model entry against ``mamba_selective_scan_torch``,
    the JAX model's chunked form; the contract entry against
    ``mamba_scan_torch``, the sequential loop, on da and dbu formed from
    the same inputs), both against ``mamba_ref`` in float64 at the ragged
    shape, with device times of the kernel and the plain version beside the
    bound (no PyTorch call computes the selective scan). Returns the rows by
    (entry, label)."""
    import torch
    from repro_torch.kernels import mamba_scan as km

    on_card = device.type == "cuda"
    gen = torch.Generator(device).manual_seed(SEED + 6)
    rows = {}
    for label, B, S, E, N, dtype, nonzero in MAMBA_SHAPES:
        margs = mamba_inputs(B, S, E, N, dtype, nonzero, gen, device)
        cargs = contract_inputs(*margs)
        for entry, kernel, plain, args in (
                ("model", km.mamba_selective_scan, km.mamba_selective_scan_torch, margs),
                ("contract", km.mamba_scan, km.mamba_scan_torch, cargs)):
            got = kernel(*args)
            if on_card:
                torch.cuda.synchronize()
            want = plain(*args)
            err = mamba_err(got, want, f"mamba_scan {entry} {label}")
            row = dict(max_abs_err=err, shape=f"B={B} S={S} E={E} N={N} {dtype} u/B/C, "
                       f"{'nonzero' if nonzero else 'zero'} h0 ({entry} entry)")
            if label.startswith("ragged"):
                ref = mamba_ref64(*cargs)
                row["ref_err"] = max(mamba_err(got, ref, f"{entry} {label} vs float64"),
                                     mamba_err(want, ref, f"{entry} plain {label} vs float64"))
            row["bound_ms"], row["bound_by"] = mamba_bound_ms(
                B, S, E, N, margs[1].element_size(), entry == "model")
            row["library_ms"] = None
            if on_card:
                row["ms"] = device_ms(lambda: kernel(*args))
                row["plain_ms"] = device_ms(lambda: plain(*args), reps=3 if S > 64 else 20)
            rows[(entry, label)] = row
            times = (f"device ms kernel {row['ms']:.5f} plain {row['plain_ms']:.5f}" if on_card
                     else "device ms not measured")
            ref_text = f", vs float64 {row['ref_err']:.3g}" if "ref_err" in row else ""
            print(f"[12 mamba_scan] {entry} {label} ({row['shape']}): err {err:.3g}{ref_text} "
                  f"(atol {MAMBA_ATOL} rtol {MAMBA_RTOL}), {times}, bound {row['bound_ms']:.5f} "
                  f"by {row['bound_by']}, library none")
        del margs, cargs
    return rows


def jamba_served(smoke: bool = False):
    """jamba-v0.1-52b at its published widths, cut in depth from 32 to 16
    layers (two of four periods) with bf16 weights: 52.1 GB, the deepest
    cut one 80 GB card holds. ``smoke`` gives the SMOKE configuration."""
    import dataclasses as dc

    import torch
    from repro_torch.configs import get_config

    cfg = get_config("jamba-v0.1-52b", smoke=smoke)
    return cfg if smoke else dc.replace(cfg, n_layers=16, param_dtype=torch.bfloat16)


def selective_scan_f64(delta, u, bm, cm, A, h0, *, mode=None):
    """The model entry's scan in float64, one token at a time, cast back to
    float32: a third summation order for the witness below
    (``ops.selective_scan``'s signature)."""
    import torch

    d, uu, b, c, a = (x.double() for x in (delta, u, bm, cm, A))
    h = h0.double()
    ys = []
    for t in range(d.shape[1]):
        h = torch.exp(d[:, t, :, None] * a) * h + (d[:, t] * uu[:, t])[..., None] * b[:, t, None, :]
        ys.append(torch.einsum("ben,bn->be", h, c[:, t]))
    return torch.stack(ys, dim=1).float(), h.float()


def shadow_rerun_hybrid(model, lm, prompts, run) -> dict:
    """``run``'s forward calls once more on the kernel route, teacher-forced
    on its tokens, with every Mamba scan launch held to the plain version on
    the kernel route's own inputs (phase 12's tolerance) and every
    attention launch too (phase 8's). Returns the launches checked and the
    largest errors of each, and the largest gap of the rerun's logits from
    the served run's."""
    import torch
    from repro_torch.kernels import ops

    real_scan, real_attn = ops.selective_scan, ops.gqa_flash_attention
    scan_errs, attn_errs = [], []

    def checked_scan(delta, u, bm, cm, A, h0, *, mode="cuda"):
        out = real_scan(delta, u, bm, cm, A, h0, mode=mode)
        plain = real_scan(delta, u, bm, cm, A, h0, mode="torch")
        scan_errs.append(mamba_err(out, plain, f"served scan launch {len(scan_errs)} "
                                   f"({tuple(delta.shape)})"))
        return out

    def checked_attn(q, k, v, *, mode="cuda", **kw):
        out = real_attn(q, k, v, mode=mode, **kw)
        want = real_attn(q, k, v, mode="torch", **kw).double()
        tol = FLASH_TOL[str(q.dtype).split(".")[-1]]
        diff = (out.double() - want).abs()
        check(bool(torch.isfinite(out).all()) and bool((diff <= tol + tol * want.abs()).all()),
              f"served attention launch {len(attn_errs)} ({tuple(q.shape)}): max abs err "
              f"{float(diff.max()):.3g} beyond {tol}")
        attn_errs.append(float(diff.max()))
        return out

    try:
        ops.selective_scan, ops.gqa_flash_attention = checked_scan, checked_attn
        gaps = replay_gaps(model, lm, prompts, run, 0.0)
    finally:
        ops.selective_scan, ops.gqa_flash_attention = real_scan, real_attn
    return dict(launches=len(scan_errs), max_abs_err=max(scan_errs),
                attn_launches=len(attn_errs), attn_err=max(attn_errs),
                rerun_gap=max(g[0] for g in gaps))


#: prompt seeds of the hybrid witness: the served prompts' and two more
WITNESS_SEEDS = (SEED, SEED + 1, SEED + 2)


def hybrid_witness(model, lm, prompts) -> dict:
    """The serving prefill of ``prompts`` by three routes: the kernels', the
    plain versions', and the plain route with attention and the scan in
    float64; the gaps of their last-position logits. Inside the kernel
    route every launch is also computed by its plain version and in float64
    on the same inputs: for attention, the outputs more than one bf16 ulp
    from float64 (rounded to bf16) are counted for the kernel and for the
    plain version; for the scan, each one's largest error from float64 on
    y and the final state. Kernels no further from float64 than their
    plain versions, launch by launch, while the whole routes' logits lie
    apart, show the model's amplification of last-bit differences, not a
    fault of the kernels."""
    import torch
    from repro_torch.kernels import ops

    real_scan, real_attn = ops.selective_scan, ops.gqa_flash_attention
    attn, scan = [], []

    def counted_attn(q, k, v, *, mode="cuda", **kw):
        out = real_attn(q, k, v, mode=mode, **kw)
        plain = real_attn(q, k, v, mode="torch", **kw)
        ref = attention64(q, k, v, **kw)
        ku, pu = bf16_ulps(out, ref), bf16_ulps(plain, ref)
        attn.append((int((ku > 1).sum()), int((pu > 1).sum()), float(ku.max()), float(pu.max()),
                     out.numel()))
        return out

    def counted_scan(delta, u, bm, cm, A, h0, *, mode="cuda"):
        out = real_scan(delta, u, bm, cm, A, h0, mode=mode)
        plain = real_scan(delta, u, bm, cm, A, h0, mode="torch")
        ref = selective_scan_f64(delta, u, bm, cm, A, h0)
        err = lambda got: max(float((g - r).abs().max()) for g, r in zip(got, ref))  # noqa: E731
        scan.append((err(out), err(plain)))
        return out

    def logits():
        cache = model.init_cache(prompts.shape[0], prompts.shape[1] + 1, device=prompts.device)
        return model.prefill(lm, {"tokens": prompts}, cache)[0][:, -1, :].float()

    try:
        ops.selective_scan, ops.gqa_flash_attention = counted_scan, counted_attn
        kern = logits()
        lm.mode = "torch"
        ops.selective_scan, ops.gqa_flash_attention = real_scan, real_attn
        plain = logits()
        ops.selective_scan, ops.gqa_flash_attention = selective_scan_f64, attention64
        plain64 = logits()
    finally:
        ops.selective_scan, ops.gqa_flash_attention = real_scan, real_attn
        lm.mode = None
    gap = lambda a, b: float((a - b).abs().max()) / float(b.abs().max())  # noqa: E731
    return dict(kernel_vs_plain=gap(kern, plain), plain_vs_f64=gap(plain, plain64),
                kernel_vs_f64=gap(kern, plain64),
                attn_outputs=sum(a[4] for a in attn),
                attn_kernel_over_1ulp=sum(a[0] for a in attn),
                attn_plain_over_1ulp=sum(a[1] for a in attn),
                attn_kernel_max_ulps=max(a[2] for a in attn),
                attn_plain_max_ulps=max(a[3] for a in attn),
                scan_launches=len(scan), scan_kernel_err=max(e[0] for e in scan),
                scan_plain_err=max(e[1] for e in scan))


def jamba_f32_decode_check(device, requests: int, prompt_len: int) -> float:
    """jamba-v0.1-52b at float32 compute and float32 weights, cut to one
    period (8 layers, 13.3 B parameters, 53.2 GB) so that it fits the card:
    decode steps from one state by both routes (``twin_decode_gaps``) must
    agree within 1e-4 of the logits' scale (float32 sums in another order
    through 8 layers), and in argmax wherever the top-2 gap is wider.
    Returns the largest gap."""
    import dataclasses as dc

    import torch
    from repro_torch.launch import serve

    tol = 1e-4
    f32 = dc.replace(jamba_served(), n_layers=8, param_dtype=torch.float32, compute_dtype=torch.float32)
    model, lm, prompts = serve.prepare(f32, requests=requests, prompt_len=prompt_len, seed=SEED,
                                       device=device)
    gaps = twin_decode_gaps(model, lm, prompts, tol)
    for t, (rel, _, wide_flips) in enumerate(gaps):
        check(rel <= tol, f"jamba f32 decode step {t} from one state: plain and kernel routes' "
              f"logits differ by {rel:.3g} of their scale (tol {tol})")
        check(wide_flips == 0, f"jamba f32 decode step {t}: argmax differs where the top-2 gap "
              f"exceeds {tol} of the scale")
    return max(g[0] for g in gaps)


def phase_serve_jamba(device, smoke: bool = False, requests: int = 8, prompt_len: int = 512,
                      n_gen: int = 32) -> dict:
    """The hybrid serving path: admission of 8 streams on H100_HOST through
    the CUDA scorer, then ``jamba-v0.1-52b`` at its published widths cut to
    16 layers with bf16 weights (``jamba_served``; drawn on the card from
    SEED) serving 8 requests of 512 prompt tokens and 32 generated tokens by
    the kernel route. The launches must be 14 x 32 mamba_scan (7 Mamba
    sub-layers per period) and 2 x 32 flash_attention (one attention
    sub-layer per period).

    MoE's top-2 routing and capacity drops flip on last-bit differences, so
    two correct bf16 routes give logits far apart. So every scan and
    attention launch of the served run is held to the plain version on its
    own inputs (``shadow_rerun_hybrid``); the teacher-forced plain-route
    replay is measured beside ``hybrid_witness`` on ``WITNESS_SEEDS``, not
    held to a limit, and each kernel must lie, launch by launch, no further
    from float64 than twice its plain version there; at float32
    compute on a one-period cut, decode steps from one state must agree
    across the routes (``jamba_f32_decode_check``); a SMOKE run at f32
    compute with a prompt longer than SMOKE's window of 64, so the window
    bites, must give the card the CPU's tokens. Returns the path's numbers.
    ``smoke`` and the sizes shrink it for a rehearsal on the CPU."""
    import gc
    import math

    import torch
    from repro_torch.core import H100_HOST
    from repro_torch.kernels import consolidation as kc
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels import mamba_scan as km
    from repro_torch.launch import serve
    from repro_torch.models import hybrid

    tol = 2e-2
    on_card = device.type == "cuda"
    if on_card:
        gc.collect()
        torch.cuda.empty_cache()
    kc.reset_launches()
    placements = serve.admission_check("jamba-v0.1-52b", requests, host=H100_HOST, device=device)
    check(all(p is not None for p in placements), f"admission queued a stream: {placements}")
    check(sum(kc.LAUNCHES.values()) > 0 or not on_card,
          "admission never launched consolidation_scores")
    print(f"[13 serve jamba] admission of {requests} streams on 2 x {H100_HOST.name}: "
          f"{placements}, consolidation_scores launches {sum(kc.LAUNCHES.values())}")

    cfg = jamba_served(smoke)
    t0 = time.perf_counter()
    model, lm, prompts = serve.prepare(cfg, requests=requests, prompt_len=prompt_len, seed=SEED,
                                       device=device)
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in lm.parameters())
    weight_bytes = sum(p.numel() * p.element_size() for p in lm.parameters())
    n_periods = cfg.n_layers // hybrid.PERIOD
    n_attn = n_periods * sum(hybrid.is_attn(cfg, i) for i in range(hybrid.PERIOD))
    n_mamba = cfg.n_layers - n_attn
    serve.generate(model, lm, prompts, 2)  # warm-up: cuBLAS handles, allocator, the builds
    if on_card:
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    km.reset_launches()
    kf.reset_launches()
    run = serve.generate(model, lm, prompts, n_gen, keep_logits=True)
    scans, flashes = sum(km.LAUNCHES.values()), sum(kf.LAUNCHES.values())
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    check(scans == n_mamba * n_gen or not on_card,
          f"serving launched mamba_scan {scans} times, want {n_mamba} x {n_gen}")
    check(flashes == n_attn * n_gen or not on_card,
          f"serving launched flash_attention {flashes} times, want {n_attn} x {n_gen}")
    check(all(key[0] == "model" for key in km.LAUNCHES), f"scan entries {sorted(km.LAUNCHES)}")
    check(all(key[0] in ("mma", "mma_split") for key in kf.LAUNCHES),
          f"serving's flash launches left the tensor-core entries: {sorted(kf.LAUNCHES)}")
    check(tuple(run.tokens.shape) == (requests, n_gen), f"tokens {tuple(run.tokens.shape)}")
    check(bool(((run.tokens >= 0) & (run.tokens < cfg.vocab)).all()), "token out of the vocab")
    check(all(bool(torch.isfinite(x.float()).all()) for x in run.logits), "non-finite logits")
    decode_ms = [1e3 * t for t in run.decode_s]
    total = run.prefill_s + sum(run.decode_s)
    state_bytes = sum(math.prod(i.shape) * i.dtype.itemsize
                      for i in model.cache_infos(requests, prompt_len + n_gen).values())
    print(f"[13 serve jamba] {cfg.name} {cfg.n_layers} layers, {n_params / 1e9:.3f} B params "
          f"({weight_bytes / 1e9:.2f} GB, drawn in {init_s:.2f} s), {requests} requests x prompt "
          f"{prompt_len} + {n_gen} tokens: prefill {1e3 * run.prefill_s:.3f} ms, decode "
          f"{statistics.mean(decode_ms):.3f} ms/step (median {statistics.median(decode_ms):.3f}, "
          f"min {min(decode_ms):.3f}, max {max(decode_ms):.3f}), {requests * n_gen / total:.1f} "
          f"tokens/s over {total:.3f} s, peak device memory {peak / 2**30:.3f} GiB (cache and "
          f"states {state_bytes / 1e6:.1f} MB); mamba_scan launches {scans} over "
          f"{len(km.LAUNCHES)} shapes {sorted(km.LAUNCHES)}, flash_attention launches {flashes} "
          f"by entry {by_entry(kf.LAUNCHES)}")

    shadow = shadow_rerun_hybrid(model, lm, prompts, run)
    check(shadow["launches"] == n_mamba * n_gen and shadow["attn_launches"] == n_attn * n_gen,
          f"the shadow rerun checked {shadow['launches']} scan and {shadow['attn_launches']} "
          f"attention launches")
    print(f"[13 serve jamba] shadow rerun of the {n_gen} calls: all {shadow['launches']} scan "
          f"launches within atol {MAMBA_ATOL} rtol {MAMBA_RTOL} of the plain version on their own "
          f"inputs, max abs err {shadow['max_abs_err']:.3g}; all {shadow['attn_launches']} "
          f"attention launches within phase 8's tolerance, max abs err {shadow['attn_err']:.3g}; "
          f"rerun logits vs the served run's {shadow['rerun_gap']:.3g} of their scale")

    # the plain route, teacher-forced on the kernel route's tokens: measured
    before = (sum(km.LAUNCHES.values()), sum(kf.LAUNCHES.values()))
    lm.mode = "torch"
    gaps = replay_gaps(model, lm, prompts, run, tol)
    lm.mode = None
    check((sum(km.LAUNCHES.values()), sum(kf.LAUNCHES.values())) == before,
          "the plain route launched a kernel")
    bf16_decode = max(g[0] for g in twin_decode_gaps(model, lm, prompts, tol))
    print(f"[13 serve jamba] plain route teacher-forced over {n_gen} calls (measured, not held "
          f"to {tol}): logits {gaps[0][0]:.4g} of their scale apart at the prefill, "
          f"{max(g[0] for g in gaps[1:]) if n_gen > 1 else 0.0:.4g} at most over the decode "
          f"steps; argmax differs in {sum(g[1] for g in gaps)} of {requests * n_gen} places, "
          f"{sum(g[2] for g in gaps)} of them where the top-2 gap exceeds {tol} of the scale; "
          f"8 bf16 decode steps each from one state by both routes: logits up to "
          f"{bf16_decode:.4g} apart")
    witnesses = []
    for seed in WITNESS_SEEDS:
        seeded = prompts if seed == SEED else torch.randint(
            0, cfg.vocab, tuple(prompts.shape), device=device,
            generator=torch.Generator(device).manual_seed(seed))
        w = hybrid_witness(model, lm, seeded)
        check(all(math.isfinite(v) for v in w.values()), f"witness: {w}")
        check(w["scan_launches"] == n_mamba, f"the witness read {w['scan_launches']} scans")
        print(f"[13 serve jamba] witness, prefill of the "
              f"{'served prompts' if seed == SEED else f'prompts of seed {seed}'}: last-position "
              f"logits kernel vs plain route {w['kernel_vs_plain']:.4g} of their scale, plain vs "
              f"attention and scan in float64 {w['plain_vs_f64']:.4g}, kernel vs float64 "
              f"{w['kernel_vs_f64']:.4g}; per launch on the kernel route's inputs, of "
              f"{w['attn_outputs']} attention outputs {w['attn_kernel_over_1ulp']} lie more than "
              f"1 bf16 ulp from float64 by the kernel (max {w['attn_kernel_max_ulps']:.4g} ulps) "
              f"and {w['attn_plain_over_1ulp']} by the plain version (max "
              f"{w['attn_plain_max_ulps']:.4g}); the {w['scan_launches']} scans' largest error "
              f"from float64 {w['scan_kernel_err']:.3g} by the kernel, "
              f"{w['scan_plain_err']:.3g} by the plain version")
        # a kernel that rounds where its plain version does not, or masks a
        # row it should see, lands far more outputs away from float64
        check(w["attn_kernel_over_1ulp"] <= 2 * w["attn_plain_over_1ulp"] + 64,
              f"witness seed {seed}: {w['attn_kernel_over_1ulp']} flash outputs lie more than "
              f"1 bf16 ulp from float64, the plain version's {w['attn_plain_over_1ulp']}")
        check(w["scan_kernel_err"] <= 2 * w["scan_plain_err"] + 1e-8,
              f"witness seed {seed}: the scan kernel is {w['scan_kernel_err']:.3g} from float64, "
              f"the plain version {w['scan_plain_err']:.3g}")
        witnesses.append(w)
    out = dict(launches_scan=scans, launches_flash=flashes, prefill_ms=1e3 * run.prefill_s,
               decode_ms=statistics.mean(decode_ms), tokens_per_s=requests * n_gen / total,
               replay_gaps=[g[0] for g in gaps], witnesses=witnesses,
               bf16_decode_from_one_state=bf16_decode, shadow_err=shadow["max_abs_err"], peak_gib=peak / 2**30)
    if not on_card:
        return out

    out.update(profile_serving(model, lm, prompts, run, {
        km: launch_counts("mamba_scan_kernel", km), kf: flash_counts}, "13 serve jamba"))
    del lm, run
    gc.collect()
    torch.cuda.empty_cache()
    out["f32_decode_gap"] = jamba_f32_decode_check(device, requests, prompt_len)
    print(f"[13 serve jamba] float32 compute and weights, one period (8 layers), 8 decode steps "
          f"each from one state by both routes: logits within {out['f32_decode_gap']:.3g} of "
          f"their scale (tol 1e-4), argmax equal wherever the top-2 gap is wider")
    gc.collect()
    torch.cuda.empty_cache()
    smoke_card_matches_cpu("jamba-v0.1-52b", device, "13 serve jamba", prompt_len=80)
    return out


def free_card() -> None:
    """Return the earlier phases' device memory before a phase draws a
    large model."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the smoke runs on the GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  -- fails where the repository is missing

    device = torch.device("cuda")
    smi_line = phase_env()
    phase_build()
    rows = phase_kernel(device)
    n_launch = phase_rack(device)
    check(n_launch > 0, "main path never launched consolidation_scores")
    fleet = phase_fleet(device)
    scatter = phase_pair_scatter(device)
    adaptive = phase_adaptive(device)
    flash = phase_flash(device)
    served = phase_serve(device)
    wkv = phase_rwkv_scan(device)
    served_rwkv = phase_serve_rwkv(device)
    free_card()
    scan = phase_mamba_scan(device)
    served_jamba = phase_serve_jamba(device)

    q = 1024
    print(json.dumps({"kernels": [{
        "name": "consolidation_scores", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/consolidation_scores.cu",
        "replaces": "src/repro/kernels/consolidation.py:65",
        "launches": n_launch,
        "max_abs_err": max(r["max_abs_err"] for r in [*rows.values(), *fleet.values()]),
        "ms": rows[q]["ms"], "plain_ms": rows[q]["plain_ms"],
        "bound_ms": rows[q]["bound_ms"], "bound_by": rows[q]["bound_by"],
        "library_ms": None,
        "shape": f"m=64 T=230 Q={q}",
    }, {
        "name": "pair_scatter", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/pair_scatter.cu",
        "replaces": "src/repro/kernels/telemetry.py:150",
        "launches": adaptive["scatter"],
        "max_abs_err": max(scatter["max_abs_err"], scatter["ref_err"]),
        "ms": scatter["ms"], "plain_ms": scatter["plain_ms"],
        "bound_ms": scatter["bound_ms"], "bound_by": scatter["bound_by"],
        "library_ms": scatter["library_ms"],
        "shape": f"B={scatter['B']} T={scatter['T']} K={scatter['K']}",
    }, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:118",
        "launches": served["launches"] + served_jamba["launches_flash"],
        "max_abs_err": max(r["max_abs_err"] for r in flash.values()),
        **{key: flash[("prefill", "bfloat16")][key]
           for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")},
        "decode": {key: flash[("decode@511", "bfloat16")][key]
                   for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")},
    }, {
        "name": "rwkv6_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rwkv6_scan.cu",
        "replaces": "src/repro/kernels/rwkv6_scan.py:90",
        "launches": served_rwkv["launches"],
        "max_abs_err": max(served_rwkv["shadow_err"],
                           *(max(r["max_abs_err"], r.get("ref_err", 0.0)) for r in wkv.values())),
        **{key: wkv["prefill"][key]
           for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")},
        "decode": {key: wkv["decode"][key]
                   for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")},
    }, {
        "name": "mamba_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mamba_scan.cu",
        "replaces": "src/repro/kernels/mamba_scan.py:66",
        "launches": served_jamba["launches_scan"],
        "max_abs_err": max(served_jamba["shadow_err"],
                           *(max(r["max_abs_err"], r.get("ref_err", 0.0)) for r in scan.values())),
        **{key: scan[("model", "prefill")][key]
           for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")},
        "decode": {key: scan[("model", "decode")][key]
                   for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")},
        "contract": {key: scan[("contract", "prefill")][key]
                     for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")},
    }]}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
