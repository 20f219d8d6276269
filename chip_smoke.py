"""Smoke run of the PyTorch/CUDA port on one GPU: ``python3 chip_smoke.py``.

Drives the port's three main paths on the card -- the online consolidation
engine (``repro_torch.core.ConsolidationEngine``) with the hand-written CUDA
candidate scorer, the adaptive loop (``repro_torch.core.AdaptiveEngine``)
whose streaming D-estimators take their pair statistics from the
hand-written CUDA scatter, and the serving driver
(``repro_torch.launch.serve``), whose dense LM attends through the
hand-written CUDA flash attention -- in nine phases:

  1. environment: torch and CUDA versions, the card's name and power limit;
  2. build: nvcc builds every kernel under ``src/repro_torch/kernels/csrc``;
  3. kernel vs plain version: ``consolidation_scores`` against
     ``consolidation_scores_torch`` on the same inputs (64 servers, Q = 1, 8,
     512, 1024; max abs error <= 1e-5 on both outputs), with median times;
  4. main path, rack scale: 64 servers, 1024 arrivals through the engine;
     the kernel route must place exactly as the plain-version route, the
     criterion-1 queue and a full queue rescan must occur, and a small trace
     must place exactly as the port does on the CPU;
  5. main path, fleet scale: 1024 servers, 4096 arrivals: the kernel against
     its plain version at this width and the rescans' Q = 4096 (<= 1e-5),
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
     and 32, and f32 q on a bf16 cache; device times of the kernel, the plain version and
     ``scaled_dot_product_attention`` (the library call, never used by the
     port), beside the bound;
  9. serving, ``tinyllama-1.1b`` at full width with weights drawn on the
     card: admission of 8 streams on two H100 hosts through the CUDA
     scorer, then 8 requests of 512 prompt tokens and 32 greedy tokens by
     the kernel route, which must launch flash_attention 22 x 32 times; a
     teacher-forced replay on the plain route must give the same logits
     (within 2e-2 of their scale) and argmax wherever the top-2 gap is
     wider; prefill ms, decode ms per step, tokens/s, peak memory and the
     kernel's share of device time under ``torch.profiler``; at the JAX
     package's init scale (near one-hot softmaxes), the prefill's logits by
     the kernel, plain and float64-attention routes, and every layer's
     kernel attention held to the plain version on the same inputs; a SMOKE
     run at float32 compute must give the same tokens on the card as on
     the CPU.

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
    over HBM bandwidth; against the fp32 work over the fp32 peak."""
    import numpy as np

    c = counts.cpu().numpy()
    m, T = c.shape
    Q = int(wtypes.shape[0])
    cand = np.zeros(T, bool)
    cand[wtypes.cpu().numpy()] = True
    rows = int(((c > 0) | cand[None, :]).sum())  # distinct D rows needed
    nnz = int((c > 0).sum())
    nbytes = 4 * (rows * T + 2 * m * T + T + m + Q + 2 * Q * m)
    flops = 2 * nnz * T + 2 * m * T + 5 * Q * m * T
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


def kernel_error(args, label: str) -> float:
    """Max abs error of the kernel against its plain version on ``args``,
    over both outputs; fails above TOL or on a non-finite score."""
    import torch
    from repro_torch.kernels import consolidation as kc

    got, want = kc.consolidation_scores(*args), kc.consolidation_scores_torch(*args)
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    check(all(bool(torch.isfinite(g).all()) for g in got), f"{label}: non-finite scores")
    check(err <= TOL, f"{label}: kernel vs plain max abs err {err:.3g} > {TOL}")
    return err


def phase_kernel(device) -> dict:
    import numpy as np
    from repro_torch.core import kernel_args
    from repro_torch.kernels import consolidation as kc

    rng = np.random.default_rng(SEED)
    cl, counts = kernel_inputs(64, device, rng)
    rows = {}
    for Q in (1, 8, 512, 1024):  # 512: the adaptive queue run's full rescans
        wt = candidate_types(counts, Q, rng)
        args = kernel_args(cl, counts, wt)
        err = kernel_error(args, f"m=64 Q={Q}")
        bound, bound_by = bound_ms(counts, wt)
        kernel = lambda: kc.consolidation_scores(*args)  # noqa: E731
        plain = lambda: kc.consolidation_scores_torch(*args)  # noqa: E731
        rows[Q] = dict(max_abs_err=err, ms=device_ms(kernel), plain_ms=device_ms(plain),
                       call_ms=call_ms(kernel), plain_call_ms=call_ms(plain),
                       bound_ms=bound, bound_by=bound_by)
    print("[3 kernel] consolidation_scores vs plain, m=64 T=230, device ms (per call "
          "with host launch): " + "; ".join(
              f"Q={Q} err={r['max_abs_err']:.3g} kernel {r['ms']:.5f} ({r['call_ms']:.4f}) "
              f"plain {r['plain_ms']:.5f} ({r['plain_call_ms']:.4f}) bound "
              f"{r['bound_ms']:.5f} by {r['bound_by']}" for Q, r in rows.items()))
    return rows


def drive(engine, arrivals, device):
    """One timed run of the main path: (result, wall seconds, launches by Q,
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
            f"kernel launches by Q {launches}, peak device memory {peak / 2**20:.1f} MiB")


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


def device_busy(fn, names=("score_kernel",)) -> tuple[float, dict, float, int]:
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
        busy, named, pwall_prof, _ = device_busy(lambda: eng.run(arrivals[:256]))
        share = kernel_shares(busy, named, pwall_prof,
                              {"score_kernel": sum(kc.LAUNCHES.values())}, "rack")
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
    """The kernel against its plain version at fleet width and the full
    rescans' Q = n, then the fleet-scale main path by the kernel route and by
    the plain-version route on the same trace. Returns the kernel check's
    numbers."""
    import numpy as np
    from repro_torch.core import ConsolidationEngine, kernel_args
    from repro_torch.kernels import consolidation as kc

    rng = np.random.default_rng(SEED + 1)
    cl, counts = kernel_inputs(m, device, rng)
    args = kernel_args(cl, counts, candidate_types(counts, n, rng))
    row = dict(max_abs_err=kernel_error(args, f"m={m} Q={n}"),
               call_ms=call_ms(lambda: kc.consolidation_scores(*args), reps=10),
               plain_call_ms=call_ms(lambda: kc.consolidation_scores_torch(*args), reps=10))
    row["bound_ms"], row["bound_by"] = bound_ms(counts, args[-1])
    del cl, counts, args
    print(f"[5 fleet] consolidation_scores vs plain, m={m} T=230 Q={n}: err "
          f"{row['max_abs_err']:.3g}, per call kernel {row['call_ms']:.5f} ms, plain "
          f"{row['plain_call_ms']:.5f} ms, bound {row['bound_ms']:.5f} ms by {row['bound_by']}")

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
    return row


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
    scorer launches by Q, peak, shadow gap)."""
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
            f"{len(scatter_launches)} shapes), consolidation_scores by Q {score_launches}; "
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
    check(8 in q_score, f"{q_label}: no drain scored at Q = 8")
    print(describe_adaptive(q_label, *q_out))

    if on_card:
        # one segment of a fresh run under the profiler: the device's share
        prof = AdaptiveEngine(servers, drift=drift, scorer="cuda", scatter="cuda",
                              device=device, **kw)
        kc.reset_launches()
        kt.reset_launches()
        busy, named, pwall, _ = device_busy(
            lambda: prof.run(arrivals[:per_segment], segments=1),
            ("pair_scatter_kernel", "score_kernel"))
        share = kernel_shares(busy, named, pwall, {
            "pair_scatter_kernel": sum(kt.LAUNCHES.values()),
            "score_kernel": sum(kc.LAUNCHES.values())}, "adaptive")
        print(f"[7 adaptive] profiled rerun of segment 0: device kernels {busy:.4f} s of "
              f"{pwall:.3f} s wall; {share}")

    return dict(scatter=sum(scatter_launches.values()) + sum(q_scatter.values()),
                score=sum(score_launches.values()) + sum(q_score.values()))

#: (label, B, Sq, Skv, H, Hkv, dh, causal, q_offset): the serving path's
#: shapes (tinyllama-1.1b, 8 requests, prompt 512, 32 tokens, a 672-row
#: padded cache), the edges the path does not reach, and the head dims of
#: the other kernel instances
FLASH_SHAPES = [
    ("prefill", 8, 512, 672, 32, 4, 64, True, 0),
    ("decode@0", 8, 1, 672, 32, 4, 64, True, 0),
    ("decode@511", 8, 1, 672, 32, 4, 64, True, 511),
    ("decode@542", 8, 1, 672, 32, 4, 64, True, 542),
    ("ragged Sq=17", 8, 17, 672, 32, 4, 64, True, 0),
    ("non-causal", 2, 128, 300, 32, 4, 64, False, 0),
    ("llama3.2 prefill", 8, 512, 672, 24, 8, 128, True, 0),
    ("llama3.2 decode@542", 8, 1, 672, 24, 8, 128, True, 542),
    ("SMOKE width dh=16", 2, 33, 70, 4, 2, 16, True, 20),
    ("dh=32", 2, 33, 70, 4, 2, 32, True, 20),
]


def flash_bound_ms(B, Sq, Skv, H, Hkv, dh, causal, q_offset, q_size, kv_size) -> tuple[float, str]:
    """Least time for one call on these inputs: q and out, and the k/v rows
    some query sees, moved once over HBM bandwidth; against 4 dh flops per
    (query, head, visible kv row) over the dense peak of q's dtype (bf16
    tensor cores, or fp32 without TF32)."""
    from repro_torch.kernels.flash_attention import visible_rows

    rows = visible_rows(Sq, Skv, causal, q_offset)
    seen = sum(min(Skv, q_offset + i + 1) for i in range(Sq)) if causal else Sq * Skv
    nbytes = 2 * B * Sq * H * dh * q_size + 2 * B * rows * Hkv * dh * kv_size
    flops = 4 * B * H * dh * seen
    peak = BF16_FLOPS if q_size == 2 else FP32_FLOPS
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def sdpa_form(q, k, v, causal: bool, q_offset: int):
    """The same function by ``scaled_dot_product_attention`` on [B, H, S, dh]
    views (GQA through ``enable_gqa``), with an explicit boolean mask where
    the causal diagonal is offset. Timed as the library call; the port
    never calls it."""
    import torch
    import torch.nn.functional as F

    Sq, Skv = q.shape[1], k.shape[1]
    mask = None
    if causal and q_offset:
        mask = ((q_offset + torch.arange(Sq, device=q.device))[:, None]
                >= torch.arange(Skv, device=q.device)[None, :])
    out = F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask,
        is_causal=causal and not q_offset, enable_gqa=True)
    return out.transpose(1, 2)


def phase_flash(device) -> dict:
    """``flash_attention`` against ``flash_attention_torch`` at every
    FLASH_SHAPES shape in bf16 and f32 (and f32 q on a bf16 cache at one
    decode shape), with device times of the kernel, the plain version and
    SDPA, and the bound. Returns the rows by (label, dtype)."""
    import torch
    from repro_torch.kernels import flash_attention as kf

    gen = torch.Generator(device).manual_seed(SEED + 3)
    cases = [(shape, dt, dt) for shape in FLASH_SHAPES for dt in ("bfloat16", "float32")]
    cases.append((FLASH_SHAPES[2], "float32", "bfloat16"))
    rows = {}
    for (label, B, Sq, Skv, H, Hkv, dh, causal, off), qdt, kvdt in cases:
        q = torch.randn(B, Sq, H, dh, generator=gen, device=device).to(getattr(torch, qdt))
        k, v = (torch.randn(B, Skv, Hkv, dh, generator=gen, device=device)
                .to(getattr(torch, kvdt)) for _ in range(2))
        got = kf.flash_attention(q, k, v, causal=causal, q_offset=off)
        torch.cuda.synchronize()
        want = kf.flash_attention_torch(q, k, v, causal=causal, q_offset=off)
        tol = FLASH_TOL[qdt]
        diff = (got.double() - want.double()).abs()
        err = float(diff.max())
        check(bool(torch.isfinite(got).all()), f"flash {label} {qdt}: non-finite output")
        check(bool((diff <= tol + tol * want.double().abs()).all()),
              f"flash {label} {qdt}/{kvdt}: kernel vs plain max abs err {err:.3g} > {tol}")
        row = dict(max_abs_err=err, tol=tol,
                   ms=device_ms(lambda: kf.flash_attention(q, k, v, causal=causal, q_offset=off)),
                   plain_ms=device_ms(
                       lambda: kf.flash_attention_torch(q, k, v, causal=causal, q_offset=off)))
        if qdt == kvdt:
            lib = sdpa_form(q, k, v, causal, off)
            row["library_err"] = float((lib.double() - want.double()).abs().max())
            row["library_ms"] = device_ms(lambda: sdpa_form(q, k, v, causal, off))
        else:
            row["library_err"] = row["library_ms"] = None  # SDPA takes one dtype
        row["bound_ms"], row["bound_by"] = flash_bound_ms(
            B, Sq, Skv, H, Hkv, dh, causal, off, q.element_size(), k.element_size())
        row["shape"] = (f"B={B} Sq={Sq} Skv={Skv} H={H} Hkv={Hkv} dh={dh} "
                        f"{'causal' if causal else 'non-causal'} q_offset={off} {qdt}/{kvdt}")
        rows[(label, qdt if qdt == kvdt else f"{qdt}/{kvdt}")] = row
        lib_text = ("SDPA n/a" if row["library_ms"] is None else
                    f"SDPA {row['library_ms']:.5f} (err {row['library_err']:.3g})")
        print(f"[8 flash] {label} {qdt}/{kvdt}: err {err:.3g} (tol {tol}), device ms kernel "
              f"{row['ms']:.5f} plain {row['plain_ms']:.5f} {lib_text} bound "
              f"{row['bound_ms']:.5f} by {row['bound_by']}")
    return rows


def bf16_ulps(got, want):
    """|got - want| in bf16 ulps of the larger magnitude, elementwise."""
    import torch

    a, b = got.double(), want.double()
    mag = torch.maximum(a.abs(), b.abs()).clamp_min(2.0 ** -126)
    return (a - b).abs() / torch.exp2(torch.floor(torch.log2(mag)) - 7)


def attention64(q, k, v, *, causal: bool = True, q_offset: int = 0, mode=None):
    """Attention in float64 on the model layout (``attention_ref``), cast to
    q's dtype: a third summation order for the witness below."""
    import torch
    from repro_torch.kernels.ref import attention_ref

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

    def checked(q, k, v, *, causal=True, q_offset=0, mode="cuda"):
        out = real(q, k, v, causal=causal, q_offset=q_offset, mode=mode)
        plain = real(q, k, v, causal=causal, q_offset=q_offset, mode="torch")
        ref = attention64(q, k, v, causal=causal, q_offset=q_offset).double()
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
    lm.attn_mode = "torch"
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
    import dataclasses as dc
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
    check(tuple(run.tokens.shape) == (requests, n_gen), f"tokens {tuple(run.tokens.shape)}")
    check(bool(((run.tokens >= 0) & (run.tokens < cfg.vocab)).all()), "token out of the vocab")
    decode_ms = [1e3 * t for t in run.decode_s]
    total = run.prefill_s + sum(run.decode_s)
    print(f"[9 serve] {cfg.name} {n_params / 1e9:.3f} B params, {requests} requests x prompt "
          f"{prompt_len} + {n_gen} tokens: prefill {1e3 * run.prefill_s:.3f} ms, decode "
          f"{statistics.mean(decode_ms):.3f} ms/step (median {statistics.median(decode_ms):.3f}, "
          f"min {min(decode_ms):.3f}, max {max(decode_ms):.3f}), {requests * n_gen / total:.1f} "
          f"tokens/s over {total:.3f} s, peak device memory {peak / 2**30:.3f} GiB; "
          f"flash_attention launches {n_launch} over {len(launches)} shapes")

    # the plain route, teacher-forced on the kernel route's tokens
    lm.attn_mode = "torch"
    cache = model.init_cache(requests, prompt_len + n_gen, device=device)
    worst_rel, worst_gap_mismatch, flips = 0.0, 0, 0
    for t in range(n_gen):
        if t == 0:
            logits, cache = model.prefill(lm, {"tokens": prompts}, cache)
        else:
            logits, cache = model.decode_step(lm, cache, run.tokens[:, t - 1:t])
        plain, kern = logits[:, -1, :].float(), run.logits[t].float()
        scale = float(kern.abs().max())
        rel = float((plain - kern).abs().max()) / scale
        worst_rel = max(worst_rel, rel)
        check(rel <= tol, f"step {t}: plain and kernel routes' logits differ by {rel:.3g} of "
              f"their scale")
        top2 = kern.topk(2, dim=-1).values
        wide = (top2[:, 0] - top2[:, 1]) > tol * scale
        differ = plain.argmax(-1) != kern.argmax(-1)
        flips += int(differ.sum())
        check(not bool((differ & wide).any()), f"step {t}: argmax differs where the top-2 gap "
              f"exceeds {tol} of the scale")
    lm.attn_mode = None
    check(sum(kf.LAUNCHES.values()) == n_launch, "the plain route launched the kernel")
    print(f"[9 serve] plain route teacher-forced over {n_gen} steps: logits within {worst_rel:.3g} "
          f"of their scale (tol {tol}); argmax differs in {flips} of {requests * n_gen} "
          f"places, none where the top-2 gap exceeds the tolerance")

    # the kernel's share of device time, prefill alone and 8 decode steps
    if not on_card:
        return dict(launches=n_launch, prefill_ms=1e3 * run.prefill_s,
                    decode_ms=statistics.mean(decode_ms), worst_rel=worst_rel)
    kf.reset_launches()
    busy_p, named_p, wall_p, n_p = device_busy(lambda: serve.generate(model, lm, prompts, 1),
                                               ("flash_attention_kernel",))
    share_p = kernel_shares(busy_p, named_p, wall_p,
                            {"flash_attention_kernel": sum(kf.LAUNCHES.values())}, "prefill")
    cache = model.init_cache(requests, prompt_len + n_gen, device=device)
    _, cache = model.prefill(lm, {"tokens": prompts}, cache)

    def decode8():
        c = dict(cache)
        for i in range(8):
            _, c = model.decode_step(lm, c, run.tokens[:, i:i + 1])

    kf.reset_launches()
    busy_d, named_d, wall_d, n_d = device_busy(decode8, ("flash_attention_kernel",))
    share_d = kernel_shares(busy_d, named_d, wall_d,
                            {"flash_attention_kernel": sum(kf.LAUNCHES.values())}, "decode")
    print(f"[9 serve] profiled prefill: {n_p} device kernels, {busy_p:.5f} s of {wall_p:.4f} s "
          f"wall; {share_p}\n[9 serve] profiled 8 decode steps: {n_d} device kernels "
          f"({n_d / 8:.1f} per step), {busy_d:.5f} s of {wall_d:.4f} s wall; {share_d}")

    del lm
    gc.collect()
    witness = jax_scale_witness(cfg, prompts, device)

    # a SMOKE model at float32 compute: the card's tokens are the CPU's
    smoke = dc.replace(get_config("tinyllama-1.1b", smoke=True), compute_dtype=torch.float32)
    s_model, s_lm, s_prompts = serve.prepare(smoke, requests=2, prompt_len=16, seed=SEED,
                                             device="cpu")
    want = serve.generate(s_model, s_lm, s_prompts, 8).tokens
    got = serve.generate(s_model, s_lm.to(device), s_prompts.to(device), 8).tokens
    check(torch.equal(got.cpu(), want), f"SMOKE f32: card tokens {got.tolist()} != CPU "
          f"{want.tolist()}")
    print(f"[9 serve] SMOKE tinyllama at f32 compute, 2 x (16 + 8): card tokens == CPU tokens "
          f"{want[0].tolist()}")
    return dict(launches=n_launch, prefill_ms=1e3 * run.prefill_s,
                decode_ms=statistics.mean(decode_ms), worst_rel=worst_rel, witness=witness)


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

    q = 1024
    print(json.dumps({"kernels": [{
        "name": "consolidation_scores", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/consolidation_scores.cu",
        "replaces": "src/repro/kernels/consolidation.py:65",
        "launches": n_launch,
        "max_abs_err": max(r["max_abs_err"] for r in [*rows.values(), fleet]),
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
        "launches": served["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in flash.values()),
        **{key: flash[("prefill", "bfloat16")][key]
           for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")},
        "decode": {key: flash[("decode@511", "bfloat16")][key]
                   for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")},
    }]}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
