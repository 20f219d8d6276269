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
flash kernel, with a dense LM on an int8 KV cache, the MoE LM, the Whisper
encoder-decoder and the InternVL vlm, all attending through the flash
kernel (non-causal for Whisper's encoder and cross-attention), and the
fleet-health plane with the fused closed loop, whose
CUSUM scan and action loops are hand-written CUDA (``cusum_scan``,
``fleet_actions``), with the observability plane and the float64 oracle's
tensor twins, the server axis over a one-rank process group, and the
training path of every LM family (``distributed.train_step``, whose
gradients run through the flash, WKV and scan kernels' autograd
Functions) -- in twenty-three phases (14 runs after 7; 18-23 after 13;
15, 16 and 17 last), then the purity audit over all of it:

  1. environment: torch and CUDA versions, the card's name and power limit;
  2. build: nvcc builds every kernel under ``src/repro_torch/kernels/csrc``;
  3. kernel vs plain version: ``consolidation_scores`` by both of its paths
     (the single pass and the table path, whose outputs must be bitwise
     equal) against ``consolidation_scores_torch`` on the same inputs (64
     servers, Q = 1, 8, 16, 32, 64, 128, 230, 512, 1024, 4096, on either
     side of the crossover; max abs error <= 1e-5 on both outputs), with
     median device times of each path;
  4. main path, rack scale: 64 servers, 1024 arrivals through the engine,
     whose event loop runs as replays of a captured CUDA graph of S
     micro-events, each scoring every grid type once (Q = 230, the table
     path); µs per decision, loop reads (one per replay) against their
     bound ceil((4n + 8) / S); the kernel route must place exactly as the
     plain-version route, the criterion-1 queue and a full queue rescan
     must occur, a profiled rerun must see exactly the launches the
     wrapper's per-replay tally counts, and a small trace must place
     exactly as the port does on the CPU, with the same loop counters and
     at most its loop reads plus the fixed copies in and out as
     synchronizing calls;
  5. main path, fleet scale: 1024 servers, 4096 arrivals: the kernel by both
     paths against its plain version at this width, at Q = 1, 8, the
     loop's Q = 230 and 4096 (<= 1e-5, the paths bitwise equal), then the
     engine with the kernel route (µs per decision, loop reads against
     their bound), which must place exactly as the plain-version route on
     the same trace;
  6. pair_scatter vs plain versions: the contract entry against
     ``pair_scatter_torch`` at B = 0, 1, 7, 300, 4096, 9000, T = 17, 32,
     230 and K = 1 (1-D), 1, 2, 3 (atol 2e-5, rtol 1e-5), each bitwise equal
     on a rerun (and the banked entry at m = 5, B = 300, K = 3 for each T),
     and against the float64 reference at one shape, with device
     times beside the ``index_add_`` scatter-add form at B = 4096 and 16 (a
     host-alternating update's size), T = 230, K = 2; the banked entry
     against ``pair_scatter_banked_torch`` (same tolerance, bitwise equal
     reruns) at the rack stream's segments (m = 64,
     B = 256 and 512), a fleet block (m = 1024, B = 4096), a block with -1
     and past-the-space keys and one past the sort's shared memory (B =
     9000), against the float64 reference at m = 64, B = 512, with device
     times beside the bound and the dense ``index_add_`` form;
  7. adaptive loop, rack scale, ``scorer='cuda'`` and ``scatter='cuda'``:
     64 servers, 8 segments of 256 arrivals from the uniform prior 0.0, a
     congestion drift at segment 4; then 3 segments of 512 arrivals from
     the profiled prior, a drift at segment 1, where every segment must
     queue and rescan its whole queue. Each run twice: host-alternating,
     where every estimator update is replayed on shadow estimators with
     the plain scatter, whose tables must agree after every segment, and
     the contract entry's launches must be exactly the updates that had a
     co-run; and in stream mode (``stream=True``), where the banked entry
     must launch exactly once per segment, a shadow bank on the plain
     scatter must agree after every segment, segment 0 must place as the
     host-alternating run with estimators within 1e-4 of its float64 ones,
     and the first later divergence is reported (float32 device state can
     break a near-tie); the estimator refresh ms and wall per segment of
     both modes side by side. Segment 0 of the first must place as the
     plain engine on the prior D, and a small adaptive run on the card,
     which queues, must equal the same run on the CPU, on each path. Then
     stream mode at fleet width (1024 servers, 4 segments of 4096 arrivals,
     congestion from segment 2): segment 0 must place as the plain engine
     on the prior D, the banked entry launch once per segment and a shadow
     bank on the plain scatter agree after every segment; wall and refresh
     ms per segment and peak memory. Every segment's loop reads within
     their bound;
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
     at the serving prefill (B 8, S 512, H 64, dh 64, bf16 r/k/v), the
     same under strong decays (wlog = -exp(U[-6, 2])), decode (S 1) from a
     nonzero state, ragged S = 17 and 33, the SMOKE head size dh 16 and
     float32 r/k/v; every bf16 call with S > 1 must run the chunked
     tensor-core entry and every other the sequential one; at the prefill,
     under strong decays and at S = 33 the kernel may lie no further from
     the float64 recurrence than twice the plain version; device times of
     the kernel and the plain version beside the bound (no library call
     computes WKV6);
 11. serving, ``rwkv6-7b`` at full width with weights drawn on the card
     and the decay's ``w_base`` / ``w_lora_b`` perturbed (at the init they
     make the decay uniform): admission of 8 streams on two H100 hosts,
     then 8 requests of 512 prompt tokens and 32 greedy tokens by the kernel
     route, which must launch rwkv6_scan 32 x 32 times (32 prefill calls
     on the chunked entry, 992 decode steps on the sequential one); a
     shadow rerun
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
     device times of the kernel and the plain versions beside the bound and,
     for the model entry, the SFU's floor for its exponentials (no library
     call computes the selective scan);
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
     same tokens on the card as on the CPU;
 14. the fleet-health plane and the fused closed loop:
     ``AdaptiveEngine(fleet=FleetController())`` at rack width (64 servers,
     8 segments of 256 arrivals from the prior 0.0, server 5 in a gradual
     decay) on the host-alternating path and through
     ``run(device_loop=True)``: placements, queue decisions, health events
     (kind, server, segment), observations, pool routing, active masks and
     the ring total must be identical, D and the CUSUM state within 1e-5,
     an eviction must requeue work into the next segment, and every
     ``cusum_scan`` launch (bit for bit) and ``fleet_actions`` launch
     (equal outputs) of both runs is held to its plain version on its own
     inputs; each fused segment's body (all but its event loop) under
     torch's sync debug mode set to "error", and the fused run again under
     its warnings (every synchronizing call, by caller); then fleet width (1024 servers, 4
     segments of 4096) on both paths, which must decide identically; wall
     and loop reads per segment of both paths, both kernels' device ms
     beside their plain versions, bounds and chain floors (an acting and a
     quiet launch of ``fleet_actions``); then seeded launches held to their
     plain versions (``seeded_fleet_kernels``): ``cusum_scan`` at the rack
     and fleet blocks and on a block where a server's rows name two pool
     rows and at 9216 servers (state in global memory), ``fleet_actions``
     at m 64 and 1024 acting (a pool handed over twice) and quiet, an evict
     pass that stops at one active server, and acting at m 14504;
 15. observability and the oracle (ROADMAP items 3 and 7; run last): the engine at
     rack width (64 servers, 1024 arrivals) and fleet width (1024, 4096)
     with ``metrics=True, record=True``, whose placements and queue
     decisions must equal the flags-off run's (phase 5's at fleet width),
     whose counters must equal ``LoopStats`` and the result's counts and
     whose decision ring must rebuild every placement
     (``explain.check_reconstruction``); µs per decision on and off, and
     kernels and device µs per step on and off in a profiled rerun of the
     first 64 arrivals, the flags-off count per step equal to phase 4's; a small
     trace with both flags whose frame and ring on the card equal the CPU's
     (integer columns exactly, floats within 1e-5); phase 14's rack again
     with both flags on the host-alternating path and the fused loop
     (segment body under the sync debug mode's "error"): phase 14's
     decisions, counters equal to each other and to the health events,
     rings' integer columns equal, wall per segment on and off;
     ``explain.attribute_run`` over a recorded adaptive rack run (64
     servers, 3 x 32), which must telescope to each segment's regret within
     1e-5; ``local_search_torch`` at 64 servers from a greedy packing made
     on half the rack, by the kernel (one launch per iteration) and by its
     plain version, which must make the same moves, then at 1024 servers
     where memory allows, ms per iteration and peak memory; and
     ``admission_check(metrics=True)``;
 16. the server axis (ROADMAP item 8; run last) at one rank of an NCCL
     group (``ServerAxis.over_process_group()``, destroyed at the phase's
     end): a. ``greedy_sequence_hier`` on the dense axis with 8 and 64 pods
     at 1024 servers over phase 5's 4096 arrival types, from an empty fleet
     and from a half-full one with ``col0`` supplied, bitwise equal to the
     flat ``greedy_sequence`` (placements and counts), µs and kernels per
     decision; b. ``run_trace(axis=)`` on phase 4's and 5's traces (cuda
     scorer): placements, queue decisions and ``LoopStats`` equal to their
     dense runs, finish times within 1e-5, µs per decision beside them,
     collectives per micro-event from the axis tally, every scorer launch
     of one captured block held to the plain version (the block rerun
     eagerly with a tape, ending bitwise where the replay did); the same
     with telemetry, metrics and record at rack width (the frame and the
     ring's integer columns equal, floats within 1e-5); c. the dense axis
     profiles phase 4's kernels per step (±0.5), beside the sharded loop's;
     d. phase 14's rack through the fused loop on the axis with metrics and
     record (segment body under the sync debug mode's "error"): phase 14's
     decisions, events, routing, masks, telemetry ring, D and detector
     within 1e-5, phase 15's counters and decision ring, every
     ``cusum_scan`` and ``fleet_actions`` launch held to its plain version,
     wall per segment; e. ``cusum_update_sharded``,
     ``bank_update_sharded``, ``greedy_sequence_sharded`` and
     ``resolve_leaders_device`` bitwise equal to the dense entries;
 17. the purity audit (ROADMAP item 9; run last): ``repro_torch.analysis.
     run_all`` on the card over every registered hot entry at m = 64 and
     1024 (T = 230, observation blocks of 512 and 8192 rows, the LM kernels
     at their serving shapes): the dispatch walk (host reads, data-dependent
     shapes, float64 on a device tier), each entry again under the sync
     debug mode "error", ``cuobjdump``'s registers, static shared memory and
     local memory of all seven built libraries, and the capture guard with
     real graph captures (a rerun builds and captures nothing). Any
     unbaselined finding fails the run; a planted ``.item()`` must be caught
     by the dispatch walk and the sync mode. Then
     ``examples/torch_closed_loop_adaptive.py`` at smoke size (4 segments)
     on the card, whose placements must equal its CPU run's;
 18. serving on an int8 KV cache (ROADMAP item 10e; run after 13):
     ``tinyllama-1.1b`` at full width with ``kv_cache_dtype='int8'``, the
     same admission and 8 x (512 + 32) tokens as phase 9 (``serve_arch``:
     exactly 22 x 32 flash launches on the tensor-core entries, finite
     logits, the teacher-forced plain-route replay within 2e-2 of the
     logits' scale and the same argmax wherever the top-2 gap is wider,
     prefill and decode ms, peak memory, kernels per decode step and the
     kernel's share under torch.profiler); the cache's bytes beside the
     bf16 cache's; the int8 route's attention (the visible rows' codes and
     scales dequantized to a fresh bf16 buffer, then the kernel) at the
     prefill and decode@542, held to the plain version, its device ms
     beside the kernel's alone, the plain route's, SDPA's on the
     dequantized rows and a bound that reads the codes and scales once;
 19. the MoE LM (item 10d): ``moonshot-v1-16b-a3b`` at its published
     widths and depth (48 layers, 64 experts, top 6) with bf16 weights
     (28.06 B parameters, 56.1 GB, held to the count reckoned from the
     widths) through ``serve_arch`` (48 x 32 flash launches); then the
     kimi and moonshot SMOKE models at f32 compute on the card against the
     CPU (``smoke_card_matches_cpu``: teacher-forced logits within 1e-3,
     tokens equal; kimi at seeds 0, 1 and 2, each up to a near-tie, where
     the same run with float32 caches on both devices must give equal
     tokens); kimi's published dh of 112 is not one the kernel takes;
 20. the encoder-decoder (item 10d): ``whisper-medium`` at full width (24 +
     24 layers over 1500 frame embeddings), 8 x (416 + 32) tokens through
     ``serve_arch``: 24 encoder + 24 x 32 self + 24 x 32 cross flash
     launches; the kernel's non-causal uses held to the plain version at
     these shapes with device ms beside SDPA and the bound (the encoder's
     self-attention, Sq = Skv = 1500; cross-attention at the prefill, Sq
     416, and at decode on the split entry); the SMOKE card-vs-CPU check;
 21. the vlm (item 10d): ``internvl2-2b`` at full width (24 layers, dh
     128), 256 patch embeddings before each 512-token prompt, 32 generated,
     through ``serve_arch`` (24 x 32 flash launches), the cache sized for
     the patches; the SMOKE card-vs-CPU check;
 22. training the dense family (item 10f): ``tinyllama-1.1b`` at full
     width through ``launch.train`` (6 steps of 8 x 1024, exactly 264
     flash launches, a falling loss, step ms, tokens/s, peak memory), the
     attention's gradient at the training shape against the plain version
     and float64, and at depth 2 a float32 step on the card against the
     CPU's, two microbatches against one and a resumed run bit for bit;
 23. training the other families (item 10s): ``rwkv6-7b`` at depth 4, a
     one-period ``jamba-v0.1-52b`` with 2 experts on Adafactor,
     ``moonshot-v1-16b-a3b`` at depth 2, ``whisper-medium`` and
     ``internvl2-2b`` whole, at published widths through ``make_train_step``
     (4 steps on one 4 x 1024 batch: every leaf's gradient finite and
     nonzero, exact flash, WKV and scan launches, a falling loss, step ms,
     tokens/s, peak memory at most 72 GiB); the WKV and scan Functions and
     whisper's cross and encoder attention at the training shape against
     the plain version and float64, with the kernels' rows there; each
     SMOKE model's float32 loss and gradients on the card against the CPU.

Each of 18-23 prints its wall seconds. Then a JSON line with each kernel's numbers, the ``nvidia-smi`` name/power
line, and a last JSON line ``{"ok": true, "device": {...}}``. Any failed
check raises, so the script exits nonzero; without a CUDA device, or
without the repository beside it, it exits nonzero before printing a result.
Imports nothing of JAX and nothing of the JAX package ``repro``.
"""
from __future__ import annotations

import collections
import contextlib
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
#: ex2 per second on the SFU: 16 per SM per clock, 132 SMs at the 1.98 GHz
#: boost clock (H100 SXM; Hopper tuning guide's throughput table)
SFU_EX2_PER_S = 16 * 132 * 1.98e9
#: the fleet kernels' chain floors: cycles of one dependent fp32 FMUL or
#: FADD and of one dependent shared-memory load (``tools/sm_latency.cu``
#: measures them on the card), at the 1.98 GHz boost clock
FP32_DEP_CYCLES = 4
SMEM_ROUND_TRIP_CYCLES = 30
CLOCK_HZ = 1.98e9
TOL = 1e-5
#: the numbers every row of the kernels line carries
KERNEL_KEYS = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")
#: and the fleet kernels' rows their chain floor beside the bound
FLEET_KERNEL_KEYS = KERNEL_KEYS + ("chain_ms",)
#: grid types: the candidates the event loop scores per micro-event (Q = T)
GRID_T = 230
#: synchronizing calls of one engine run besides the loop's reads: the
#: trace's three copies to the card, the deadlock flag, four result arrays,
#: makespan and max degradation
FIXED_COPIES = 10
#: pair_scatter vs its plain version: f32 sums of B products in a different
#: order (tests/test_kernels.py's bound for the Pallas kernel)
SCATTER_ATOL, SCATTER_RTOL = 2e-5, 1e-5
#: flash_attention vs its plain version (tests/test_kernels.py's bounds for
#: the Pallas kernel): a bf16 output rounds once, f32 sums run in another order
FLASH_TOL = {"bfloat16": 2e-2, "float32": 2e-5}
#: the main path's runs that phase 15 compares its flagged runs with: phase
#: 4's profiled kernels per step, phase 5's fleet run
MAIN_RUNS: dict = {}


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


#: the row of the event loop's own call: every grid type once, in order
LOOP_Q = "230 (every grid type once)"


def loop_types(device):
    """The candidate types the event loop scores per micro-event: every grid
    type once (``arange(T)``), so every server's D is read in full."""
    import torch

    return torch.arange(GRID_T, dtype=torch.int32, device=device)


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
#: pair_scatter's: each entry's sort (the contract's, the bank's), then the
#: accumulate both share
SCATTER_KERNELS = ("chunk_sort_kernel", "bucket_kernel", "accumulate_kernel")


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
    # 230 random types (repeats, half absent everywhere) beside the loop's
    # own call on every grid type once; 512: the adaptive queue run's queue;
    # the crossover lies among 16..128; 4096: the fleet's Q at rack width
    qs = sorted({1, 8, 16, kc.CROSSOVER_Q, 2 * kc.CROSSOVER_Q, 128, GRID_T, 512, 1024, 4096})
    for Q in qs:
        args = kernel_args(cl, counts, candidate_types(counts, Q, rng))
        rows[Q] = score_row(args, counts, f"m=64 Q={Q}")
    rows[LOOP_Q] = score_row(kernel_args(cl, counts, loop_types(device)), counts,
                             f"m=64 Q={LOOP_Q}")
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


def reads_bound(n: int) -> int:
    """The most loop reads a run of ``n`` arrivals may make: one per block
    of S micro-events over the step budget 4N + 8 of its capacity N."""
    from repro_torch.core.engine import capacity
    from repro_torch.core.engine_torch import BLOCK_STEPS

    steps = 4 * capacity(n) + 8
    return -(-steps // min(BLOCK_STEPS, steps))


def check_reads(res, label: str) -> None:
    n = len(res.placements)
    check(res.stats.host_syncs <= reads_bound(n),
          f"{label}: {res.stats.host_syncs} loop reads > {reads_bound(n)}")


def describe(res, wall, launches, peak) -> str:
    s, n = res.stats, len(res.placements)
    return (f"wall {wall:.3f} s, {1e6 * wall / n:.1f} us/decision, {s.events} micro-events, "
            f"{s.host_syncs} loop reads = graph replays of S={s.block_steps} micro-events "
            f"(bound {reads_bound(n)}), {s.drain_full_scans} full rescans, "
            f"queued {sum(res.was_queued)}/{n}, makespan {res.makespan:.6f} s, "
            f"kernel launches by (path, Q) {launches}, peak device memory {peak / 2**20:.1f} MiB")


def count_syncs(fn) -> tuple[int, dict]:
    """Synchronizing CUDA calls made by ``fn`` (the trace's copy to the card,
    the loop's reads, the result copies), as torch's sync debug mode reports
    them: (count, count by the calling file and line)."""
    import warnings

    import torch

    # the mode's first use flags a call inside torch.cuda itself: switch it
    # once before recording
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.cuda.set_sync_debug_mode("warn")
        torch.cuda.set_sync_debug_mode("default")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    flagged = [w for w in caught if "synchroniz" in str(w.message)]
    where = collections.Counter(f"{pathlib.Path(w.filename).name}:{w.lineno}" for w in flagged)
    return len(flagged), dict(where)


def device_busy(fn, names=SCORE_KERNELS) -> tuple[float, dict, float, int]:
    """What torch.profiler saw of ``fn`` on the device: (seconds of all
    device kernels, {name: (seconds, launches)} of the kernels whose name
    contains each of ``names``, wall seconds of the profiled call, number of
    device kernels). Kernel times are self device times on one stream, so
    they do not overlap; the wall includes the profiler's overhead."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # one synchronized launch and a pause first, a pause last: launches
        # right after the tracer starts can go unrecorded (a profiled
        # prefill once missed two of its 22 attention launches with the
        # launch alone)
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        time.sleep(0.05)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        time.sleep(0.05)
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    seconds = lambda evs: 1e-6 * sum(e.self_device_time_total for e in evs)  # noqa: E731
    named = {}
    for name in names:
        hits = [e for e in kernels if name in e.name]
        named[name] = (seconds(hits), len(hits))
    return seconds(kernels), named, wall, len(kernels)


def device_busy_counted(fn, names, counted, reset) -> tuple[float, dict, float, int, dict]:
    """``device_busy`` of ``fn`` with the wrappers' launch counts taken
    afresh (``reset`` zeroes them, ``counted`` reads them by kernel name),
    and those counts. A trace can lose kernel records: now and then one, in
    a long window (8 decode steps of rwkv6-7b, ~21000 kernels) as in a short
    one; and in some runs every window of the rwkv6-7b decode and of the
    jamba prefill and decode lost exactly one scan launch, where the same
    jamba window profiled in a process of its own lost none
    (``tools/profiler_loss.py``). A window is not rerun: in a whole run on
    an H100 the rerun of a window that had lost records lost them again in
    6 of 7 windows, at up to ~40 s a window; ``kernel_shares`` reports such
    a window's shares as not measured."""
    reset()
    busy, named, wall, n = device_busy(fn, names)
    want = counted()
    lost = {name: (named[name][1], k) for name, k in want.items() if named[name][1] != k}
    if lost:
        print(f"chip_smoke: the profiled window's trace saw (launches, counted) {lost} in {n} "
              f"device kernels", file=sys.stderr)
    return busy, named, wall, n, want


def kernel_shares(busy: float, named: dict, wall: float, counted: dict, label: str) -> str:
    """The profiled shares as text. Fails if the trace saw a kernel more
    often than its wrapper counted launches. Where it saw one less often,
    the trace lost records: the
    shares are then not measured (the wrappers' counts, which the phases
    check, stand), and the busy share is a lower bound."""
    if busy <= 0:
        return "the profiler saw no device time: busy share not measured"
    extra = {name: (n, counted[name]) for name, (_, n) in named.items() if n > counted[name]}
    check(not extra, f"{label}: the profiler saw more launches than the wrappers counted "
          f"(seen, counted): {extra}")
    short = {name: (n, counted[name]) for name, (_, n) in named.items() if n < counted[name]}
    if short:
        return (f"device busy at least {100 * busy / wall:.2f} % of the wall; kernel shares not "
                f"measured: the profiled window's trace lost records, it saw (launches, "
                f"counted) {short}")
    parts = [f"device busy {100 * busy / wall:.2f} % of the wall"]
    for name, (sec, n) in named.items():
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

    first = drive(eng, arrivals, device)[1]  # captures the loop's graph at this capacity
    res, wall, launches, peak = drive(eng, arrivals, device)
    MAIN_RUNS["rack"] = dict(res=res, wall=wall, arrivals=arrivals)
    print(f"[4 rack] m={m} n={n} scorer=cuda: " + describe(res, wall, launches, peak)
          + f"; the first run at this capacity, capture included, {first:.3f} s")
    check_outputs(res, n, "rack cuda")
    check_reads(res, "rack")
    check(sum(res.was_queued) > 0, "rack: the criterion-1 queue was never used")
    check(res.stats.drain_full_scans > 0, "rack: no drain rescanned the whole queue")
    check(device.type != "cuda" or set(launches) == {("table", GRID_T)},
          f"rack: the loop scored other than every grid type per micro-event: {launches}")
    n_launch = sum(launches.values())

    plain = ConsolidationEngine(servers, D=eng.D, scorer=plain_scorer, device=device)
    pres, pwall, _, _ = drive(plain, arrivals, device)
    rel = check_same_route(res, pres, "rack")

    if device.type == "cuda":
        # the first 256 arrivals only: parsing the trace of the whole run
        # takes minutes of host time; a first run captures their graph
        eng.run(arrivals[:256])
        out = []
        busy, named, pwall_prof, n_kernels, want = device_busy_counted(
            lambda: out.append(eng.run(arrivals[:256])), SCORE_KERNELS, score_counts,
            kc.reset_launches)
        share = kernel_shares(busy, named, pwall_prof, want, "rack")
        stats = out[-1].stats
        steps = stats.host_syncs * stats.block_steps
        MAIN_RUNS["rack_profile"] = (n_kernels, steps, busy)
        print(f"[4 rack] profiled rerun of the first 256 arrivals (graph replays): device "
              f"kernels {busy:.4f} s of {pwall_prof:.3f} s wall, {n_kernels} kernels in "
              f"{steps} steps ({stats.events} micro-events): {n_kernels / steps:.1f} kernels "
              f"and {1e6 * busy / steps:.1f} us of device time per step; {share}")

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
    check(got.placements == ref.placements and got.was_queued == ref.was_queued,
          "small trace: card and CPU runs place differently")
    check(abs(got.makespan - ref.makespan) <= 1e-3 * ref.makespan,
          "small trace: card and CPU makespans differ")
    check(got.stats == ref.stats, f"small trace: loop stats {got.stats} on the card, "
          f"{ref.stats} on the CPU")
    flagged, where = "not measured", {}
    if device.type == "cuda":
        flagged, where = count_syncs(lambda: small_eng.run(small_arr))
        check(flagged <= reads_bound(ns) + FIXED_COPIES,
              f"small trace: {flagged} synchronizing calls > {reads_bound(ns)} loop reads "
              f"+ {FIXED_COPIES} fixed copies: {where}")
    print(f"[4 rack] small trace m={ms} n={ns}: card run == CPU run "
          f"(queued {sum(got.was_queued)}, makespan {got.makespan:.6f} s, same loop stats); "
          f"synchronizing calls flagged by torch's sync debug mode in a rerun: "
          f"{flagged} (bound {reads_bound(ns)} loop reads + {FIXED_COPIES} fixed copies), "
          f"of which loop reads {got.stats.host_syncs}; by caller {where}")
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
    # Q = 1, 8, 230 random types and the rescans' Q = n that the engine
    # scored per candidate batch before it scored every grid type, then the
    # loop's own call on every grid type once
    for Q in (1, 8, GRID_T, n):
        args = kernel_args(cl, counts, candidate_types(counts, Q, rng))
        rows[Q] = score_row(args, counts, f"m={m} Q={Q}",
                            plain="call" if Q == n else "device" if Q == GRID_T else None)
    args = kernel_args(cl, counts, loop_types(device))
    rows[LOOP_Q] = score_row(args, counts, f"m={m} Q={LOOP_Q}")
    del cl, counts, args
    print(f"[5 fleet] consolidation_scores vs plain, m={m} T=230, both paths bitwise equal; "
          f"device ms (per call with host launch): "
          + "; ".join(describe_scores(Q, r) for Q, r in rows.items()))

    servers = rack(m)
    arrivals = trace(n, gap=1e-4 * 64 / m)
    eng = ConsolidationEngine(servers, scorer="cuda", device=device)
    eng.run(trace(64, gap=1e-4 * 64 / m, seed=1))  # warm-up at this width
    first = drive(eng, arrivals, device)[1]  # captures the loop's graph at this capacity
    res, wall, launches, peak = drive(eng, arrivals, device)
    check_outputs(res, n, "fleet")
    check_reads(res, "fleet")
    check(res.stats.drain_full_scans > 0, "fleet: no drain rescanned the whole queue")
    check(device.type != "cuda" or set(launches) == {("table", GRID_T)},
          f"fleet: the loop scored other than every grid type per micro-event: {launches}")
    print(f"[5 fleet] m={m} n={n} scorer=cuda: " + describe(res, wall, launches, peak)
          + f"; the first run at this capacity, capture included, {first:.3f} s")

    MAIN_RUNS["fleet"] = dict(res=res, wall=wall, arrivals=arrivals)
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


#: the banked entry's shapes: (label, m, B, share of keys dropped); T = 230,
#: K = 2. The rack stream's segments (256 and 512 arrivals over 64 servers),
#: a fleet-width block, a block with -1 and past-the-space keys, and one past
#: the 8192 keys the kernel sorts in shared memory
BANKED_SHAPES = [("rack 256", 64, 256, 0.0), ("rack 512", 64, 512, 0.0),
                 ("fleet 4096", 1024, 4096, 0.0), ("dropped keys", 64, 300, 0.4),
                 ("sort in global memory", 256, 9000, 0.1)]


def banked_inputs(m: int, B: int, T: int, K: int, drop: float, device, rng):
    """Seeded banked-scatter inputs: keys server * T + type over m servers,
    a ``drop`` share of them -1 or past the key space; co rows of a few
    co-resident types, as the stream's are."""
    import numpy as np
    import torch

    keys = (rng.integers(0, m, B) * T + rng.integers(0, T, B)).astype(np.int32)
    bad = rng.random(B) < drop
    keys[bad] = rng.choice(np.array([-1, m * T, m * T + 5], np.int32), int(bad.sum()))
    co = (rng.random((B, T)) * 2).astype(np.float32)
    vals = rng.normal(size=(K, B)).astype(np.float32)
    return tuple(torch.from_numpy(x).to(device) for x in (keys, co, vals))


def banked_index_add_form(keys, co, vals, n_rows: int):
    """The dense [K, n_rows, T] table by the scatter-add the JAX package
    lowers to on a GPU (``repro/telemetry/estimator.py:292-300``), with a
    dump row for dropped keys. Timed as the library call; the port never
    calls it."""
    import torch

    K, T = vals.shape[0], co.shape[1]
    idx = torch.where((keys >= 0) & (keys < n_rows), keys, n_rows).long()
    acc = torch.zeros((K, n_rows + 1, T), dtype=torch.float32, device=co.device)
    acc.index_add_(1, idx, co[None] * vals[:, :, None])
    return acc[:, :n_rows]


def banked_bound_ms(keys, T: int, K: int, n_rows: int) -> tuple[float, str]:
    """Least time for one banked call on these inputs: the in-range rows'
    co rows and values and all keys read once, the touched rows and their
    keys written once, over HBM bandwidth; against 2 K T fp32 operations per
    row in range over the fp32 peak."""
    import torch

    B = int(keys.shape[0])
    keep = (keys >= 0) & (keys < n_rows)
    rows = int(keep.sum())
    n_keys = int(torch.unique(keys[keep]).numel())
    nbytes = 4 * (rows * T + B + K * rows + K * n_keys * T + n_keys)
    flops = 2 * K * rows * T
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def phase_pair_scatter(device) -> dict:
    """``pair_scatter``'s two entries against their plain versions at every
    listed shape, bitwise equal on a rerun, and against the float64
    references at one shape each; times of the contract entry at B=4096,
    T=230, K=2 and of the banked entry at ``BANKED_SHAPES``, beside the
    bound and the ``index_add_`` form."""
    import numpy as np
    import torch
    from repro_torch.kernels import telemetry as kt
    from repro_torch.kernels.ref import pair_scatter_banked_ref, pair_scatter_ref

    on_card = device.type == "cuda"
    rng = np.random.default_rng(SEED + 2)
    errs = []
    for T in (17, 32, 230):  # an odd T moves single floats, an even one float2
        for B in (0, 1, 7, 300, 4096, 9000):
            for K in (None, 1, 2, 3):
                args = scatter_inputs(B, T, K, device, rng)
                label = f"pair_scatter B={B} T={T} K={K or '1-D'}"
                got = kt.pair_scatter(*args)
                errs.append(close_err(got, kt.pair_scatter_torch(*args), label))
                again = kt.pair_scatter(*args)
                check(all(torch.equal(a, b) for a, b in zip(got, again)),
                      f"{label}: a rerun is not bitwise equal")
        bargs = banked_inputs(5, 300, T, 3, 0.2, device, rng)
        errs.append(close_err(kt.pair_scatter_banked(*bargs, 5 * T)[:1],
                              kt.pair_scatter_banked_torch(*bargs, 5 * T)[:1],
                              f"banked m=5 B=300 T={T} K=3"))
    args = scatter_inputs(300, 230, 2, device, rng)
    ref = [torch.from_numpy(x).to(device)
           for x in pair_scatter_ref(*(a.cpu().numpy() for a in args))]
    err_ref = close_err(kt.pair_scatter(*args), ref, "pair_scatter vs float64 reference")

    # timed at phase 6's B = 4096 and at a host-alternating update's size
    T, K = 230, 2
    timed = {}
    for B in (4096, 16):
        args = scatter_inputs(B, T, K, device, rng)
        r = dict(shape=f"B={B} T={T} K={K}", lib_err=close_err(
            [index_add_form(*args)], [kt.pair_scatter(*args)[0]], "index_add_ form vs kernel"))
        r["bound_ms"], r["bound_by"] = scatter_bound_ms(args[0].cpu(), T, K)
        if on_card:
            r.update(ms=device_ms(lambda: kt.pair_scatter(*args)),
                     plain_ms=device_ms(lambda: kt.pair_scatter_torch(*args)),
                     library_ms=device_ms(lambda: index_add_form(*args)),
                     call_ms=call_ms(lambda: kt.pair_scatter(*args)))
            r["times"] = (f"device ms kernel {r['ms']:.5f} (per call {r['call_ms']:.4f}), "
                          f"plain {r['plain_ms']:.5f}, index_add_ form {r['library_ms']:.5f}")
        else:
            r["times"] = "times not measured off the card"
        timed[B] = r
    row = dict(timed[4096], max_abs_err=max(errs), ref_err=err_ref, host_path=timed[16])
    print(f"[6 pair_scatter] contract vs plain at {len(errs) - 3} shapes (B 0..9000, T "
          f"17/32/230, K 1-D/1/2/3, each rerun bitwise equal) and banked at m=5 B=300 K=3 per "
          f"T: max abs err {row['max_abs_err']:.3g}; vs "
          f"float64 ref (B=300 T=230 K=2) {err_ref:.3g}; "
          + "; ".join(f"at {r['shape']}: {r['times']}, bound {r['bound_ms']:.5f} ms by "
                      f"{r['bound_by']}, index_add_ form vs kernel max abs err "
                      f"{r['lib_err']:.3g}" for r in timed.values()))

    banked = {}
    for label, m, Bb, drop in BANKED_SHAPES:
        n_rows = m * T
        bargs = banked_inputs(m, Bb, T, K, drop, device, rng)
        got = kt.pair_scatter_banked(*bargs, n_rows)
        want = kt.pair_scatter_banked_torch(*bargs, n_rows)
        check(torch.equal(got[1], want[1]), f"banked {label}: slot keys differ")
        r = dict(max_abs_err=close_err(got[:1], want[:1], f"banked {label} vs plain"),
                 shape=f"m={m} B={Bb} T={T} K={K}" + (f" dropped {drop}" if drop else ""))
        again = kt.pair_scatter_banked(*bargs, n_rows)
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"banked {label}: a rerun is not bitwise equal")
        n_keys = int((got[1] < n_rows).sum())
        dense = banked_index_add_form(*bargs, n_rows)
        r["lib_err"] = close_err([dense[:, got[1][:n_keys].long()]], [got[0][:, :n_keys]],
                                 f"banked {label}: index_add_ form vs kernel")
        if label == "rack 512":
            rr, rk = pair_scatter_banked_ref(*(a.cpu().numpy() for a in bargs), n_rows)
            check(np.array_equal(rk, got[1].cpu().numpy()), f"banked {label}: keys vs float64")
            r["ref_err"] = close_err(got[:1], [torch.from_numpy(rr).to(device)],
                                     f"banked {label} vs float64 reference")
        del dense
        r["bound_ms"], r["bound_by"] = banked_bound_ms(bargs[0].cpu(), T, K, n_rows)
        r["n_keys"] = n_keys
        if on_card:
            r.update(ms=device_ms(lambda: kt.pair_scatter_banked(*bargs, n_rows)),
                     plain_ms=device_ms(lambda: kt.pair_scatter_banked_torch(*bargs, n_rows)),
                     library_ms=device_ms(lambda: banked_index_add_form(*bargs, n_rows)),
                     call_ms=call_ms(lambda: kt.pair_scatter_banked(*bargs, n_rows)))
            times = (f"device ms kernel {r['ms']:.5f} (per call {r['call_ms']:.4f}), plain "
                     f"{r['plain_ms']:.5f}, index_add_ form {r['library_ms']:.5f}")
        else:
            times = "times not measured off the card"
        print(f"[6 pair_scatter] banked {r['shape']}, {n_keys} keys: vs plain max abs err "
              f"{r['max_abs_err']:.3g}" + (f", vs float64 ref {r['ref_err']:.3g}"
                                           if "ref_err" in r else "")
              + f", rerun bitwise equal; {times}; bound {r['bound_ms']:.5f} ms by "
              f"{r['bound_by']}; index_add_ form vs kernel {r['lib_err']:.3g}")
        banked[label] = r
    row["banked"] = banked
    return row


def estimator_gap(est, snap) -> float:
    """Max abs difference of an estimator's L, log_b and n_pair from a
    snapshot of another's."""
    return max(float((a - b).abs().max()) for a, b in zip((est.L, est.log_b, est.n_pair), snap))


def timed_segments(eng, on_segment):
    """Wrap ``eng`` so that each segment's engine run ends in a synchronize
    and is stamped, and ``on_segment`` is stamped after a synchronize: the
    estimator refresh of segment k is the span between the two stamps (the
    per-server log split and updates, or the ring push and the banked
    update). Returns (stamps of run ends, stamps of refresh ends)."""
    import torch

    run_end, refresh_end = [], []
    make = eng.engine_for_segment

    class Timed:
        def __init__(self, engine):
            self.engine = engine

        def run(self, *args, **kw):
            res = self.engine.run(*args, **kw)
            if eng.device.type == "cuda":
                torch.cuda.synchronize(eng.device)
            run_end.append(time.perf_counter())
            return res

    eng.engine_for_segment = lambda k: Timed(make(k))

    def stamped(k, res, engine):
        if eng.device.type == "cuda":
            torch.cuda.synchronize(eng.device)
        refresh_end.append(time.perf_counter())
        on_segment(k, res, engine)

    return run_end, refresh_end, stamped


def adaptive_run(servers, arrivals, segments: int, drift, prior, device, label: str):
    """One timed adaptive run at rack width on the host-alternating path with
    ``scorer='cuda'`` and ``scatter='cuda'``, the launch counts zeroed just
    before it and read just after. Every estimator update is replayed on
    shadow estimators with the plain scatter, whose tables must agree after
    every segment, and the scatter launches must be exactly the contract
    entry's, one per per-server update that had a co-run. Returns a dict:
    result, wall, per-segment walls and refresh ms, launches by shape,
    scorer launches by (path, Q), peak, shadow gap, estimator snapshots."""
    import gc

    import numpy as np
    import torch
    from repro_torch.core import AdaptiveEngine
    from repro_torch.kernels import consolidation as kc
    from repro_torch.kernels import telemetry as kt

    on_card = device.type == "cuda"
    eng = AdaptiveEngine(servers, drift=drift, scorer="cuda", scatter="cuda", device=device,
                         prior=prior, decay=0.997)
    snaps = []

    def on_segment(k, res, engine):
        snaps.append([(e.L.clone(), e.log_b.clone(), e.n_pair.clone())
                      for e in engine.estimators])

    run_end, refresh_end, stamped = timed_segments(eng, on_segment)
    if on_card:
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    kc.reset_launches()
    kt.reset_launches()
    t0 = time.perf_counter()
    res = eng.run(arrivals, segments=segments, on_segment=stamped)
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
        check_reads(r, f"{label} segment")
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
                expected[("contract", n_co, kept.shape[1], 2)] += 1
            est.update(log)
            worst = max(worst, estimator_gap(est, snaps[k][s]))
        check(worst <= TOL, f"{label}: kernel and plain estimators differ by {worst:.3g} "
              f"after segment {k}")
    check(scatter_launches == expected,
          f"{label}: {sum(scatter_launches.values())} pair_scatter launches, "
          f"{sum(expected.values())} per-server updates with a co-run")
    walls = np.diff([t0] + refresh_end)
    refresh_ms = [1e3 * (b - a) for a, b in zip(run_end, refresh_end)]
    return dict(res=res, wall=wall, walls=walls, refresh_ms=refresh_ms,
                scatter=scatter_launches, score=score_launches, peak=peak, worst=worst,
                snaps=snaps)


def describe_adaptive(label, r) -> str:
    res, launches = r["res"], r["scatter"]
    sizes = sorted(key[1] for key in launches)
    entries = sorted({key[0] for key in launches})
    return (f"[7 adaptive] {label}: wall {r['wall']:.3f} s, {res.total_obs} observations; per "
            f"segment wall s {[round(float(w), 3) for w in r['walls']]}, estimator refresh ms "
            f"{[round(t, 3) for t in r['refresh_ms']]}, simulated durations s "
            f"{[round(d, 6) for d in res.durations]}, micro-events "
            f"{[x.stats.events for x in res.segments]}, queued "
            f"{[sum(x.was_queued) for x in res.segments]}, full rescans "
            f"{[x.stats.drain_full_scans for x in res.segments]}\n"
            f"[7 adaptive] {label}: launches pair_scatter {sum(launches.values())} "
            f"({'/'.join(entries)} entry; B {sizes[0]}..{sizes[-1]}, {len(launches)} shapes), "
            f"consolidation_scores by (path, Q) {r['score']}; shadow estimators (plain scatter) "
            f"within {r['worst']:.3g} after every segment; peak device memory "
            f"{r['peak'] / 2**20:.1f} MiB")


def co_run_rows(block, est, m: int) -> int:
    """Rows of a stream block that enter the banked scatter: valid, within
    the lost-frac limit, on a server of the bank, with co-resident
    exposure."""
    ok = (block.valid & (block.lost_frac <= est.max_lost_frac) & (block.server >= 0)
          & (block.server < m) & (block.co_sum > est.solo_eps))
    return int(ok.sum())


def adaptive_stream_run(servers, arrivals, segments: int, drift, prior, device, label: str,
                        host: dict | None):
    """The same adaptive run in stream mode (``stream=True``): each segment's
    rows go to the ring and one banked update, whose scatter must be exactly
    one launch of the banked entry per segment with a co-run. The segments'
    blocks are replayed on a shadow bank with the plain scatter, whose state
    must agree after every segment; segment 0 must place as the host-
    alternating run ``host`` did (where one is given), with estimators
    within 1e-4 of its float64 ones after it; later segments' placements are
    compared and the first divergence reported (float32 device state against
    float64 host state can break a near-tie). Returns a dict as
    ``adaptive_run`` does, with the divergence."""
    import gc

    import numpy as np
    import torch
    from repro_torch.core import AdaptiveEngine
    from repro_torch.kernels import consolidation as kc
    from repro_torch.kernels import telemetry as kt
    from repro_torch.telemetry import EstimatorBank, RingBlock

    on_card = device.type == "cuda"
    eng = AdaptiveEngine(servers, drift=drift, scorer="cuda", scatter="cuda", device=device,
                         prior=prior, decay=0.997, stream=True)
    m = len(servers)
    blocks, snaps = [], []

    def on_segment(k, res, engine):
        blocks.append(RingBlock(*(a.clone() for a in res.stream_block)))
        snaps.append([a.clone() for a in engine.bank.stacked_state()])

    run_end, refresh_end, stamped = timed_segments(eng, on_segment)
    if on_card:
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    kc.reset_launches()
    kt.reset_launches()
    t0 = time.perf_counter()
    res = eng.run(arrivals, segments=segments, on_segment=stamped)
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
        check_reads(r, f"{label} segment")
        check(r.observations is None and r.stream_block is not None,
              f"{label}: a segment formed a host log")
    check(host is None or res.n_obs == host["res"].n_obs,
          f"{label}: observations used {res.n_obs} != host-alternating "
          f"{host and host['res'].n_obs}")
    check(eng.ring.total == n, f"{label}: the ring took {eng.ring.total} of {n} rows")
    T = blocks[0].T
    expected = collections.Counter()
    for blk in blocks:
        check(co_run_rows(blk, eng.estimators[0], m) > 0, f"{label}: a segment had no co-run")
        expected[("banked", blk.rows, T, 2, m * T)] += 1
    check(scatter_launches == expected,
          f"{label}: pair_scatter launches {dict(scatter_launches)}, want one banked launch "
          f"per segment {dict(expected)}")

    # a shadow bank on the plain scatter, replayed on the same blocks
    shadow = EstimatorBank([dataclasses.replace(e, scatter="torch") for e in eng.estimators])
    worst = 0.0
    for k, blk in enumerate(blocks):
        shadow.update_device(blk, sparse_tables=True)
        gap = max(float((a - b).abs().max())
                  for a, b in zip(shadow.stacked_state()[:4], snaps[k][:4]))
        check(torch.equal(shadow.stacked_state().n_obs, snaps[k][4]),
              f"{label}: shadow bank's observation counts differ after segment {k}")
        worst = max(worst, gap)
        check(worst <= TOL, f"{label}: kernel and plain banks differ by {worst:.3g} after "
              f"segment {k}")

    walls = np.diff([t0] + refresh_end)
    refresh_ms = [1e3 * (b - a) for a, b in zip(run_end, refresh_end)]
    out = dict(res=res, wall=wall, walls=walls, refresh_ms=refresh_ms,
               scatter=scatter_launches, score=score_launches, peak=peak, worst=worst,
               gap0=None, diverged=None)
    if host is None:
        return out
    # segment 0 against the host-alternating run
    h0 = host["res"].segments[0]
    check(res.segments[0].placements == h0.placements
          and res.segments[0].was_queued == h0.was_queued,
          f"{label}: segment 0 places differently from the host-alternating run")
    st = snaps[0]
    gap0 = 0.0
    for s_, (L, log_b, n_pair) in enumerate(host["snaps"][0]):
        for dev_t, host_t in ((st[0][s_].T, L), (st[1][s_], log_b), (st[2][s_].T, n_pair)):
            gap0 = max(gap0, float((dev_t.double() - host_t).abs().max()))
    check(gap0 <= 1e-4, f"{label}: estimators after segment 0 are {gap0:.3g} from the "
          f"host-alternating ones")
    out["diverged"] = next(((k, first_divergence(r.placements, h.placements))
                            for k, (r, h) in enumerate(zip(res.segments, host["res"].segments))
                            if r.placements != h.placements), None)
    out["gap0"] = gap0
    return out


def describe_stream(label, r, host) -> str:
    div = ("every segment places as the host-alternating run" if r["diverged"] is None else
           f"first divergence from the host-alternating run: segment {r['diverged'][0]}, "
           f"arrival {r['diverged'][1]} (not gated: float32 device state)")
    h_ms, s_ms = host["refresh_ms"], r["refresh_ms"]
    return (describe_adaptive(label + " stream", r) + "\n"
            f"[7 adaptive] {label} stream: segment 0 == host-alternating run, estimators "
            f"within {r['gap0']:.3g} of its float64 ones; {div}\n"
            f"[7 adaptive] {label}: estimator refresh ms per segment, host-alternating "
            f"{[round(t, 3) for t in h_ms]} (median {statistics.median(h_ms):.3f}) vs stream "
            f"{[round(t, 3) for t in s_ms]} (median {statistics.median(s_ms):.3f}); wall per "
            f"segment s {[round(float(w), 3) for w in host['walls']]} vs "
            f"{[round(float(w), 3) for w in r['walls']]}")


def phase_adaptive(device, m: int = 64, segments: int = 8, per_segment: int = 256,
                   queue=(3, 512), small=(2, 3, 16), fleet=(1024, 4, 4096)) -> dict:
    """Drives the adaptive loop (the second main path) at rack width twice on
    each path, host-alternating and stream: from the uniform prior 0.0 under
    a congestion drift, and from the profiled prior at twice the arrivals per
    segment, where the criterion-1 queue fills and drains rescan it; then
    once in stream mode at fleet width (``fleet``: servers, segments,
    arrivals per segment; congestion from the middle segment). Every
    scatter launch is held to the plain version through shadow estimators or
    a shadow bank. Returns launch counts by entry."""
    import numpy as np
    from repro_torch.core import AdaptiveEngine, ConsolidationEngine
    from repro_torch.kernels import consolidation as kc
    from repro_torch.kernels import telemetry as kt
    from repro_torch.telemetry import congestion_at

    on_card = device.type == "cuda"
    kw = dict(prior=0.0, decay=0.997)

    # small runs on the card against the same runs on the CPU (plain scatter)
    ms, ks, ns = small
    small_arr = trace(ks * ns, gap=2e-4, seed=5)
    for stream in (False, True):
        mode = "stream" if stream else "host-alternating"
        cpu = AdaptiveEngine(rack(ms), scatter="torch", device="cpu", stream=stream, **kw)
        card = AdaptiveEngine(rack(ms), device=device, stream=stream, **kw)
        want, got = cpu.run(small_arr, segments=ks), card.run(small_arr, segments=ks)
        for k in range(ks):
            check(got.segments[k].placements == want.segments[k].placements
                  and got.segments[k].was_queued == want.segments[k].was_queued,
                  f"small {mode} run: card and CPU place differently in segment {k}")
        gap = max(estimator_gap(c, (e.L.to(device), e.log_b.to(device), e.n_pair.to(device)))
                  for c, e in zip(card.estimators, cpu.estimators))
        check(gap <= TOL, f"small {mode} run: card and CPU estimates differ by {gap:.3g}")
        check(got.n_obs == want.n_obs and got.total_obs > 0,
              f"small {mode} run: observations differ")
        queued = sum(sum(r.was_queued) for r in got.segments)
        check(queued > 0, f"small {mode} run: the criterion-1 queue was never used")
        print(f"[7 adaptive] small {mode} run m={ms} {ks}x{ns}: card run == CPU run "
              f"(placements, {queued} queue decisions, {got.total_obs} observations; estimator "
              f"tables within {gap:.3g})")

    # prior 0.0 under drift: at 4 arrivals per server per segment the learned
    # D never predicts a 50 % degradation, so this run does not queue
    servers = rack(m)
    n = segments * per_segment
    arrivals = trace(n, gap=1e-4)
    drift = congestion_at(servers, segments // 2, server=0, factor=0.4)
    label = f"m={m} {segments}x{per_segment} prior 0.0 drift at {segments // 2}"
    host = adaptive_run(servers, arrivals, segments, drift, 0.0, device, label)
    print(describe_adaptive(label, host))

    # segment 0 places as the plain engine on the prior D (uniform 0)
    base = ConsolidationEngine(servers, D=np.zeros((230, 230)), scorer="cuda", device=device)
    b0 = base.run(arrivals[:per_segment])
    check(b0.placements == host["res"].segments[0].placements
          and b0.was_queued == host["res"].segments[0].was_queued,
          "adaptive: segment 0 places differently from the plain engine on the prior D")
    print("[7 adaptive] segment 0 == plain engine on the prior D")
    stream = adaptive_stream_run(servers, arrivals, segments, drift, 0.0, device, label, host)
    print(describe_stream(label, stream, host))

    # the profiled prior at 8 arrivals per server per segment: the
    # criterion-1 queue fills, so drains score at Q = 8 and rescan the whole
    # queue on estimated D with telemetry on; congestion from segment 1
    kq, nq = queue
    q_arrivals = trace(kq * nq, gap=1e-4, seed=7)
    q_drift = congestion_at(servers, 1, server=0, factor=0.4)
    q_label = f"m={m} {kq}x{nq} profiled prior drift at 1"
    q_host = adaptive_run(servers, q_arrivals, kq, q_drift, "profiled", device, q_label)
    q_res = q_host["res"]
    q_queued = [sum(r.was_queued) for r in q_res.segments]
    check(all(q > 0 for q in q_queued), f"{q_label}: a segment never queued ({q_queued})")
    check(all(r.stats.drain_full_scans > 0 for r in q_res.segments),
          f"{q_label}: a segment's drains never rescanned the whole queue")
    check(not on_card or set(q_host["score"]) == {("table", GRID_T)},
          f"{q_label}: the loop scored other than every grid type per micro-event: "
          f"{q_host['score']}")
    print(describe_adaptive(q_label, q_host))
    q_stream = adaptive_stream_run(servers, q_arrivals, kq, q_drift, "profiled", device, q_label,
                                   q_host)
    check(all(sum(r.was_queued) > 0 for r in q_stream["res"].segments),
          f"{q_label} stream: a segment never queued")
    print(describe_stream(q_label, q_stream, q_host))

    # stream mode at fleet width: segment 0 places as the plain engine on the
    # prior D, one banked launch per segment, a shadow bank on the plain
    # scatter agrees after every segment
    fm, fk, fn = fleet
    f_servers = rack(fm)
    f_arrivals = trace(fk * fn, gap=1e-4 * 64 / fm, seed=11)
    f_drift = congestion_at(f_servers, fk // 2, server=0, factor=0.4)
    f_label = f"m={fm} {fk}x{fn} prior 0.0 drift at {fk // 2}"
    f_stream = adaptive_stream_run(f_servers, f_arrivals, fk, f_drift, 0.0, device, f_label,
                                   None)
    f_base = ConsolidationEngine(f_servers, D=np.zeros((GRID_T, GRID_T)), scorer="cuda",
                                 device=device).run(f_arrivals[:fn])
    check(f_base.placements == f_stream["res"].segments[0].placements
          and f_base.was_queued == f_stream["res"].segments[0].was_queued,
          f"{f_label} stream: segment 0 places differently from the plain engine on the prior D")
    print(describe_adaptive(f_label + " stream", f_stream) + "\n"
          f"[7 adaptive] {f_label} stream: segment 0 == plain engine on the prior D; loop "
          f"reads per segment {[r.stats.host_syncs for r in f_stream['res'].segments]} "
          f"(bound {reads_bound(fn)} each)")
    del f_base

    if on_card:
        # one segment of a fresh run on each path under the profiler: the
        # device's share; a first, unprofiled run captures the loop's graph
        for stream_mode in (False, True):
            prof = AdaptiveEngine(servers, drift=drift, scorer="cuda", scatter="cuda",
                                  device=device, stream=stream_mode, **kw)
            prof.run(arrivals[:per_segment], segments=1)

            def counted():
                by_entry = collections.Counter()
                for key, n_launch in kt.LAUNCHES.items():
                    by_entry[key[0]] += n_launch
                return {"chunk_sort_kernel": by_entry["contract"],
                        "bucket_kernel": by_entry["banked"],
                        "accumulate_kernel": sum(by_entry.values()), **score_counts()}

            busy, named, pwall, _, want = device_busy_counted(
                lambda: prof.run(arrivals[:per_segment], segments=1),
                (*SCATTER_KERNELS, *SCORE_KERNELS), counted,
                lambda: (kc.reset_launches(), kt.reset_launches()))
            share = kernel_shares(busy, named, pwall, want, "adaptive")
            print(f"[7 adaptive] profiled rerun of segment 0 (graph replays), "
                  f"{'stream' if stream_mode else 'host-alternating'}: device kernels "
                  f"{busy:.4f} s of {pwall:.3f} s wall; {share}")

    return dict(contract=sum(host["scatter"].values()) + sum(q_host["scatter"].values()),
                banked=sum(stream["scatter"].values()) + sum(q_stream["scatter"].values())
                + sum(f_stream["scatter"].values()),
                score=sum(host["score"].values()) + sum(q_host["score"].values()),
                refresh_host=host["refresh_ms"], refresh_stream=stream["refresh_ms"],
                diverged=(stream["diverged"], q_stream["diverged"]))

# --- phase 14: the fleet-health plane and the fused closed loop --------------

#: fleet_actions vs cusum_scan records of one run: (entry, args, kwargs, outputs)
ACTION_ENTRIES = ("cusum", "split", "evict")


@contextlib.contextmanager
def kernel_tape(tape: list):
    """Record every cusum_scan and fleet_actions wrapper call the fleet plane
    makes (inputs cloned before, outputs after), to hold each launch to its
    plain version after the run. Adds device copies, no host read."""
    from repro_torch.fleet import controller, detect

    originals = {"cusum": (detect, "cusum_scan"), "split": (controller, "split_loop"),
                 "evict": (controller, "evict_loop")}
    saved = {}

    def recording(entry, fn):
        def call(*args, **kwargs):
            keep = tuple(a.clone() if hasattr(a, "clone") else type(a)(*(x.clone() for x in a))
                         for a in args)
            out = fn(*args, **kwargs)
            tape.append((entry, keep, kwargs, type(out)(*(x.clone() for x in out))))
            return out
        return call

    for entry, (mod, name) in originals.items():
        saved[entry] = getattr(mod, name)
        setattr(mod, name, recording(entry, saved[entry]))
    try:
        yield tape
    finally:
        for entry, (mod, name) in originals.items():
            setattr(mod, name, saved[entry])


def check_tape(tape: list, label: str) -> dict:
    """Each recorded launch against its plain version on the same inputs:
    bitwise for cusum_scan, equal outputs for fleet_actions. The fleet_actions
    plain loops make ~25 small ops per server, each a launch on the card
    (about a minute for the pair at m 14504), so they run on CPU copies of
    the inputs: they only compare, count and move values, which gives the
    same outputs on either device. Returns the launches checked and the
    largest difference seen, by entry."""
    import torch
    from repro_torch.kernels import cusum as kcu
    from repro_torch.kernels import fleet_actions as kfa

    def on_cpu(a):
        if isinstance(a, torch.Tensor):
            return a.cpu()
        if isinstance(a, dict):
            return {k: on_cpu(v) for k, v in a.items()}
        if isinstance(a, tuple):  # the args, or a named tuple of tensors
            return type(a)(*map(on_cpu, a)) if hasattr(a, "_fields") else tuple(map(on_cpu, a))
        return a

    plain = {"cusum": kcu.cusum_scan_torch, "split": kfa.split_loop_torch,
             "evict": kfa.evict_loop_torch}
    checked, err = collections.Counter(), collections.Counter()
    for i, (entry, args, kwargs, got) in enumerate(tape):
        if entry != "cusum":
            args, kwargs, got = map(on_cpu, (args, kwargs, got))
        want = plain[entry](*args, **kwargs)
        for name, a, b in zip(type(got)._fields, got, want):
            gap = float((a.double() - b.double()).abs().max()) if a.numel() else 0.0
            err[entry] = max(err[entry], gap)
            check(torch.equal(a, b), f"{label}: {entry} launch {i} differs from its plain "
                  f"version in {name} (max abs {gap:.3g})")
        checked[entry] += 1
    return dict(checked), dict(err)


@contextlib.contextmanager
def segment_body_sync_free():
    """Run the fused loop's segment body (everything but the event loop:
    ``closed_loop._assemble`` and ``_fold_segment``) under torch's sync
    debug mode set to "error": a synchronizing call there -- a read, or a
    tensor built from host data -- fails the phase."""
    import torch
    from repro_torch.core import closed_loop

    saved = {name: getattr(closed_loop, name) for name in ("_assemble", "_fold_segment")}

    def guarded(fn):
        def call(*args, **kwargs):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*args, **kwargs)
            except RuntimeError as err:
                raise CheckFailed(f"fused segment body synchronized: {err}") from err
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return call

    for name, fn in saved.items():
        setattr(closed_loop, name, guarded(fn))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(closed_loop, name, fn)


@contextlib.contextmanager
def capture_clock(spent: list):
    """Time every event-loop graph capture (a new engine, or a new shape,
    captures once) between synchronizes: appends its seconds to ``spent``."""
    import torch
    from repro_torch.core import engine_torch

    orig = engine_torch._TraceLoop._capture

    def timed(loop):
        torch.cuda.synchronize()
        start = time.perf_counter()
        try:
            return orig(loop)
        finally:
            torch.cuda.synchronize()
            spent.append(time.perf_counter() - start)

    engine_torch._TraceLoop._capture = timed
    try:
        yield spent
    finally:
        engine_torch._TraceLoop._capture = orig


def reset_all_launches() -> None:
    from repro_torch.kernels import consolidation as kc
    from repro_torch.kernels import cusum as kcu
    from repro_torch.kernels import fleet_actions as kfa
    from repro_torch.kernels import telemetry as kt

    for mod in (kc, kt, kcu, kfa):
        mod.reset_launches()


def read_all_launches() -> dict:
    from repro_torch.kernels import consolidation as kc
    from repro_torch.kernels import cusum as kcu
    from repro_torch.kernels import fleet_actions as kfa
    from repro_torch.kernels import telemetry as kt

    return {"consolidation_scores": sum(kc.LAUNCHES.values()),
            "pair_scatter": sum(kt.LAUNCHES.values()), "cusum_scan": sum(kcu.LAUNCHES.values()),
            "fleet_actions": sum(kfa.LAUNCHES.values()),
            "split": sum(v for k, v in kfa.LAUNCHES.items() if k[0] == "split"),
            "evict": sum(v for k, v in kfa.LAUNCHES.items() if k[0] == "evict")}


def fleet_health_run(servers, arrivals, segments: int, drift, device, device_loop: bool,
                     tape: list | None = None, count: bool = False, obs: bool = False) -> dict:
    """One adaptive run with ``FleetController`` on the host-alternating path or
    the fused loop (``device_loop``), ``scorer='cuda'`` and ``scatter='cuda'``,
    the launch counts zeroed just before it and read just after (the fused
    run is the phase's main path). The host path stamps each segment's end
    after a synchronize; the fused path has no host point between segments,
    so its wall per segment is the run's over the segments; on the card its
    segment body runs under ``segment_body_sync_free`` and every event-loop
    capture is timed (``capture_clock``). ``count`` runs it under the sync
    debug mode's warnings instead (``count_syncs``), with no clock. ``obs``
    runs it with ``metrics=True, record=True`` (phase 15), the decision ring
    sized for every row of the run."""
    import gc

    import numpy as np
    import torch
    from repro_torch.configs import MeshConfig
    from repro_torch.core import AdaptiveEngine
    from repro_torch.fleet import FleetController

    on_card = device.type == "cuda"
    fleet = FleetController(mesh=MeshConfig())
    eng = AdaptiveEngine(servers, drift=drift, scorer="cuda" if on_card else "torch",
                         scatter="cuda" if on_card else "torch", device=device, prior=0.0,
                         decay=0.997, fleet=fleet, ring_capacity=2 * len(arrivals) // segments,
                         decision_capacity=4 * len(arrivals))
    stamps = []

    def stamp(k, res, engine):
        if on_card:
            torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    if on_card:
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() if on_card else 0
    reset_all_launches()
    captures = []
    with contextlib.ExitStack() as stack:
        if tape is not None:
            stack.enter_context(kernel_tape(tape))
        if on_card and not count:
            stack.enter_context(capture_clock(captures))
        if device_loop and on_card and not count:
            stack.enter_context(segment_body_sync_free())
        t0 = time.perf_counter()
        run = lambda: eng.run(arrivals, segments=segments, device_loop=device_loop,  # noqa: E731
                              on_segment=None if device_loop else stamp, metrics=obs,
                              record=obs)
        if count:
            got = []
            synced = count_syncs(lambda: got.append(run()))
            res = got[0]
        else:
            res, synced = run(), None
        if on_card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = read_all_launches()
    peak = torch.cuda.max_memory_allocated() - base if on_card else 0
    walls = (np.diff([t0] + stamps).tolist() if stamps else [wall / segments] * segments)
    n_seg = len(arrivals) // segments
    for r in res.segments:
        check_outputs(r, len(r.placements), "fleet health segment")
        check(r.stats.host_syncs <= -(-(4 * 2 * n_seg + 8) // r.stats.block_steps)
              or not device_loop, "fleet health: a fused segment read the host past its bound")
    return dict(eng=eng, fleet=fleet, res=res, wall=wall, walls=walls, launches=launches,
                peak=peak, syncs=[r.stats.host_syncs for r in res.segments], synced=synced,
                engines=len(eng._engine_cache), captures=captures)


def events_of(res) -> list:
    return [(ev.kind, ev.server, ev.segment) for evs in res.health for ev in evs]


def compare_fleet_paths(host: dict, fused: dict, label: str) -> tuple[float, float]:
    """Decisions exact (placements, queueing, health events, observations,
    routing, masks, ring), D and the detector state within 1e-5. Returns
    the (D, detector) gaps."""
    import numpy as np
    import torch

    h, f = host["res"], fused["res"]
    for k, (a, b) in enumerate(zip(h.segments, f.segments)):
        check(a.placements == b.placements, f"{label}: segment {k} places differently, "
              f"first at arrival {first_divergence(a.placements, b.placements)}")
        check(a.was_queued == b.was_queued, f"{label}: segment {k} queues differently")
    check(events_of(h) == events_of(f), f"{label}: health events differ: {events_of(h)} vs "
          f"{events_of(f)}")
    check(h.n_obs == f.n_obs, f"{label}: observations used {h.n_obs} vs {f.n_obs}")
    hf, ff = host["fleet"], fused["fleet"]
    check(np.array_equal(hf.pool.row_of, ff.pool.row_of)
          and np.array_equal(hf.pool._read_row, ff.pool._read_row),
          f"{label}: pool routing differs")
    check(np.array_equal(hf.active_mask(), ff.active_mask()), f"{label}: active masks differ")
    check(host["eng"].ring.total == fused["eng"].ring.total, f"{label}: ring totals differ")
    d_gap = max(float((a - b).abs().max()) for a, b in zip(hf.current_D(), ff.current_D()))
    det_gap = max(float((a - b).abs().max()) for a, b in zip(hf.detector.state,
                                                             ff.detector.state))
    check(d_gap <= TOL and det_gap <= TOL, f"{label}: D within {d_gap:.3g}, detector within "
          f"{det_gap:.3g} (limit {TOL})")
    return d_gap, det_gap


def requeues(res, n_seg: int) -> list[tuple[int, int]]:
    """(segment of an eviction, arrivals requeued into the next segment)."""
    out = []
    for seg in sorted({s for kind, _, s in events_of(res) if kind == "evict"}):
        if seg + 1 < len(res.segments):
            out.append((seg, len(res.segments[seg + 1].placements) - n_seg))
    return out


def once_ms(fn, reps: int = 1) -> float:
    """Median of ``reps`` timed calls after one warm call (CUDA events): for
    the plain versions whose Python loops take too long for ``call_ms``."""
    import torch

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


def cusum_row(record, label: str) -> dict:
    """Device times of one recorded cusum_scan launch's inputs: the kernel,
    its plain version, the bound (each row's 13 input bytes and the state
    read and written once, over HBM; 13 fp32 operations per valid row over
    the fp32 peak) and the chain floor (the longest pool chain's valid rows,
    one dependent FMUL and FADD each)."""
    import torch
    from repro_torch.kernels import cusum as kcu

    _, args, kwargs, _ = record
    state, server, row, resid, valid = args
    B, m, rows = int(server.shape[0]), int(state.level.shape[0]), int(state.pool_level.shape[0])
    ms = device_ms(lambda: kcu.cusum_scan(*args, **kwargs))
    plain_ms = once_ms(lambda: kcu.cusum_scan_torch(*args, **kwargs))
    nbytes = 13 * B + 2 * 4 * (4 * m + 2 * rows)
    n_valid = int(valid.sum())
    ops = 13 * n_valid
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS
    chain = int(torch.bincount(row[valid].long(), minlength=1).max()) if n_valid else 0
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations", library_ms=None,
                chain_ms=1e3 * chain * 2 * FP32_DEP_CYCLES / CLOCK_HZ,
                shape=f"{label}: m={m} B={B} pool rows={rows}, {n_valid} valid rows, longest "
                      f"pool chain {chain}")


def actions_row(split_rec, evict_rec, label: str) -> dict:
    """Device times of one recorded pair of fleet_actions launches (split,
    then evict, on their recorded inputs): the kernel, the plain version,
    the bound (the [m] inputs read once and outputs written once over HBM;
    the acting steps' integer work -- 3 compares per server per acting step
    -- over the fp32 peak of the CUDA cores) and the chain floor (one
    dependent shared-memory round trip per acting step)."""
    from repro_torch.kernels import fleet_actions as kfa

    s_args, e_args = split_rec[1], evict_rec[1]
    m = int(s_args[1].shape[0])
    ms = device_ms(lambda: (kfa.split_loop(*s_args), kfa.evict_loop(*e_args)))
    plain = lambda: (kfa.split_loop_torch(*s_args), kfa.evict_loop_torch(*e_args))  # noqa: E731
    plain_ms = once_ms(plain) if m > 256 else call_ms(plain, reps=5)
    slow = int(s_args[-1][0])
    acting = slow * (int(s_args[0].sum()) + int(((e_args[0] | e_args[1]) & e_args[6]).sum()))
    fired = int(split_rec[3].fired.sum()) + int(evict_rec[3].fired.sum())
    nbytes = 143 * m + 16
    ops = 3 * m * acting
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations", library_ms=None,
                chain_ms=1e3 * acting * SMEM_ROUND_TRIP_CYCLES / CLOCK_HZ,
                shape=f"{label}: m={m}, {acting} acting steps, {fired} actions, "
                      f"take_slow={slow}")


#: seeded fleet-kernel inputs at phase 14's shapes (``tools/kernel_ab.py``
#: times the same): cusum_scan (label, m, B, valid rows) as the fused rack's
#: and fleet's blocks, fleet_actions (m, case)
CUSUM_SHAPES = (("rack", 64, 512, 271), ("fleet", 1024, 8192, 4131))
ACTION_SHAPES = ((64, "acting"), (64, "quiet"), (1024, "acting"), (1024, "quiet"))


def cusum_inputs(m: int, B: int, n_valid: int, device, rng, one_row: bool = True):
    """(args, kwargs) of a cusum_scan block: ``n_valid`` valid rows at random
    places among B, on random servers of the two spec pools (pool row 0 for
    the even servers, 1 for the odd: ``FleetController``'s default specs
    alternate), a tenth of the servers already split off to their own rows;
    with ``one_row`` False each row names pool row 0 or 1 at random, so a
    server's rows name both (no caller builds such a block)."""
    import numpy as np
    import torch
    from repro_torch.kernels import cusum as kcu

    row_map = np.where(rng.random(m) < 0.1, np.arange(m), np.arange(m) % 2)
    server = rng.integers(0, m, B)
    row = row_map[server] if one_row else rng.integers(0, 2, B)
    valid = np.zeros(B, bool)
    valid[rng.permutation(B)[:n_valid]] = True
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)  # noqa: E731
    state = kcu.CusumState(f32(rng.exponential(0.5, (m, 2))), f32(rng.normal(0, 0.3, m)),
                           f32(rng.exponential(4.0, m)), f32(rng.normal(0, 0.3, m)),
                           f32(rng.exponential(40.0, m) * (row_map == np.arange(m))))
    i32 = lambda a: torch.from_numpy(np.asarray(a, np.int32)).to(device)  # noqa: E731
    args = (state, i32(server), i32(row), f32(rng.normal(0, 0.5, B)),
            torch.from_numpy(valid).to(device))
    return args, dict(k=0.25, level_decay=0.9)


def actions_inputs(m: int, case: str, device, rng):
    """(split args, evict args) of fleet_actions at m servers in the two spec
    pools (a tenth split off, 2 % dropped; servers 0-4 alternate).
    ``acting``: a tenth flagged, leaders 0 and 1 and server 2 among them
    (pool 0 handed over twice, to 2 and then 4), a twentieth with a level
    hit, a fifth with a base hit, 97 % active; ``quiet``: nothing can fire
    (take_slow 0); ``last one``: every active server (30 %) hits, so
    evictions stop at one active server."""
    import numpy as np
    import torch

    idx = np.arange(m)
    u = rng.random(m)
    row_map = np.where(u < 0.1, idx, idx % 2)
    row_map = np.where(u > 0.98, -1, row_map)
    row_map[:5] = [0, 1, 0, 1, 0]
    p_flag, p_hit, p_base, p_active = {"acting": (0.1, 0.05, 0.2, 0.97),
                                       "quiet": (0.0, 0.0, 0.0, 0.97),
                                       "last one": (0.0, 1.0, 0.0, 0.3)}[case]
    flags = rng.random(m) < p_flag
    if case == "acting":
        flags[:3] = True
    f32 = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.normal(0, 1, shape).astype(np.float32)).to(device)
    i32 = lambda a: torch.from_numpy(np.asarray(a, np.int32)).to(device)  # noqa: E731
    b = lambda a: torch.from_numpy(np.asarray(a, bool)).to(device)  # noqa: E731
    ctl = i32([int(case != "quiet"), 1])
    routing = (i32(row_map), i32(np.where(row_map >= 0, row_map, idx)), i32(idx))
    s_args = (b(flags), *routing, f32(m, 2), f32(m), f32(m), ctl)
    e_args = (b(rng.random(m) < p_hit), b(rng.random(m) < p_base), f32(m), *routing,
              b(rng.random(m) < p_active), f32(m, 2), f32(m), f32(m), f32(m), f32(m), ctl)
    return s_args, e_args


def seeded_fleet_kernels(device) -> tuple[dict, dict]:
    """Seeded launches of both fleet kernels held to their plain versions
    (``check_tape``): cusum_scan at phase 14's rack and fleet blocks, a
    fleet block that breaks the one-pool-row rule and 9216 servers (state
    in global memory); fleet_actions at m 64 and 1024, acting (with a
    leader's hand-over, twice in one pool) and quiet, an evict pass that
    stops at one active server, and acting at m 14504. Returns the launches
    checked and the largest difference, by entry."""
    import numpy as np
    from repro_torch.kernels import cusum as kcu
    from repro_torch.kernels import fleet_actions as kfa

    rng = np.random.default_rng(SEED + 14)
    tape = []
    # the mixed block breaks the one-pool-row rule; at m 9216 the state and
    # the keys' counts stay in global memory
    for label, m, B, n_valid in CUSUM_SHAPES + (("rows mixed", 1024, 8192, 4131),
                                                ("global state", 9216, 2048, 1024)):
        args, kwargs = cusum_inputs(m, B, n_valid, device, rng, one_row=label != "rows mixed")
        tape.append(("cusum", args, kwargs, kcu.cusum_scan(*args, **kwargs)))
    state, server, row, _, valid = tape[-2][1]
    pairs = {(int(s), int(r)) for s, r in zip(server[valid].tolist(), row[valid].tolist())}
    check(len(pairs) > len({s for s, _ in pairs}),
          "seeded cusum_scan: the mixed block gives no server two pool rows")
    # m 14504: the most servers the earlier one-CTA design took
    for m, case in ACTION_SHAPES + ((1024, "last one"), (14504, "acting")):
        s_args, e_args = actions_inputs(m, case, device, rng)
        sp, ev = kfa.split_loop(*s_args), kfa.evict_loop(*e_args)
        tape += [("split", s_args, {}, sp), ("evict", e_args, {}, ev)]
        if case == "acting":
            check(bool(sp.fired[0]) and bool(sp.fired[2]) and int(sp.row_map[4]) == 4,
                  f"seeded fleet_actions m={m}: pool 0 was not handed over twice")
        elif case == "last one":
            check(int(ev.active.sum()) == 1, "seeded fleet_actions: the evict pass did not "
                  f"stop at one active server ({int(ev.active.sum())} left)")
        else:
            check(not sp.fired.any() and not ev.fired.any(),
                  f"seeded fleet_actions m={m}: the quiet case acted")
    return check_tape(tape, "seeded fleet kernels")


def summarize_events(res) -> str:
    """Splits and evictions per segment, and the first evicted servers."""
    per = collections.Counter((kind, seg) for kind, _, seg in events_of(res))
    segs = sorted({seg for _, seg in per})
    evicted = [s for kind, s, _ in events_of(res) if kind == "evict"]
    return (", ".join(f"segment {k}: {per[('split', k)]} splits {per[('evict', k)]} evictions"
                      for k in segs) or "none"
            ) + f"; evicted servers {evicted[:12]}{' ...' if len(evicted) > 12 else ''}"


def describe_fleet_run(label: str, r: dict, n_seg: int) -> str:
    res = r["res"]
    return (f"[14 fleet health] {label}: wall {r['wall']:.3f} s, wall per segment s "
            f"{[round(w, 3) for w in r['walls']]} (mean {r['wall'] / len(res.segments):.3f}), "
            f"loop reads per segment {r['syncs']}, arrivals per segment "
            f"{[len(s.placements) for s in res.segments]}, observations {list(res.n_obs)}, "
            f"events: {summarize_events(res)}; launches {r['launches']}, segment engines built "
            f"{r['engines']}, event-loop captures {len(r['captures'])} taking "
            f"{sum(r['captures']):.3f} s, peak device memory above the run's start "
            f"{r['peak'] / 2**20:.1f} MiB")


def phase_fleet_health(device, rack_shape=(64, 8, 256), fleet_shape=(1024, 4, 4096),
                       failing: int = 5) -> dict:
    """The fleet-health plane and the fused closed loop (ROADMAP items 5 and
    6): ``AdaptiveEngine(fleet=FleetController())`` on the host-alternating
    path and through ``run(device_loop=True)`` on one trace, with server
    ``failing`` in a ``gradual_decay``; at rack width every cusum_scan and
    fleet_actions launch is held to its plain version and the two paths must
    decide identically, evict ``failing`` and requeue work; at fleet width
    decisions must be identical and every fused fleet_actions launch (and
    the last cusum_scan launch) is held to its plain version. Returns the
    kernel rows and counts."""
    import torch
    from repro_torch.telemetry import gradual_decay

    on_card = device.type == "cuda"
    out = {"launches": collections.Counter(), "checked": collections.Counter(),
           "max_abs_err": collections.Counter()}
    for label, (m, k, n), seed in (("rack", rack_shape, 13), ("fleet", fleet_shape, 17)):
        servers = rack(m)
        arrivals = trace(k * n, gap=1e-4 * 64 / m, seed=seed)
        drift = gradual_decay(servers, server=failing, rate=0.65, start=1, segments=k)
        run_label = f"m={m} {k}x{n} gradual decay of server {failing}"
        tape_h, tape_f = [], []
        host = fleet_health_run(servers, arrivals, k, drift, device, False,
                                tape_h if label == "rack" else None)
        fused = fleet_health_run(servers, arrivals, k, drift, device, True, tape_f)
        print(describe_fleet_run(f"{run_label} host-alternating", host, n))
        print(describe_fleet_run(f"{run_label} fused", fused, n))
        d_gap, det_gap = compare_fleet_paths(host, fused, run_label)
        req = requeues(fused["res"], n)
        for name in ("consolidation_scores", "pair_scatter", "cusum_scan", "split", "evict"):
            check(not on_card or fused["launches"][name] > 0,
                  f"{run_label} fused: never launched {name}")
        out["launches"].update({key: fused["launches"][key]
                                for key in ("cusum_scan", "fleet_actions")})
        evicted = [s for kind, s, _ in events_of(fused["res"]) if kind == "evict"]
        if label == "rack":
            check(failing in evicted, f"{run_label}: server {failing} was not evicted "
                  f"(evicted {evicted})")
            check(any(q > 0 for _, q in req), f"{run_label}: no eviction requeued work ({req})")
            checked, err = check_tape(tape_h + tape_f, run_label)
            out["checked"].update(checked)
            for key, gap in err.items():
                out["max_abs_err"][key] = max(out["max_abs_err"][key], gap)
            syncs = None
            if on_card:
                # the fused run again under the sync debug mode: every
                # synchronizing call, by caller
                rerun = fleet_health_run(servers, arrivals, k, drift, device, True, count=True)
                n_sync, where = rerun["synced"]
                loop_reads = sum(rerun["syncs"])
                syncs = (n_sync, where, loop_reads)
                print(f"[14 fleet health] {run_label} fused rerun under the sync debug mode: "
                      f"{n_sync} synchronizing calls, {loop_reads} of them the event loop's "
                      f"block reads ({loop_reads / k:.1f} per segment), the rest the "
                      f"prologue's copies and the epilogue's reads; by caller {where}")
            out["rack"] = dict(host=host, fused=fused, syncs=syncs)
        else:
            # every fused fleet_actions launch and the last fused cusum_scan
            # launch at fleet width against their plain versions too
            cus = [rec for rec in tape_f if rec[0] == "cusum"]
            acts = [rec for rec in tape_f if rec[0] != "cusum"]
            checked, err = check_tape(cus[-1:] + acts, run_label)
            out["checked"].update(checked)
            for key, gap in err.items():
                out["max_abs_err"][key] = max(out["max_abs_err"][key], gap)
            out["fleet"] = dict(host=host, fused=fused)
        print(f"[14 fleet health] {run_label}: server {failing} "
              f"{'evicted' if failing in evicted else 'not evicted'}, {len(evicted)} of {m} "
              f"servers evicted; host-alternating == fused (placements, queue "
              f"decisions, events, observations, routing, masks, ring total); D within "
              f"{d_gap:.3g}, detector within {det_gap:.3g}; evictions with requeue (segment, "
              f"arrivals requeued) {req}; wall per segment host {host['wall'] / k:.3f} s vs "
              f"fused {fused['wall'] / k:.3f} s; loop reads per segment host {host['syncs']} vs "
              f"fused {fused['syncs']}")
        if on_card:
            cus = [rec for rec in tape_f if rec[0] == "cusum" and int(rec[1][4].sum()) > 0]
            out[f"cusum_{label}"] = cusum_row(cus[-1], label)
            splits = [rec for rec in tape_f if rec[0] == "split"]
            evicts = [rec for rec in tape_f if rec[0] == "evict"]
            busiest = max(range(len(splits)), key=lambda i: (
                int(splits[i][3].fired.sum()) + int(evicts[i][3].fired.sum()),
                int(splits[i][1][-1][0])))
            out[f"actions_{label}"] = actions_row(splits[busiest], evicts[busiest], label)
            quiet = [i for i in range(len(splits)) if int(splits[i][1][-1][0]) == 0]
            if quiet:
                out[f"actions_{label}_quiet"] = actions_row(splits[quiet[-1]], evicts[quiet[-1]],
                                                            label + " quiet")
            for key in (f"cusum_{label}", f"actions_{label}", f"actions_{label}_quiet"):
                if key in out:
                    r = out[key]
                    print(f"[14 fleet health] {key.split('_')[0]} {r['shape']}: device ms "
                          f"kernel {r['ms']:.5f} plain {r['plain_ms']:.3f} bound "
                          f"{r['bound_ms']:.3g} by {r['bound_by']}, chain floor "
                          f"{r['chain_ms']:.3g}, library none")
        del tape_h, tape_f
        if on_card:
            free_card()
    print(f"[14 fleet health] launches held to their plain versions {dict(out['checked'])}")
    out["seeded"], seeded_err = seeded_fleet_kernels(device)
    for key, gap in seeded_err.items():
        out["max_abs_err"][key] = max(out["max_abs_err"][key], gap)
    print(f"[14 fleet health] seeded launches held to their plain versions {out['seeded']} "
          f"(cusum_scan: rack and fleet blocks, a block breaking the one-pool-row rule "
          f"and 9216 servers in global memory; fleet_actions: m 64 and 1024 acting, with pool 0 "
          f"handed over twice, and quiet, an evict pass stopping at one active server, m "
          f"14504 acting)")
    return out


# -- phase 15: observability and the oracle ------------------------------------

def obs_counter_checks(res, frame, label: str) -> dict:
    """The engine's frame against ``LoopStats`` and the counts taken from the
    result: every arrival arrives once, places once (at arrival or from
    the drain) and finishes once on its server; each micro-event is one of
    arrive, finish, drain. Returns the counters."""
    import numpy as np
    from repro_torch.obs import metrics as M

    n = len(res.placements)
    queued = sum(res.was_queued)
    c = {name: M.counter_value(frame, name) for name in M.COUNTERS}
    want = dict(events=res.stats.events, arrivals=n,
                placements=sum(p is not None for p in res.placements), queued=queued,
                drain_placements=queued, drain_full_scans=res.stats.drain_full_scans,
                finishes=sum(t < float("inf") for t in res.finish_times), deadlocks=0,
                drain_steps=res.stats.events - 2 * n)
    for name, value in want.items():
        check(c[name] == value, f"{label}: counter {name} {c[name]}, the run says {value}")
    per = np.bincount([p for p in res.placements if p is not None], minlength=frame.m)
    for col in ("placements", "finishes"):
        check(np.array_equal(M.server_values(frame, col), per),
              f"{label}: per-server {col} differ from the result's placements")
    check(M.gauge_value(frame, "queue_peak") >= (1 if queued else 0),
          f"{label}: queue_peak {M.gauge_value(frame, 'queue_peak')} with {queued} queued")
    for hist in ("waiting_time", "headroom", "slowdown"):
        total = int(M.hist_counts(frame, hist).sum())
        check(total == n, f"{label}: {total} {hist} samples for {n} arrivals")
    return c


def obs_ring_checks(rec, placements, label: str) -> int:
    """The ring rebuilds every placement (``explain.check_reconstruction``);
    returns its rows."""
    from repro_torch.obs import explain
    from repro_torch.obs.recorder import DecisionRing

    ring = DecisionRing(rec.capacity, rec.ptr.device)
    ring.adopt(rec)
    check(ring.total <= ring.capacity, f"{label}: the ring wrapped ({ring.total} rows)")
    bad = explain.check_reconstruction(ring, [placements])
    check(not bad, f"{label}: the ring does not rebuild the run: {bad[:3]}")
    return ring.total


def profile_run(run) -> tuple[int, int, float]:
    """(device kernels, steps, device seconds) of a profiled call of ``run``
    (an engine run; a first call captures its graph)."""
    run()
    out = []
    busy, _, _, n_kernels = device_busy(lambda: out.append(run()), ())
    stats = out[0].stats
    return n_kernels, stats.host_syncs * stats.block_steps, busy


def obs_engine(device, m: int, n: int, gap: float, base: dict | None, label: str) -> dict:
    """The engine at ``m`` servers, ``n`` arrivals with ``metrics`` and
    ``record`` on: the first run captures, the second is timed. Its
    placements and queue decisions must equal the flags-off run (``base``,
    or a run made here), its counters ``LoopStats`` and the result, its
    ring every placement."""
    import gc

    import torch
    from repro_torch.core import ConsolidationEngine
    from repro_torch.kernels import consolidation as kc

    servers = rack(m)
    arrivals = trace(n, gap=gap)
    if base is None:
        off = ConsolidationEngine(servers, scorer="cuda", device=device)
        off.run(arrivals)  # capture
        res_off, wall_off, _, _ = drive(off, arrivals, device)
    else:
        res_off, wall_off = base["res"], base["wall"]
    eng = ConsolidationEngine(servers, scorer="cuda", device=device)
    t0 = time.perf_counter()
    eng.run(arrivals, metrics=True, record=True)  # captures the flagged graph
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    gc.collect()
    torch.cuda.synchronize()
    kc.reset_launches()
    t0 = time.perf_counter()
    res = eng.run(arrivals, metrics=True, record=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = sum(kc.LAUNCHES.values())
    check(res.placements == res_off.placements and res.was_queued == res_off.was_queued,
          f"{label}: metrics/record changed a decision, first at arrival "
          f"{first_divergence(res.placements, res_off.placements)}")
    check(res.stats == res_off.stats, f"{label}: loop stats {res.stats} vs {res_off.stats}")
    counters = obs_counter_checks(res, res.metrics, label)
    rows = obs_ring_checks(res.decisions, res.placements, label)
    check(rows == n + counters["drain_placements"], f"{label}: {rows} ring rows")
    return dict(eng=eng, arrivals=arrivals, res=res, wall=wall, wall_off=wall_off,
                first=first, launches=launches, counters=counters, rows=rows)


def obs_small_parity(device, m: int = 16, n: int = 64) -> dict:
    """A small trace with both flags on the card and on the CPU: the same
    frame counters, gauges and per-server columns, the ring's integer
    columns equal (candidate ids outside near-ties) and its float columns
    within TOL."""
    import numpy as np
    from repro_torch.core import ConsolidationEngine
    from repro_torch.obs import metrics as M
    from repro_torch.obs.recorder import DecisionRing

    arrivals = trace(n, gap=2e-5)
    runs = []
    for dev in ("cpu", device):
        res = ConsolidationEngine(rack(m), scorer="cuda", device=dev).run(
            arrivals, metrics=True, record=True)
        ring = DecisionRing(res.decisions.capacity, dev)
        ring.adopt(res.decisions)
        runs.append((res, ring.columns()))
    (cpu, ccols), (card, gcols) = runs
    check(card.placements == cpu.placements, "obs small trace: card and CPU place differently")
    for name in ("counters", "gauges", "per_server"):
        check(np.array_equal(getattr(card.metrics, name).cpu().numpy(),
                             getattr(cpu.metrics, name).numpy()),
              f"obs small trace: frame {name} differ between card and CPU")
    hist_same = bool(np.array_equal(card.metrics.hist.cpu().numpy(), cpu.metrics.hist.numpy()))
    gap, ties = 0.0, 0
    for name, a in gcols.items():
        b = ccols[name]
        if name == "cand":
            # the kernel and its plain version round apart in the last bit,
            # so a rank is not held where a neighbour's score lies within
            # the scheduler's tie margin but not equal, on either device
            # (exact ties break by index on both; the last slot's lower
            # neighbour is off the ring: held only at inf)
            sc = ccols["score"]
            with np.errstate(invalid="ignore"):
                near = [(g > 0) & (g <= 1e-6) for g in
                        (np.abs(np.diff(sc, axis=1)), np.abs(np.diff(gcols["score"], axis=1)))]
                apart = ~(near[0] | near[1])
            clear = np.ones_like(sc, bool)
            clear[:, 1:] &= apart
            clear[:, :-1] &= apart
            clear[:, -1] &= ~np.isfinite(sc[:, -1])
            clear |= ~np.isfinite(sc)
            ties = int((~clear).sum())
            check(np.array_equal(a[clear], b[clear]), "obs small trace: candidates differ")
        elif a.dtype.kind == "i":
            check(np.array_equal(a, b), f"obs small trace: ring column {name} differs")
        else:
            fin = np.isfinite(b)
            check(np.array_equal(np.isfinite(a), fin), f"obs small trace: ring {name} inf")
            if fin.any():
                gap = max(gap, float(np.abs(a[fin] - b[fin]).max()))
    check(gap <= TOL, f"obs small trace: ring floats within {gap:.3g} > {TOL}")
    return dict(rows=len(gcols["arrival"]), float_gap=gap, hist_same=hist_same, ties=ties,
                queued=M.counter_value(card.metrics, "queued"))


def obs_adaptive(device, health: dict, rack_shape=(64, 8, 256), failing: int = 5) -> dict:
    """Phase 14's rack run again with ``metrics`` and ``record`` on, on the
    host-alternating path and the fused loop (its segment body under the
    sync debug mode's "error"): the decisions of phase 14's unflagged runs,
    the shared counters equal to each other and to the health events, the
    two rings' integer columns equal."""
    import numpy as np
    import torch
    from repro_torch.obs import metrics as M
    from repro_torch.obs import explain
    from repro_torch.telemetry import gradual_decay

    m, k, n = rack_shape
    servers = rack(m)
    arrivals = trace(k * n, gap=1e-4 * 64 / m, seed=13)
    drift = gradual_decay(servers, server=failing, rate=0.65, start=1, segments=k)
    runs = {name: fleet_health_run(servers, arrivals, k, drift, device, device_loop, obs=True)
            for name, device_loop in (("host", False), ("fused", True))}
    shared = [i for i, c in enumerate(M.COUNTERS) if c != "d_cols_refreshed"]
    frames = {}
    for name, r in runs.items():
        base = health["rack"][name]["res"]
        res = r["res"]
        for j, (a, b) in enumerate(zip(res.segments, base.segments)):
            check(a.placements == b.placements and a.was_queued == b.was_queued,
                  f"obs adaptive {name}: segment {j} decides differently with the flags on")
        check(events_of(res) == events_of(base), f"obs adaptive {name}: health events differ")
        f = res.metrics
        kinds = collections.Counter(kind for kind, _, _ in events_of(res))
        placed = sum(len(s.placements) for s in res.segments)
        for cname, value in (("segments", k), ("splits", kinds["split"]),
                             ("evictions", kinds["evict"]), ("arrivals", placed)):
            check(M.counter_value(f, cname) == value, f"obs adaptive {name}: {cname} "
                  f"{M.counter_value(f, cname)} vs {value}")
        # every requeued arrival is placed again in the next segment; an
        # eviction in the last segment counts its requeue with no next one
        check(M.counter_value(f, "requeues") >= placed - len(arrivals),
              f"obs adaptive {name}: requeues {M.counter_value(f, 'requeues')} < "
              f"{placed - len(arrivals)} arrivals placed twice")
        bad = explain.check_reconstruction(res.decisions, [s.placements for s in res.segments])
        check(not bad, f"obs adaptive {name}: the ring does not rebuild the run: {bad[:3]}")
        frames[name] = f
    hf, ff = frames["host"], frames["fused"]
    check(torch.equal(hf.counters[shared], ff.counters[shared]),
          "obs adaptive: host and fused counters differ")
    hc, fc = runs["host"]["res"].decisions.columns(), runs["fused"]["res"].decisions.columns()
    MAIN_RUNS["obs_fused"] = runs["fused"]["res"]  # phase 16's sharded fused run's reference
    for col in ("arrival", "segment", "server", "kind", "qdepth", "pool_row", "cand"):
        check(np.array_equal(hc[col], fc[col]), f"obs adaptive: ring column {col} differs")
    return dict(runs=runs, counters={c: M.counter_value(hf, c) for c in M.COUNTERS},
                rows=len(hc["arrival"]),
                walls_off={name: health["rack"][name]["wall"] / k for name in runs})


def obs_attribution(device, m: int = 64, segments: int = 3, per_segment: int = 32) -> dict:
    """A recorded adaptive rack run attributed by ``explain.attribute_run``
    (float64 forced replays, p + 1 per segment of p decisions):
    ``check_exactness`` at JAX's 1e-5 and ``check_reconstruction``."""
    import numpy as np
    from repro_torch.core import AdaptiveEngine, profile_pairwise_fast
    from repro_torch.obs import explain

    servers = rack(m)
    arrivals = trace(segments * per_segment, gap=2e-5, seed=21)
    eng = AdaptiveEngine(servers, prior=0.0, decay=0.997, scorer="cuda",
                         scatter="cuda" if device.type == "cuda" else "torch", device=device,
                         decision_capacity=4 * len(arrivals))
    res = eng.run(arrivals, segments=segments, record=True)
    ordered = sorted(arrivals, key=lambda tw: tw[0])
    bounds = np.linspace(0, len(ordered), segments + 1).astype(int)
    chunks = [ordered[bounds[j]:bounds[j + 1]] for j in range(segments)]
    D = {s: profile_pairwise_fast(s) for s in set(servers)}
    t0 = time.perf_counter()
    atts = explain.attribute_run(res.decisions, chunks, lambda j: eng.servers,
                                 lambda j: [D[s] for s in eng.servers], alpha=eng.alpha,
                                 objective=eng.objective, durations=res.durations)
    wall = time.perf_counter() - t0
    check(len(atts) == segments, f"attribution: {len(atts)} segments attributed")
    bad = explain.check_exactness(atts) + explain.check_reconstruction(
        res.decisions, [r.placements for r in res.segments])
    check(not bad, f"attribution: {bad[:3]}")
    err = max(abs(sum(d.delta for d in a.decisions) - a.regret) for a in atts)
    return dict(atts=atts, wall=wall, err=err, decisions=sum(len(a.decisions) for a in atts))


def obs_local_search(device, m: int, n: int, plain: bool) -> dict:
    """``local_search_torch`` from a ``greedy_sequence`` packing made while
    half the fleet was masked out (servers back from maintenance), on the
    kernel's wrapper -- one launch per iteration at Q = T -- and, with
    ``plain``, on its plain version, which must make the same moves to the
    same counts. ms per iteration and peak memory above the start."""
    import gc

    import numpy as np
    import torch
    from repro_torch.core import PackedCluster, profile_pairwise_fast, type_index
    from repro_torch.core.binpack_torch import greedy_sequence
    from repro_torch.core.engine_torch import SEARCH_BLOCK, local_search_torch
    from repro_torch.kernels import consolidation as kc

    servers = rack(m)
    D = {s: profile_pairwise_fast(s) for s in set(servers)}
    Ds = [D[s] for s in servers]
    half = np.r_[np.ones(m // 2), np.zeros(m - m // 2)]
    cl_half = PackedCluster.build(servers, Ds, active=half, device=device)
    cl = PackedCluster.build(servers, Ds, device=device)
    wt = torch.tensor([type_index(w) for _, w in trace(n, gap=1e-4)], device=device)
    counts, _ = greedy_sequence(cl_half, torch.zeros((m, GRID_T), device=device), wt)
    del cl_half
    out = {"workloads": int(counts.sum())}
    for route, scorer in (("cuda", None), ("plain", plain_scorer)):
        if route == "plain" and not plain:
            continue
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        kc.reset_launches()
        t0 = time.perf_counter()
        c, moves = local_search_torch(cl, counts, 100, scorer=scorer)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        moves = int(moves)
        iters = -(-(moves + 1) // SEARCH_BLOCK) * SEARCH_BLOCK
        launches = sum(kc.LAUNCHES.values())
        check(route != "cuda" or device.type != "cuda" or launches == iters,
              f"local search m={m}: {launches} scorer launches for {iters} iterations")
        check(torch.equal(c.sum(0), counts.sum(0)), f"local search m={m}: workloads lost")
        out[route] = dict(counts=c, moves=moves, iters=iters, ms=1e3 * wall / iters,
                          launches=launches if route == "cuda" else 0,
                          peak=torch.cuda.max_memory_allocated() - base)
    if plain:
        check(out["cuda"]["moves"] == out["plain"]["moves"] > 0
              and torch.equal(out["cuda"]["counts"], out["plain"]["counts"]),
              f"local search m={m}: kernel route {out['cuda']['moves']} moves, plain route "
              f"{out['plain']['moves']}, counts equal "
              f"{torch.equal(out['cuda']['counts'], out['plain']['counts'])}")
    return out


def phase_observability(device, health: dict) -> dict:
    """Phase 15: the metrics plane, the decision recorder, regret
    attribution, local search and admission metrics on the card (ROADMAP
    items 3 and 7). Returns the consolidation_scores launches of its main
    path runs."""
    import torch
    from repro_torch.kernels import consolidation as kc
    from repro_torch.launch import serve

    on = {}
    # a. the engine at rack and fleet width, flags on against flags off
    rk = obs_engine(device, 64, 1024, 1e-4, None, "obs rack")
    fl = MAIN_RUNS.get("fleet")  # phase 5's flags-off run (None: run one here)
    fw = obs_engine(device, 1024, 4096, 1e-4 * 64 / 1024, fl, "obs fleet")
    launches = rk["launches"] + fw["launches"]
    # the first 64 arrivals: a profile of the flags-on loop over phase 4's
    # 256 holds ~350,000 kernels, whose parsing outlasts the run
    eng, head = rk["eng"], rk["arrivals"][:64]
    prof = {"off": profile_run(lambda: eng.run(head)),
            "on": profile_run(lambda: eng.run(head, metrics=True, record=True))}
    del rk["eng"], fw["eng"]
    want = MAIN_RUNS.get("rack_profile", (0, 0, 0.0))
    # one kernel more or fewer in a step moves kernels per step by one; the
    # kernels around the replays (copies in and out, the status reads) by
    # a few hundredths
    check(not want[1] or abs(prof["off"][0] / prof["off"][1] - want[0] / want[1]) < 0.5,
          f"obs rack: {prof['off'][0]} kernels in {prof['off'][1]} steps with the flags off, "
          f"phase 4 saw {want[0]} in {want[1]}")
    for label, r in (("rack m=64 n=1024", rk), ("fleet m=1024 n=4096", fw)):
        n = len(r["arrivals"])
        print(f"[15 obs] engine {label}, metrics and record on: placements and queue "
              f"decisions equal to the flags-off run, counters equal to LoopStats and the "
              f"result {r['counters']}, the ring ({r['rows']} rows) rebuilds every placement; "
              f"{1e6 * r['wall'] / n:.1f} us/decision on vs {1e6 * r['wall_off'] / n:.1f} off; "
              f"{r['res'].stats.host_syncs} loop reads; first run at this capacity (capture) "
              f"{r['first']:.3f} s; consolidation_scores launches {r['launches']}")
    per = {tag: (k / s, 1e6 * b / s) for tag, (k, s, b) in prof.items()}
    print(f"[15 obs] rack profiled rerun of the first 64 arrivals: flags off {prof['off'][0]} "
          f"kernels in {prof['off'][1]} steps = {per['off'][0]:.1f} kernels and "
          f"{per['off'][1]:.1f} us of device time per step (phase 4: "
          f"{want[0] / want[1] if want[1] else 'not measured'}); flags on "
          f"{prof['on'][0]} kernels in {prof['on'][1]} steps = {per['on'][0]:.1f} kernels and "
          f"{per['on'][1]:.1f} us per step")
    small = obs_small_parity(device)
    print(f"[15 obs] small trace m=16 n=64, both flags: card == CPU (frame counters, gauges, "
          f"per-server columns; ring integer columns, {small['rows']} rows, candidate ids "
          f"but {small['ties']} slots near a tie; ring floats within "
          f"{small['float_gap']:.3g}; histograms bitwise equal: {small['hist_same']}; queued "
          f"{small['queued']})")

    # b. the adaptive rack recorded, both paths
    kc.reset_launches()
    ad = obs_adaptive(device, health)
    for name, r in ad["runs"].items():
        launches += r["launches"]["consolidation_scores"]
        print(f"[15 obs] adaptive rack {name}, metrics and record on: decisions and health "
              f"events equal to phase 14's unflagged run; wall per segment "
              f"{r['wall'] / len(r['res'].segments):.3f} s on vs "
              f"{ad['walls_off'][name]:.3f} off; captures {len(r['captures'])} taking "
              f"{sum(r['captures']):.3f} s; launches {r['launches']}")
    print(f"[15 obs] adaptive rack: host and fused counters equal except d_cols_refreshed "
          f"({ad['counters']}), rings' integer columns equal ({ad['rows']} rows), the fused "
          f"segment body ran under the sync debug mode's 'error'")
    free_card()

    # c. regret attribution over a recorded rack run
    at = obs_attribution(device)
    print(f"[15 obs] attribution m=64 3x32: {at['decisions']} decisions over "
          f"{len(at['atts'])} segments, regret per segment "
          f"{[round(a.regret, 6) for a in at['atts']]}, by bucket "
          f"{[{k: round(v, 6) for k, v in a.by_bucket.items()} for a in at['atts']]}, "
          f"|sum(deltas) - regret| <= {at['err']:.3g} (limit 1e-5), replays took "
          f"{at['wall']:.2f} s on the host")

    # d. local search
    ls = obs_local_search(device, 64, 256, plain=True)
    launches += ls["cuda"]["launches"]
    print(f"[15 obs] local search m=64 from a greedy packing of {ls['workloads']} on half the "
          f"rack: kernel route {ls['cuda']['moves']} moves in {ls['cuda']['iters']} iterations "
          f"({ls['cuda']['launches']} scorer launches), {ls['cuda']['ms']:.3f} ms/iteration; "
          f"plain route the same moves and counts, {ls['plain']['ms']:.3f} ms/iteration")
    free_card()
    free, _ = torch.cuda.mem_get_info()
    big = None
    if free > 16 * 2**30:
        big = obs_local_search(device, 1024, 2048, plain=False)
        launches += big["cuda"]["launches"]
        print(f"[15 obs] local search m=1024 from a greedy packing of {big['workloads']} on "
              f"half the fleet: {big['cuda']['moves']} moves in {big['cuda']['iters']} "
              f"iterations, {big['cuda']['ms']:.3f} ms/iteration, peak device memory above "
              f"the start {big['cuda']['peak'] / 2**30:.2f} GiB")
    else:
        print(f"[15 obs] local search m=1024 not run: {free / 2**30:.1f} GiB free")
    free_card()

    # e. admission with the metrics plane
    plain_admit = serve.admission_check("tinyllama-1.1b", 8, device=device)
    placements, frame = serve.admission_check("tinyllama-1.1b", 8, device=device,
                                              metrics=True)
    from repro_torch.obs import metrics as M
    check(placements == plain_admit and M.counter_value(frame, "arrivals") == 8,
          f"admission metrics: {placements} vs {plain_admit}")
    print(f"[15 obs] admission_check(metrics=True) on the card: placements {placements}, "
          f"waiting-time and slowdown p50/p95/p99 "
          f"{M.percentiles(frame, 'waiting_time').round(6).tolist()} / "
          f"{M.percentiles(frame, 'slowdown').round(4).tolist()}")
    on.update(launches=launches, prof=prof)
    return on


# -- phase 16: the server axis ------------------------------------------------

def engine_arrays(arrivals, device):
    """The engine's own trace preparation (``ConsolidationEngine._run_torch``)
    for a trace whose length is its capacity (a power of two): times sorted
    and taken from the first, types and bytes; plus that first time."""
    import numpy as np
    import torch
    from repro_torch.core import type_index

    times = np.asarray([t for t, _ in arrivals], np.float64)
    order = np.argsort(times, kind="stable")
    t0 = float(times.min())
    host = (np.asarray(times[order] - t0, np.float32),
            np.asarray([type_index(arrivals[i][1]) for i in order], np.int32),
            np.asarray([arrivals[i][1].data_total for i in order], np.float32))
    return tuple(torch.from_numpy(x).to(device) for x in host), t0


def timed(fn, device):
    """(fn(), seconds), synchronized on both sides on the card."""
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def kernels_per(fn, units: int) -> float | str:
    """Device kernels per unit of a profiled call of ``fn`` (the card only)."""
    import torch

    if not torch.cuda.is_available():
        return "not measured"
    _, _, _, n_kernels = device_busy(fn, ())
    return n_kernels / units


def axis_greedy(device, m: int = 1024, n: int = 4096, pods=(8, 64)) -> dict:
    """16a: ``greedy_sequence_hier`` on the dense axis against the flat
    ``greedy_sequence`` over phase 5's arrival types, from an empty fleet
    and from a half-full one with ``col0`` supplied: placements and final
    counts bitwise equal. Times both per decision; kernels per decision
    from a profiled rerun of 64 decisions."""
    import torch
    from repro_torch.core import (PackedCluster, greedy_sequence, greedy_sequence_hier,
                                  profile_pairwise_fast, type_index)
    from repro_torch.distributed import ServerAxis

    servers = rack(m)
    D = {s: profile_pairwise_fast(s) for s in set(servers)}
    cl = PackedCluster.build(servers, [D[s] for s in servers], device=device)
    wt = torch.tensor([type_index(w) for _, w in trace(n, gap=1e-4 * 64 / m)],
                      dtype=torch.int32, device=device)
    zeros = torch.zeros((m, cl.T), device=device)
    greedy_sequence(cl, zeros, wt[:8])  # warm-up
    (cf, pf), flat_s = timed(lambda: greedy_sequence(cl, zeros, wt), device)
    # the fleet half-full: the flat run's first half placed; from there the
    # flat greedy places the second half as it did (pf, cf)
    first = pf[:n // 2].long()
    half = torch.zeros_like(zeros).index_put_(
        (first.clamp(min=0), wt[:n // 2].long()), (first >= 0).to(zeros.dtype), accumulate=True)
    col0 = torch.einsum("mt,mtu->mu", half, cl.D)
    out = dict(flat_us=1e6 * flat_s / n, queued=int((pf < 0).sum()), hier_us={})
    for p in pods:
        ax = ServerAxis(pods=p)
        greedy_sequence_hier(cl, zeros, wt[:8], ax)  # warm-up
        (ch, ph), hier_s = timed(lambda: greedy_sequence_hier(cl, zeros, wt, ax), device)
        check(torch.equal(ph, pf) and torch.equal(ch, cf),
              f"16a pods={p}: hierarchical placements or counts differ from the flat greedy "
              f"(first at {first_divergence(ph.tolist(), pf.tolist())})")
        ch2, ph2 = greedy_sequence_hier(cl, half, wt[n // 2:], ax, col0=col0)
        check(torch.equal(ph2, pf[n // 2:]) and torch.equal(ch2, cf),
              f"16a pods={p}: from the half-full fleet, hierarchical differs from flat")
        out["hier_us"][p] = 1e6 * hier_s / n
    head = wt[:64]
    out["flat_kernels"] = kernels_per(lambda: greedy_sequence(cl, zeros, head), 64)
    out["hier_kernels"] = kernels_per(
        lambda: greedy_sequence_hier(cl, zeros, head, ServerAxis(pods=pods[0])), 64)
    return out


def capture_loop(eng, arrays, axis, cache: dict, **kw) -> None:
    """The loop of this trace's capacity built (its graph captured on the
    card) by a run of its first 16 arrivals (``trace_segment``'s traced
    count: the graph is the same block of micro-events at any count)."""
    from repro_torch.core import make_scorer
    from repro_torch.core.engine_torch import trace_segment

    m = eng.cluster.m
    local = (lambda x: x) if axis is None else (lambda x: axis.local(x, m))  # noqa: E731
    trace_segment(local(eng.cluster), local(eng.dyn), *arrays, 16, scorer=make_scorer("cuda"),
                  axis=axis, cache=cache, **kw)


def sharded_trace(eng, arrays, axis, cache: dict, **kw):
    """``run_trace`` on the engine's cluster and dynamics with the cuda
    scorer (the loop's call on every grid type), cached per shape and axis."""
    from repro_torch.core import make_scorer, run_trace

    return run_trace(eng.cluster, eng.dyn, *arrays, scorer=make_scorer("cuda"), axis=axis,
                     cache=cache, **kw)


def same_as_engine(tr, res, t0: float, label: str) -> float:
    """The sharded trace against the engine's result of phase 4 or 5:
    placements, queue decisions and loop stats equal, finish times within
    TOL relative. Returns the largest relative finish-time gap."""
    import numpy as np

    place = [int(p) if p >= 0 else None for p in tr.placement.tolist()]
    check(place == list(res.placements), f"{label}: placements differ from the dense run, "
          f"first at arrival {first_divergence(place, res.placements)}")
    check(tr.was_queued.tolist() == list(res.was_queued),
          f"{label}: queue decisions differ from the dense run")
    check(tr.stats == res.stats, f"{label}: loop stats {tr.stats} vs {res.stats}")
    got = tr.finish_time.double().cpu().numpy() + t0
    want = np.asarray(res.finish_times)
    gap = float(np.max(np.abs(got - want) / np.abs(want)))
    check(gap <= TOL, f"{label}: finish times {gap:.3g} apart relative")
    return gap


def block_scorer_tape(loop, label: str) -> int:
    """Every scorer launch of one captured block, held to the plain version:
    the block replayed from the start, then run again eagerly from the start
    with each scorer call's inputs recorded, which must leave the state
    bitwise as the replay did; each recorded call then goes through
    ``kernel_error`` (1e-5 against ``consolidation_scores_torch``, both
    kernel paths bitwise equal). Returns the launches checked."""
    import torch
    from repro_torch.core import kernel_args

    fields = ("placement", "was_queued", "counts", "col0", "slot_rem", "finish_time", "now")
    loop._reset()
    loop.graph.replay()
    replay = {f: getattr(loop.st, f).clone() for f in fields}
    loop._reset()
    tape, orig = [], loop.scorer

    def recording(cl, counts, wtypes):
        tape.append(kernel_args(cl, counts.clone(), wtypes.clone()))
        return orig(cl, counts, wtypes)

    loop.scorer = recording
    try:
        loop.block()
    finally:
        loop.scorer = orig
    for f in fields:
        check(torch.equal(getattr(loop.st, f), replay[f]),
              f"{label}: the eager block's {f} differs from the replay's")
    for i, args in enumerate(tape):
        kernel_error(args, f"{label} launch {i}")
    return len(tape)


def axis_engine(device, axis, widths=(("rack", 64), ("fleet", 1024))) -> dict:
    """16b and 16c: the sharded event loop at one rank on phase 4's and 5's
    traces (``MAIN_RUNS``), against their dense runs; the flagged run at
    rack width against the dense flagged run; the dense axis profiled as
    phase 4 was."""
    import torch
    from repro_torch.core import ConsolidationEngine
    from repro_torch.distributed import DENSE
    from repro_torch.distributed import server_axis as sa
    from repro_torch.kernels import consolidation as kc

    on_card = device.type == "cuda"
    out = {"launches": 0}
    for label, m in widths:
        base = MAIN_RUNS[label]
        arrivals = base["arrivals"]
        n = len(arrivals)
        eng = ConsolidationEngine(rack(m), scorer="cuda", device=device)
        arrays, t0 = engine_arrays(arrivals, device)
        cache: dict = {}
        _, first = timed(lambda: capture_loop(eng, arrays, axis, cache), device)
        kc.reset_launches()
        sa.reset_calls()
        tr, wall = timed(lambda: sharded_trace(eng, arrays, axis, cache), device)
        launches, calls = sum(kc.LAUNCHES.values()), dict(sa.CALLS)
        check(not on_card or launches > 0, f"16b {label}: the sharded loop never launched "
              "consolidation_scores")
        out["launches"] += launches
        gap = same_as_engine(tr, base["res"], t0, f"16b {label} sharded")
        loop = next(l for l in cache.values() if l.axis is axis)
        steps = tr.stats.host_syncs * tr.stats.block_steps
        r = dict(m=m, n=n, wall=wall, first=first, wall_dense=base["wall"], gap=gap,
                 launches=launches, calls=calls, stats=tr.stats,
                 calls_per_step={k: v / steps for k, v in calls.items()})
        if on_card:
            r["tape"] = block_scorer_tape(loop, f"16b {label} block")
        if label == "rack":
            head, _ = engine_arrays(arrivals[:256], device)
            flags = dict(telemetry=True, metrics=True, record=True)
            runs = {}
            for name, ax in (("dense", None), ("sharded", axis)):
                capture_loop(eng, head, ax, cache, **flags)
                runs[name] = sharded_trace(eng, head, ax, cache, **flags)
            d, s = runs["dense"], runs["sharded"]
            for f in ("placement", "was_queued"):
                check(torch.equal(getattr(s, f), getattr(d, f)), f"16b flags: {f} differs")
            check(s.stats == d.stats, f"16b flags: loop stats {s.stats} vs {d.stats}")
            for f in ("counters", "gauges", "hist", "per_server"):
                check(torch.equal(getattr(s.metrics, f), getattr(d.metrics, f)),
                      f"16b flags: the metric frame's {f} differ")
            check(torch.equal(s.rec.block.ints, d.rec.block.ints) and
                  int(s.rec.total) == int(d.rec.total), "16b flags: the ring's integer "
                  "columns differ")
            fgap = max(float(torch.nan_to_num(a - b, nan=0.0, posinf=0.0, neginf=0.0)
                             .abs().max())
                       for a, b in ((s.rec.block.floats, d.rec.block.floats),
                                    (s.finish_time, d.finish_time), (s.obs_logr, d.obs_logr),
                                    (s.obs_co, d.obs_co)))
            check(torch.equal(torch.isinf(s.rec.block.floats), torch.isinf(d.rec.block.floats))
                  and fgap <= TOL, f"16b flags: ring floats / telemetry {fgap:.3g} apart")
            r["flags_gap"] = fgap
            if on_card:
                # the first 64 arrivals, as phase 15 profiles them: the
                # profiler's parse of phase 4's 256 outlasts the run
                prof, head = {}, engine_arrays(arrivals[:64], device)[0]
                for name, ax in (("sharded", axis), ("dense axis", DENSE)):
                    capture_loop(eng, head, ax, cache)
                    got = []
                    busy, _, _, n_k = device_busy(
                        lambda ax=ax: got.append(sharded_trace(eng, head, ax, cache)), ())
                    st = got[0].stats
                    prof[name] = (n_k, st.host_syncs * st.block_steps, busy)
                want = MAIN_RUNS.get("rack_profile", (0, 0, 0.0))
                k_dense = prof["dense axis"][0] / prof["dense axis"][1]
                check(not want[1] or abs(k_dense - want[0] / want[1]) < 0.5,
                      f"16c: {k_dense:.1f} kernels per step through the dense axis, phase 4 "
                      f"saw {want[0] / max(want[1], 1):.1f}")
                r["prof"], r["prof_phase4"] = prof, want
                capture_loop(eng, arrays, None, cache)
                _, dense_wall = timed(lambda: sharded_trace(eng, arrays, None, cache), device)
                r["wall_dense_trace"] = dense_wall
        out[label] = r
        del eng, cache, loop
        if on_card:
            free_card()
    return out


@contextlib.contextmanager
def closed_loop_on(axis):
    """Every ``run_closed_loop`` the adaptive engine makes runs on ``axis``
    (the engine's fused path builds its own config; the axis is the
    loop's, not the engine's)."""
    from repro_torch.core import closed_loop

    orig = closed_loop.run_closed_loop

    def sharded(cluster, dyn_stack, Lp_t, logb, carry, xs, config, **kw):
        return orig(cluster, dyn_stack, Lp_t, logb, carry, xs,
                    dataclasses.replace(config, axis=axis), **kw)

    closed_loop.run_closed_loop = sharded
    try:
        yield
    finally:
        closed_loop.run_closed_loop = orig


def axis_fused(device, axis, health: dict, rack_shape=(64, 8, 256), failing: int = 5) -> dict:
    """16d: phase 14's rack case through the fused loop on the axis, with
    ``metrics`` and ``record`` on: phase 14's dense fused decisions, health
    events, routing, masks and ring, D and the detector within 1e-5; every
    cusum_scan and fleet_actions launch held to its plain version; the
    segment body under the sync debug mode's "error" (``fleet_health_run``
    on the card)."""
    import torch
    from repro_torch.obs import explain
    from repro_torch.obs import metrics as M
    from repro_torch.telemetry import gradual_decay

    m, k, n = rack_shape
    servers = rack(m)
    arrivals = trace(k * n, gap=1e-4 * 64 / m, seed=13)
    drift = gradual_decay(servers, server=failing, rate=0.65, start=1, segments=k)
    tape: list = []
    with closed_loop_on(axis):
        run = fleet_health_run(servers, arrivals, k, drift, device, True, tape, obs=True)
    base = health["rack"]["fused"]
    d_gap, det_gap = compare_fleet_paths(base, run, "16d sharded fused")
    ring_a, ring_b = base["eng"].ring._buf, run["eng"].ring._buf
    check(torch.equal(ring_a.ints, ring_b.ints) and torch.equal(ring_a.scalars, ring_b.scalars)
          and torch.equal(ring_a.co, ring_b.co), "16d: the telemetry rings differ")
    for name in ("pair_scatter", "cusum_scan", "split", "evict"):
        check(device.type != "cuda" or run["launches"][name] > 0,
              f"16d: the sharded fused loop never launched {name}")
    checked, err = check_tape(tape, "16d sharded fused")
    res = run["res"]
    bad = explain.check_reconstruction(res.decisions, [s.placements for s in res.segments])
    check(not bad, f"16d: the decision ring does not rebuild the run: {bad[:3]}")
    flagged = MAIN_RUNS.get("obs_fused")
    if flagged is not None:
        check(torch.equal(res.metrics.counters, flagged.metrics.counters),
              "16d: counters differ from phase 15's flagged dense fused run")
        a, b = res.decisions.state.block, flagged.decisions.state.block
        check(torch.equal(a.ints, b.ints), "16d: the decision rings' integer columns differ")
        rgap = float(torch.nan_to_num(a.floats - b.floats, nan=0.0, posinf=0.0, neginf=0.0)
                     .abs().max())
        check(rgap <= TOL, f"16d: decision ring floats {rgap:.3g} apart")
    kinds = collections.Counter(kind for kind, _, _ in events_of(res))
    check(M.counter_value(res.metrics, "evictions") == kinds["evict"],
          "16d: the eviction counter differs from the health events")
    return dict(run=run, d_gap=d_gap, det_gap=det_gap, checked=checked, err=err,
                wall_dense=base["wall"] / k, k=k, events=dict(kinds))


def axis_entries(device, axis, fused: dict) -> dict:
    """16e: the standalone sharded entries against the dense ones, bitwise,
    on the sharded fused run's final state and its telemetry ring:
    ``cusum_update_sharded``, ``bank_update_sharded`` (the banked
    pair_scatter), ``greedy_sequence_sharded`` and
    ``resolve_leaders_device``. Returns the pair_scatter launches."""
    import numpy as np
    import torch
    from repro_torch.core import PackedCluster, greedy_sequence, greedy_sequence_sharded
    from repro_torch.core import profile_pairwise_fast, type_index
    from repro_torch.fleet import cusum_update_sharded, resolve_leaders_device
    from repro_torch.fleet.detect import _cusum_update
    from repro_torch.kernels import telemetry as kt
    from repro_torch.telemetry.estimator import _bank_core, _remap_rows, bank_update_sharded

    run = fused["run"]
    fleet, eng = run["fleet"], run["eng"]
    block = eng.ring._buf
    bank = fleet.pool.bank.stacked_state()
    row_map = torch.from_numpy(fleet.pool.row_of.astype(np.int32)).to(device)
    det, dd = fleet.detector.state, fleet.detector
    kw = dict(k=float(dd.k), level_decay=float(dd.level_decay),
              max_lost_frac=float(dd.max_lost_frac))
    got, used = cusum_update_sharded(axis, det, block, bank.log_b, bank.L_t, row_map, **kw)
    want, used_d = _cusum_update(det, block, bank.log_b, bank.L_t, row_map, **kw)
    check(all(torch.equal(a, b) for a, b in zip(got, want)) and int(used) == int(used_d),
          "16e: cusum_update_sharded differs from the dense update")
    rblock = _remap_rows(block, row_map)
    hyp = dict(fleet.pool.bank._hypers, sparse_tables=True)
    kt.reset_launches()
    got, used = bank_update_sharded(axis, bank, rblock, **hyp)
    scatter_launches = sum(kt.LAUNCHES.values())
    want, used_d = _bank_core(bank, rblock, **hyp)
    check(all(torch.equal(a, b) for a, b in zip(got, want)) and int(used) == int(used_d),
          "16e: bank_update_sharded differs from the dense update")
    check(device.type != "cuda" or scatter_launches > 0,
          "16e: bank_update_sharded never launched pair_scatter")
    m = 64
    servers = rack(m)
    D = {s: profile_pairwise_fast(s) for s in set(servers)}
    cl = PackedCluster.build(servers, [D[s] for s in servers], device=device)
    wt = torch.tensor([type_index(w) for _, w in trace(512, gap=1e-4)], dtype=torch.int32,
                      device=device)
    zeros = torch.zeros((m, cl.T), device=device)
    cs, ps = greedy_sequence_sharded(cl, zeros, wt, axis)
    cf, pf = greedy_sequence(cl, zeros, wt)
    check(torch.equal(ps, pf) and torch.equal(cs, cf),
          "16e: greedy_sequence_sharded differs from the dense greedy")
    rng = np.random.default_rng(SEED)
    labels = rng.integers(0, 6, m)
    leader: dict = {}
    host = np.asarray([leader.setdefault(int(lab), s) for s, lab in enumerate(labels)])
    dev_rows = resolve_leaders_device(axis, torch.tensor(labels, dtype=torch.int32,
                                                         device=device))
    check(np.array_equal(dev_rows.cpu().numpy(), host),
          "16e: resolve_leaders_device differs from the host's leader rule")
    return dict(scatter=scatter_launches, queued=int((pf < 0).sum()))


def phase_server_axis(device, health: dict, greedy=(1024, 4096, (8, 64)),
                      widths=(("rack", 64), ("fleet", 1024)), rack_shape=(64, 8, 256)) -> dict:
    """Phase 16: the server axis (ROADMAP item 8) at one rank of a process
    group (NCCL on the card, gloo on the CPU), run last; the group is
    destroyed before it returns. Returns the kernel launches of its main
    paths."""
    import torch.distributed as dist
    from repro_torch.distributed import ServerAxis

    t_phase = time.perf_counter()
    axis = ServerAxis.over_process_group(device=device)
    backend = dist.get_backend(axis.group)
    try:
        g = axis_greedy(device, *greedy)
        print(f"[16 axis] a. greedy_sequence_hier, dense axis, m={greedy[0]}, phase 5's "
              f"{greedy[1]} types "
              f"({g['queued']} queued): placements and counts bitwise equal to the flat "
              f"greedy from an empty fleet and from a half-full one with col0 supplied; "
              f"us per decision flat {g['flat_us']:.1f}, hier "
              + ", ".join(f"pods {p} {us:.1f}" for p, us in g["hier_us"].items())
              + f"; kernels per decision (64 profiled) flat {g['flat_kernels']}, hier "
              f"{g['hier_kernels']}")
        e = axis_engine(device, axis, widths)
        for label, _ in widths:
            r = e[label]
            calls = sum(r["calls_per_step"].values())
            print(f"[16 axis] b. sharded event loop at one {backend} rank, {label} "
                  f"m={r['m']} n={r['n']}: placements, queue decisions and LoopStats "
                  f"{r['stats']} equal to phase {4 if label == 'rack' else 5}'s dense run, "
                  f"finish times within {r['gap']:.3g}; {1e6 * r['wall'] / r['n']:.1f} us per "
                  f"decision sharded vs {1e6 * r['wall_dense'] / r['n']:.1f} dense (phase "
                  f"{4 if label == 'rack' else 5}'s engine run)"
                  + (f", {1e6 * r['wall_dense_trace'] / r['n']:.1f} dense run_trace"
                     if "wall_dense_trace" in r else "")
                  + f"; capture at this capacity (a 16-arrival run) {r['first']:.3f} s; "
                  f"collectives per micro-event "
                  f"{calls:.2f} {r['calls_per_step']}; consolidation_scores launches "
                  f"{r['launches']}" + (f"; {r['tape']} scorer launches of one captured "
                                        "block held to the plain version" if "tape" in r else ""))
        rk = e["rack"]
        print(f"[16 axis] b. flags (telemetry, metrics, record) at rack, 256 arrivals: "
              f"sharded == dense (decisions, stats, the whole frame, the ring's integer "
              f"columns), ring floats and telemetry within {rk['flags_gap']:.3g}")
        if "prof" in rk:
            per = {k: (n / s, 1e6 * b / s) for k, (n, s, b) in rk["prof"].items()}
            want = rk["prof_phase4"]
            print(f"[16 axis] c. kernels and device us per step, rack, first 64 arrivals: "
                  f"dense axis {per['dense axis'][0]:.1f} / {per['dense axis'][1]:.1f} "
                  f"(phase 4: {want[0] / max(want[1], 1):.1f} / "
                  f"{1e6 * want[2] / max(want[1], 1):.1f}); sharded at one rank "
                  f"{per['sharded'][0]:.1f} / {per['sharded'][1]:.1f}")
        f = axis_fused(device, axis, health, rack_shape)
        run = f["run"]
        print(f"[16 axis] d. sharded fused loop at one rank, rack "
              f"{' x '.join(map(str, rack_shape))}, server 5 "
              f"decaying, metrics and record on: decisions, health events {f['events']}, "
              f"routing, masks and the telemetry ring equal to phase 14's dense fused run; D "
              f"within {f['d_gap']:.3g}, detector within {f['det_gap']:.3g}; launches held "
              f"to plain {f['checked']}; wall per segment {run['wall'] / f['k']:.3f} s vs "
              f"{f['wall_dense']:.3f} dense (phase 14, flags off); captures "
              f"{len(run['captures'])} taking {sum(run['captures']):.3f} s; launches "
              f"{run['launches']}")
        x = axis_entries(device, axis, f)
        print(f"[16 axis] e. cusum_update_sharded, bank_update_sharded ({x['scatter']} "
              f"pair_scatter launches), greedy_sequence_sharded (m=64, 512 types, "
              f"{x['queued']} queued) and resolve_leaders_device bitwise equal to dense")
    finally:
        dist.destroy_process_group()
    print(f"[16 axis] phase took {time.perf_counter() - t_phase:.1f} s")
    fl = f["run"]["launches"]
    return dict(consolidation_scores=e["launches"] + fl["consolidation_scores"],
                pair_scatter=fl["pair_scatter"] + x["scatter"], cusum_scan=fl["cusum_scan"],
                fleet_actions=fl["fleet_actions"], checked=f["checked"], err=f["err"])


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
        row = flash_row("8 flash", label, q, k, v, causal=causal, q_offset=off, window=win)
        rows[(label, qdt if qdt == kvdt else f"{qdt}/{kvdt}")] = row
    return rows


def flash_row(tag: str, label: str, q, k, v, *, causal: bool, q_offset: int = 0,
              window: int = 0) -> dict:
    """``flash_attention`` against ``flash_attention_torch`` on one call's
    inputs: the entry (CUDA cores for an f32 q, the tensor-core prefill or
    split entry for bf16), the split entry's bitwise rerun, the error within
    FLASH_TOL of q's dtype, finite outputs; device times of the kernel, the
    plain version and SDPA (one dtype only), the bound. Returns the row."""
    import torch
    from repro_torch.kernels import flash_attention as kf

    B, Sq, H, dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    qdt, kvdt = str(q.dtype).split(".")[-1], str(k.dtype).split(".")[-1]
    kw = dict(causal=causal, q_offset=q_offset, window=window)
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
        lib = sdpa_form(q, k, v, causal, q_offset, window)
        row["library_err"] = float((lib.double() - want.double()).abs().max())
        row["library_ms"] = device_ms(lambda: sdpa_form(q, k, v, causal, q_offset, window))
    else:
        row["library_err"] = row["library_ms"] = None  # SDPA takes one dtype
    row["bound_ms"], row["bound_by"] = flash_bound_ms(
        B, Sq, Skv, H, Hkv, dh, causal, q_offset, q.element_size(), k.element_size(), window)
    row["shape"] = (f"B={B} Sq={Sq} Skv={Skv} H={H} Hkv={Hkv} dh={dh} "
                    f"{'causal' if causal else 'non-causal'} q_offset={q_offset} "
                    f"window={window} {qdt}/{kvdt}")
    lib_text = ("SDPA n/a" if row["library_ms"] is None else
                f"SDPA {row['library_ms']:.5f} (err {row['library_err']:.3g})")
    print(f"[{tag}] {label} {qdt}/{kvdt}: entry {want_entry}, err {err:.3g} (tol {tol}), "
          f"{'bitwise equal on a rerun, ' if Sq == 1 else ''}device ms kernel "
          f"{row['ms']:.5f} plain {row['plain_ms']:.5f} {lib_text} bound "
          f"{row['bound_ms']:.5f} by {row['bound_by']}")
    return row


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


def replay_gaps(model, lm, prompts, run, tol: float,
                extras: dict | None = None) -> list[tuple[float, int, int]]:
    """Teacher-forced replay of the forward calls of ``run`` (the kernel
    route's tokens, the prefill's ``extras`` beside its prompts) through
    ``lm``, set to its other route. Per call: (max |diff| of the
    last-position logits over the kernel route's max |.|, the rows whose
    argmax differs, those of them whose top-2 gap in the kernel route is
    wider than ``tol`` of the scale)."""
    requests, n_gen = run.tokens.shape
    batch = dict(extras or {}, tokens=prompts)
    cache = model.init_cache(requests, model.prefix_len(batch) + prompts.shape[1] + n_gen,
                             device=prompts.device)
    vocab = model.cfg.vocab  # the padded vocab's columns hold -1e30, no scale
    out = []
    for t in range(n_gen):
        if t == 0:
            logits, cache = model.prefill(lm, batch, cache)
        else:
            logits, cache = model.decode_step(lm, cache, run.tokens[:, t - 1:t])
        plain, kern = logits[:, -1, :vocab].float(), run.logits[t][:, :vocab].float()
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


#: device kernels as torch.profiler names them, by the wrapper's entry
FLASH_KERNELS = {"simt": ("flash_attention_kernel",), "mma": ("flash_attention_mma_kernel",),
                 "mma_split": ("flash_attention_split_kernel", "flash_attention_combine_kernel")}
RWKV_KERNELS = {"sequential": ("rwkv6_scan_kernel",), "chunked": ("rwkv6_scan_chunked_kernel",)}


def entry_counts(km, kernels: dict):
    """Launches of each of a kernel module's device kernels (``kernels``:
    their names by entry), from the wrapper's counts by entry."""
    def counts() -> dict:
        out = {name: 0 for names in kernels.values() for name in names}
        for key, n in km.LAUNCHES.items():
            for name in kernels[key[0]]:
                out[name] += n
        return out
    return counts


def profile_serving(model, lm, prompts, run, kernels: dict, tag: str,
                    extras: dict | None = None) -> dict:
    """Prints each kernel's share of device time under torch.profiler, for
    one prefill (of ``prompts`` and ``extras``) and then 8 decode steps of
    ``run``'s tokens; ``kernels``
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
    busy_p, named_p, wall_p, n_p, want = device_busy_counted(
        lambda: serve.generate(model, lm, prompts, 1, extras=extras), names, counted, reset)
    share_p = kernel_shares(busy_p, named_p, wall_p, want, f"{tag} prefill")
    batch = dict(extras or {}, tokens=prompts)
    cache = model.init_cache(requests, model.prefix_len(batch) + prompts.shape[1] + n_gen,
                             device=prompts.device)
    _, cache = model.prefill(lm, batch, cache)

    def decode8():
        c = dict(cache)
        for i in range(8):
            _, c = model.decode_step(lm, c, run.tokens[:, i:i + 1])

    busy_d, named_d, wall_d, n_d, want = device_busy_counted(decode8, names, counted, reset)
    share_d = kernel_shares(busy_d, named_d, wall_d, want, f"{tag} decode")
    print(f"[{tag}] profiled prefill: {n_p} device kernels, {busy_p:.5f} s of {wall_p:.4f} s "
          f"wall; {share_p}\n[{tag}] profiled 8 decode steps: {n_d} device kernels "
          f"({n_d / 8:.1f} per step), {busy_d:.5f} s of {wall_d:.4f} s wall; {share_d}")
    return dict(kernels_per_decode_step=n_d / 8, prefill_busy=busy_p / wall_p if wall_p else 0.0,
                decode_busy=busy_d / wall_d if wall_d else 0.0)


#: a SMOKE model at f32 compute, card against CPU through the bf16 caches:
#: teacher-forced last-position logits within this of their scale
SMOKE_F32_TOL = 1e-3


def float32_cache(model, batch: int, rows: int, device) -> dict:
    """``model``'s cache with its bf16 arrays held in float32: the attention
    layer writes and reads whatever float dtype its cache holds, as the JAX
    layer does. A witness only; the models' own caches are bf16."""
    import torch

    return {k: v.float() if torch.is_tensor(v) and v.dtype == torch.bfloat16 else v
            for k, v in model.init_cache(batch, rows, device=device).items()}


def teacher_forced(model, lm, batch: dict, cache: dict, tokens, cpu_logits, vocab: int):
    """The card's last-position logits along the CPU's ``tokens`` [B, n]
    from ``cache``, against the CPU's ``cpu_logits`` (one [B, Vp] per step):
    (per step the largest |card - CPU| of each request, per step the CPU's
    top-2 gap of each request, the largest distance over the CPU logits'
    scale, the card's cache after the last step)."""
    dist, gaps, worst = [], [], 0.0
    for t in range(tokens.shape[1]):
        if t == 0:
            logits, cache = model.prefill(lm, batch, cache)
        else:
            logits, cache = model.decode_step(lm, cache,
                                              tokens[:, t - 1:t].to(batch["tokens"].device))
        card, cpu = logits[:, -1, :vocab].float().cpu(), cpu_logits[t][:, :vocab].float()
        top2 = cpu.topk(2, dim=-1).values
        dist.append((card - cpu).abs().amax(-1))
        gaps.append(top2[:, 0] - top2[:, 1])
        worst = max(worst, float((card - cpu).abs().max()) / float(cpu.abs().max()))
    return dist, gaps, worst, cache


def bf16_entries_apart(card_cache: dict, cpu_cache: dict) -> tuple[int, int, int]:
    """(entries that differ, entries, the largest difference in bf16 ulps)
    over the bf16 arrays of two caches of the same model."""
    import torch

    apart = total = ulps = 0
    for k, a in cpu_cache.items():
        if not (torch.is_tensor(a) and a.dtype == torch.bfloat16):
            continue
        d = (card_cache[k].cpu().view(torch.int16).int() - a.view(torch.int16).int()).abs()
        apart, total = apart + int((d != 0).sum()), total + d.numel()
        ulps = max(ulps, int(d.max()))
    return apart, total, ulps


def smoke_card_matches_cpu(arch: str, device, tag: str, adjust=None, prompt_len: int = 16,
                           near_ties: bool = False, seed: int = SEED) -> None:
    """The SMOKE model of ``arch`` at float32 compute, weights, prompts and
    any patch or frame embeddings drawn on the CPU from ``seed`` (then the
    weights passed to ``adjust(lm, generator)`` if given): 8 greedy tokens
    for 2 requests of ``prompt_len`` must be the same on the card as on the
    CPU, and, teacher-forced along the CPU's tokens, the card's logits must
    lie within SMOKE_F32_TOL of their scale of the CPU's at every step. The
    bf16 cache entries that the two devices rounded to different neighbours
    are counted. With ``near_ties`` a request's tokens may part at a step
    where the CPU's top-2 gap is narrower than the two devices' logit
    distance in that row, and only there, and only if the witness holds:
    the same run with float32 caches on both devices (``float32_cache``)
    gives the card the CPU's tokens, strictly, at a smaller teacher-forced
    distance; so the parting comes from the bf16 cache's roundings."""
    import dataclasses as dc

    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed.serve_step import greedy_generate, greedy_steps
    from repro_torch.launch import serve

    smoke = dc.replace(get_config(arch, smoke=True), compute_dtype=torch.float32)
    s_model, s_lm, s_prompts, s_extras = serve.prepare(smoke, requests=2, prompt_len=prompt_len,
                                                       seed=seed, device="cpu")
    if adjust is not None:
        adjust(s_lm, torch.Generator().manual_seed(seed))
    n = 8
    want = serve.generate(s_model, s_lm, s_prompts, n, extras=s_extras, keep_logits=True)
    cpu_batch = dict(s_extras, tokens=s_prompts)
    rows = s_model.prefix_len(cpu_batch) + prompt_len + n
    _, cpu_cache = greedy_generate(s_model, s_lm, cpu_batch,
                                   s_model.init_cache(2, rows, device="cpu"), n)
    if near_ties:  # the witness's CPU side, with float32 caches
        steps = list(greedy_steps(s_model, s_lm, cpu_batch,
                                  float32_cache(s_model, 2, rows, "cpu"), n))
        want32 = torch.stack([tok for tok, _, _ in steps], dim=1)
        logits32 = [lg[:, -1] for _, lg, _ in steps]
    card_lm = s_lm.to(device)  # in place: the CPU runs come first
    extras = {k: x.to(device) for k, x in s_extras.items()}
    got = serve.generate(s_model, card_lm, s_prompts.to(device), n, extras=extras).tokens.cpu()
    V, batch = smoke.vocab, dict(extras, tokens=s_prompts.to(device))
    dist, gaps, worst, cache = teacher_forced(s_model, card_lm, batch,
                                              s_model.init_cache(2, rows, device=device),
                                              want.tokens, want.logits, V)
    check(worst <= SMOKE_F32_TOL, f"{arch} SMOKE f32: teacher-forced card logits {worst:.3g} of "
          f"their scale from the CPU's (tol {SMOKE_F32_TOL})")
    apart, total, ulps = bf16_entries_apart(cache, cpu_cache)
    parted = []
    for r in range(2):
        off = (got[r] != want.tokens[r]).nonzero()
        if len(off):
            t = int(off[0])
            check(near_ties and float(gaps[t][r]) < float(dist[t][r]),
                  f"{arch} SMOKE f32: request {r}'s card tokens {got[r].tolist()} leave the CPU's "
                  f"{want.tokens[r].tolist()} at step {t}, where the CPU's top-2 gap "
                  f"{float(gaps[t][r]):.3g} is wider than the devices' logit distance "
                  f"{float(dist[t][r]):.3g}")
            parted.append(f"request {r} from step {t} (a near-tie: the CPU's top-2 gap "
                          f"{float(gaps[t][r]):.3g} < the devices' distance "
                          f"{float(dist[t][r]):.3g})")
    print(f"[{tag}] SMOKE {arch} seed {seed} at f32 compute, 2 x ({prompt_len} + 8): card tokens "
          f"{'== CPU tokens' if not parted else 'part from the CPU tokens at ' + '; '.join(parted)}"
          f" {want.tokens[0].tolist()}; teacher-forced logits within {worst:.3g} of their scale "
          f"(tol {SMOKE_F32_TOL}); bf16 cache entries apart {apart} of {total} (at most {ulps} "
          f"ulp)")
    if not parted:
        return
    # the witness: float32 caches on both devices
    got32, _ = greedy_generate(s_model, card_lm, batch, float32_cache(s_model, 2, rows, device), n)
    _, _, worst32, _ = teacher_forced(s_model, card_lm, batch,
                                      float32_cache(s_model, 2, rows, device), want32, logits32, V)
    check(torch.equal(got32.cpu(), want32),
          f"{arch} SMOKE f32 with float32 caches: card tokens {got32.cpu().tolist()}, CPU "
          f"{want32.tolist()}")
    check(worst32 < worst, f"{arch} SMOKE f32: teacher-forced distance {worst32:.3g} with float32 "
          f"caches, not below {worst:.3g} with bf16 ones")
    print(f"[{tag}] SMOKE {arch} seed {seed}, witness with float32 caches on both devices: card "
          f"tokens == CPU tokens {want32[0].tolist()}; teacher-forced logits within "
          f"{worst32:.3g} of their scale (bf16 caches: {worst:.3g})")


def phase_serve(device, smoke: bool = False, requests: int = 8, prompt_len: int = 512,
                n_gen: int = 32) -> dict:
    """The serving path at full width: ``tinyllama-1.1b`` (22 layers, d_model
    2048, weights drawn on the card from SEED) through ``serve_arch``:
    admission of 8 streams on H100_HOST through the CUDA scorer, 8 requests
    of 512 prompt tokens and 32 generated tokens by the kernel route, flash
    launches exactly 22 x 32, the teacher-forced plain-route replay within
    REPLAY_TOL; then ``jax_scale_witness`` runs the prefill at the JAX init
    scale, and a SMOKE run at f32 compute must give the card the CPU's
    tokens. Returns the path's numbers. ``smoke`` and the sizes shrink it
    for a rehearsal on the CPU."""
    from repro_torch.configs import get_config

    cfg = get_config("tinyllama-1.1b", smoke=smoke)
    out = serve_arch(device, cfg, "9 serve", requests=requests, prompt_len=prompt_len,
                     n_gen=n_gen, want_launches=cfg.n_layers * n_gen)
    prompts = out["prompts"]
    drop_models(out)
    if device.type != "cuda":
        return out
    free_card()
    out["witness"] = jax_scale_witness(cfg, prompts, device)
    # a SMOKE model at float32 compute: the card's tokens are the CPU's
    smoke_card_matches_cpu("tinyllama-1.1b", device, "9 serve")
    return out


#: rwkv6_scan vs its plain version and the float64 recurrence (tests/test_kernels.py's
#: bounds for the Pallas kernel): float32 sums over dh terms and the tokens' decays
RWKV_ATOL, RWKV_RTOL = 5e-4, 1e-3
#: (label, B, S, H, dh, r/k/v dtype, nonzero s0, strong decays): the
#: serving path's shapes (rwkv6-7b, 8 requests, prompt 512: the prefill from
#: a zero state, decode from the prefill's), the prefill under the strongest
#: decays the served model can draw, ragged S, the SMOKE head size and
#: float32 r/k/v
RWKV_SHAPES = [
    ("prefill", 8, 512, 64, 64, "bfloat16", False, False),
    ("strong decay", 8, 512, 64, 64, "bfloat16", False, True),
    ("decode", 8, 1, 64, 64, "bfloat16", True, False),
    ("ragged S=17", 8, 17, 64, 64, "bfloat16", True, False),
    ("ragged S=33", 8, 33, 64, 64, "bfloat16", True, False),
    ("SMOKE dh=16", 2, 33, 4, 16, "bfloat16", True, False),
    ("SMOKE dh=16 decode", 2, 1, 4, 16, "float32", True, False),
    ("f32", 2, 65, 8, 64, "float32", True, False),
]
#: the shapes at which the kernel is held to float64 against its plain
#: version: no further than twice the plain version's error
RWKV_WITNESS = ("prefill", "strong decay", "ragged S=33")


def rwkv_inputs(B, S, H, dh, dtype, nonzero_s0, strong, gen, device):
    """Seeded WKV inputs on ``device``: r, k, v ~ N(0, 1) in ``dtype``,
    wlog = -exp(0.5 N(0, 1)) per channel and token, or with ``strong``
    -exp(U[-6, 2]) (down to -e^2 per token, as ``perturb_decay``'s
    ``w_base`` up to 1 with its LoRA can give), u ~ 0.1 N(0, 1), s0
    ~ N(0, 1) or zeros."""
    import torch

    rand = lambda *shape: torch.randn(*shape, generator=gen, device=device)  # noqa: E731
    dt = getattr(torch, dtype)
    r, k, v = (rand(B, S, H, dh).to(dt) for _ in range(3))
    if strong:
        wlog = -torch.exp(torch.rand(B, S, H, dh, generator=gen, device=device) * 8.0 - 6.0)
    else:
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
    shape, on the entry ``ks.entry`` picks (every bf16 call with S > 1 on
    the chunked one); at RWKV_WITNESS both against ``rwkv6_ref`` in float64,
    where the kernel may lie no further from it than twice the plain
    version; device times of the kernel and the plain version beside the
    bound (no PyTorch call computes WKV6). Returns the rows by label."""
    import torch
    from repro_torch.kernels import rwkv6_scan as ks

    on_card = device.type == "cuda"
    gen = torch.Generator(device).manual_seed(SEED + 4)
    rows = {}
    for label, B, S, H, dh, dtype, nonzero, strong in RWKV_SHAPES:
        args = rwkv_inputs(B, S, H, dh, dtype, nonzero, strong, gen, device)
        ks.reset_launches()
        got = ks.rwkv6_scan(*args)
        if on_card:
            torch.cuda.synchronize()
            name = ks.entry(args[0].dtype, S)
            check(dict(ks.LAUNCHES) == {(name, B, S, H, dh): 1},
                  f"rwkv6_scan {label}: launches {dict(ks.LAUNCHES)}, want one on the {name} entry")
            check(name == ("chunked" if dtype == "bfloat16" and S > 1 else "sequential"),
                  f"rwkv6_scan {label}: {dtype} S={S} ran the {name} entry")
        want = ks.rwkv6_scan_torch(*args)
        err = rwkv_err(got, want, f"rwkv6_scan {label}")
        row = dict(max_abs_err=err, entry=ks.entry(args[0].dtype, S),
                   shape=f"B={B} S={S} H={H} dh={dh} {dtype} r/k/v, "
                   f"{'nonzero' if nonzero else 'zero'} s0{', strong decays' if strong else ''}")
        if label in RWKV_WITNESS:
            ref = rwkv_ref64(*args)
            row["ref_err"] = rwkv_err(got, ref, f"rwkv6_scan {label} vs float64")
            row["plain_ref_err"] = rwkv_err(want, ref, f"rwkv6_scan_torch {label} vs float64")
            check(row["ref_err"] <= 2 * row["plain_ref_err"],
                  f"rwkv6_scan {label}: the kernel is {row['ref_err']:.3g} from float64, the "
                  f"plain version {row['plain_ref_err']:.3g}")
            del ref
        row["bound_ms"], row["bound_by"] = rwkv_bound_ms(B, S, H, dh, args[0].element_size())
        row["library_ms"] = None
        if on_card:
            row["ms"] = device_ms(lambda: ks.rwkv6_scan(*args))
            row["plain_ms"] = device_ms(lambda: ks.rwkv6_scan_torch(*args),
                                        reps=5 if S > 64 else 20)
        rows[label] = row
        times = (f"device ms kernel {row['ms']:.5f} plain {row['plain_ms']:.5f}" if on_card
                 else "device ms not measured")
        ref_text = (f", vs float64 {row['ref_err']:.3g} (plain {row['plain_ref_err']:.3g})"
                    if "ref_err" in row else "")
        print(f"[10 rwkv6_scan] {label} ({row['shape']}): {row['entry']} entry, err {err:.3g}"
              f"{ref_text} (atol {RWKV_ATOL} rtol {RWKV_RTOL}), {times}, bound "
              f"{row['bound_ms']:.5f} by {row['bound_by']}, library none")
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
    model, lm, prompts, _ = serve.prepare(f32, requests=requests, prompt_len=prompt_len, seed=SEED,
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
    model, lm, prompts, _ = serve.prepare(cfg, requests=requests, prompt_len=prompt_len, seed=SEED,
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
    entries = by_entry(launches)
    check(n_launch == cfg.n_layers * n_gen or not on_card,
          f"serving launched rwkv6_scan {n_launch} times, want {cfg.n_layers} x {n_gen}")
    # the prefill's bf16 calls on the tensor cores, every decode step sequential
    check(not on_card or entries == {"chunked": cfg.n_layers,
                                     "sequential": cfg.n_layers * (n_gen - 1)},
          f"serving's rwkv6_scan launches by entry {entries}, want {cfg.n_layers} chunked and "
          f"{cfg.n_layers * (n_gen - 1)} sequential")
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
          f"{state_bytes / 1e6:.1f} MB); rwkv6_scan launches {n_launch} by entry {entries} over "
          f"{len(launches)} shapes {sorted(launches)}")

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
    out = dict(launches=n_launch, by_entry=entries, prefill_ms=1e3 * run.prefill_s,
               decode_ms=statistics.mean(decode_ms), replay_gaps=[g[0] for g in gaps],
               witness=witness, shadow_err=shadow["max_abs_err"], peak_gib=peak / 2**30)
    if not on_card:
        return out

    profile_serving(model, lm, prompts, run, {ks: entry_counts(ks, RWKV_KERNELS)},
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
            # the model entry's exponentials alone, one per (b, t, e, n), on the SFU
            row["sfu_ms"] = 1e3 * B * S * E * N / SFU_EX2_PER_S if entry == "model" else None
            row["library_ms"] = None
            if on_card:
                row["ms"] = device_ms(lambda: kernel(*args))
                row["plain_ms"] = device_ms(lambda: plain(*args), reps=3 if S > 64 else 20)
            rows[(entry, label)] = row
            times = (f"device ms kernel {row['ms']:.5f} plain {row['plain_ms']:.5f}" if on_card
                     else "device ms not measured")
            ref_text = f", vs float64 {row['ref_err']:.3g}" if "ref_err" in row else ""
            sfu_text = (f", SFU floor {row['sfu_ms']:.5f} ({B * S * E * N} ex2)"
                        if row["sfu_ms"] is not None else "")
            print(f"[12 mamba_scan] {entry} {label} ({row['shape']}): err {err:.3g}{ref_text} "
                  f"(atol {MAMBA_ATOL} rtol {MAMBA_RTOL}), {times}, bound {row['bound_ms']:.5f} "
                  f"by {row['bound_by']}{sfu_text}, library none")
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
    model, lm, prompts, _ = serve.prepare(f32, requests=requests, prompt_len=prompt_len, seed=SEED,
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
    model, lm, prompts, _ = serve.prepare(cfg, requests=requests, prompt_len=prompt_len, seed=SEED,
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
        km: launch_counts("mamba_scan_kernel", km), kf: entry_counts(kf, FLASH_KERNELS)},
        "13 serve jamba"))
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


# -- phase 17: the purity audit -------------------------------------------------

#: the teacher-forced replay's limit on the logits' gap, in units of their scale
REPLAY_TOL = 2e-2


def serve_arch(device, cfg, tag: str, *, requests: int, prompt_len: int, n_gen: int,
               want_launches: int) -> dict:
    """One serving phase's common path: admission of ``requests`` streams on
    H100_HOST through the CUDA scorer, then ``cfg`` (weights, prompts and any
    patch or frame embeddings drawn on the card from SEED) serving
    ``requests`` x (``prompt_len`` + ``n_gen``) tokens by the kernel route,
    which must launch flash_attention exactly ``want_launches`` times, all on
    the tensor-core entries, and give finite logits and in-vocab tokens; the
    teacher-forced replay on the plain route must give logits within
    REPLAY_TOL of their scale and the same argmax wherever the top-2 gap is
    wider; the kernel's share of device time under torch.profiler. Returns
    the numbers and, under "model", "lm", "prompts", "extras" and "run",
    what a phase checks further (the caller drops them)."""
    import gc

    import torch
    from repro_torch.core import H100_HOST
    from repro_torch.kernels import consolidation as kc
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.launch import serve

    on_card = device.type == "cuda"
    if on_card:
        gc.collect()
        torch.cuda.empty_cache()
    kc.reset_launches()
    placements = serve.admission_check(cfg.name, requests, host=H100_HOST, device=device)
    check(all(p is not None for p in placements), f"admission queued a stream: {placements}")
    check(sum(kc.LAUNCHES.values()) > 0 or not on_card,
          "admission never launched consolidation_scores")
    print(f"[{tag}] admission of {requests} streams on 2 x {H100_HOST.name}: {placements}, "
          f"consolidation_scores launches {sum(kc.LAUNCHES.values())}")

    t0 = time.perf_counter()
    model, lm, prompts, extras = serve.prepare(cfg, requests=requests, prompt_len=prompt_len,
                                               seed=SEED, device=device)
    if on_card:
        torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in lm.parameters())
    weight_bytes = sum(p.numel() * p.element_size() for p in lm.parameters())
    serve.generate(model, lm, prompts, 2, extras=extras)  # warm-up: cuBLAS, the allocator
    if on_card:
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    kf.reset_launches()
    run = serve.generate(model, lm, prompts, n_gen, extras=extras, keep_logits=True)
    launches = dict(kf.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    n_launch = sum(launches.values())
    check(n_launch == want_launches or not on_card,
          f"{cfg.name}: serving launched flash_attention {n_launch} times, want {want_launches}")
    check(all(key[0] in ("mma", "mma_split") for key in launches),
          f"{cfg.name}: flash launches left the tensor-core entries: {sorted(launches)}")
    check(tuple(run.tokens.shape) == (requests, n_gen), f"tokens {tuple(run.tokens.shape)}")
    check(bool(((run.tokens >= 0) & (run.tokens < cfg.vocab)).all()), "token out of the vocab")
    check(all(bool(torch.isfinite(x.float()).all()) for x in run.logits), "non-finite logits")
    decode_ms = [1e3 * t for t in run.decode_s]
    total = run.prefill_s + sum(run.decode_s)
    prefix = ", ".join(f"{k} {tuple(x.shape)}" for k, x in extras.items())
    print(f"[{tag}] {cfg.name} {n_params / 1e9:.3f} B params ({weight_bytes / 1e9:.2f} GB, "
          f"drawn in {init_s:.2f} s), {requests} requests x prompt {prompt_len} + {n_gen} tokens"
          f"{' beside ' + prefix if prefix else ''}: prefill {1e3 * run.prefill_s:.3f} ms, decode "
          f"{statistics.mean(decode_ms):.3f} ms/step (median {statistics.median(decode_ms):.3f}, "
          f"min {min(decode_ms):.3f}, max {max(decode_ms):.3f}), {requests * n_gen / total:.1f} "
          f"tokens/s over {total:.3f} s, peak device memory {peak / 2**30:.3f} GiB; "
          f"flash_attention launches {n_launch} over {len(launches)} shapes, by entry "
          f"{by_entry(launches)}")

    lm.mode = "torch"
    gaps = replay_gaps(model, lm, prompts, run, REPLAY_TOL, extras)
    lm.mode = None
    for t, (rel, _, wide_flips) in enumerate(gaps):
        check(rel <= REPLAY_TOL, f"{cfg.name} step {t}: plain and kernel routes' logits differ "
              f"by {rel:.3g} of their scale")
        check(wide_flips == 0, f"{cfg.name} step {t}: argmax differs where the top-2 gap "
              f"exceeds {REPLAY_TOL} of the scale")
    check(sum(kf.LAUNCHES.values()) == n_launch, "the plain route launched the kernel")
    worst_rel, flips = max(g[0] for g in gaps), sum(g[1] for g in gaps)
    print(f"[{tag}] plain route teacher-forced over {n_gen} steps: logits within "
          f"{worst_rel:.3g} of their scale (tol {REPLAY_TOL}; prefill {gaps[0][0]:.3g}); argmax "
          f"differs in {flips} of {requests * n_gen} places, none where the top-2 gap exceeds "
          f"the tolerance")
    out = dict(launches=n_launch, by_entry=by_entry(launches), n_params=n_params,
               weight_gb=weight_bytes / 1e9, init_s=init_s, prefill_ms=1e3 * run.prefill_s,
               decode_ms=statistics.mean(decode_ms), tokens_per_s=requests * n_gen / total,
               peak_gib=peak / 2**30, worst_rel=worst_rel, prefill_rel=gaps[0][0], flips=flips,
               model=model, lm=lm, prompts=prompts, extras=extras, run=run)
    if on_card:
        out.update(profile_serving(model, lm, prompts, run, {kf: entry_counts(kf, FLASH_KERNELS)},
                                   tag, extras))
    return out


def drop_models(out: dict) -> dict:
    """A serving phase's numbers without its model and tensors."""
    for key in ("model", "lm", "prompts", "extras", "run"):
        out.pop(key, None)
    return out


def int8_route_row(tag: str, label: str, q, codes, scales, *, q_offset: int) -> dict:
    """The int8 route of one attention call (``layers.attention_apply`` on an
    int8 cache): the visible rows' codes [B, T, Hkv, dh] and scales
    [B, T, Hkv] dequantized to bf16, then the kernel (causal, at
    ``q_offset``). Held to the plain version on the dequantized rows like
    ``flash_row``; device ms of the kernel alone, of the route (dequantize
    both + kernel), of the plain route and of SDPA on the dequantized rows,
    beside the route's bound: q and out, the codes and scales read once
    (what a kernel that dequantizes in its tile loads would move)."""
    import torch
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.models.layers import dequantize_kv

    B, Sq, H, dh = q.shape
    T, Hkv = codes[0].shape[1], codes[0].shape[2]

    def deq():
        return (dequantize_kv(codes[0], scales[0], torch.bfloat16),
                dequantize_kv(codes[1], scales[1], torch.bfloat16))

    rk, rv = deq()
    check(rk.is_contiguous() and rk.data_ptr() != codes[0].data_ptr(),
          f"{label}: the kernel's k is not a fresh dequantized buffer")
    row = flash_row(tag, label, q, rk, rv, causal=True, q_offset=q_offset)
    row["kernel_ms"] = row["ms"]
    row["ms"] = device_ms(lambda: kf.flash_attention(q, *deq(), causal=True, q_offset=q_offset))
    row["plain_ms"] = device_ms(
        lambda: kf.flash_attention_torch(q, *deq(), causal=True, q_offset=q_offset))
    row["library_ms"] = device_ms(lambda: sdpa_form(q, *deq(), True, q_offset))
    row["bound_ms"], row["bound_by"] = flash_bound_ms(
        B, Sq, T, H, Hkv, dh, True, q_offset, 2, 1 + 2 / dh)
    row["shape"] = (f"B={B} Sq={Sq} visible T={T} H={H} Hkv={Hkv} dh={dh} causal "
                    f"q_offset={q_offset}, int8 codes + bf16 scales dequantized to bf16")
    print(f"[{tag}] {label} int8 route: device ms dequantize + kernel {row['ms']:.5f} (kernel "
          f"{row['kernel_ms']:.5f}), plain {row['plain_ms']:.5f}, SDPA on the dequantized rows "
          f"{row['library_ms']:.5f}, bound {row['bound_ms']:.5f} by {row['bound_by']} (codes "
          f"and scales read once)")
    return row


def phase_serve_int8(device, smoke: bool = False, requests: int = 8, prompt_len: int = 512,
                     n_gen: int = 32) -> dict:
    """Phase 18, the int8 KV cache: ``tinyllama-1.1b`` at full width with
    ``kv_cache_dtype='int8'`` through ``serve_arch`` (22 x 32 flash
    launches; the teacher-forced replay within REPLAY_TOL), the cache's
    bytes beside the bf16 cache's, and the int8 route's attention at the
    served prefill and decode@542 (``int8_route_row``). Returns the
    numbers; ``smoke`` and the sizes shrink it for a rehearsal on the CPU."""
    import dataclasses as dc
    import math

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.layers import quantize_kv

    tag = "18 serve int8"
    cfg = dc.replace(get_config("tinyllama-1.1b", smoke=smoke), kv_cache_dtype="int8")
    out = serve_arch(device, cfg, tag, requests=requests, prompt_len=prompt_len, n_gen=n_gen,
                     want_launches=cfg.n_layers * n_gen)
    model = out["model"]

    def cache_bytes(c) -> int:
        from repro_torch.models.api import build_model

        return sum(math.prod(i.shape) * i.dtype.itemsize
                   for i in build_model(c).cache_infos(requests, prompt_len + n_gen).values())

    out["cache_mb"] = cache_bytes(cfg) / 1e6
    out["bf16_cache_mb"] = cache_bytes(dc.replace(cfg, kv_cache_dtype="bf16")) / 1e6
    check(set(model.init_cache(1, 1, device=device)) == {"k", "v", "k_scale", "v_scale", "len"},
          "the int8 cache lacks its scales")
    print(f"[{tag}] KV cache {out['cache_mb']:.3f} MB (int8 codes + bf16 scales) against "
          f"{out['bf16_cache_mb']:.3f} MB in bf16, x{out['cache_mb'] / out['bf16_cache_mb']:.4f}")
    drop_models(out)
    if device.type != "cuda":
        return out
    gen = torch.Generator(device).manual_seed(SEED + 7)
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    rows = {}
    for label, Sq, T, off in (("prefill", prompt_len, prompt_len, 0),
                              ("decode@542", 1, prompt_len + n_gen - 1, prompt_len + n_gen - 2)):
        q = torch.randn(requests, Sq, H, dh, generator=gen, device=device).bfloat16()
        kv = [quantize_kv(torch.randn(requests, T, Hkv, dh, generator=gen, device=device)
                          .bfloat16()) for _ in range(2)]
        rows[label] = int8_route_row(tag, label, q, [c for c, _ in kv], [s for _, s in kv],
                                     q_offset=off)
    out["rows"] = rows
    return out


def moe_params(cfg) -> int:
    """The MoE transformer's parameters, reckoned from its widths: per layer
    attention (4 D H dh), router (D E), experts (E (2 D F + F D)) and two
    norms (2 D); the embedding and the untied head (2 Vp D) and the final
    norm (D)."""
    from repro_torch.models.layers import padded_vocab

    D, E, F = cfg.d_model, cfg.moe_experts, cfg.moe_dff
    layer = 4 * D * cfg.n_heads * cfg.d_head + D * E + E * 3 * D * F + 2 * D
    return cfg.n_layers * layer + 2 * padded_vocab(cfg.vocab) * D + D


def phase_serve_moe(device, smoke: bool = False, requests: int = 8, prompt_len: int = 512,
                    n_gen: int = 32) -> dict:
    """Phase 19, the MoE LM: ``moonshot-v1-16b-a3b`` at its published widths
    and depth (48 layers, 64 experts, top 6) with bf16 weights (56 GB, drawn
    on the card), its parameter count held to ``moe_params``, through
    ``serve_arch`` (48 x 32 flash launches; the teacher-forced replay within
    REPLAY_TOL); then the kimi and moonshot SMOKE models at f32 compute,
    whose tokens on the card must equal the CPU's (kimi's at three seeds,
    each up to a near-tie that float32 caches on both devices remove; its
    published dh of 112 is not one the kernel takes). Returns the
    numbers."""
    import dataclasses as dc

    import torch
    from repro_torch.configs import get_config

    tag = "19 serve moe"
    cfg = dc.replace(get_config("moonshot-v1-16b-a3b", smoke=smoke), param_dtype=torch.bfloat16)
    out = serve_arch(device, cfg, tag, requests=requests, prompt_len=prompt_len, n_gen=n_gen,
                     want_launches=cfg.n_layers * n_gen)
    from repro_torch.models.layers import padded_vocab

    D, Vp = cfg.d_model, padded_vocab(cfg.vocab)
    check(out["n_params"] == moe_params(cfg),
          f"moonshot: {out['n_params']} parameters, reckoned {moe_params(cfg)}")
    print(f"[{tag}] {out['n_params']} parameters = {cfg.n_layers} layers x "
          f"{(out['n_params'] - 2 * Vp * D - D) // cfg.n_layers} + 2 x {Vp} x {D} + {D}, as "
          f"reckoned from the widths; {out['weight_gb']:.2f} GB of weights")
    drop_models(out)
    if device.type == "cuda":
        free_card()
        # kimi's SMOKE at seed 0 meets a near-tie (a top-2 gap of 1.0e-5 on
        # the CPU) before its eighth token; seeds 1 and 2 are further draws
        for seed in (SEED, SEED + 1, SEED + 2):
            smoke_card_matches_cpu("kimi-k2-1t-a32b", device, tag, near_ties=True, seed=seed)
        smoke_card_matches_cpu("moonshot-v1-16b-a3b", device, tag)
    return out


def phase_serve_whisper(device, smoke: bool = False, requests: int = 8, prompt_len: int = 416,
                        n_gen: int = 32) -> dict:
    """Phase 20, the encoder-decoder: ``whisper-medium`` at full width (24
    encoder and 24 decoder layers over 1500 frame embeddings) serving 8
    requests of 416 prompt tokens and 32 generated (within Whisper's 448)
    through ``serve_arch``: 24 encoder + 24 x 32 self + 24 x 32 cross flash
    launches, the teacher-forced replay within REPLAY_TOL. The kernel's two
    new uses are held to the plain version at these shapes (``flash_row``):
    the encoder's non-causal self-attention (Sq = Skv = 1500, not a multiple
    of the kv tile), the cross-attention at the prefill (Sq 416, Skv 1500)
    and at decode (Sq 1, the split entry, causal off); a SMOKE run at f32
    compute must give the card the CPU's tokens. Returns the numbers."""
    import torch
    from repro_torch.configs import get_config

    tag = "20 serve whisper"
    cfg = get_config("whisper-medium", smoke=smoke)
    out = serve_arch(device, cfg, tag, requests=requests, prompt_len=prompt_len, n_gen=n_gen,
                     want_launches=cfg.enc_layers + 2 * cfg.n_layers * n_gen)
    drop_models(out)
    if device.type != "cuda":
        return out
    gen = torch.Generator(device).manual_seed(SEED + 8)
    B, H, Hkv, dh, T = requests, cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.enc_seq
    rows = {}
    for label, Sq in (("encoder", T), ("cross prefill", prompt_len), ("cross decode", 1)):
        q = torch.randn(B, Sq, H, dh, generator=gen, device=device).bfloat16()
        k, v = (torch.randn(B, T, Hkv, dh, generator=gen, device=device).bfloat16()
                for _ in range(2))
        rows[label] = flash_row(tag, label, q, k, v, causal=False)
    out["rows"] = rows
    smoke_card_matches_cpu("whisper-medium", device, tag)
    return out


def phase_serve_vlm(device, smoke: bool = False, requests: int = 8, prompt_len: int = 512,
                    n_gen: int = 32) -> dict:
    """Phase 21, the vlm: ``internvl2-2b`` at full width (24 layers, dh 128)
    serving 8 requests of 256 patch embeddings and 512 prompt tokens and 32
    generated through ``serve_arch`` (24 x 32 flash launches; the
    teacher-forced replay within REPLAY_TOL), its cache sized for the
    patches (768 + 32 rows and the pad, where the JAX serve script's 672 would not
    hold the prefill); a SMOKE run at f32 compute must give the card the
    CPU's tokens. Returns the numbers."""
    from repro_torch.configs import get_config
    from repro_torch.models.api import CACHE_PAD

    tag = "21 serve vlm"
    cfg = get_config("internvl2-2b", smoke=smoke)
    out = serve_arch(device, cfg, tag, requests=requests, prompt_len=prompt_len, n_gen=n_gen,
                     want_launches=cfg.n_layers * n_gen)
    rows, prefill = cfg.vis_tokens + prompt_len + n_gen + CACHE_PAD, cfg.vis_tokens + prompt_len
    jax_rows = prompt_len + n_gen + CACHE_PAD
    print(f"[{tag}] cache of {rows} rows: {cfg.vis_tokens} patches + {prompt_len} prompt + "
          f"{n_gen} generated + {CACHE_PAD} pad; the JAX serve script's {jax_rows} rows "
          f"{'would not' if jax_rows < prefill else 'would'} hold the prefill's {prefill}")
    drop_models(out)
    if device.type == "cuda":
        smoke_card_matches_cpu("internvl2-2b", device, tag)
    return out


#: phase 22's cut for the checks that compare runs (card against CPU,
#: microbatches, resume): the published widths at this depth
TRAIN_CHECK_LAYERS = 2
#: the attention gradient at the training shape, bf16: the Function's dq,
#: dk, dv (a bf16 chunked backward: scores and weights rounded to bf16, as
#: JAX's) against autograd through the kernel's plain version (float32
#: scores), each as a share of the plain gradient's largest |.|: a few bf16
#: ulps (2 ** -8 = 0.0039), FLASH_TOL's bf16 limit for the forward
TRAIN_GRAD_TOL = 2e-2
#: ... and both against a float64 witness on one batch row and kv head
TRAIN_GRAD64_TOL = 2e-2
#: card against CPU and microbatches, float32 compute: the loss (relative),
#: the grad norm (relative), m after one step (= 0.1 x the clipped
#: gradient; of each leaf's largest |.|)
TRAIN_F32_TOL = {"loss": 1e-5, "grad_norm": 1e-5, "m": 2e-5}
# Masters after one float32 step, two runs apart, in units of lr: Adam's
# first update moves an entry by ~lr g / (|g| + eps), so entries with |g|
# near eps and the runs' rounding noise near |g| differ most; on an H100
# the card against the CPU read 0.082 lr, two microbatches against one 0.0705.
TRAIN_MASTER_LR = 0.5


def train_pipe(cfg, batch: int, seq: int, state=None):
    """The training pipeline of ``launch.train`` (its store), from ``state``
    (a cursor) or the start."""
    from repro_torch.data import TokenPipeline, synthetic_store

    pipe = TokenPipeline(synthetic_store(n_files=2, file_mb=64, block_mb=8), vocab=cfg.vocab,
                         batch=batch, seq_len=seq)
    if state is not None:
        pipe.load_state_dict(state)
    return pipe


def on_device(b: dict, device) -> dict:
    import torch

    return {k: torch.as_tensor(v).to(device) for k, v in b.items()}


def master_gap(got, want, lr: float) -> tuple[float, int, int]:
    """(largest |got - want| over every master, in units of lr; entries
    further apart than 1e-2 lr; entries compared). After Adam's first step
    d = g / (|g| + eps) per entry, an entry whose gradient lies within the
    two runs' rounding noise of 0 may move up to 2 lr apart; one whose |g|
    is near eps and the noise near |g| moves a fraction of lr."""
    from repro_torch.tree import leaves

    worst, far, n = 0.0, 0, 0
    for a, b in zip(leaves(got), leaves(want)):
        d = (a.double() - b.to(a.device).double()).abs()
        worst = max(worst, float(d.max()) / lr)
        far += int((d > 1e-2 * lr).sum())
        n += d.numel()
    return worst, far, n


def leaf_gap(got, want) -> float:
    """Largest |got - want| of each leaf over its largest |want|, worst leaf
    (on ``got``'s device)."""
    from repro_torch.tree import leaves

    return max(float((a.double() - b.to(a.device).double()).abs().max())
               / max(float(b.double().abs().max()), 1e-30)
               for a, b in zip(leaves(got), leaves(want)))


def check_f32_step(tag: str, label: str, got, want, lr: float, n_far: float = 1e-5) -> dict:
    """Two float32 train steps from the same state (``got``/``want``: the
    (params, opt_state, metrics) each returned) within TRAIN_F32_TOL: loss,
    grad norm, m (the gradient, clipped, times 0.1), v; the masters within
    TRAIN_MASTER_LR lr and at most ``n_far`` of them further than 1e-2 lr
    apart."""
    (p1, o1, m1), (p0, o0, m0) = got, want
    gaps = {k: abs(float(m1[k]) - float(m0[k])) / abs(float(m0[k])) for k in ("loss", "grad_norm")}
    gaps["m"] = leaf_gap(o1["m"], o0["m"])
    gaps["v"] = leaf_gap(o1["v"], o0["v"])
    worst, far, n = master_gap(p1, p0, lr)
    for k, tol in TRAIN_F32_TOL.items():
        check(gaps[k] <= tol, f"{tag} {label}: {k} {gaps[k]:.3g} apart (tol {tol})")
    check(gaps["v"] <= 2 * TRAIN_F32_TOL["m"], f"{tag} {label}: v {gaps['v']:.3g} apart")
    check(worst <= TRAIN_MASTER_LR and far <= n_far * n,
          f"{tag} {label}: masters up to {worst:.3g} lr apart, {far} of {n} beyond 1e-2 lr")
    print(f"[{tag}] {label}: loss {float(m1['loss']):.6f} vs {float(m0['loss']):.6f} "
          f"(rel {gaps['loss']:.3g}), grad norm rel {gaps['grad_norm']:.3g}, m {gaps['m']:.3g} "
          f"and v {gaps['v']:.3g} of their scale, masters up to {worst:.3g} lr apart with "
          f"{far} of {n} entries beyond 1e-2 lr (tol {TRAIN_F32_TOL}, masters "
          f"{TRAIN_MASTER_LR} lr)")
    return dict(gaps, master_lr=worst, master_far=far)


def attention_f64(q, k, v, causal: bool = True):
    """Model-layout GQA attention in float64, differentiable: the witness."""
    import math

    import torch

    B, S, H, dh = q.shape
    Hkv = k.shape[2]
    qf = q.reshape(B, S, Hkv, H // Hkv, dh)
    s = torch.einsum("bqhgd,bthd->bhgqt", qf, k) / math.sqrt(dh)
    if causal:
        keep = torch.ones(S, k.shape[1], dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    return torch.einsum("bhgqt,bthd->bqhgd", torch.softmax(s, -1), v).reshape(B, S, H, dh)


def train_attention_grad(tag: str, cfg, B: int, S: int, device, *, Skv: int | None = None,
                         causal: bool = True, label: str = "training forward") -> dict:
    """One layer's attention at the training shape (bf16; causal
    self-attention, or with ``causal=False`` the encoder's or, with ``Skv``
    keys, cross-attention) with a gradient: the Function (kernel forward,
    chunked plain backward) against autograd through the kernel's plain
    version on the same inputs and output gradient (out within FLASH_TOL,
    dq, dk, dv within TRAIN_GRAD_TOL of the plain gradient's scale), both
    against a float64 witness on batch row 0 and kv head 0 (its query
    group); the kernel's forward row at this shape (``flash_row``: ms,
    plain, SDPA, bound) and the forward + backward ms of the Function, the
    plain version and SDPA. Returns the numbers and the forward row."""
    import torch
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.models.layers import FlashAttention

    H, Hkv, dh, chunk = cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.attn_chunk
    Skv = S if Skv is None else Skv
    gen = torch.Generator(device).manual_seed(SEED + 22)
    q = torch.randn(B, S, H, dh, generator=gen, device=device).bfloat16()
    k, v = (torch.randn(B, Skv, Hkv, dh, generator=gen, device=device).bfloat16()
            for _ in range(2))
    dout = torch.randn(B, S, H, dh, generator=gen, device=device).bfloat16()

    def fn_route():
        x = [t.detach().requires_grad_() for t in (q, k, v)]
        out = FlashAttention.apply(*x, causal, 0, chunk)
        return out.detach(), torch.autograd.grad(out, x, dout)

    def plain_route():
        x = [t.detach().requires_grad_() for t in (q, k, v)]
        out = kf.flash_attention_torch(*x, causal=causal)
        return out.detach(), torch.autograd.grad(out, x, dout)

    kf.reset_launches()
    out, grads = fn_route()
    check(sum(kf.LAUNCHES.values()) == (device.type == "cuda"),
          f"{tag}: the Function launched the kernel {sum(kf.LAUNCHES.values())} times")
    pout, pgrads = plain_route()
    x64 = [t[:1, :, :H // Hkv if t.shape[2] == H else 1].double().requires_grad_()
           for t in (q, k, v)]
    w64 = torch.autograd.grad(attention_f64(*x64, causal=causal), x64,
                              dout[:1, :, :H // Hkv].double())
    sl = lambda t: t[:1, :, :H // Hkv if t.shape[2] == H else 1].double()  # noqa: E731
    res = {"out": float((out.double() - pout.double()).abs().max())}
    check(bool(torch.isfinite(out).all()) and all(bool(torch.isfinite(g).all()) for g in grads),
          f"{tag}: non-finite attention output or gradient")
    check(res["out"] <= FLASH_TOL["bfloat16"] * (1 + float(pout.double().abs().max())),
          f"{tag}: forward {res['out']:.3g} from the plain version")
    for name, g, pg, w in zip(("dq", "dk", "dv"), grads, pgrads, w64):
        scale = float(pg.double().abs().max())
        res[name] = float((g.double() - pg.double()).abs().max()) / scale
        w_scale = float(w.abs().max())
        res[f"{name}_f64"] = float((sl(g) - w).abs().max()) / w_scale
        res[f"{name}_plain_f64"] = float((sl(pg) - w).abs().max()) / w_scale
        check(res[name] <= TRAIN_GRAD_TOL, f"{tag}: {name} {res[name]:.3g} of its scale from "
              f"autograd through the plain version (tol {TRAIN_GRAD_TOL})")
        check(res[f"{name}_f64"] <= TRAIN_GRAD64_TOL,
              f"{tag}: {name} {res[f'{name}_f64']:.3g} of its scale from float64 "
              f"(tol {TRAIN_GRAD64_TOL})")
    print(f"[{tag}] {label}: attention gradient at B={B} Sq={S} Skv={Skv} H={H} Hkv={Hkv} "
          f"dh={dh} bf16 {'causal' if causal else 'non-causal'}: "
          f"out {res['out']:.3g} from the plain version; dq {res['dq']:.3g}, dk {res['dk']:.3g}, "
          f"dv {res['dv']:.3g} of their scale from autograd through the plain version (tol "
          f"{TRAIN_GRAD_TOL}); against float64 on one batch row and kv head: Function "
          f"{res['dq_f64']:.3g}/{res['dk_f64']:.3g}/{res['dv_f64']:.3g}, plain "
          f"{res['dq_plain_f64']:.3g}/{res['dk_plain_f64']:.3g}/{res['dv_plain_f64']:.3g} "
          f"(tol {TRAIN_GRAD64_TOL})")
    if device.type != "cuda":
        return res
    res["row"] = flash_row(tag, label, q, k, v, causal=causal)

    def sdpa_route():
        x = [t.detach().requires_grad_() for t in (q, k, v)]
        out = sdpa_form(*x, causal, 0)
        return torch.autograd.grad(out, x, dout)

    res["fwd_bwd_ms"] = call_ms(fn_route, reps=10)
    res["plain_fwd_bwd_ms"] = call_ms(plain_route, reps=10)
    res["sdpa_fwd_bwd_ms"] = call_ms(sdpa_route, reps=10)
    print(f"[{tag}] {label} forward + backward ms: Function (kernel forward, chunked plain "
          f"backward) "
          f"{res['fwd_bwd_ms']:.4f}, plain version {res['plain_fwd_bwd_ms']:.4f}, SDPA "
          f"{res['sdpa_fwd_bwd_ms']:.4f} (CUDA events around each call, median of 10)")
    return res


def train_full(tag: str, cfg, smoke: bool, steps: int, batch: int, seq: int, lr: float,
               device) -> dict:
    """``launch.train`` at ``cfg``'s width and depth on ``device``: ``steps``
    steps of batch x seq from seed 0 (AdamW, peak lr 3e-4, warmup 1), with
    the flash launches counted from zero around the run (card: exactly 2 x
    n_layers per step, the forward and the remat recompute, on the
    tensor-core prefill entry at the training shape); finite losses and grad
    norms, the last loss below the first; step ms (median of the steps after
    the first), tokens/s, peak memory; then one step under torch.profiler
    (flash's share of device time) and the optimizer update timed alone.
    Returns the numbers."""
    import gc
    import math

    import torch
    from repro_torch.configs import RunConfig
    from repro_torch.distributed.train_step import make_train_step
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.launch import train
    from repro_torch.models import build_model
    from repro_torch.optim import OptConfig, make_optimizer
    from repro_torch.tree import leaves

    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    kf.reset_launches()
    t0 = time.perf_counter()
    run = train.train(["--arch", cfg.name, *(["--smoke"] if smoke else []),
                       "--steps", str(steps), "--batch", str(batch), "--seq", str(seq),
                       "--lr", str(lr), "--seed", str(SEED), "--log-every", "1",
                       "--device", device.type])
    wall = time.perf_counter() - t0
    launches = dict(kf.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    n_launch = sum(launches.values())
    want = 2 * cfg.n_layers * steps
    if on_card:
        check(n_launch == want, f"{tag}: training launched flash_attention {n_launch} times, "
              f"want {want} (forward and remat recompute of {cfg.n_layers} layers x {steps})")
        check(set(launches) == {("mma", batch, seq, seq, cfg.n_heads, cfg.n_kv_heads,
                                 cfg.d_head)}, f"{tag}: flash launches {launches}")
    losses, norms = run.losses, [m["grad_norm"] for m in run.metrics]
    check(len(losses) == steps and all(math.isfinite(x) for x in losses + norms),
          f"{tag}: losses {losses}, grad norms {norms}")
    check(losses[-1] < losses[0], f"{tag}: the loss did not fall: {losses}")
    step_ms = 1e3 * statistics.median(run.step_s[1:])
    n_params = sum(p.numel() for p in leaves(run.params))
    out = dict(launches=n_launch, losses=losses, grad_norms=norms, step_ms=step_ms,
               first_step_ms=1e3 * run.step_s[0], tokens_per_s=batch * seq / (step_ms / 1e3),
               peak_gib=peak / 2**30, wall_s=wall, n_params=n_params)
    print(f"[{tag}] {cfg.name} {n_params / 1e9:.4f} B params, {steps} steps of {batch} x {seq} "
          f"tokens: losses {[round(x, 4) for x in losses]}, grad norms "
          f"{[round(x, 3) for x in norms]}; step {step_ms:.2f} ms (median of steps 2-{steps}; "
          f"first {out['first_step_ms']:.1f}), {out['tokens_per_s']:.0f} tokens/s, peak device "
          f"memory {out['peak_gib']:.3f} GiB, run {wall:.1f} s; flash_attention launches "
          f"{n_launch} (want {want})")
    if not on_card:
        return out
    model = build_model(cfg)
    run_cfg = RunConfig(model=cfg, shape="train_4k", learning_rate=lr, total_steps=steps,
                        warmup_steps=1)
    _, step_fn = make_train_step(model, run_cfg)
    params, opt = run.params, run.opt_state
    del run
    b = on_device(next(train_pipe(cfg, batch, seq)), device)
    busy, named, pwall, n, counted = device_busy_counted(
        lambda: step_fn(params, opt, b, steps), tuple(entry_counts(kf, FLASH_KERNELS)()),
        entry_counts(kf, FLASH_KERNELS), kf.reset_launches)
    out["profile"] = kernel_shares(busy, named, pwall, counted, tag)
    sec = named["flash_attention_mma_kernel"][0]
    out["flash_share"] = sec / busy if busy > 0 else None
    out["device_busy"] = busy / pwall if pwall > 0 else None
    print(f"[{tag}] profiled step: {n} device kernels, {busy:.4f} s of {pwall:.4f} s wall; "
          f"{out['profile']}")
    gc.collect()
    ocfg = OptConfig(weight_decay=run_cfg.weight_decay, grad_clip=run_cfg.grad_clip)
    _, opt_update = make_optimizer(cfg.optimizer, ocfg)
    lr_t = torch.tensor(lr, device=device)
    with torch.no_grad():
        out["opt_ms"] = call_ms(lambda: opt_update(params, params, opt, lr_t, ocfg), reps=5)
    print(f"[{tag}] the AdamW update alone over {n_params / 1e9:.4f} B float32 masters: "
          f"{out['opt_ms']:.2f} ms (CUDA events, median of 5), {100 * out['opt_ms'] / step_ms:.1f} "
          f"% of a step")
    return out


def train_checks(tag: str, cfg, device) -> dict:
    """At ``cfg`` cut to TRAIN_CHECK_LAYERS: (card only) one float32 step
    on the card against the same step on the CPU from the same carried
    masters and batch (B 2, S 128; ``check_f32_step``); two microbatches
    against one at float32 on ``device`` (B 4, S 128); and resume: 6 bf16
    steps (B 4, S 512) with a checkpoint (weights, optimizer state, data
    cursor) after the third, restored into fresh tensors, which must equal
    the state saved (masters, m, v, step) bit for bit and whose steps 4-6
    must give the uninterrupted run's losses bit for bit (the step is
    deterministic). Returns the numbers."""
    import dataclasses as dc
    import tempfile

    import torch
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import RunConfig
    from repro_torch.distributed.train_step import make_train_step
    from repro_torch.models import build_model, materialize
    from repro_torch.optim import OptConfig, make_optimizer
    from repro_torch.tree import leaves_with_path, tree_map

    from repro_torch.device import resolve_device

    resolve_device(device)  # float32 products in full float32 on the card: TF32 off
    check(not torch.backends.cuda.matmul.allow_tf32, f"{tag}: TF32 is on")
    out = {}
    cut = dc.replace(cfg, n_layers=min(cfg.n_layers, TRAIN_CHECK_LAYERS))
    f32 = dc.replace(cut, compute_dtype=torch.float32)
    lr = 3e-4
    opt_init = make_optimizer(cfg.optimizer, OptConfig())[0]

    def stepper(c, microbatches=1):
        return make_train_step(build_model(c), RunConfig(
            model=c, shape="train_4k", learning_rate=lr, total_steps=6, warmup_steps=1,
            microbatches=microbatches))[1]

    cpu = torch.device("cpu")
    masters = materialize(build_model(f32).param_infos(), torch.Generator(cpu).manual_seed(SEED))
    step = stepper(f32)
    if device.type == "cuda":
        b = on_device(next(train_pipe(f32, 2, 128)), cpu)
        t0 = time.perf_counter()
        on_cpu = step(masters, opt_init(masters), b, 1)
        cpu_s = time.perf_counter() - t0
        masters = tree_map(lambda t: t.to(device), masters)
        on_card = step(masters, opt_init(masters), on_device(b, device), 1)
        out["card_vs_cpu"] = check_f32_step(
            tag, f"float32 step, card against CPU (depth {cut.n_layers}, B 2, S 128; the CPU "
                 f"step {cpu_s:.1f} s)", on_card, on_cpu, lr)
        del on_cpu, on_card
    b4 = on_device(next(train_pipe(f32, 4, 128)), device)
    one = step(masters, opt_init(masters), b4, 1)
    two = stepper(f32, microbatches=2)(masters, opt_init(masters), b4, 1)
    out["microbatches"] = check_f32_step(
        tag, f"float32, 2 microbatches against 1 (depth {cut.n_layers}, B 4, S 128)", two, one, lr)
    del masters, one, two

    step = stepper(cut)
    params = materialize(build_model(cut).param_infos(), torch.Generator(device).manual_seed(SEED))
    opt, pipe = opt_init(params), train_pipe(cut, 4, 512)
    losses, batches = [], []
    with tempfile.TemporaryDirectory() as root:
        ckpt = Checkpointer(root)
        for i in range(6):
            batches.append(on_device(next(pipe), device))
            params, opt, m = step(params, opt, batches[-1], i)
            losses.append(float(m["loss"]))
            if i == 2:
                ckpt.save(3, {"params": params, "opt": opt, "data": pipe.state_dict()})
                saved = tree_map(torch.clone, {"params": params, "opt": opt})
        ckpt.wait()
        like = tree_map(torch.zeros_like, {"params": params, "opt": opt})
        like["data"] = {"epoch": 0, "step": 0}
        t0 = time.perf_counter()
        back = ckpt.restore(3, like, device=device)
        restore_s = time.perf_counter() - t0
    restored = dict(leaves_with_path({"params": back["params"], "opt": back["opt"]}))
    for path, t in leaves_with_path(saved):
        check(t.dtype == restored[path].dtype and torch.equal(t, restored[path]),
              f"{tag}: restored {'/'.join(map(str, path))} differs from the state saved")
    del saved
    pipe = train_pipe(cut, 4, 512, state=back["data"])
    params, opt, resumed = back["params"], back["opt"], []
    for i in range(3, 6):
        b = on_device(next(pipe), device)
        check(torch.equal(b["tokens"], batches[i]["tokens"]),
              f"{tag}: the restored data cursor gives another batch {i + 1}")
        params, opt, m = step(params, opt, b, i)
        resumed.append(float(m["loss"]))
    check(resumed == losses[3:], f"{tag}: resumed losses {resumed} against {losses[3:]}")
    out["resume"] = dict(losses=losses, resumed=resumed, restore_s=restore_s)
    print(f"[{tag}] resume (depth {cut.n_layers}, bf16, B 4, S 512): checkpoint after step 3, "
          f"restored into fresh tensors in {restore_s:.2f} s, masters, m, v and step equal to "
          f"the state saved; steps 4-6 losses {resumed} equal the uninterrupted {losses[3:]} "
          f"bit for bit")
    return out


def phase_train(device, smoke: bool = False, steps: int = 6, batch: int = 8,
                seq: int = 1024, lr: float = 3e-4) -> dict:
    """Phase 22, training (ROADMAP item 10f): ``tinyllama-1.1b`` at its
    published width and depth through ``launch.train`` (``train_full``),
    the attention gradient at the training shape (``train_attention_grad``)
    and the checks at a cut depth (``train_checks``). Returns the numbers;
    ``smoke`` and the sizes shrink it for a rehearsal on the CPU (there the
    launch counts, the profile, the timings and the card-vs-CPU step are
    skipped; ``lr`` above ``launch.train``'s default 3e-4 lets a SMOKE loss fall
    in 6 steps)."""
    from repro_torch.configs import get_config

    tag = "22 train"
    cfg = get_config("tinyllama-1.1b", smoke=smoke)
    out = train_full(tag, cfg, smoke, steps, batch, seq, lr, device)
    free_card_if(device)
    out["grad"] = train_attention_grad(tag, cfg, batch, seq, device)
    free_card_if(device)
    out.update(train_checks(tag, cfg, device))
    return out


#: phase 23 (ROADMAP item 10s): the families that train besides the dense
#: one, each at its published widths and cut to what one card holds with
#: its optimizer (PERF.md section 4): (arch, the cut, the parameter count
#: reckoned from the widths)
TRAIN_FAMILIES = (
    ("rwkv6-7b", {"n_layers": 4}, 1.41e9),
    ("jamba-v0.1-52b", {"n_layers": 8, "moe_experts": 2, "optimizer": "adafactor"}, 3.43e9),
    ("moonshot-v1-16b-a3b", {"n_layers": 2}, 1.81e9),
    ("whisper-medium", {}, 0.81e9),
    ("internvl2-2b", {}, 1.89e9),
)
#: whisper's text under its 1500 frames: the decoder's published context
WHISPER_TEXT = 448
#: the most device memory a family's steps may hold
TRAIN_PEAK_GIB = 72.0
#: a family's parameter count against the reckoning (relative)
PARAMS_REL = 0.01
#: card against CPU at each SMOKE configuration, float32: the loss
#: (relative) and every gradient (of its leaf's largest |.|) within the CPU
#: tests' tolerances against JAX (tests/test_torch_train_*.py)
SMOKE_TRAIN_TOL = {"ssm": 5e-5, "hybrid": 2e-5, "moe": 5e-6, "vlm": 5e-6, "encdec": 5e-6}
#: leaves whose gradient is zero in exact arithmetic (the key biases: a
#: shift shared by every key leaves the softmax as it is): finite and held
#: to the tree's largest gradient, never required to be nonzero
ZERO_IN_EXACT = ("bk",)


def train_cut(arch: str, cut: dict, smoke: bool):
    """``arch``'s configuration cut as phase 23 trains it; with ``smoke``
    the SMOKE configuration, keeping only the cut's optimizer."""
    import dataclasses as dc

    from repro_torch.configs import get_config

    cfg = get_config(arch, smoke=smoke)
    return dc.replace(cfg, **({k: v for k, v in cut.items() if k == "optimizer"} if smoke
                              else cut))


def text_len(cfg, seq: int) -> int:
    """Text tokens of a training sequence of ``seq`` positions: the vlm's
    after its patches (JAX's s_text = S - vis_tokens), whisper's decoder
    text over its frames."""
    if cfg.family == "vlm":
        return seq - cfg.vis_tokens
    if cfg.family == "encdec":
        return min(WHISPER_TEXT, seq)
    return seq


def family_batch(cfg, batch: int, seq: int, device) -> dict:
    """The first batch of tokens and labels from ``launch.train``'s
    chunk-store pipeline at the family's text length, with the family's
    patch or frame embeddings (``Model.prefill_extras``) drawn N(0, 1) from
    a seeded generator in the compute dtype."""
    import torch
    from repro_torch.models import build_model

    b = on_device(next(train_pipe(cfg, batch, text_len(cfg, seq))), device)
    gen = torch.Generator(device).manual_seed(SEED + 23)
    for name, shape in build_model(cfg).prefill_extras(batch).items():
        b[name] = torch.randn(*shape, generator=gen, device=device).to(cfg.compute_dtype)
    return b


def perturb_tree_decay(params, gen) -> None:
    """``perturb_decay`` on a parameter tree's stacked time-mix leaves: the
    init's zero ``w_lora_b`` gives ``w_lora_a`` an all-zero gradient."""
    time_mix = params["layers"]["time"]
    time_mix["w_base"].uniform_(-6.0, 1.0, generator=gen)
    time_mix["w_lora_b"].normal_(0.0, 0.1, generator=gen)


def leaf_check(tag: str, grads) -> int:
    """Every leaf's gradient finite and, but for ZERO_IN_EXACT's, not all
    zero (a kernel route without a grad_fn gives its upstream leaves none,
    which ``loss_and_grads`` refuses, or zeros, which this refuses).
    Returns the leaves checked."""
    import torch
    from repro_torch.tree import leaves_with_path

    n = 0
    for path, g in leaves_with_path(grads):
        name = "/".join(map(str, path))
        check(bool(torch.isfinite(g).all()), f"{tag}: the gradient of {name} is not finite")
        check(path[-1] in ZERO_IN_EXACT or bool(g.ne(0).any()),
              f"{tag}: the gradient of {name} is all zero")
        n += 1
    return n


def lm_launches() -> dict:
    """The three LM kernels' launch counts by entry, those launched."""
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels import mamba_scan as km
    from repro_torch.kernels import rwkv6_scan as ks

    out = {}
    for name, mod in (("flash", kf), ("rwkv6_scan", ks), ("mamba_scan", km)):
        by = collections.Counter()
        for key, n in mod.LAUNCHES.items():
            by[key[0]] += n
        if by:
            out[name] = dict(by)
    return out


def want_launches(cfg, steps: int) -> dict:
    """Each LM kernel's launches in ``steps`` training steps of ``cfg``: the
    forward and the remat recompute of every attention (the encdec's
    encoder, decoder and cross), WKV and Mamba layer, on the entry a bf16
    training forward takes."""
    from repro_torch.models import hybrid

    L = cfg.n_layers
    n_attn = {"ssm": 0, "encdec": 3 * L,
              "hybrid": L // hybrid.PERIOD * sum(hybrid.is_attn(cfg, i)
                                                 for i in range(hybrid.PERIOD))}.get(cfg.family, L)
    n_mamba = L - n_attn if cfg.family == "hybrid" else 0
    return {name: {entry: 2 * n * steps} for name, entry, n in (
        ("flash", "mma", n_attn), ("rwkv6_scan", "chunked", L if cfg.family == "ssm" else 0),
        ("mamba_scan", "model", n_mamba)) if n}


def train_family(tag: str, cfg, reckoned: float, steps: int, batch: int, seq: int, lr: float,
                 device) -> dict:
    """``cfg`` trained through ``make_train_step`` on ``device``: seed 0
    masters (RWKV's decay perturbed), a batch from the chunk-store
    pipeline with the family's extras; every leaf's gradient on it
    (``leaf_check``); then ``steps`` steps on that batch (the config's
    optimizer, peak lr ``lr`` from the first step, no warmup) with the LM
    kernels' launches counted from zero around them (card: exactly
    ``want_launches``), finite losses and grad norms, the last loss below
    the first. One batch, as an overfitting check: the pipeline's tokens
    are uniformly random, so a fresh batch's loss can only fall by the
    logits' calibration, less in a few steps than one batch's spread from
    the next (on an H100, fresh batches' losses rose over 4 steps as the
    model fitted the ones it saw, rwkv 11.5005 to 11.5027). Step ms (median
    after the first), tokens/s (the loss's text tokens), peak memory (card:
    at most TRAIN_PEAK_GIB). Returns the numbers."""
    import math

    import torch
    from repro_torch.configs import RunConfig
    from repro_torch.distributed.train_step import loss_and_grads, make_train_step
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels import mamba_scan as km
    from repro_torch.kernels import rwkv6_scan as ks
    from repro_torch.models import build_model
    from repro_torch.tree import leaves

    on_card = device.type == "cuda"
    model = build_model(cfg)
    init, step_fn = make_train_step(model, RunConfig(
        model=cfg, shape="train_4k", learning_rate=lr, total_steps=steps, warmup_steps=0))
    params, opt = init(torch.Generator(device).manual_seed(SEED))
    if cfg.family == "ssm":
        perturb_tree_decay(params, torch.Generator(device).manual_seed(SEED + 1))
    n_params = sum(p.numel() for p in leaves(params))
    check(not on_card or math.isclose(n_params, reckoned, rel_tol=PARAMS_REL),
          f"{tag}: {n_params} parameters, reckoned {reckoned:.3g}")
    b = family_batch(cfg, batch, seq, device)
    t0 = time.perf_counter()
    n_leaves = leaf_check(tag, loss_and_grads(model, params, b)[2])
    check_s = time.perf_counter() - t0
    if on_card:
        free_card()
        torch.cuda.reset_peak_memory_stats()
    for mod in (kf, ks, km):
        mod.reset_launches()
    losses, norms, step_s = [], [], []
    for i in range(steps):
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, b, i)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        if on_card:
            torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    launches = lm_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30 if on_card else 0.0
    del params, opt
    want = want_launches(cfg, steps)
    step_ms = 1e3 * statistics.median(step_s[1:])
    tokens = batch * text_len(cfg, seq)
    out = dict(n_params=n_params, reckoned=reckoned, leaves=n_leaves, launches=launches,
               want=want, losses=losses, grad_norms=norms, step_ms=step_ms,
               first_step_ms=1e3 * step_s[0], tokens_per_s=tokens / (step_ms / 1e3),
               peak_gib=peak, grad_check_s=check_s)
    print(f"[{tag}] {cfg.name} ({cfg.family}, {cfg.n_layers} layers, {cfg.optimizer}) "
          f"{n_params / 1e9:.4f} B params (reckoned {reckoned / 1e9:.2f} B); all {n_leaves} "
          f"leaves' gradients finite and nonzero ({', '.join(ZERO_IN_EXACT)} finite; "
          f"{check_s:.1f} s); {steps} steps of {batch} x {seq} ({tokens} text tokens a step): "
          f"losses {[round(x, 4) for x in losses]}, grad norms {[round(x, 3) for x in norms]}; "
          f"step {step_ms:.2f} ms (median of steps 2-{steps}; first {out['first_step_ms']:.1f}), "
          f"{out['tokens_per_s']:.0f} tokens/s, peak device memory {peak:.3f} GiB; launches "
          f"{launches} (want {want if on_card else 'card only'})", flush=True)
    if on_card:
        check(launches == want, f"{tag}: kernel launches {launches}, want {want}")
        check(peak <= TRAIN_PEAK_GIB, f"{tag}: peak device memory {peak:.3f} GiB")
    check(all(math.isfinite(x) for x in losses + norms), f"{tag}: losses {losses}, norms {norms}")
    check(losses[-1] < losses[0], f"{tag}: the loss did not fall: {losses}")
    return out


def wkv_grad_check(tag: str, B: int, S: int, H: int, dh: int, device) -> dict:
    """The WKV Function at the training shape (bf16 r/k/v, zero s0): its
    forward (the kernel's chunked entry, one launch) within the WKV
    tolerance of the plain version; its gradients (dr, dk, dv, dwlog, du)
    against autograd through the plain version on the same inputs and dy
    within TRAIN_GRAD_TOL of each one's scale, and dr, dk, dv, dwlog
    against a float64 witness (``rwkv6_ref``) on batch row 0 and head 0
    within TRAIN_GRAD64_TOL (du sums over the batch rows: plain only); the
    kernel's row at this shape and the forward + backward ms of the
    Function and of the plain version. Returns the numbers."""
    import torch
    from repro_torch.kernels import rwkv6_scan as ks
    from repro_torch.models.rwkv import WKV

    gen = torch.Generator(device).manual_seed(SEED + 23)
    r, k, v, wlog, u, s0 = rwkv_inputs(B, S, H, dh, "bfloat16", False, False, gen, device)
    dy = torch.randn(B, S, H, dh, generator=gen, device=device)

    def route(fn):
        def run():
            xs = [t.detach().requires_grad_() for t in (r, k, v, wlog, u)]
            y, _ = fn(*xs, s0)
            return y.detach(), torch.autograd.grad(y, xs, dy)
        return run

    fn_route, plain_route = route(WKV.apply), route(ks.rwkv6_scan_torch)
    ks.reset_launches()
    y, grads = fn_route()
    if device.type == "cuda":
        check(dict(ks.LAUNCHES) == {("chunked", B, S, H, dh): 1},
              f"{tag}: the WKV Function launched {dict(ks.LAUNCHES)}")
    py, pgrads = plain_route()
    res = {"out": rwkv_err((y,), (py,), f"{tag} WKV forward")}
    x64 = [t[:1, :, :1].double().requires_grad_() for t in (r, k, v, wlog)]
    y64, _ = rwkv_ref64(*x64, u[:1].double(), s0[:1, :1].double())
    w64 = torch.autograd.grad(y64, x64, dy[:1, :, :1].double())
    for name, g, pg in zip(("dr", "dk", "dv", "dwlog", "du"), grads, pgrads):
        check(bool(torch.isfinite(g).all()), f"{tag}: WKV {name} not finite")
        res[name] = float((g.double() - pg.double()).abs().max()) / float(pg.double().abs().max())
        check(res[name] <= TRAIN_GRAD_TOL, f"{tag}: WKV {name} {res[name]:.3g} of its scale from "
              f"autograd through the plain version (tol {TRAIN_GRAD_TOL})")
    for name, g, pg, w in zip(("dr", "dk", "dv", "dwlog"), grads, pgrads, w64):
        scale = float(w.abs().max())
        res[f"{name}_f64"] = float((g[:1, :, :1].double() - w).abs().max()) / scale
        res[f"{name}_plain_f64"] = float((pg[:1, :, :1].double() - w).abs().max()) / scale
        check(res[f"{name}_f64"] <= TRAIN_GRAD64_TOL, f"{tag}: WKV {name} "
              f"{res[f'{name}_f64']:.3g} of its scale from float64 (tol {TRAIN_GRAD64_TOL})")
    print(f"[{tag}] WKV Function at B={B} S={S} H={H} dh={dh} bf16: forward {res['out']:.3g} "
          f"from the plain version; gradients of their scale from autograd through the plain "
          f"version: " + ", ".join(f"{n} {res[n]:.3g}" for n in ("dr", "dk", "dv", "dwlog", "du"))
          + f" (tol {TRAIN_GRAD_TOL}); against float64 on batch row 0, head 0: Function "
          + "/".join(f"{res[n + '_f64']:.3g}" for n in ("dr", "dk", "dv", "dwlog")) + ", plain "
          + "/".join(f"{res[n + '_plain_f64']:.3g}" for n in ("dr", "dk", "dv", "dwlog"))
          + f" (tol {TRAIN_GRAD64_TOL})")
    if device.type != "cuda":
        return res
    args = (r, k, v, wlog, u, s0)
    row = dict(max_abs_err=res["out"], entry="chunked", library_ms=None,
               shape=f"B={B} S={S} H={H} dh={dh} bfloat16 r/k/v, zero s0 (training forward)",
               ms=device_ms(lambda: ks.rwkv6_scan(*args)),
               plain_ms=device_ms(lambda: ks.rwkv6_scan_torch(*args), reps=5))
    row["bound_ms"], row["bound_by"] = rwkv_bound_ms(B, S, H, dh, 2)
    res["row"] = row
    res["fwd_bwd_ms"] = call_ms(fn_route, reps=5)
    res["plain_fwd_bwd_ms"] = call_ms(plain_route, reps=5)
    print(f"[{tag}] WKV training forward ({row['shape']}): device ms kernel {row['ms']:.5f} plain "
          f"{row['plain_ms']:.5f} bound {row['bound_ms']:.5f} by {row['bound_by']}, library none; "
          f"forward + backward ms: Function (kernel forward, plain backward) "
          f"{res['fwd_bwd_ms']:.3f}, plain version {res['plain_fwd_bwd_ms']:.3f} (CUDA events "
          f"around each call, median of 5)")
    return res


def scan_f64(delta, u, bm, cm, A):
    """The selective scan in float64 from a zero state, one token at a
    time, differentiable: the witness."""
    import torch

    h = torch.zeros(delta.shape[0], *A.shape, dtype=torch.float64, device=delta.device)
    ys = []
    for t in range(delta.shape[1]):
        h = torch.exp(delta[:, t, :, None] * A) * h + (delta[:, t] * u[:, t])[..., None] \
            * bm[:, t, None, :]
        ys.append(torch.einsum("ben,bn->be", h, cm[:, t]))
    return torch.stack(ys, dim=1)


def scan_grad_check(tag: str, B: int, S: int, E: int, N: int, device) -> dict:
    """The selective-scan Function at the training shape (bf16 u, B, C as
    strided views of one projection, zero h0): its forward (the kernel's
    model entry, one launch) within the scan tolerance of the plain
    version; its gradients (ddelta, du, dB, dC, dA) against autograd
    through the plain version within TRAIN_GRAD_TOL of each one's scale,
    and ddelta, du, dB, dC against a float64 witness on batch row 0 within
    TRAIN_GRAD64_TOL (dA sums over the rows: plain only); the kernel's row
    at this shape and the forward + backward ms of the Function and of the
    plain version. Returns the numbers."""
    import torch
    from repro_torch.kernels import mamba_scan as km
    from repro_torch.models.mamba import SelectiveScan

    gen = torch.Generator(device).manual_seed(SEED + 23)
    delta, u, bm, cm, A, h0 = mamba_inputs(B, S, E, N, "bfloat16", False, gen, device)
    dy = torch.randn(B, S, E, generator=gen, device=device)

    def route(fn):
        def run():
            xs = [t.detach().requires_grad_() for t in (delta, u, bm, cm, A)]
            y, _ = fn(*xs, h0)
            return y.detach(), torch.autograd.grad(y, xs, dy)
        return run

    fn_route, plain_route = route(SelectiveScan.apply), route(km.mamba_selective_scan_torch)
    km.reset_launches()
    y, grads = fn_route()
    if device.type == "cuda":
        check(dict(km.LAUNCHES) == {("model", B, S, E, N): 1},
              f"{tag}: the scan Function launched {dict(km.LAUNCHES)}")
    py, pgrads = plain_route()
    res = {"out": mamba_err((y,), (py,), f"{tag} scan forward")}
    x64 = [t[:1].double().requires_grad_() for t in (delta, u, bm, cm)]
    w64 = torch.autograd.grad(scan_f64(*x64, A.double()), x64, dy[:1].double())
    names = ("ddelta", "du", "dB", "dC", "dA")
    for name, g, pg in zip(names, grads, pgrads):
        check(bool(torch.isfinite(g).all()), f"{tag}: scan {name} not finite")
        res[name] = float((g.double() - pg.double()).abs().max()) / float(pg.double().abs().max())
        check(res[name] <= TRAIN_GRAD_TOL, f"{tag}: scan {name} {res[name]:.3g} of its scale from "
              f"autograd through the plain version (tol {TRAIN_GRAD_TOL})")
    for name, g, pg, w in zip(names, grads, pgrads, w64):
        scale = float(w.abs().max())
        res[f"{name}_f64"] = float((g[:1].double() - w).abs().max()) / scale
        res[f"{name}_plain_f64"] = float((pg[:1].double() - w).abs().max()) / scale
        check(res[f"{name}_f64"] <= TRAIN_GRAD64_TOL, f"{tag}: scan {name} "
              f"{res[f'{name}_f64']:.3g} of its scale from float64 (tol {TRAIN_GRAD64_TOL})")
    print(f"[{tag}] scan Function at B={B} S={S} E={E} N={N} bf16: forward {res['out']:.3g} "
          f"from the plain version; gradients of their scale from autograd through the plain "
          f"version: " + ", ".join(f"{n} {res[n]:.3g}" for n in names)
          + f" (tol {TRAIN_GRAD_TOL}); against float64 on batch row 0: Function "
          + "/".join(f"{res[n + '_f64']:.3g}" for n in names[:4]) + ", plain "
          + "/".join(f"{res[n + '_plain_f64']:.3g}" for n in names[:4])
          + f" (tol {TRAIN_GRAD64_TOL})")
    if device.type != "cuda":
        return res
    args = (delta, u, bm, cm, A, h0)
    row = dict(max_abs_err=res["out"], library_ms=None,
               shape=f"B={B} S={S} E={E} N={N} bfloat16 u/B/C, zero h0 (model entry, "
                     f"training forward)",
               ms=device_ms(lambda: km.mamba_selective_scan(*args)),
               plain_ms=device_ms(lambda: km.mamba_selective_scan_torch(*args), reps=3))
    row["bound_ms"], row["bound_by"] = mamba_bound_ms(B, S, E, N, 2, True)
    row["sfu_ms"] = 1e3 * B * S * E * N / SFU_EX2_PER_S
    res["row"] = row
    res["fwd_bwd_ms"] = call_ms(fn_route, reps=3)
    res["plain_fwd_bwd_ms"] = call_ms(plain_route, reps=3)
    print(f"[{tag}] scan training forward ({row['shape']}): device ms kernel {row['ms']:.5f} "
          f"plain {row['plain_ms']:.5f} bound {row['bound_ms']:.5f} by {row['bound_by']} (SFU "
          f"floor {row['sfu_ms']:.5f}), library none; forward + backward ms: Function (kernel "
          f"forward, chunked plain backward) {res['fwd_bwd_ms']:.3f}, plain version "
          f"{res['plain_fwd_bwd_ms']:.3f} (CUDA events around each call, median of 3)")
    return res


def smoke_train_card_vs_cpu(tag: str, arch: str, cut: dict, device) -> dict:
    """The family's SMOKE model at float32 compute (the cut's optimizer
    aside, which the loss does not see): ``loss_and_grads`` on the card
    against the CPU from the same masters (RWKV's decay perturbed) and
    batch (B 2, 64 positions), the loss within SMOKE_TRAIN_TOL relative
    and every gradient within it of its leaf's largest |.|
    (ZERO_IN_EXACT's of the tree's). Returns the gaps."""
    import dataclasses as dc

    import torch
    from repro_torch.distributed.train_step import loss_and_grads
    from repro_torch.models import build_model, materialize
    from repro_torch.tree import leaves, leaves_with_path, tree_map

    cfg = dc.replace(train_cut(arch, cut, smoke=True), compute_dtype=torch.float32)
    model = build_model(cfg)
    cpu = torch.device("cpu")
    params = materialize(model.param_infos(), torch.Generator(cpu).manual_seed(SEED))
    if cfg.family == "ssm":
        perturb_tree_decay(params, torch.Generator(cpu).manual_seed(SEED + 1))
    b = family_batch(cfg, 2, 64, cpu)
    l0, _, g0 = loss_and_grads(model, params, b)
    l1, _, g1 = loss_and_grads(model, tree_map(lambda t: t.to(device), params),
                               on_device(b, device))
    tol = SMOKE_TRAIN_TOL[cfg.family]
    top = max(float(w.abs().max()) for w in leaves(g0))
    res = {"loss": abs(float(l1) - float(l0)) / abs(float(l0)), "grad": 0.0}
    check(res["loss"] <= tol, f"{tag}: SMOKE loss on the card {float(l1)} against the CPU's "
          f"{float(l0)} (tol {tol})")
    for (path, g), w in zip(leaves_with_path(g1), leaves(g0)):
        scale = top if path[-1] in ZERO_IN_EXACT else float(w.abs().max())
        gap = float((g.cpu().double() - w.double()).abs().max()) / scale
        res["grad"] = max(res["grad"], gap)
        check(gap <= tol, f"{tag}: SMOKE gradient of {'/'.join(map(str, path))} {gap:.3g} of "
              f"its scale from the CPU's (tol {tol})")
    print(f"[{tag}] SMOKE float32 card against CPU: loss {float(l1):.6f} vs {float(l0):.6f} "
          f"(rel {res['loss']:.3g}), every gradient within {res['grad']:.3g} of its scale "
          f"(tol {tol})")
    return res


def phase_train_families(device, smoke: bool = False, steps: int = 4, batch: int = 4,
                         seq: int = 1024, lr: float = 3e-4) -> dict:
    """Phase 23, training the other families (ROADMAP item 10s): each of
    TRAIN_FAMILIES at its published widths with its cut (``train_family``:
    every leaf's gradient, exact launches, falling loss, step ms,
    tokens/s, peak memory), the autograd Function new on its path at the
    training shape (``wkv_grad_check``, ``scan_grad_check``, whisper's
    cross-attention at 448 x 1500 and encoder at 1500 x 1500 through
    ``train_attention_grad``), the flash kernel's row at the other
    families' training attention, and (card only) the SMOKE model's loss
    and gradients on the card against the CPU. ``smoke`` and the sizes
    shrink it for a rehearsal on the CPU, where the launch counts, the
    peak, the kernel rows, the timings and the card-vs-CPU check are
    skipped. Returns the numbers by arch."""
    import torch

    on_card = device.type == "cuda"
    out = {}
    for arch, cut, reckoned in TRAIN_FAMILIES:
        tag = f"23 train {arch}"
        cfg = train_cut(arch, cut, smoke)
        r = train_family(tag, cfg, reckoned, steps, batch, seq, lr, device)
        free_card_if(device)
        S = text_len(cfg, seq)
        if cfg.family == "ssm":
            r["wkv"] = wkv_grad_check(tag, batch, S, cfg.d_model // cfg.rwkv_head_size,
                                      cfg.rwkv_head_size, device)
        elif cfg.family == "hybrid":
            E = cfg.mamba_expand * cfg.d_model
            r["scan"] = scan_grad_check(tag, batch, S, E, cfg.mamba_dstate, device)
        elif cfg.family == "encdec":
            r["cross"] = train_attention_grad(tag, cfg, batch, S, device, Skv=cfg.enc_seq,
                                              causal=False, label="cross-attention")
            free_card_if(device)
            r["encoder"] = train_attention_grad(tag, cfg, batch, cfg.enc_seq, device,
                                                causal=False, label="encoder")
        if on_card and cfg.family in ("hybrid", "moe", "vlm"):
            gen = torch.Generator(device).manual_seed(SEED + 23)
            H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
            q = torch.randn(batch, seq, H, dh, generator=gen, device=device).bfloat16()
            k, v = (torch.randn(batch, seq, Hkv, dh, generator=gen, device=device).bfloat16()
                    for _ in range(2))
            r["flash_row"] = flash_row(tag, "training forward", q, k, v, causal=True,
                                       window=cfg.sliding_window)
            del q, k, v
        free_card_if(device)
        if on_card:
            r["card_vs_cpu"] = smoke_train_card_vs_cpu(tag, arch, cut, device)
        out[arch] = r
    return out


def free_card_if(device) -> None:
    if device.type == "cuda":
        free_card()


def audit_example(device) -> dict:
    """``examples/torch_closed_loop_adaptive.py`` at smoke size (4 segments,
    the drift at 2) on ``device``: its result, printed lines and seconds."""
    import contextlib
    import importlib.util
    import io

    spec = importlib.util.spec_from_file_location(
        "torch_closed_loop_adaptive", ROOT / "examples" / "torch_closed_loop_adaptive.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = io.StringIO()
    start = time.perf_counter()
    with contextlib.redirect_stdout(out):
        res = mod.main(["--device", device.type, "--segments", "4", "--drift-at", "2"])
    return {"res": res, "lines": out.getvalue().splitlines(),
            "seconds": time.perf_counter() - start}


def phase_audit(device) -> dict:
    """Phase 17 (ROADMAP item 9; run last): ``repro_torch.analysis.run_all``
    on the card over every registered entry at the production shapes -- the
    dispatch walk, each entry again under the sync debug mode "error", the
    resource pass over the seven built libraries, the capture guard with real
    graph captures -- which must leave no unbaselined finding; a planted
    ``.item()`` entry the host-sync run must catch; then the adaptive example
    twin at smoke size on the card, whose decisions must equal its CPU run's."""
    import torch
    from repro_torch.analysis import load_baseline, new_findings, run_all
    from repro_torch.analysis.dispatch_audit import audit_entry
    from repro_torch.analysis.registry import (CARD_SHAPES, REGISTRY, TIER_DEVICE, BuildCtx,
                                               HotEntry)

    t_phase = time.perf_counter()
    findings, stats = run_all(device=device)
    baseline = load_baseline()
    fresh = new_findings(findings, baseline)
    for f in fresh:
        print(f"[17 audit] NEW {f.render()}", file=sys.stderr)
    check(not fresh, f"17: {len(fresh)} unbaselined finding(s): "
                     + "; ".join(f.key() for f in fresh))
    check(set(stats["dispatch"]) == {e.name for e in REGISTRY},
          "17: the dispatch walk missed a registered entry")
    check(all(info.get("host_sync") for e in stats["dispatch"].values()
              for info in e["shapes"].values()) or any(f.analysis == "sync" for f in findings),
          "17: an entry skipped its host-sync run")
    check(len(stats["kernel"]) == 7, f"17: resource pass saw {sorted(stats['kernel'])}")
    captures = stats["capture"]["warm"].get("engine_torch._TraceLoop._capture", 0)
    check(stats["capture"]["graphs"] and captures >= 1,
          "17: the capture guard's warm run captured no graph")
    x = torch.arange(4.0, device=device)
    planted = HotEntry("planted.item", TIER_DEVICE, lambda ctx: (lambda x: x.sum().item(), (x,)))
    caught, _ = audit_entry(planted, BuildCtx(device, CARD_SHAPES[0]))
    check({f.rule for f in caught} == {"host-callback", "host-sync"},
          f"17: a planted .item() gave {[f.key() for f in caught]}")
    kernels = {src: (max(k["registers"] for k in ks), max(k["shared"] for k in ks),
                     max(k["local"] + k["stack"] for k in ks), len(ks))
               for src, ks in stats["kernel"].items()}
    spills = [f"{src}:{k['name']} {k['registers']}/{k['stack'] + k['local']}"
              for src, ks in sorted(stats["kernel"].items()) for k in ks
              if k["stack"] + k["local"]]
    card = audit_example(device)
    cpu = audit_example(torch.device("cpu"))
    check(len(card["res"].segments) == 4, "17: the example ran short")
    for k, (a, b) in enumerate(zip(card["res"].segments, cpu["res"].segments)):
        check(a.placements == b.placements and a.was_queued == b.was_queued,
              f"17: the example's segment {k} placed differently on the card and the CPU")
    check(card["res"].n_obs == cpu["res"].n_obs, "17: the example's estimators consumed "
                                                 "different observations on the card")
    seconds = time.perf_counter() - t_phase
    print(f"[17 audit] {len(stats['dispatch'])} entries at m = "
          f"{'/'.join(str(s.m) for s in CARD_SHAPES)} (passes {', '.join(stats['passes'])}; "
          f"{', '.join(f'{k} {v:.1f} s' for k, v in stats['seconds'].items())}): "
          f"{len(findings)} finding(s), {len(findings) - len(fresh)} baselined "
          f"({', '.join(sorted({f.key() for f in findings}))}), 0 new; planted .item() caught by "
          f"host-callback and host-sync; capture warm {stats['capture']['warm']}, every rerun "
          f"builds nothing; kernels (max registers / static smem B / local + stack B over n "
          f"kernels): " + ", ".join(f"{src} {r}/{sm}/{lo} over {n}" for src, (r, sm, lo, n)
                                     in sorted(kernels.items()))
          + f"; spilling (registers / local + stack B): {', '.join(spills) or 'none'}"
          + f"; example twin on the card {card['seconds']:.1f} s ({card['lines'][-1].strip()}), "
          f"decisions equal to its CPU run; phase {seconds:.1f} s")
    return {"stats": stats, "findings": findings, "seconds": seconds, "kernels": kernels}


def timed_phase(tag: str, phase, device) -> dict:
    """Run ``phase(device)``, print its wall seconds and keep them in its result."""
    t0 = time.perf_counter()
    out = phase(device)
    out["seconds"] = time.perf_counter() - t0
    print(f"[{tag}] phase took {out['seconds']:.1f} s")
    return out


def start_clock():
    """A function printing, after each phase, the seconds since this call:
    the script must end within its time limit, and these lines say where
    the time went."""
    t0 = time.perf_counter()

    def clock(label: str) -> None:
        print(f"[clock] {label} ended at {time.perf_counter() - t0:.1f} s", flush=True)
    return clock


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
    clock = start_clock()
    smi_line = phase_env()
    clock("phase_env")
    phase_build()
    clock("phase_build")
    rows = phase_kernel(device)
    clock("phase_kernel")
    n_launch = phase_rack(device)
    clock("phase_rack")
    check(n_launch > 0, "main path never launched consolidation_scores")
    fleet = phase_fleet(device)
    clock("phase_fleet")
    scatter = phase_pair_scatter(device)
    clock("phase_pair_scatter")
    adaptive = phase_adaptive(device)
    clock("phase_adaptive")
    health = phase_fleet_health(device)
    clock("phase_fleet_health")
    # phase 15 compares with the rack runs' results and walls, phase 16 with
    # the fused rack run's engine and controller; the other engines (their
    # captured graphs) go before the serving phases draw their models
    health.pop("fleet")
    keep = {"host": ("res", "wall"), "fused": ("res", "wall", "eng", "fleet")}
    health["rack"] = {name: {key: health["rack"][name][key] for key in keys}
                      for name, keys in keep.items()}
    free_card()
    flash = phase_flash(device)
    clock("phase_flash")
    served = phase_serve(device)
    clock("phase_serve")
    wkv = phase_rwkv_scan(device)
    clock("phase_rwkv_scan")
    served_rwkv = phase_serve_rwkv(device)
    clock("phase_serve_rwkv")
    free_card()
    scan = phase_mamba_scan(device)
    clock("phase_mamba_scan")
    served_jamba = phase_serve_jamba(device)
    clock("phase_serve_jamba")
    free_card()
    served_int8 = timed_phase("18 serve int8", phase_serve_int8, device)
    clock("phase_serve_int8")
    free_card()
    served_moe = timed_phase("19 serve moe", phase_serve_moe, device)
    clock("phase_serve_moe")
    free_card()
    served_whisper = timed_phase("20 serve whisper", phase_serve_whisper, device)
    clock("phase_serve_whisper")
    free_card()
    served_vlm = timed_phase("21 serve vlm", phase_serve_vlm, device)
    clock("phase_serve_vlm")
    free_card()
    trained = timed_phase("22 train", phase_train, device)
    clock("phase_train")
    free_card()
    families = timed_phase("23 train families", phase_train_families, device)
    clock("phase_train_families")
    free_card()
    # last, so that its profiled and captured runs leave nothing to the
    # serving phases' profiles
    obs = phase_observability(device, health)
    clock("phase_observability")
    free_card()
    axis = phase_server_axis(device, health)
    clock("phase_server_axis")
    free_card()
    phase_audit(device)
    clock("phase_audit")

    q = LOOP_Q  # the event loop's one call per micro-event, on every grid type
    flash_launches = {"9 serve": served["launches"], "13 serve jamba": served_jamba["launches_flash"],
                 "18 serve int8": served_int8["launches"], "19 serve moe": served_moe["launches"],
                 "20 serve whisper": served_whisper["launches"],
                 "21 serve vlm": served_vlm["launches"], "22 train": trained["launches"],
                 "23 train": sum(r["launches"].get("flash", {}).get("mma", 0)
                                 for k, r in families.items() if k != "seconds")}
    trained23 = {k: r for k, r in families.items() if k != "seconds"}
    wkv_train, scan_train = trained23["rwkv6-7b"]["wkv"], trained23["jamba-v0.1-52b"]["scan"]
    rwkv_train = trained23["rwkv6-7b"]["launches"]["rwkv6_scan"]["chunked"]
    scan_train_n = trained23["jamba-v0.1-52b"]["launches"]["mamba_scan"]["model"]
    flash_uses = {"int8_prefill": served_int8["rows"]["prefill"],
                "int8_decode": served_int8["rows"]["decode@542"],
                "whisper_encoder": served_whisper["rows"]["encoder"],
                "cross_prefill": served_whisper["rows"]["cross prefill"],
                "cross_decode": served_whisper["rows"]["cross decode"],
                "training_forward": trained["grad"]["row"],
                "training_whisper_encoder": trained23["whisper-medium"]["encoder"]["row"],
                "training_whisper_cross": trained23["whisper-medium"]["cross"]["row"],
                **{f"training_{arch.split('-')[0]}": trained23[arch]["flash_row"]
                   for arch in ("jamba-v0.1-52b", "moonshot-v1-16b-a3b", "internvl2-2b")}}
    print(json.dumps({"kernels": [{
        "name": "consolidation_scores", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/consolidation_scores.cu",
        "replaces": "src/repro/kernels/consolidation.py:65",
        "launches": n_launch + obs["launches"] + axis["consolidation_scores"],
        "launches_phase_15": obs["launches"],
        "launches_phase_16": axis["consolidation_scores"],
        "max_abs_err": max(r["max_abs_err"] for r in [*rows.values(), *fleet.values()]),
        "ms": rows[q]["ms"], "plain_ms": rows[q]["plain_ms"],
        "bound_ms": rows[q]["bound_ms"], "bound_by": rows[q]["bound_by"],
        "library_ms": None,
        "shape": "m=64 T=230 Q=230 (every grid type)",
        "fleet": {"ms": fleet[q]["ms"], "plain_ms": fleet[q]["plain_ms"],
                  "bound_ms": fleet[q]["bound_ms"], "bound_by": fleet[q]["bound_by"],
                  "library_ms": None, "shape": "m=1024 T=230 Q=230 (every grid type)"},
    }, {
        "name": "pair_scatter", "entry": "contract", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/pair_scatter.cu",
        "replaces": "src/repro/kernels/telemetry.py:150",
        "launches": adaptive["contract"],
        "max_abs_err": max(scatter["max_abs_err"], scatter["ref_err"]),
        **{key: scatter[key]
           for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")},
        "host_path": {key: scatter["host_path"][key]
                      for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                  "shape")},
    }, {
        "name": "pair_scatter", "entry": "banked", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/pair_scatter.cu",
        "replaces": "src/repro/kernels/telemetry.py:150",
        "launches": adaptive["banked"] + axis["pair_scatter"],
        "launches_phase_16": axis["pair_scatter"],
        "max_abs_err": max(max(r["max_abs_err"], r.get("ref_err", 0.0))
                           for r in scatter["banked"].values()),
        **{key: scatter["banked"]["rack 256"][key]
           for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")},
        "shapes": {label: {key: r[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                   "library_ms", "shape")}
                   for label, r in scatter["banked"].items() if label != "rack 256"},
    }, {
        "name": "cusum_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/cusum_scan.cu",
        "replaces": "src/repro/fleet/detect.py:85 (_cusum_update's lax.scan; no pl.pallas_call)",
        "launches": health["launches"]["cusum_scan"] + axis["cusum_scan"],
        "launches_phase_16": axis["cusum_scan"],
        "max_abs_err": max(health["max_abs_err"]["cusum"], axis["err"].get("cusum", 0.0)),
        **{key: health["cusum_rack"][key] for key in FLEET_KERNEL_KEYS},
        "fleet": {key: health["cusum_fleet"][key] for key in FLEET_KERNEL_KEYS},
        "launches_held_to_plain": health["checked"]["cusum"] + axis["checked"].get("cusum", 0),
        "seeded_held_to_plain": health["seeded"]["cusum"],
    }, {
        "name": "fleet_actions", "entries": "split, evict", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fleet_actions.cu",
        "replaces": "src/repro/fleet/controller.py:223 (fleet_step's two lax.fori_loops; "
                    "no pl.pallas_call)",
        "launches": health["launches"]["fleet_actions"] + axis["fleet_actions"],
        "launches_phase_16": axis["fleet_actions"],
        "max_abs_err": max(health["max_abs_err"]["split"], health["max_abs_err"]["evict"],
                           *(axis["err"].get(e, 0.0) for e in ("split", "evict"))),
        **{key: health["actions_rack"][key] for key in FLEET_KERNEL_KEYS},
        **{name: {key: health[f"actions_{tag}"][key] for key in FLEET_KERNEL_KEYS}
           for name, tag in (("quiet", "rack_quiet"), ("fleet", "fleet"),
                             ("fleet_quiet", "fleet_quiet")) if f"actions_{tag}" in health},
        "launches_held_to_plain": (health["checked"]["split"] + health["checked"]["evict"]
                                   + sum(axis["checked"].get(e, 0) for e in ("split", "evict"))),
        "seeded_held_to_plain": health["seeded"]["split"] + health["seeded"]["evict"],
    }, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:118",
        "launches": sum(flash_launches.values()),
        "launches_by_phase": flash_launches,
        "max_abs_err": max(r["max_abs_err"] for r in [*flash.values(), *flash_uses.values()]),
        **{key: flash[("prefill", "bfloat16")][key]
           for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")},
        "decode": {key: flash[("decode@511", "bfloat16")][key]
                   for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")},
        **{name: {key: r[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                          "library_ms", "shape", "max_abs_err")}
           for name, r in flash_uses.items()},
        "training_step": {key: trained[key] for key in (
            "step_ms", "tokens_per_s", "peak_gib", "flash_share", "device_busy", "opt_ms")}
        | {key: trained["grad"][key] for key in ("fwd_bwd_ms", "plain_fwd_bwd_ms",
                                                 "sdpa_fwd_bwd_ms")},
        "training_families": {arch: {key: r[key] for key in (
            "step_ms", "tokens_per_s", "peak_gib", "n_params")} for arch, r in trained23.items()},
        **{f"fwd_bwd_whisper_{part}": {key: trained23["whisper-medium"][part][key] for key in (
            "fwd_bwd_ms", "plain_fwd_bwd_ms", "sdpa_fwd_bwd_ms")} for part in ("encoder", "cross")},
    }, {
        "name": "rwkv6_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rwkv6_scan.cu",
        "replaces": "src/repro/kernels/rwkv6_scan.py:90",
        "launches": served_rwkv["launches"] + rwkv_train,
        "launches_by_entry": served_rwkv["by_entry"], "launches_phase_23": rwkv_train,
        "max_abs_err": max(served_rwkv["shadow_err"], wkv_train["out"],
                           *(max(r["max_abs_err"], r.get("ref_err", 0.0)) for r in wkv.values())),
        **{key: wkv["prefill"][key]
           for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")},
        "decode": {key: wkv["decode"][key]
                   for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")},
        "strong_decay": {key: wkv["strong decay"][key]
                         for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                     "shape", "ref_err", "plain_ref_err")},
        "training_forward": {key: wkv_train["row"][key] for key in KERNEL_KEYS},
        "training_fwd_bwd": {key: wkv_train[key] for key in ("fwd_bwd_ms", "plain_fwd_bwd_ms")},
    }, {
        "name": "mamba_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mamba_scan.cu",
        "replaces": "src/repro/kernels/mamba_scan.py:66",
        "launches": served_jamba["launches_scan"] + scan_train_n,
        "launches_phase_23": scan_train_n,
        "max_abs_err": max(served_jamba["shadow_err"], scan_train["out"],
                           *(max(r["max_abs_err"], r.get("ref_err", 0.0)) for r in scan.values())),
        **{key: scan[("model", "prefill")][key]
           for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")},
        "sfu_ms": scan[("model", "prefill")]["sfu_ms"],
        "decode": {key: scan[("model", "decode")][key]
                   for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")},
        "contract": {key: scan[("contract", "prefill")][key]
                     for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")},
        "training_forward": {key: scan_train["row"][key] for key in KERNEL_KEYS + ("sfu_ms",)},
        "training_fwd_bwd": {key: scan_train[key] for key in ("fwd_bwd_ms", "plain_fwd_bwd_ms")},
    }]}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
