"""Time two checkouts' kernels on one card, in turns:

    python3 tools/kernel_ab.py PARENT_ROOT [CHANGE_ROOT]

CHANGE_ROOT defaults to this checkout. Runs parent, change, change, parent,
each in a process of its own (the two checkouts' packages share a name).
Each run times, through the wrappers' default calls (which both checkouts
have), ``consolidation_scores`` at m = 64, Q = 1, 8, 1024 and m = 1024,
Q = 1, 8, 4096, ``pair_scatter``'s contract entry at B = 4096, T = 230,
K = 2 and its banked entry at the rack and fleet rows of
``chip_smoke.BANKED_SHAPES`` -- on a checkout without the banked entry,
that block runs as the host-alternating refresh runs it, one contract
launch per server with rows in it (the per-server split is not timed) --
``flash_attention`` in bf16 at the serving rows of
``chip_smoke.FLASH_SHAPES`` (tinyllama-1.1b and jamba-v0.1-52b, prefill and
decode@511), ``rwkv6_scan`` at the serving rows of ``chip_smoke.RWKV_SHAPES``
(prefill, the prefill under strong decays, decode) and both entries of
``mamba_scan`` at the served rows of ``chip_smoke.MAMBA_SHAPES`` (prefill,
decode), ``cusum_scan`` at the rack and fleet blocks of
``chip_smoke.CUSUM_SHAPES`` and ``fleet_actions`` (split then evict) acting
and quiet at the rows of ``chip_smoke.ACTION_SHAPES``. The timer
(``device_ms``), the inputs (``kernel_inputs``, ``candidate_types``,
``scatter_inputs``, ``banked_inputs``, ``rwkv_inputs``, ``mamba_inputs``,
``contract_inputs``, ``cusum_inputs``, ``actions_inputs``) and the shapes
are this checkout's ``chip_smoke.py`` ones, so both sides are timed as its
phases 3, 5, 6, 8, 10, 12 and 14 time them, on the same seeded inputs.
Prints each run's device ms, then per shape the mean of each side and
change / parent. Needs one CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parents[1]
#: (m, Q) of the scorer; the labels of chip_smoke.BANKED_SHAPES, of
#: chip_smoke.FLASH_SHAPES timed in bf16, of chip_smoke.RWKV_SHAPES and of
#: chip_smoke.MAMBA_SHAPES
SCORES = [(64, 1), (64, 8), (64, 1024), (1024, 1), (1024, 8), (1024, 4096)]
BANKED = ("rack 256", "rack 512", "fleet 4096")
FLASH = ("prefill", "decode@511", "jamba prefill", "jamba decode@511")
RWKV = ("prefill", "strong decay", "decode")
MAMBA = ("prefill", "decode")


def measure(root: pathlib.Path) -> dict:
    """Device ms of each shape by the kernels of the checkout at ``root``."""
    sys.path[:0] = [str(root / "src"), str(HERE)]
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.core import kernel_args
    from repro_torch.kernels import consolidation as kc
    from repro_torch.kernels import cusum as kcu
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels import fleet_actions as kfa
    from repro_torch.kernels import mamba_scan as km
    from repro_torch.kernels import rwkv6_scan as ks
    from repro_torch.kernels import telemetry as kt

    dev = torch.device("cuda")
    out = {}
    for m, Q in SCORES:
        rng = np.random.default_rng(cs.SEED)
        cl, counts = cs.kernel_inputs(m, dev, rng)
        args = kernel_args(cl, counts, cs.candidate_types(counts, Q, rng))
        out[f"scores m={m} Q={Q}"] = cs.device_ms(lambda: kc.consolidation_scores(*args))
    rng = np.random.default_rng(cs.SEED + 2)
    T, K = 230, 2
    sargs = cs.scatter_inputs(4096, T, K, dev, rng)
    out["pair_scatter contract B=4096"] = cs.device_ms(lambda: kt.pair_scatter(*sargs))
    for label, m, B, drop in cs.BANKED_SHAPES:
        if label not in BANKED:
            continue
        keys, co, vals = cs.banked_inputs(m, B, T, K, drop, dev, rng)
        if hasattr(kt, "pair_scatter_banked"):
            fn = lambda: kt.pair_scatter_banked(keys, co, vals, m * T)  # noqa: E731
        else:  # one contract launch per server with rows, as the host path
            parts = []
            for s in range(m):
                sel = (keys >= 0) & (keys // T == s)
                if bool(sel.any()):
                    parts.append(((keys[sel] % T).contiguous(), co[sel].contiguous(),
                                  vals[:, sel].contiguous()))
            fn = lambda: [kt.pair_scatter(*p) for p in parts]  # noqa: E731
        out[f"pair_scatter banked {label}"] = cs.device_ms(fn)
    gen = torch.Generator(dev).manual_seed(cs.SEED + 3)
    for label, B, Sq, Skv, H, Hkv, dh, causal, off, win in cs.FLASH_SHAPES:
        if label not in FLASH:
            continue
        q = torch.randn(B, Sq, H, dh, generator=gen, device=dev).bfloat16()
        k, v = (torch.randn(B, Skv, Hkv, dh, generator=gen, device=dev).bfloat16()
                for _ in range(2))
        kw = dict(causal=causal, q_offset=off, window=win)
        out[f"flash {label}"] = cs.device_ms(lambda: kf.flash_attention(q, k, v, **kw))
        del q, k, v
    gen = torch.Generator(dev).manual_seed(cs.SEED + 4)
    for label, *shape in cs.RWKV_SHAPES:
        if label in RWKV:
            args = cs.rwkv_inputs(*shape, gen, dev)
            out[f"rwkv6_scan {label}"] = cs.device_ms(lambda: ks.rwkv6_scan(*args))
    gen = torch.Generator(dev).manual_seed(cs.SEED + 6)
    for label, *shape in cs.MAMBA_SHAPES:
        if label in MAMBA:
            margs = cs.mamba_inputs(*shape, gen, dev)
            out[f"mamba_scan model {label}"] = cs.device_ms(
                lambda: km.mamba_selective_scan(*margs))
            cargs = cs.contract_inputs(*margs)
            out[f"mamba_scan contract {label}"] = cs.device_ms(lambda: km.mamba_scan(*cargs))
            del margs, cargs
    rng = np.random.default_rng(cs.SEED + 14)
    for label, m, B, n_valid in cs.CUSUM_SHAPES:
        cargs, ckw = cs.cusum_inputs(m, B, n_valid, dev, rng)
        out[f"cusum_scan {label} B={B}"] = cs.device_ms(lambda: kcu.cusum_scan(*cargs, **ckw))
    for m, case in cs.ACTION_SHAPES:
        s_args, e_args = cs.actions_inputs(m, case, dev, rng)
        out[f"fleet_actions m={m} {case}"] = cs.device_ms(
            lambda: (kfa.split_loop(*s_args), kfa.evict_loop(*e_args)))
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
