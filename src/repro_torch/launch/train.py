"""End-to-end training entry point of the port (counterpart of
``repro/launch/train.py``).

On the card:      python -m repro_torch.launch.train --arch tinyllama-1.1b \
                      --steps 6 --batch 8 --seq 1024
On the CPU:       python -m repro_torch.launch.train --device cpu --smoke \
                      --steps 20 --batch 4 --seq 64

On a mesh:       torchrun --nproc-per-node 2 -m repro_torch.launch.train \
                      --device cpu --smoke --mesh 1,2 --steps 4 --batch 4 --seq 64

Wires the training substrate together: the chunk-store data pipeline ->
the training step (``distributed.train_step``) -> async, atomic
checkpoints -> heartbeats with the straggler policy. Restart-safety:
rerunning with the same --ckpt dir resumes from the last complete step,
the data-pipeline cursor included. ``--mesh DATA,MODEL`` runs the sharded
step (the decoder LMs) on a mesh over the default process group, as JAX's
launcher runs under ``make_host_mesh()``: every rank draws the same batch
and computes on its rows; rank 0 prints. Sharded checkpoints are ROADMAP
10p-b, so ``--mesh`` with ``--ckpt`` raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from ..checkpoint import Checkpointer
from ..configs.base import MeshConfig, RunConfig
from ..configs.registry import get_config
from ..data import TokenPipeline, synthetic_store
from ..device import resolve_device
from ..distributed.fault_tolerance import HeartbeatMonitor
from ..distributed.train_step import make_sharded_train_step, make_train_step
from ..models.api import build_model
from .mesh import parse_mesh, process_mesh


@dataclasses.dataclass
class TrainRun:
    """What a run did: the loss of every step it ran (from ``start_step``
    on), each step's wall seconds (ended by reading its loss, which waits
    for the device), the metrics as host floats, and the final state."""
    start_step: int
    losses: list[float]
    step_s: list[float]
    metrics: list[dict[str, float]]
    params: dict
    opt_state: dict


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--mesh", default="", help="DATA,MODEL: the sharded step on a mesh")
    args = ap.parse_args(argv)
    if args.mesh and args.ckpt:
        raise ValueError("--mesh with --ckpt: sharded checkpoints are ROADMAP item 10p-b")
    return args


def train(argv=None) -> TrainRun:
    """Train as ``argv`` asks; return what the run did."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    model = build_model(cfg)
    data, mdl = parse_mesh(args.mesh) if args.mesh else (1, 1)
    run = RunConfig(model=cfg, shape="train_4k", mesh=MeshConfig(data=data, model=mdl),
                    learning_rate=args.lr, total_steps=args.steps,
                    warmup_steps=max(1, args.steps // 10), microbatches=args.microbatches)
    lead = True
    if args.mesh:
        mesh = process_mesh(data, mdl, device)
        init, train_step, _ = make_sharded_train_step(model, run, mesh)
        lead = mesh.coords == {"data": 0, "model": 0}
    else:
        init, train_step = make_train_step(model, run)
    params, opt_state = init(torch.Generator(device).manual_seed(args.seed))

    store = synthetic_store(n_files=2, file_mb=64, block_mb=8)
    pipe = TokenPipeline(store, vocab=cfg.vocab, batch=args.batch, seq_len=args.seq,
                         prefetch=2).start()
    ckpt = Checkpointer(args.ckpt) if args.ckpt else None
    monitor = HeartbeatMonitor(n_hosts=1)
    try:
        start_step = 0
        if ckpt and ckpt.latest_step() is not None:
            s = ckpt.latest_step()
            restored = ckpt.restore(s, {"params": params, "opt": opt_state,
                                        "data": pipe.state_dict()}, device=device)
            params, opt_state = restored["params"], restored["opt"]
            pipe.load_state_dict(restored["data"])
            start_step = s
            print(f"resumed from step {s}")

        t0 = time.time()
        losses, step_s, metrics = [], [], []
        for step in range(start_step, args.steps):
            batch = {k: torch.from_numpy(v).to(device) for k, v in next(pipe).items()}
            ts = time.time()
            params, opt_state, out = train_step(params, opt_state, batch, step)
            out = {k: float(v) for k, v in out.items()}
            step_s.append(time.time() - ts)
            losses.append(out["loss"])
            metrics.append(out)
            monitor.heartbeat(0, time.time(), step_s[-1])
            if lead and (step % args.log_every == 0 or step == args.steps - 1):
                print(f"step {step:5d} loss {out['loss']:.4f} lr {out['lr']:.2e} "
                      f"gnorm {out['grad_norm']:.3f} "
                      f"({(time.time()-t0)/max(1, step-start_step+1):.3f}s/step)")
            if ckpt and (step + 1) % args.ckpt_every == 0:
                ckpt.save(step + 1, {"params": params, "opt": opt_state,
                                     "data": pipe.state_dict()})
            stragglers = monitor.stragglers()
            if stragglers:
                print(f"straggler hosts detected: {stragglers} (Eqn-4 policy)")
        if ckpt:
            ckpt.save(args.steps, {"params": params, "opt": opt_state,
                                   "data": pipe.state_dict()}, blocking=True)
    finally:
        pipe.stop()
    if losses and lead:
        print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f}); "
              f"improved: {losses[-1] < losses[0]}")
    return TrainRun(start_step, losses, step_s, metrics, params, opt_state)


def main(argv=None) -> list[float]:
    """JAX's ``main``: the losses of the steps this run ran."""
    return train(argv).losses


if __name__ == "__main__":
    main()
