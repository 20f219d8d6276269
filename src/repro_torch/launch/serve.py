"""Serving driver with consolidation-gated admission (counterpart of
``repro/launch/serve.py``).

Request streams are admitted onto the serving hosts by the paper's engine
(``admission_check``), then one batch of requests runs batched prefill and
greedy decode against the KV cache on one device, attention through the
hand-written CUDA kernel on the card:

  python -m repro_torch.launch.serve --arch tinyllama-1.1b --requests 8 \\
      --prompt-len 512 --gen 32
  python -m repro_torch.launch.serve --device cpu --smoke --requests 2 \\
      --prompt-len 16 --gen 8

Weights are drawn at random from ``--seed`` (nothing is downloaded).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from ..configs.base import ModelConfig
from ..configs.registry import get_config
from ..core import H100_HOST, ConsolidationEngine, Deadlock, ServerSpec, Workload
from ..core.units import KB, MB
from ..device import resolve_device
from ..distributed.serve_step import greedy_steps
from ..models.api import Model, build_model
from ..models.transformer import TransformerLM


def admission_check(arch: str, n_streams: int, *, host: ServerSpec = H100_HOST,
                    device: str | torch.device | None = None, metrics: bool = False):
    """Admit ``n_streams`` request streams onto two serving hosts through the
    ConsolidationEngine (the paper's online operating model, §V).

    Each stream is characterized (§III.A) by its host-side I/O: KV-cache
    paging working set as FS, per-decode-step activation traffic as RS.
    Returns one placement per stream; ``None`` means the stream was not
    admitted on arrival and had to queue for capacity (criterion 1), and a
    deadlock admits nothing. Scores through the CUDA kernel on the card and
    the engine's own torch scorer on the CPU.
    """
    if metrics:
        raise NotImplementedError(
            "admission metrics need the obs/ plane: ROADMAP Queue 1 item 7")
    device = resolve_device(device)
    scorer = "cuda" if device.type == "cuda" else "torch"
    engine = ConsolidationEngine([host, host], scorer=scorer, device=device)
    stream = Workload(fs=64 * MB, rs=256 * KB, name=f"serve:{arch}")
    try:
        result = engine.run([(0.0, stream)] * n_streams)
    except Deadlock:
        # the stream fits no empty host: admit nothing rather than crash the
        # serving driver at startup
        return [None] * n_streams
    return [None if q else p for p, q in zip(result.placements, result.was_queued)]


def prepare(cfg: ModelConfig, *, requests: int, prompt_len: int, seed: int = 0,
            device: str | torch.device | None = None) -> tuple[Model, TransformerLM, torch.Tensor]:
    """(model, lm, prompts [requests, prompt_len]): weights and prompts drawn
    from one generator seeded with ``seed`` on ``device``."""
    device = resolve_device(device)
    model = build_model(cfg)
    gen = torch.Generator(device).manual_seed(seed)
    lm = model.init(gen, device=device)
    prompts = torch.randint(0, cfg.vocab, (requests, prompt_len), generator=gen, device=device)
    return model, lm, prompts


@dataclasses.dataclass
class ServeRun:
    """One batch served: tokens [B, gen] and the time of each forward call
    (seconds, ended by a device synchronize); ``logits`` holds each call's
    last-position logits [B, Vp] when kept."""

    tokens: torch.Tensor
    prefill_s: float
    decode_s: list[float]
    logits: list[torch.Tensor] | None = None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(model: Model, lm: TransformerLM, prompts: torch.Tensor, gen: int, *,
             keep_logits: bool = False) -> ServeRun:
    """Prefill ``prompts`` into a fresh cache, then ``gen - 1`` greedy decode
    steps (``serve_step.greedy_steps``): ``gen`` tokens per request."""
    B, S = prompts.shape
    device = prompts.device
    cache = model.init_cache(B, S + gen, device=device)
    toks, times, kept = [], [], [] if keep_logits else None
    _sync(device)
    t0 = time.perf_counter()
    for tok, logits, _ in greedy_steps(model, lm, {"tokens": prompts}, cache, gen):
        _sync(device)
        times.append(time.perf_counter() - t0)
        toks.append(tok)
        if kept is not None:
            kept.append(logits[:, -1, :])
        t0 = time.perf_counter()
    return ServeRun(torch.stack(toks, dim=1), times[0], times[1:], kept)


def main(argv=None) -> torch.Tensor:
    """Parse the command line, admit, serve one batch; returns the generated
    tokens [requests, gen] on the CPU."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    placements = admission_check(args.arch, args.requests, device=device)
    print(f"consolidation admission: {args.requests} stream(s) -> hosts {placements}")

    cfg = get_config(args.arch, smoke=args.smoke)
    model, lm, prompts = prepare(cfg, requests=args.requests, prompt_len=args.prompt_len,
                                 seed=args.seed, device=device)
    run = generate(model, lm, prompts, args.gen)
    total = run.prefill_s + sum(run.decode_s)
    print(f"generated {tuple(run.tokens.shape)} tokens in {total:.3f} s "
          f"({args.requests * args.gen / total:.1f} tok/s; prefill {1e3 * run.prefill_s:.2f} ms, "
          f"decode {1e3 * sum(run.decode_s) / max(len(run.decode_s), 1):.2f} ms/step) on {device}")
    print("sample:", run.tokens[0][:12].tolist())
    return run.tokens.cpu()


if __name__ == "__main__":
    main()
