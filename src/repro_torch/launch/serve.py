"""Serving driver with consolidation-gated admission (counterpart of
``repro/launch/serve.py``).

Request streams are admitted onto the serving hosts by the paper's engine
(``admission_check``), then one batch of requests runs batched prefill and
greedy decode on one device: a dense or MoE LM against its KV cache (bf16,
or int8 with ``kv_cache_dtype='int8'``), attention through the
hand-written CUDA flash kernel on the card; the vlm, whose 256 patch
embeddings go before the prompt; the Whisper encoder-decoder, whose
encoder reads 1500 frame embeddings and whose decoder cross-attends to
them; RWKV6 against its recurrent state, the WKV through the hand-written
CUDA scan; or the Jamba hybrid against its KV cache and Mamba states, with
windowed attention through the flash kernel and Mamba's selective scan
through the hand-written CUDA ``mamba_scan``. The patch and frame
embeddings are drawn at random (the frontends are stubs, as in JAX):

  python -m repro_torch.launch.serve --arch tinyllama-1.1b --requests 8 \\
      --prompt-len 512 --gen 32
  python -m repro_torch.launch.serve --arch whisper-medium --requests 8 \\
      --prompt-len 416 --gen 32
  python -m repro_torch.launch.serve --arch internvl2-2b --requests 8 \\
      --prompt-len 512 --gen 32
  python -m repro_torch.launch.serve --arch rwkv6-7b --requests 8 \\
      --prompt-len 512 --gen 32
  python -m repro_torch.launch.serve --arch rwkv6-7b --device cpu --smoke \\
      --requests 2 --prompt-len 16 --gen 8
  python -m repro_torch.launch.serve --arch jamba-v0.1-52b --device cpu --smoke \\
      --requests 2 --prompt-len 16 --gen 8

``moonshot-v1-16b-a3b`` (28.1 B parameters) fits one 80 GB card only with
bf16 weights (56 GB): ``chip_smoke.py`` serves it with
``param_dtype=bfloat16``, and the int8 KV cache with
``kv_cache_dtype='int8'`` (``dataclasses.replace`` of the config).
``kimi-k2-1t-a32b`` runs as ``--smoke`` only: its 1T parameters fit no
card, and its head dim of 112 is not one the flash kernel takes.

The full ``jamba-v0.1-52b`` (32 layers, 51.57 B parameters) does not fit
one 80 GB card even in bf16 (103 GB); ``chip_smoke.py`` serves it cut to
16 layers with ``param_dtype=bfloat16`` (``dataclasses.replace`` of the
CONFIG, 52.1 GB), and ``--arch jamba-v0.1-52b`` without ``--smoke`` asks
for the whole model. Weights are drawn at random from ``--seed`` (nothing
is downloaded).
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
from ..models.api import LM, Model, build_model

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

    ``metrics=True`` updates the ``repro_torch.obs`` MetricFrame in the
    admission run and returns ``(placements, frame)`` -- the frame's
    waiting-time and slowdown histograms are the serving-SLO percentiles
    (``None`` frame on deadlock: the run never completed).
    """
    device = resolve_device(device)
    scorer = "cuda" if device.type == "cuda" else "torch"
    engine = ConsolidationEngine([host, host], scorer=scorer, device=device)
    stream = Workload(fs=64 * MB, rs=256 * KB, name=f"serve:{arch}")
    try:
        result = engine.run([(0.0, stream)] * n_streams, metrics=metrics)
    except Deadlock:
        # the stream fits no empty host: admit nothing rather than crash the
        # serving driver at startup
        placements = [None] * n_streams
        return (placements, None) if metrics else placements
    placements = [None if q else p for p, q in zip(result.placements, result.was_queued)]
    return (placements, result.metrics) if metrics else placements


def prepare(cfg: ModelConfig, *, requests: int, prompt_len: int, seed: int = 0,
            device: str | torch.device | None = None
            ) -> tuple[Model, LM, torch.Tensor, dict[str, torch.Tensor]]:
    """(model, lm, prompts [requests, prompt_len], extras): the LM of
    ``cfg``'s family, its weights, the prompts and then the prefill's other
    inputs (``extras``: the vlm's ``vis_embeds`` [requests, 256, D], the
    encdec's ``audio_embeds`` [requests, 1500, D], standard normal in the
    compute dtype; empty for the other families) drawn from one generator
    seeded with ``seed`` on ``device``."""
    device = resolve_device(device)
    model = build_model(cfg)
    gen = torch.Generator(device).manual_seed(seed)
    lm = model.init(gen, device=device)
    prompts = torch.randint(0, cfg.vocab, (requests, prompt_len), generator=gen, device=device)
    extras = {name: torch.randn(shape, generator=gen, device=device).to(cfg.compute_dtype)
              for name, shape in model.prefill_extras(requests).items()}
    return model, lm, prompts, extras


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


def generate(model: Model, lm: LM, prompts: torch.Tensor, gen: int, *,
             extras: dict[str, torch.Tensor] | None = None,
             keep_logits: bool = False) -> ServeRun:
    """Prefill ``prompts`` (with ``extras``, the prefill's other inputs) into
    a fresh cache, then ``gen - 1`` greedy decode steps
    (``serve_step.greedy_steps``): ``gen`` tokens per request. The cache
    holds every row the requests write, a vlm's patch embeddings included,
    plus ``CACHE_PAD`` (the JAX serve script sizes it for the prompt and the
    generated tokens only, which a prefix of more than ``CACHE_PAD`` rows
    overruns)."""
    B, S = prompts.shape
    device = prompts.device
    batch = dict(extras or {}, tokens=prompts)
    cache = model.init_cache(B, model.prefix_len(batch) + S + gen, device=device)
    toks, times, kept = [], [], [] if keep_logits else None
    _sync(device)
    t0 = time.perf_counter()
    for tok, logits, _ in greedy_steps(model, lm, batch, cache, gen):
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

    placements, frame = admission_check(args.arch, args.requests, device=device, metrics=True)
    print(f"consolidation admission: {args.requests} stream(s) -> hosts {placements}")
    if frame is not None:
        # the paper's utilization-floor criterion as a serving SLO: waiting
        # time (s) and slowdown (x solo) percentiles of the admission run
        from ..obs.report import percentile_table

        print("admission SLO percentiles:")
        print(percentile_table(frame, ("waiting_time", "slowdown")))

    cfg = get_config(args.arch, smoke=args.smoke)
    model, lm, prompts, extras = prepare(cfg, requests=args.requests,
                                         prompt_len=args.prompt_len, seed=args.seed,
                                         device=device)
    run = generate(model, lm, prompts, args.gen, extras=extras)
    total = run.prefill_s + sum(run.decode_s)
    print(f"generated {tuple(run.tokens.shape)} tokens in {total:.3f} s "
          f"({args.requests * args.gen / total:.1f} tok/s; prefill {1e3 * run.prefill_s:.2f} ms, "
          f"decode {1e3 * sum(run.decode_s) / max(len(run.decode_s), 1):.2f} ms/step) on {device}")
    print("sample:", run.tokens[0][:12].tolist())
    return run.tokens.cpu()


if __name__ == "__main__":
    main()
