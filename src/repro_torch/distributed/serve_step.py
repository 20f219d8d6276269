"""Serving steps: prefill and decode against the model's cache (a KV cache,
an encoder-decoder's self and cross K/V, or a recurrent state), with
sampling (counterpart of ``repro/distributed/serve_step.py``).

Greedy decoding takes the argmax of the float32 cast of the last
position's logits (the first index among equal maxima, as ``jnp.argmax``).
Temperature sampling draws from an explicit ``torch.Generator``; its draws
are not JAX's ``categorical``.
"""
from __future__ import annotations

from typing import Callable, Iterator

import torch

from ..models.api import Model


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """Greedy next tokens [B] from logits [B, S, V]: argmax of the last
    position's float32 cast."""
    return logits[:, -1, :].float().argmax(dim=-1)


def make_serve_steps(model: Model) -> tuple[Callable, Callable]:
    def prefill_step(lm, batch: dict, cache: dict):
        logits, cache = model.prefill(lm, batch, cache)
        return greedy(logits), cache

    def decode_step(lm, cache: dict, tokens: torch.Tensor,
                    generator: torch.Generator | None = None, temperature: float = 0.0):
        logits, cache = model.decode_step(lm, cache, tokens)
        if generator is None or temperature == 0.0:
            return greedy(logits), cache
        probs = torch.softmax(logits[:, -1, :].float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0], cache

    return prefill_step, decode_step


def greedy_steps(model: Model, lm, batch: dict, cache: dict, steps: int
                 ) -> Iterator[tuple[torch.Tensor, torch.Tensor, dict]]:
    """The greedy loop: yield (tokens [B], logits [B, 1, Vp], cache) after
    the prefill and after each of ``steps - 1`` decode steps, each step fed
    the token before it. ``batch`` (tokens and any patch or frame
    embeddings) goes to the prefill only; decode steps take tokens. The work of a step runs when it is asked for."""
    logits, cache = model.prefill(lm, batch, cache)
    for t in range(steps):
        if t:
            logits, cache = model.decode_step(lm, cache, tok[:, None])
        tok = greedy(logits)
        yield tok, logits, cache


def greedy_generate(model: Model, lm, batch: dict, cache: dict, steps: int):
    """(tokens [B, steps], cache): the prefill's token, then steps - 1 greedy
    decode steps."""
    toks = []
    for tok, _, cache in greedy_steps(model, lm, batch, cache, steps):
        toks.append(tok)
    return torch.stack(toks, dim=1), cache
