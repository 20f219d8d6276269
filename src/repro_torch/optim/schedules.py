"""Learning-rate schedules (copied from ``repro/optim/schedules.py``): float32
arithmetic on a float32 step, in the JAX code's order, as 0-d tensors on
``device`` (the step's device when it is a tensor)."""
from __future__ import annotations

import math

import torch


def _step(step, device) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(dtype=torch.float32, device=device or step.device)
    return torch.tensor(step, dtype=torch.float32, device=device)


def warmup_cosine(step, *, peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1, device=None) -> torch.Tensor:
    step = _step(step, device)
    warm = peak_lr * step / max(warmup_steps, 1)
    t = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
    t = torch.clamp(t, 0.0, 1.0)
    cos = peak_lr * (final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * t)))
    return torch.where(step < warmup_steps, warm, cos)


def constant(step, *, peak_lr: float, device=None, **_) -> torch.Tensor:
    return torch.full_like(_step(step, device), peak_lr)
