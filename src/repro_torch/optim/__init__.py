"""Optimizers and schedules of the port (counterpart of ``repro.optim``).
The compressed gradient reductions of ``repro.optim.grad_utils`` are not
ported: they reduce over a data-parallel group, and the port trains on one
card (ROADMAP item 10p)."""
from .adamw import (
    OptConfig,
    adafactor_init,
    adafactor_update,
    adamw8bit_init,
    adamw8bit_update,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    clip_scale,
    global_norm,
    make_optimizer,
)
from .schedules import constant, warmup_cosine

__all__ = ["OptConfig", "adafactor_init", "adafactor_update", "adamw8bit_init",
           "adamw8bit_update", "adamw_init", "adamw_update", "clip_by_global_norm",
           "clip_scale", "constant", "global_norm", "make_optimizer", "warmup_cosine"]
