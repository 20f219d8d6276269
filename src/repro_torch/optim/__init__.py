"""Optimizers, schedules and gradient utilities of the port (counterpart of
``repro.optim``): ``grad_utils``' compressed data-parallel mean with error
feedback and its size buckets, which the sharded training step uses."""
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
from .grad_utils import bucket_by_size, compressed_psum_mean
from .schedules import constant, warmup_cosine

__all__ = ["OptConfig", "adafactor_init", "adafactor_update", "adamw8bit_init",
           "adamw8bit_update", "adamw_init", "adamw_update", "bucket_by_size",
           "clip_by_global_norm", "clip_scale", "compressed_psum_mean", "constant",
           "global_norm", "make_optimizer", "warmup_cosine"]
