"""Parameter declarations and their initialisation (counterpart of
``repro/models/params.py``).

A model declares its parameters as a nested dict of :class:`ParamInfo`;
``materialize`` draws every leaf from one ``torch.Generator`` on that
generator's device, with the JAX package's init rules:

  normal  truncated normal on [-2, 2], times ``scale`` or 1/sqrt(fan_in),
          fan_in being the first dim of one layer's weight
  embed   truncated normal times ``scale`` (1.0 unless given; the LM's
          embedding table declares 0.02)
  small   truncated normal times ``scale`` (0.02 unless given)
  zeros / ones / const

The random streams differ from JAX's PRNG: to compare the two packages on
the same weights, carry the JAX weights across (``repro_torch.convert``).
One difference in scale: the JAX package takes the fan-in of a stacked
layer weight from the stacked shape, whose first dim is the layer count, so
its layer weights come out 1/sqrt(n_layers) wide (std ~0.19 instead of
~0.02 at tinyllama's 22 layers and d_model 2048), which makes the random
model's softmaxes near one-hot: there a last-bit difference in a score
flips which key a query reads, and two float32 attention routes give
logits several percent apart. The port skips the 'layer' axis, so a
random model keeps the activation scale of a trained one. The sharding axes
of the JAX declaration are kept as names only.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch


@dataclasses.dataclass(frozen=True)
class ParamInfo:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]  # logical axis names, same length as shape
    init: str = "normal"  # normal | zeros | ones | const | embed | small
    scale: float | None = None  # overrides fan-in scaling when set
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"axes {self.axes} do not match shape {self.shape}")


def _fan_in(info: ParamInfo) -> int:
    """The first dim of one layer's weight: a stacked declaration's leading
    'layer' axis is not a fan-in."""
    shape = tuple(d for d, a in zip(info.shape, info.axes) if a != "layer")
    return shape[0] if len(shape) > 1 else max(1, shape[0])


def init_one(info: ParamInfo, generator: torch.Generator) -> torch.Tensor:
    """One initialised tensor on ``generator``'s device."""
    device = generator.device
    if info.init == "zeros":
        return torch.zeros(info.shape, dtype=info.dtype, device=device)
    if info.init == "ones":
        return torch.ones(info.shape, dtype=info.dtype, device=device)
    if info.init == "const":
        return torch.full(info.shape, info.scale, dtype=info.dtype, device=device)
    scale = info.scale
    if info.init == "embed":
        scale = 1.0 if scale is None else scale
    elif info.init == "small":
        scale = 0.02 if scale is None else scale
    else:  # normal: truncated normal, 1/sqrt(fan_in)
        scale = (1.0 / math.sqrt(_fan_in(info))) if scale is None else scale
    x = torch.empty(info.shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return x.mul_(scale).to(info.dtype)


def map_infos(fn: Callable[[ParamInfo], Any], tree):
    """Apply ``fn`` to every ParamInfo leaf of a nested dict, in sorted key
    order (the order JAX flattens a dict in)."""
    if isinstance(tree, ParamInfo):
        return fn(tree)
    return {k: map_infos(fn, tree[k]) for k in sorted(tree)}


def materialize(tree, generator: torch.Generator):
    """Initialise every ParamInfo leaf, drawing the leaves one after another
    from ``generator``."""
    return map_infos(lambda info: init_one(info, generator), tree)


def stack_layers(n: int, info_tree):
    """Prepend a layer axis to every ParamInfo (the JAX package scans over it;
    the port keeps the stacked layout for its weights)."""
    return map_infos(
        lambda i: ParamInfo((n, *i.shape), ("layer", *i.axes), i.init, i.scale, i.dtype),
        info_tree)
