"""Parameter declarations and their initialisation (counterpart of
``repro/models/params.py``).

A model declares its parameters as a nested dict of :class:`ParamInfo`;
``materialize`` draws every leaf from one ``torch.Generator`` on that
generator's device, with the JAX package's init rules:

  normal  truncated normal on [-2, 2], times ``scale`` or 1/sqrt(fan_in),
          fan_in being the first dim of one layer's (one expert's) weight
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
random model keeps the activation scale of a trained one. For the same
reason it skips an MoE weight's 'expert' axis, which the JAX package takes
as the fan-in of ``wi`` [E, D, 2, F] and ``wo`` [E, F, D] (1/sqrt(16) at
jamba's 16 experts, not 1/sqrt(D) and 1/sqrt(F)): a random MoE layer's
output would otherwise be thousands of times its input. Both are init
choices of the port only; the parity tests carry the JAX weights across.
The sharding axes of the JAX declaration are kept as logical names;
``partition_specs`` resolves them onto a mesh with JAX's rules, as a plain
spec per leaf: a tuple with one entry per dimension, each None, a mesh-axis
name or a tuple of names (the entries of JAX's ``PartitionSpec``).

A leaf declared in another dtype than float32 is drawn in float32 slabs of
at most ``SLAB`` elements, each cast into the leaf as it is drawn, so the
float32 transient stays one slab (a stacked MoE ``wi`` of jamba's two
periods is 3.76 B elements, 15 GB in float32).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Mapping

import torch

#: elements drawn in float32 at once for a leaf cast to another dtype
SLAB = 1 << 26


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
    """The first dim of one layer's (one expert's) weight: a stacked
    declaration's leading 'layer' axis and an MoE weight's 'expert' axis are
    not fan-ins."""
    shape = tuple(d for d, a in zip(info.shape, info.axes) if a not in ("layer", "expert"))
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

    def draw(n: int) -> torch.Tensor:
        x = torch.empty(n, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=generator)
        return x.mul_(scale)

    if info.dtype == torch.float32:
        return draw(math.prod(info.shape)).view(info.shape)
    out = torch.empty(info.shape, dtype=info.dtype, device=device)
    flat = out.view(-1)
    for start in range(0, flat.numel(), SLAB):
        n = min(SLAB, flat.numel() - start)
        flat[start:start + n].copy_(draw(n))
    return out


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


#: a leaf's sharding: per dimension None, a mesh-axis name or a tuple of names
Spec = tuple


def _axes_product(axes, sizes: Mapping[str, int]) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        return sizes.get(axes, 1)
    n = 1
    for a in axes:
        n *= sizes.get(a, 1)
    return n


def axis_names(axes) -> tuple:
    """The mesh-axis names of one spec entry (None, a name or a tuple)."""
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def spec_entry(axes):
    """One spec entry in JAX's normal form: a one-name tuple is the name."""
    return axes[0] if isinstance(axes, tuple) and len(axes) == 1 else axes


def partition_spec(info: ParamInfo, rules: Mapping[str, Any],
                   axis_sizes: Mapping[str, int] | None = None) -> Spec:
    """One leaf's spec: each logical axis through ``rules`` (name -> mesh
    axes). With ``axis_sizes`` (mesh axis -> size), JAX's divisibility rules:
      * a mesh axis that does not divide its dimension is dropped
        (kv_heads = 4 on model = 16 -> replicated);
      * a weight of 2^20 elements or more that so loses 'model' entirely
        shards its 'dmodel' (contraction) dimension over 'model' instead,
        where that divides.
    """
    resolved = [rules.get(a) if a is not None else None for a in info.axes]
    if axis_sizes is None:
        return tuple(spec_entry(a) for a in resolved)
    out = []
    for dim, axes in zip(info.shape, resolved):
        n = _axes_product(axes, axis_sizes)
        out.append(axes if (n > 1 and dim % n == 0) else (axes if n == 1 else None))
    uses_model = any("model" in axis_names(a) for a in out)
    big = math.prod(info.shape) >= (1 << 20)
    if not uses_model and big and "model" in axis_sizes:
        for i, (dim, logical) in enumerate(zip(info.shape, info.axes)):
            if logical != "dmodel":
                continue
            combined = axis_names(out[i]) + ("model",)
            if dim % _axes_product(combined, axis_sizes) == 0:
                out[i] = combined
                break
    return tuple(spec_entry(a) for a in out)


def partition_specs(tree, rules: Mapping[str, Any], axis_sizes: Mapping[str, int] | None = None):
    """``partition_spec`` of every ParamInfo leaf (JAX's ``partition_specs``)."""
    return map_infos(lambda info: partition_spec(info, rules, axis_sizes), tree)


def shard_factor(spec: Spec, axis_sizes: Mapping[str, int]) -> int:
    """Devices a leaf of ``spec`` is split over: the product of the sizes of
    the mesh axes that shard it."""
    return math.prod(_axes_product(a, axis_sizes) for a in spec)


def info_leaves(tree) -> list[ParamInfo]:
    """The ParamInfo leaves of a nested dict, in sorted key order."""
    if isinstance(tree, ParamInfo):
        return [tree]
    return [leaf for k in sorted(tree) for leaf in info_leaves(tree[k])]


def count_params(tree) -> int:
    return sum(math.prod(i.shape) for i in info_leaves(tree))
