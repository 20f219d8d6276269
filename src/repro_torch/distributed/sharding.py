"""Sharding resolution (counterpart of ``repro/distributed/sharding.py``):
logical-axis rules -> a plain spec per leaf of the parameters, the
optimizer state, the caches and the input batches, and the bytes each
device holds under them.

A spec is a tuple with one entry per dimension: None, a mesh-axis name or
a tuple of names, the entries of JAX's ``PartitionSpec`` (the port has no
``NamedSharding``; the specs are what the dry run and the decoder LMs'
sharded route read). ``local_shards`` cuts a full tree into one rank's
slices under its specs: each rank of a mesh holds exactly what its spec
gives it.
"""
from __future__ import annotations

import math
from typing import Callable, Mapping

import torch

from ..configs.base import MeshConfig, batch_axes, sharding_rules
from ..models.api import Model
from ..models.params import (Spec, axis_names, map_infos, partition_specs, shard_factor,
                             spec_entry)
from ..tree import leaves, tree_map


def axis_sizes(mesh_cfg: MeshConfig) -> dict[str, int]:
    d = {"data": mesh_cfg.data, "model": mesh_cfg.model}
    if mesh_cfg.multi_pod:
        d["pod"] = mesh_cfg.pods
    return d


def param_specs(model: Model, mesh_cfg: MeshConfig):
    return partition_specs(model.param_infos(), sharding_rules(model.cfg, mesh_cfg),
                           axis_sizes(mesh_cfg))


def cache_specs(model: Model, mesh_cfg: MeshConfig, batch: int, max_len: int):
    return partition_specs(model.cache_infos(batch, max_len),
                           sharding_rules(model.cfg, mesh_cfg), axis_sizes(mesh_cfg))


def batch_specs(model: Model, mesh_cfg: MeshConfig, input_specs: Mapping) -> dict[str, Spec]:
    """Specs of a model-input dict (``Model.input_specs``): the leading dim
    is the batch, over the data axes when the global batch divides them,
    else replicated (long_500k's batch of 1)."""
    b = spec_entry(batch_axes(mesh_cfg))
    dp = mesh_cfg.dp
    out = {}
    for k, v in input_specs.items():
        lead = b if v.shape and v.shape[0] % dp == 0 else None
        out[k] = (lead, *([None] * (len(v.shape) - 1)))
    return out


def meta_params(infos):
    """The parameter tree as meta tensors of each leaf's shape and dtype
    (JAX's ``abstract``): nothing is allocated."""
    return map_infos(lambda i: torch.empty(i.shape, dtype=i.dtype, device="meta"), infos)


def opt_state_specs(opt_init: Callable, params_meta, p_specs):
    """Optimizer-state specs, as JAX's: the state's shapes come from
    ``opt_init`` run on the meta parameter tree; a leaf mirrors the spec
    of the first parameter of its shape (AdamW's m and v: ZeRO-1 through
    the parameter sharding); a leaf whose shape is a prefix of a
    parameter's takes that spec's prefix (Adafactor's row factors); the
    rest is replicated (scalars, column factors, quantization scales)."""
    state = opt_init(params_meta)
    by_shape: dict[tuple, Spec] = {}
    prefixes: list[tuple[tuple, Spec]] = []
    for p, s in zip(leaves(params_meta), leaves_of_specs(p_specs)):
        by_shape.setdefault(tuple(p.shape), s)
        prefixes.append((tuple(p.shape), s))

    def spec_for(leaf) -> Spec:
        shape = tuple(leaf.shape)
        if shape in by_shape:
            return by_shape[shape]
        for pshape, pspec in prefixes:
            if len(shape) < len(pshape) and pshape[: len(shape)] == shape:
                return tuple(pspec[: len(shape)])
        return ()

    return tree_map(spec_for, state)


def leaves_of_specs(specs) -> list[Spec]:
    """The spec leaves of a nested dict of specs, in sorted key order (the
    order ``tree.leaves`` walks the tree they describe)."""
    if isinstance(specs, tuple):
        return [specs]
    return [s for k in sorted(specs) for s in leaves_of_specs(specs[k])]


def bytes_per_device(tree, specs, sizes: Mapping[str, int]) -> float:
    """Bytes one device holds of ``tree`` (ParamInfo or tensor leaves)
    under ``specs`` (a spec per leaf, the same structure): each leaf's
    bytes divided by the product of the sizes of the mesh axes that shard
    it."""
    xs, ss = leaves(tree), leaves_of_specs(specs)
    if len(xs) != len(ss):
        raise ValueError(f"{len(xs)} leaves against {len(ss)} specs")
    return float(sum(math.prod(x.shape) * x.dtype.itemsize / shard_factor(s, sizes)
                     for x, s in zip(xs, ss)))


def _slot(names: tuple, coords: Mapping[str, int], sizes: Mapping[str, int]) -> tuple[int, int]:
    """(slot, slots) of a rank along the axes ``names`` (the first
    outermost)."""
    i, n = 0, 1
    for a in names:
        i, n = i * sizes[a] + coords[a], n * sizes[a]
    return i, n


def local_shard(x, spec: Spec, coords: Mapping[str, int], sizes: Mapping[str, int]):
    """The slice of one leaf (a tensor or an array) that the rank at
    ``coords`` holds under ``spec``: along each dimension the slot of the
    axes its entry names. A view of ``x``."""
    for dim, entry in enumerate(spec):
        names = axis_names(entry)
        if not names:
            continue
        i, n = _slot(names, coords, sizes)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over {names}")
        c = x.shape[dim] // n
        x = x[(slice(None),) * dim + (slice(i * c, (i + 1) * c),)]
    return x


def local_shards(tree, specs, coords: Mapping[str, int], sizes: Mapping[str, int]):
    """``local_shard`` of every leaf of ``tree`` (nested dicts: parameters,
    or an optimizer state under ``opt_state_specs``) with its spec."""
    if isinstance(tree, Mapping):
        return {k: local_shards(tree[k], specs[k], coords, sizes) for k in tree}
    return local_shard(tree, specs, coords, sizes)
