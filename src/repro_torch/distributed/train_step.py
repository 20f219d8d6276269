"""The training step (counterpart of ``repro/distributed/train_step.py``):
loss -> gradients -> optimizer, with microbatch gradient accumulation and
the model's per-layer remat, on one device or on a (data, model) mesh.

The JAX step is a jitted pure function; this one runs eagerly on the
device its parameters lie on and keeps the same contract: it takes the
parameter tree (float32 masters), the optimizer state, a batch and the
step, and returns new ones with JAX's metrics. Gradients are taken with
``torch.autograd.grad`` on detached copies of the masters, so the caller's
tensors never carry a graph.

``make_sharded_train_step`` is the same step on a mesh, where JAX runs its
jitted step under GSPMD (the decoder LMs). Each rank holds its slices of
the masters and of the optimizer state (``sharding.local_shards`` under
the specs) and takes the global batch, of which it computes on its rows.
The model's routes leave every gradient of a leaf replicated over 'model'
whole on each rank (Megatron's pairs). Over the data-parallel axes:
a leaf sharded over them (FSDP) has had its ranks' gradients summed by the
reduce-scatter of its gather, and is divided by their number; a leaf
replicated over them is averaged by ``optim.compressed_psum_mean`` with
``run.grad_compression`` (error feedback kept in the optimizer state under
``grad_errors``), one all-reduce per ``bucket_by_size`` bucket. The clip
uses the global norm: each leaf's sum of squares is all-reduced over the
axes that shard it and counted once over the axes that replicate it. The
optimizer then runs unchanged on the local slices, which for AdamW is the
one-card update of each element; 8-bit AdamW (block scales across the
flattened leaf) and Adafactor (means over a leaf's rows and columns, and
its whole-leaf update clip) are refused on a mesh that shards any leaf
(ROADMAP 10p-b).
"""
from __future__ import annotations

from typing import Callable

import torch

from ..configs.base import RunConfig
from ..models import layers as L
from ..models.api import Model
from ..models.params import axis_names, materialize
from ..optim import OptConfig, compressed_psum_mean, make_optimizer, warmup_cosine
from ..optim.grad_utils import bucket_by_size, keystr
from ..tree import leaves, leaves_with_path, tree_map
from .collectives import AXES
from .sharding import leaves_of_specs, local_shards


def _split_micro(batch: dict, k: int) -> dict:
    def r(x):
        b = x.shape[0]
        if b % k:
            raise ValueError(f"batch {b} does not split into {k} microbatches")
        return x.reshape(k, b // k, *x.shape[1:])

    return {key: r(v) for key, v in batch.items()}


def loss_and_grads(model: Model, params, batch: dict, *, mode: str | None = None):
    """(loss, metrics, grads) of ``model.loss`` at ``params``: the loss and
    metrics detached, the gradients a tree of ``params``' structure."""
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, metrics = model.loss(live, batch, mode=mode)
    flat = torch.autograd.grad(loss, leaves(live))
    it = iter(flat)
    grads = tree_map(lambda _: next(it), live)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def _accumulated(model: Model, params, batch: dict, microbatches: int, mode):
    """(loss, metrics, grads): one ``loss_and_grads``, or with k > 1
    microbatches the k gradients accumulated in float32 from zeros and
    divided by k, as is the loss (no ce / zloss, as JAX's)."""
    if microbatches <= 1:
        return loss_and_grads(model, params, batch, mode=mode)
    micro = _split_micro(batch, microbatches)
    grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                     params)
    loss = 0.0
    for i in range(microbatches):
        l, _, g = loss_and_grads(model, params, {k: v[i] for k, v in micro.items()}, mode=mode)
        grads = tree_map(lambda a, b: a + b.float(), grads, g)
        loss = loss + l
    k = float(microbatches)
    return loss / k, {}, tree_map(lambda g: g / k, grads)


def make_train_step(model: Model, run: RunConfig, *,
                    mode: str | None = None) -> tuple[Callable, Callable]:
    """Returns (init(generator) -> (params, opt_state), train_step).

    ``train_step(params, opt_state, batch, step)`` returns (params,
    opt_state, metrics): ``loss``, ``lr`` and ``grad_norm``, and with one
    microbatch the loss's ``ce`` and ``zloss``, as JAX's (its accumulated
    path reports neither). With ``run.microbatches`` = k > 1 the batch's
    leading dim splits into k, the k gradients accumulate in float32 from
    zeros and are divided by k, as is the loss. ``mode`` as in
    ``layers.attention_apply``.
    """
    ocfg = OptConfig(weight_decay=run.weight_decay, grad_clip=run.grad_clip)
    opt_init, opt_update = make_optimizer(model.cfg.optimizer, ocfg)

    def init(generator: torch.Generator):
        """Float32 masters drawn on the generator's device, and the
        optimizer state."""
        params = materialize(model.param_infos(), generator)
        return params, opt_init(params)

    def train_step(params, opt_state, batch: dict, step):
        lr = warmup_cosine(step, peak_lr=run.learning_rate, warmup_steps=run.warmup_steps,
                           total_steps=run.total_steps, device=leaves(params)[0].device)
        loss, metrics, grads = _accumulated(model, params, batch, run.microbatches, mode)
        with torch.no_grad():
            new_params, new_opt, stats = opt_update(params, grads, opt_state, lr, ocfg)
        return new_params, new_opt, {"loss": loss, "lr": lr, **metrics, **stats}

    return init, train_step


def _spec_axes(spec) -> tuple[str, ...]:
    """The mesh axes a leaf's spec shards it over, in the mesh's order."""
    named = {a for entry in spec for a in axis_names(entry)}
    return tuple(a for a in AXES if a in named)


def reduce_grads(ctx, grads, method: str = "none", errors=None):
    """The data-parallel mean of this rank's gradients (local slices of
    the masters' shapes) under ``ctx`` (``layers.MeshContext``): a leaf
    sharded over batch axes is divided by their size (its gather's
    reduce-scatter summed it), a leaf replicated over batch axes goes
    through ``compressed_psum_mean`` over them with ``method`` and its
    error-feedback residual from ``errors`` (a dict keyed by ``keystr``
    path, or None). Returns (grads, errors)."""
    mesh, bx = ctx.mesh, ctx.batch_axes
    paths = [keystr(p) for p, _ in leaves_with_path(grads)]
    flat = [g.float() for g in leaves(grads)]
    rep = {}
    for i, spec in enumerate(leaves_of_specs(ctx.specs)):
        axes = _spec_axes(spec)
        split = tuple(a for a in bx if a in axes)
        if split:
            flat[i] = flat[i] / mesh.size(split)
        over = tuple(a for a in bx if a not in axes)
        # a plain mean over one rank is the identity; a compressed one is not
        rep[paths[i]] = (i, over if method != "none" or mesh.size(over) > 1 else ())
    new_errors = {} if method != "none" else errors
    for bucket in bucket_by_size(grads):
        by_axes: dict = {}
        for path in bucket:
            i, axes = rep[path]
            if axes:
                by_axes.setdefault(axes, []).append(i)
        for axes, idx in by_axes.items():
            errs = None if errors is None else [errors[paths[i]] for i in idx]
            mean, errs = compressed_psum_mean([flat[i] for i in idx], mesh.group(axes),
                                              method, errs)
            for j, i in enumerate(idx):
                flat[i] = mean[j]
                if new_errors is not None and errs[j] is not None:
                    new_errors[paths[i]] = errs[j]
    it = iter(flat)
    return tree_map(lambda _: next(it), grads), new_errors


def sharded_global_norm(ctx, grads) -> torch.Tensor:
    """The global norm of a gradient tree of local slices: each leaf's sum
    of squares, summed over the leaves sharded over the same axes and
    all-reduced over those axes (a leaf replicated over an axis counts
    once)."""
    sums: dict = {}
    for g, spec in zip(leaves(grads), leaves_of_specs(ctx.specs)):
        axes = _spec_axes(spec)
        sums[axes] = sums.get(axes, 0.0) + torch.sum(torch.square(g.float()))
    total = 0.0
    for axes in sorted(sums):
        total = total + (ctx.mesh.all_reduce(sums[axes], axes) if axes else sums[axes])
    return torch.sqrt(total)


def sharded_loss_and_grads(model: Model, ctx, params, batch: dict, *, microbatches: int = 1,
                           method: str = "none", errors=None, mode: str | None = None):
    """(loss, metrics, grads, errors) on a mesh: this rank's rows of the
    global ``batch`` through ``model.loss`` under ``ctx``, the gradients
    reduced (``reduce_grads``); the loss and metrics are the means over
    the data-parallel ranks."""
    with L.activation_sharding(ctx):
        loss, metrics, grads = _accumulated(model, params, ctx.local_rows(batch), microbatches,
                                            mode)
    grads, errors = reduce_grads(ctx, grads, method, errors)
    mean = lambda t: ctx.mesh.all_reduce(t, ctx.batch_axes) / ctx.dp  # noqa: E731
    return mean(loss), {k: mean(v) for k, v in metrics.items()}, grads, errors


def make_sharded_train_step(model: Model, run: RunConfig, mesh, *,
                            mode: str | None = None) -> tuple[Callable, Callable, object]:
    """Returns (init(generator) -> (params, opt_state), train_step, ctx) on
    ``mesh`` (``collectives.Mesh``; ctx its ``MeshContext``).

    ``init`` draws the full masters from the generator (the same seed on
    every rank) and keeps this rank's slices. ``train_step(params,
    opt_state, batch, step)`` takes the global batch and returns (params,
    opt_state, metrics) as ``make_train_step`` does: the metrics are the
    global loss (mean over the data-parallel ranks), the lr and the global
    grad norm."""
    ctx = model.mesh_context(mesh)
    ocfg = OptConfig(weight_decay=run.weight_decay, grad_clip=run.grad_clip)
    opt_init, opt_update = make_optimizer(model.cfg.optimizer, ocfg)
    sharded = any(mesh.size(a) > 1 for spec in leaves_of_specs(ctx.specs)
                  for a in _spec_axes(spec))
    if model.cfg.optimizer != "adamw" and sharded:
        raise ValueError(f"{model.cfg.optimizer} on a mesh that shards a parameter: its state "
                         "is not elementwise over the slices (ROADMAP item 10p-b)")

    def init(generator: torch.Generator):
        full = materialize(model.param_infos(), generator)
        params = tree_map(lambda t: t.contiguous().clone(),
                          local_shards(full, ctx.specs, mesh.coords, mesh.sizes))
        return params, opt_init(params)

    def train_step(params, opt_state, batch: dict, step):
        lr = warmup_cosine(step, peak_lr=run.learning_rate, warmup_steps=run.warmup_steps,
                           total_steps=run.total_steps, device=leaves(params)[0].device)
        opt = dict(opt_state)
        errors = opt.pop("grad_errors", None)
        loss, metrics, grads, errors = sharded_loss_and_grads(
            model, ctx, params, batch, microbatches=run.microbatches,
            method=run.grad_compression, errors=errors, mode=mode)
        gn = sharded_global_norm(ctx, grads)
        with torch.no_grad():
            new_params, new_opt, stats = opt_update(params, grads, opt, lr, ocfg, norm=gn)
        if errors is not None:
            new_opt["grad_errors"] = errors
        return new_params, new_opt, {"loss": loss, "lr": lr, **metrics, **stats}

    return init, train_step, ctx
