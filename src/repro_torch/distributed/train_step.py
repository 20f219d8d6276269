"""The training step (counterpart of ``repro/distributed/train_step.py``):
loss -> gradients -> optimizer, with microbatch gradient accumulation and
the model's per-layer remat, on one device.

The JAX step is a jitted pure function; this one runs eagerly on the
device its parameters lie on and keeps the same contract: it takes the
parameter tree (float32 masters), the optimizer state, a batch and the
step, and returns new ones with JAX's metrics. Gradients are taken with
``torch.autograd.grad`` on detached copies of the masters, so the caller's
tensors never carry a graph.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..configs.base import RunConfig
from ..models.api import Model
from ..models.params import materialize
from ..optim import OptConfig, make_optimizer, warmup_cosine
from ..tree import leaves, tree_map


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
        if run.microbatches <= 1:
            loss, metrics, grads = loss_and_grads(model, params, batch, mode=mode)
        else:
            micro = _split_micro(batch, run.microbatches)
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
            loss = 0.0
            for i in range(run.microbatches):
                l, _, g = loss_and_grads(model, params, {k: v[i] for k, v in micro.items()},
                                         mode=mode)
                grads = tree_map(lambda a, b: a + b.float(), grads, g)
                loss = loss + l
            k = float(run.microbatches)
            grads = tree_map(lambda g: g / k, grads)
            loss = loss / k
            metrics = {}
        with torch.no_grad():
            new_params, new_opt, stats = opt_update(params, grads, opt_state, lr, ocfg)
        return new_params, new_opt, {"loss": loss, "lr": lr, **metrics, **stats}

    return init, train_step
