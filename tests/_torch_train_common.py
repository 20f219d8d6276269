"""Shared pieces of the port's per-family training tests
(``tests/test_torch_train_*.py``): configurations at float32 compute,
the port's SMOKE draw as a numpy tree, seeded batches with each family's
extras, JAX's ``value_and_grad(model.loss)`` and jitted train steps, and
the leaf-by-leaf gradient comparison.

Weights are the port's draw carried to JAX (``convert.params_from_numpy``
on the way back): JAX's own SMOKE draw takes the stacked layer count as a
weight's fan-in, and its near one-hot softmaxes amplify float32 summation
order ~100x (ROADMAP Queue 3; ``tests/test_torch_train.py`` measures it on
the dense family).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.base import MeshConfig as JMeshConfig
from repro.configs.base import RunConfig as JRunConfig
from repro.configs.registry import get_config as jax_config
from repro.distributed.train_step import make_train_step as jax_make_train_step
from repro.models import build_model as jax_build
from repro.optim import make_optimizer as jax_make_optimizer
from repro.optim import OptConfig as JOptConfig
from repro_torch.configs import MeshConfig, RunConfig, get_config
from repro_torch.convert import opt_state_from_numpy, params_from_numpy
from repro_torch.distributed.train_step import make_train_step
from repro_torch.models import build_model, materialize
from repro_torch.tree import leaves, leaves_with_path

#: the loss and its parts, relative (float32 compute)
LOSS_REL = 1e-6


def configs(arch: str, **kw):
    """(JAX, port) SMOKE configurations of ``arch`` at float32 compute."""
    return (dataclasses.replace(jax_config(arch, smoke=True), compute_dtype=jnp.float32, **kw),
            dataclasses.replace(get_config(arch, smoke=True), compute_dtype=torch.float32, **kw))


def port_params_np(tcfg, seed: int = 0, edit=None):
    """The port's draw as a numpy tree; ``edit(tree, rng)`` may change it
    in place first (RWKV's decay, whose init is the same everywhere)."""
    drawn = materialize(build_model(tcfg).param_infos(), torch.Generator().manual_seed(seed))
    tree = jax.tree_util.tree_map(lambda t: t.numpy(), drawn)
    if edit is not None:
        edit(tree, np.random.default_rng(seed + 100))
    return tree


def batch(cfg, B: int = 2, S: int = 32, seed: int = 0, vis: bool = True) -> dict:
    """Seeded tokens and labels [B, S] and the family's extras: the vlm's
    patch embeddings (``vis``), the encdec's frame embeddings."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "vlm" and vis:
        b["vis_embeds"] = rng.normal(size=(B, cfg.vis_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        b["audio_embeds"] = rng.normal(size=(B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return b


def jb(b: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in b.items()}


def tb(b: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in b.items()}


def jax_loss_and_grads(jcfg, pnp, b: dict):
    """(loss, metrics, gradient leaves as numpy) of JAX's jitted
    ``value_and_grad(model.loss)``."""
    (loss, met), grads = jax.jit(jax.value_and_grad(jax_build(jcfg).loss, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, pnp), jb(b))
    return float(loss), {k: float(v) for k, v in met.items()}, [
        np.asarray(g) for g in jax.tree_util.tree_leaves(grads)]


def assert_grads_match(grads, want: list, rel: float, zero_in_exact: tuple = ()) -> None:
    """Every leaf of the port's gradient tree within ``rel`` of its JAX
    leaf's largest |.|, leaf by leaf in JAX's order. Leaves named in
    ``zero_in_exact`` have a zero gradient in exact arithmetic (both
    packages return rounding noise): they are held within ``rel`` of the
    whole tree's largest |gradient|."""
    got = list(leaves_with_path(grads))
    assert len(got) == len(want)
    top = max(float(np.abs(w).max()) for w in want)
    for (path, g), w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, path
        assert bool(torch.isfinite(g).all()), path
        scale = float(np.abs(w).max())
        if path[-1] in zero_in_exact:
            scale = top
        assert scale > 0, path
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=rel * scale, err_msg=str(path))


def _run_config(cfg, microbatches: int = 1) -> dict:
    return dict(model=cfg, shape="train_4k", learning_rate=1e-2, total_steps=10,
                warmup_steps=1, microbatches=microbatches)


def port_steps(tcfg, pnp, batches: list):
    """The port's (params, opt state) after ``train_pair``'s steps, alone."""
    init, step = make_train_step(build_model(tcfg), RunConfig(mesh=MeshConfig(data=1, model=1),
                                                              **_run_config(tcfg)))
    params = params_from_numpy(tcfg, pnp, device="cpu")
    opt = init(torch.Generator().manual_seed(0))[1]
    for i, b in enumerate(batches):
        params, opt, _ = step(params, opt, tb(b), i)
    return params, opt


def train_pair(jcfg, tcfg, pnp, batches: list, microbatches: int = 1):
    """(JAX, port) metrics of each step of ``make_train_step`` (the
    configuration's optimizer; warmup 1 of 10, peak lr 1e-2) from the same
    carried parameters and optimizer state on the same batches, and the
    final (params, opt state) of each."""
    _, jstep = jax_make_train_step(jax_build(jcfg), JRunConfig(
        mesh=JMeshConfig(data=1, model=1), **_run_config(jcfg, microbatches)))
    _, tstep = make_train_step(build_model(tcfg), RunConfig(
        mesh=MeshConfig(data=1, model=1), **_run_config(tcfg, microbatches)))
    jp = jax.tree_util.tree_map(jnp.asarray, pnp)
    jo = jax_make_optimizer(jcfg.optimizer, JOptConfig())[0](jp)
    tp = params_from_numpy(tcfg, pnp, device="cpu")
    to = opt_state_from_numpy(tcfg.optimizer, jax.tree_util.tree_map(np.asarray, jo), pnp,
                              device="cpu")
    jstep = jax.jit(jstep)
    out = []
    for step, b in enumerate(batches):
        jp, jo, jm = jstep(jp, jo, jb(b), jnp.int32(step))
        tp, to, tm = tstep(tp, to, tb(b), step)
        out.append(({k: float(v) for k, v in jm.items()}, {k: float(v) for k, v in tm.items()}))
    return out, (jp, jo), (tp, to)


def assert_steps_match(out, rel: float) -> None:
    """Each step's metrics: the same keys, the loss within LOSS_REL, the lr
    within 2 ulps, the grad norm within ``rel``."""
    for step, (jm, tm) in enumerate(out):
        assert set(tm) == set(jm), (set(tm), set(jm))
        assert abs(tm["loss"] - jm["loss"]) <= LOSS_REL * abs(jm["loss"]), (step, tm, jm)
        assert abs(tm["lr"] - jm["lr"]) <= 2 ** -22 * abs(jm["lr"]), (step, tm, jm)
        assert abs(tm["grad_norm"] - jm["grad_norm"]) <= rel * jm["grad_norm"], (step, tm, jm)


def assert_state_match(jax_state, port_state, rel: float) -> None:
    """Two trees leaf by leaf, each within ``rel`` of the largest |.| over
    the JAX tree's leaves."""
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(jax_state)]
    got = leaves(port_state)
    assert len(got) == len(want)
    scale = max(float(np.abs(w).max()) for w in want if w.size)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g.float().numpy(), dtype=np.float64),
                                   w.astype(np.float64), rtol=0, atol=rel * scale)


def launch_train_smoke(arch: str, steps: int = 2) -> list:
    """``launch.train --device cpu --smoke`` for ``arch``: its losses."""
    from repro_torch.launch import train

    run = train.train(["--arch", arch, "--device", "cpu", "--smoke", "--steps", str(steps),
                       "--batch", "2", "--seq", "32", "--lr", "3e-3", "--log-every", "1"])
    assert run.start_step == 0 and len(run.losses) == steps
    assert all(np.isfinite(run.losses))
    assert all(np.isfinite(m["grad_norm"]) and m["grad_norm"] > 0 for m in run.metrics)
    return run.losses
