"""One rank of the port's tensor-parallel tests (``tests/test_torch_tp_*.py``).

The decoder LMs at SMOKE widths in float32, on the port's draw from a seed
and seeded numpy batches, through the sharded route on every (data, model)
mesh of the group's size. Imports only the port.

    python tests/_torch_tp_ranks.py RANK WORLD DIR SUITE

joins a gloo group of WORLD ranks on a ``FileStore`` in DIR, runs SUITE
('train' or 'serve': every case on each mesh of WORLD ranks;
'collectives': the mesh's collectives, their autograd pairs and
``compressed_psum_mean``) and writes this rank's outputs to
``DIR/<suite>_rank<RANK>.npz``. The test process calls the same functions
with ``mesh=None`` for the one-card route, and ``spawn`` to start a group.
"""
from __future__ import annotations

import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import torch

from repro_torch.configs import MeshConfig, RunConfig, get_config
from repro_torch.distributed.collectives import Mesh
from repro_torch.distributed.serve_step import greedy_generate
from repro_torch.convert import params_from_numpy
from repro_torch.distributed.train_step import (make_sharded_train_step, make_train_step,
                                                sharded_loss_and_grads, loss_and_grads)
from repro_torch.models import build_model, materialize
from repro_torch.models import layers as L
from repro_torch.optim.grad_utils import keystr
from repro_torch.tree import leaves_with_path, tree_map

#: case -> (arch, config overrides); every case at float32 compute
CASES = {
    "llama": ("llama3.2-3b", {}),
    "llama_fsdp": ("llama3.2-3b", {"fsdp": True}),
    "starcoder": ("starcoder2-7b", {}),
    "tinyllama": ("tinyllama-1.1b", {}),
    "tinyllama_dp": ("tinyllama-1.1b", {"layout": "dp"}),
    "tinyllama_heads": ("tinyllama-1.1b", {"n_heads": 16}),
    "moonshot": ("moonshot-v1-16b-a3b", {"moe_capacity_factor": 8.0}),
    "moonshot_bf16": ("moonshot-v1-16b-a3b", {"moe_capacity_factor": 8.0,
                                              "moe_combine_dtype": "bf16"}),
    "internvl": ("internvl2-2b", {}),
}
#: the meshes (data, model) of each world size
MESHES = {1: ((1, 1),), 2: ((1, 2), (2, 1)), 4: ((1, 4), (2, 2))}
B, S, PROMPT, GEN, STEPS, LR = 4, 32, 12, 9, 3, 1e-2


def config(case: str):
    arch, kw = CASES[case]
    return dataclasses.replace(get_config(arch, smoke=True), compute_dtype=torch.float32, **kw)


def params_np(cfg, seed: int = 0) -> dict:
    """The port's draw of ``cfg`` from ``seed`` as a numpy tree."""
    drawn = materialize(build_model(cfg).param_infos(), torch.Generator().manual_seed(seed))
    return tree_map(lambda t: t.numpy(), drawn)


def batch_np(cfg, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "vlm":
        b["vis_embeds"] = rng.normal(size=(B, cfg.vis_tokens, cfg.d_model)).astype(np.float32)
    return b


def prompts_np(cfg, seed: int = 5) -> dict:
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, PROMPT)).astype(np.int64)}
    if cfg.family == "vlm":
        b["vis_embeds"] = rng.normal(size=(B, cfg.vis_tokens, cfg.d_model)).astype(np.float32)
    return b


def tb(b: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def _flat(prefix: str, tree, out: dict) -> None:
    for path, leaf in leaves_with_path(tree):
        if torch.is_tensor(leaf):
            out[prefix + keystr(path)] = leaf.detach().numpy()


def run_train(case: str, mesh: Mesh | None) -> dict:
    """The loss and every gradient at the draw (rank-local slices on a
    mesh), then ``STEPS`` AdamW steps: each step's metrics, the final
    masters and AdamW state."""
    cfg = config(case)
    model = build_model(cfg)
    pnp = params_np(cfg)
    run = RunConfig(model=cfg, shape="train_4k", mesh=MeshConfig(data=1, model=1),
                    learning_rate=LR, total_steps=10, warmup_steps=1)
    out: dict = {}
    if mesh is None:
        params = tree_map(torch.from_numpy, pnp)
        loss, _, grads = loss_and_grads(model, params, tb(batch_np(cfg, 0)))
        _, step = make_train_step(model, run)
    else:
        init, step, ctx = make_sharded_train_step(model, run, mesh)
        params = params_from_numpy(cfg, pnp, device="cpu", ctx=ctx)
        loss, _, grads, _ = sharded_loss_and_grads(model, ctx, params, tb(batch_np(cfg, 0)))
    out["loss"] = np.float64(loss)
    _flat("grad", grads, out)
    from repro_torch.optim import adamw_init

    opt = adamw_init(params)
    metrics = []
    for i in range(STEPS):
        params, opt, m = step(params, opt, tb(batch_np(cfg, 10 + i)), i)
        metrics.append([float(m["loss"]), float(m["grad_norm"]), float(m["lr"])])
    out["metrics"] = np.asarray(metrics)
    _flat("param", params, out)
    _flat("m", opt["m"], out)
    _flat("v", opt["v"], out)
    return out


def run_serve(case: str, mesh: Mesh | None) -> dict:
    """Greedy tokens [B, GEN] (this rank's rows on a mesh) from a prefill
    of the prompts plus GEN - 1 decode steps, on a bf16 and an int8 KV
    cache."""
    out = {}
    for kv in ("bf16", "int8"):
        cfg = dataclasses.replace(config(case), kv_cache_dtype=kv)
        model = build_model(cfg)
        pnp = params_np(cfg)
        batch = tb(prompts_np(cfg))
        if mesh is None:
            ctx, params = None, tree_map(torch.from_numpy, pnp)
        else:
            ctx = model.mesh_context(mesh)
            params = params_from_numpy(cfg, pnp, device="cpu", ctx=ctx)
            batch = ctx.local_rows(batch)
        with L.activation_sharding(ctx):
            lm = model.build(params)
            rows = batch["tokens"].shape[0]
            cache = model.init_cache(rows, model.prefix_len(batch) + PROMPT + GEN, device="cpu")
            toks, _ = greedy_generate(model, lm, batch, cache, GEN)
        out[f"tokens_{kv}"] = toks.numpy()
    return out


def collective_inputs(world: int, seed: int = 3) -> dict:
    """Every rank's inputs to the collectives suite, [world, ...]."""
    rng = np.random.default_rng(seed)
    return {"x": rng.normal(size=(world, 4, 6)).astype(np.float32),
            "dy": rng.normal(size=(world, 4, 6 * world)).astype(np.float32),
            "g": rng.normal(size=(world, 3, 5)).astype(np.float32) * 0.1,
            "h": rng.normal(size=(world, 7)).astype(np.float32)}


def run_collectives(mesh: Mesh, rank: int, world: int) -> dict:
    """The mesh's collectives over ('data', 'model') on this rank's inputs,
    the autograd pairs' forward and backward over it, and
    ``compressed_psum_mean`` over the whole group with each method (twice,
    the second step with the first's error feedback)."""
    from repro_torch.distributed import collectives as C
    from repro_torch.optim import compressed_psum_mean

    a = {k: torch.from_numpy(v[rank]) for k, v in collective_inputs(world).items()}
    axes = ("data", "model")
    C.reset_calls()
    out = {"all_reduce": mesh.all_reduce(a["x"], axes).numpy(),
           "all_gather": mesh.all_gather(a["x"], axes, dim=1).numpy(),
           "reduce_scatter": mesh.reduce_scatter(a["dy"], axes, dim=1).numpy()}
    for name, fn in (("copy_to", lambda t: C.copy_to(t, mesh, axes)),
                     ("reduce_from", lambda t: C.reduce_from(t, mesh, axes)),
                     ("gather_sum", lambda t: C.gather_sum(t, mesh, axes, 1)),
                     ("gather_from", lambda t: C.gather_from(t, mesh, axes, 1)),
                     ("scatter_to", lambda t: C.scatter_to(t, mesh, axes, 1))):
        x = (a["dy"] if name == "scatter_to" else a["x"]).clone().requires_grad_()
        y = fn(x)
        dy = a["dy"] if y.shape == a["dy"].shape else a["x"]
        (dx,) = torch.autograd.grad(y, x, dy)
        out[f"{name}.y"], out[f"{name}.dx"] = y.detach().numpy(), dx.numpy()
    out["calls"] = np.asarray([C.CALLS[(k, "data+model")]
                               for k in ("all_reduce", "all_gather", "reduce_scatter")])
    group = mesh.group(axes)
    for method in ("none", "bf16", "int8"):
        tree = {"g": a["g"], "h": {"k": a["h"]}}
        mean, err = compressed_psum_mean(tree, group, method)
        out[f"psum.{method}.g"], out[f"psum.{method}.h"] = mean["g"].numpy(), mean["h"]["k"].numpy()
        mean2, err2 = compressed_psum_mean(tree, group, method, err)
        out[f"psum2.{method}.g"] = mean2["g"].numpy()
        if method != "none":
            out[f"err.{method}.g"] = err["g"].numpy()
    return out


SUITES = {"train": run_train, "serve": run_serve}


def main(rank: int, world: int, where: str, suite: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(where, f"store_{suite}"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    out = {}
    try:
        for data, model in MESHES[world]:
            mesh = Mesh.build(data, model)
            if suite == "collectives":
                for k, v in run_collectives(mesh, rank, world).items():
                    out[f"{data}x{model}/{k}"] = v
                continue
            for case in CASES:
                for k, v in SUITES[suite](case, mesh).items():
                    out[f"{data}x{model}/{case}/{k}"] = v
        np.savez(os.path.join(where, f"{suite}_rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def spawn(worlds, where: pathlib.Path, suite: str, timeout: float = 240) -> dict:
    """Start one gloo group of each size in ``worlds`` at once, each rank a
    process running ``suite``; wait for all and return {world: [rank
    outputs]}. A rank that fails or outlives ``timeout`` seconds fails the
    call with its log."""
    root = pathlib.Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(root / "src"), str(root / "tests")]))
    env.pop("PYTHONSTARTUP", None)
    procs = {}
    for world in worlds:
        d = where / f"w{world}"
        d.mkdir(parents=True, exist_ok=True)
        procs[world] = [subprocess.Popen(
            [sys.executable, str(root / "tests" / "_torch_tp_ranks.py"), str(r), str(world),
             str(d), suite], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(world)]
    out = {}
    for world, ps in procs.items():
        logs = []
        for p in ps:
            try:
                logs.append(p.communicate(timeout=timeout)[0])
            except subprocess.TimeoutExpired:
                for q in ps:
                    q.kill()
                raise
        for r, p in enumerate(ps):
            assert p.returncode == 0, f"rank {r} of {world}:\n{logs[r][-3000:]}"
        d = where / f"w{world}"
        out[world] = [dict(np.load(d / f"{suite}_rank{r}.npz")) for r in range(world)]
    return out


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
