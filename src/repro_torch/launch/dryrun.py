"""Dry run of every (arch x shape) cell on a production mesh of H100s
(counterpart of ``repro/launch/dryrun.py``): what one device holds, the
step's FLOPs and bytes, and the collective traffic its sharding implies,
written as JAX's ``CellArtifact`` JSON, with nothing allocated and no card.

    python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape train_4k --mesh single
    python -m repro_torch.launch.dryrun --all [--mesh single|multi|both] [--skip-existing]

Artifacts go to ``artifacts/dryrun_torch/`` (never JAX's ``artifacts/dryrun/``).

JAX compiles each cell on 512 fake host devices and reads XLA's memory and
cost analyses. The port has no compiler to ask; it runs each cell on
``device="meta"`` tensors, the counterpart of JAX's fake devices: every
operator propagates shapes and dtypes and nothing is allocated. The dry
run asks for meta explicitly; no entry point that is meant to compute takes
meta on its own.

Per cell (``run_cell``):

1. Bytes per device, exact from the sharding specs
   (``distributed.sharding``): the parameters at their dtype; to train,
   float32 gradients and the optimizer's state (its ``init`` run on meta
   leaves); to serve, the compute-dtype copies of the weights the serving
   LM keeps beside its masters (``models.layers.Weights``) and the cache;
   and the batch. Their sum is ``state``. Beside it, the activations, by a
   formula (the count runs the one-device program, not the sharded route
   of the decoder LMs, so only the batch's split over the data axes
   shrinks them: ROADMAP 10p-b); with
   t = tokens a device runs (the batch's share times the sequence; one per
   sequence to decode), c = the compute dtype's bytes, L = layers (periods
   of 8 for the hybrid, both stacks for the encdec), w = 4 D + (H + 2 Hkv)
   dh + 3 F (F the MLP width, top-k times the expert width for the MoE, 2
   expand D for the hybrid's Mamba), Vp the padded vocab:
     train, remat 'layer':  L t D c (each layer's input, kept)
                            + 2 t w c (one layer recomputed: its
                              intermediates and their gradients)
                            + 2 (t / 8) Vp 4 (one chunk of the loss's
                              float32 logits and their gradient)
     train, remat 'none':   L t w c + 2 t w c + 2 (t / 8) Vp 4
     prefill:               t w c + b Vp 4 (one layer, then the last
                            position's logits; b = the batch's share)
     decode:                t w c + b Vp 4
   To train, the port's optimizer updates out of place: new parameters
   and state are made before the old ones go, after the backward has
   freed the activations, so ``update`` = parameters + optimizer state.
   ``peak_memory_per_device`` = state + max(activations, update) (to serve,
   state + activations); ``fits_hbm`` compares it with the card's 80 GB.
2. FLOPs and bytes moved: one step on meta tensors at two depths (1 and
   2; 8 and 16 for the hybrid, whole periods, as JAX's cost depths),
   extrapolated linearly to the full depth (``roofline.extrapolate``);
   to train, the port's train step (forward, backward, optimizer update);
   to serve, a prefill of the cell's sequence or a decode step on a cache
   filled to it. The kernels take their CUDA route (``mode='cuda'``): a
   kernel wrapper given meta tensors launches nothing and counts no
   launch, and stands in as one operator whose operands and results are
   the kernel's inputs and outputs (``kernels.meta``); the backward is the
   plain recompute the card runs. A model whose head dim the flash kernel
   does not take (kimi's 112) is counted on the plain route (``route``),
   the only one the card could run it on. FLOPs are ``FlopCounterMode``'s (the
   matmul-class operators and the kernels' own formulas; elementwise
   arithmetic is not counted), bytes ``ByteCounter``'s: each operator's
   operand and result bytes, as XLA's unfused count adds them (views and
   ``empty`` move nothing). Per device = the count / the mesh's devices.
3. Collective bytes per device, from the specs (``collective_traffic``):
   the FSDP all-gather of every leaf the data axes shard (to train twice,
   in the forward and in the remat recompute; to serve once), and the
   gradient reduction over the data axes (a reduce-scatter over the axes
   that shard the leaf, an all-reduce over the rest), by ring volumes.
   Tensor-parallel activation traffic is ROADMAP 10p-b; ``extras`` says
   it is not counted, so no reader takes the term for XLA's.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import pathlib
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from ..configs.base import SHAPES, MeshConfig, ModelConfig, RunConfig, sharding_rules
from ..configs.registry import ARCHS, cells, get_config
from ..distributed.sharding import (axis_sizes, batch_specs, bytes_per_device, cache_specs,
                                    leaves_of_specs, meta_params, opt_state_specs, param_specs)
from ..distributed.train_step import make_train_step
from ..kernels.flash_attention import HEAD_DIMS
from ..models.api import Model, build_model
from ..models.params import axis_names, count_params, info_leaves, shard_factor
from ..optim import OptConfig, make_optimizer
from .roofline import HBM_BYTES, CellArtifact, extrapolate, model_flops

ARTIFACT_ROOT = pathlib.Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"

#: JAX's variants, each a cell relowered with one knob flipped.
#: ``bf16comb`` flips the dtype of the expert-parallel combine's
#: all-reduce (``layers._moe_expert_parallel``).
VARIANTS = {
    "dp": dict(layout="dp"),  # pure-DP + FSDP layout (small models)
    "int8kv": dict(kv_cache_dtype="int8"),  # quantized KV cache (decode)
    "nofsdpexp": dict(expert_fsdp=False),  # resident expert weights (MoE)
    "bf16comb": dict(moe_combine_dtype="bf16"),  # half-width EP combine
    "nofsdpexp_bf16comb": dict(expert_fsdp=False, moe_combine_dtype="bf16"),
    "dp_noremat": dict(layout="dp", remat="none"),  # small models fit w/o remat
    "int8kv_bf16p": dict(kv_cache_dtype="int8", param_dtype=torch.bfloat16),
    "dp_noremat_mb4": dict(layout="dp", remat="none", microbatches=4),
}

#: tensor-parallel activation traffic: the count runs the one-device program
TP_NOT_COUNTED = "not counted (ROADMAP 10p-b)"

_SKIP_BYTES = frozenset({torch.ops.aten.empty, torch.ops.aten.empty_strided,
                         torch.ops.aten.empty_like, torch.ops.aten.new_empty})


def _tensor_bytes(x) -> tuple[int, int]:
    """(bytes of the tensors in x, the largest on a device other than meta)."""
    if isinstance(x, torch.Tensor):
        n = x.numel() * x.element_size()
        return n, (0 if x.is_meta else n)
    if isinstance(x, (list, tuple)):
        parts = [_tensor_bytes(y) for y in x]
        return sum(p[0] for p in parts), max((p[1] for p in parts), default=0)
    return 0, 0


class ByteCounter(TorchDispatchMode):
    """Adds every aten operator's operand and result bytes (an in-place or
    out= operator's result is its operand, counted once); views and
    ``empty`` move nothing. ``host_max`` is the largest tensor an operator
    saw or made off the meta device."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops = 0
        self.host_max = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        n_in, h_in = _tensor_bytes(list(args) + list(kwargs.values()))
        n_out, h_out = _tensor_bytes(out)
        self.host_max = max(self.host_max, h_in, h_out)
        if func.is_view or func.overloadpacket in _SKIP_BYTES:
            return out
        self.bytes += n_in + (0 if func._schema.is_mutable else n_out)
        return out


def route(cfg: ModelConfig) -> str:
    """The kernels' route the count takes: 'cuda', as the card runs the
    cell, unless the flash kernel does not take the model's head dim
    (kimi's 112), where the card can only run the plain attention."""
    return "cuda" if cfg.d_head in HEAD_DIMS else "torch"


def _step(model: Model, info: dict, microbatches: int):
    """The cell's step on meta tensors, as a function of no arguments."""
    cfg = model.cfg
    mode = route(cfg)
    params = meta_params(model.param_infos())
    batch = model.input_specs(info)
    B, S, kind = info["global_batch"], info["seq_len"], info["kind"]
    if kind == "train":
        run = RunConfig(model=cfg, shape="train_4k", mesh=MeshConfig(data=1, model=1),
                        microbatches=microbatches)
        init_opt, _ = make_optimizer(cfg.optimizer, OptConfig())
        _, train_step = make_train_step(model, run, mode=mode)
        opt = init_opt(params)
        return lambda: train_step(params, opt, batch, 0)
    lm = model.build(params)
    lm.mode = mode
    cache = dict(meta_params(model.cache_infos(B, S)), len=0 if kind == "prefill" else S)
    if kind == "prefill":
        return lambda: model.prefill(lm, batch, cache)
    return lambda: model.decode_step(lm, cache, batch["tokens"])


def count_step(cfg: ModelConfig, info: dict, microbatches: int = 1) -> dict:
    """FLOPs, bytes, operators and the largest host tensor of one step of
    ``cfg`` at ``info`` on meta tensors (all devices together)."""
    fn = _step(build_model(cfg), info, microbatches)
    counter = ByteCounter()
    with torch.no_grad() if info["kind"] != "train" else contextlib.nullcontext():
        with FlopCounterMode(display=False) as flops, counter:
            fn()
    return {"flops": float(flops.get_total_flops()), "bytes": float(counter.bytes),
            "ops": counter.ops, "host_max": counter.host_max}


def cost_depths(cfg: ModelConfig) -> tuple[int, int]:
    if cfg.family == "hybrid":
        return 8, 16  # whole periods
    return 1, 2


def cost_config(cfg: ModelConfig, n_layers: int) -> ModelConfig:
    kw = dict(n_layers=n_layers, scan_layers=False, attn_chunk=1 << 30)
    if cfg.family == "encdec":
        kw["enc_layers"] = n_layers
    return dataclasses.replace(cfg, **kw)


@functools.lru_cache(maxsize=None)
def _cost_points(cfg: ModelConfig, shape_key: tuple, microbatches: int) -> dict:
    info = dict(zip(("seq_len", "global_batch", "kind"), shape_key))
    return {L: count_step(cost_config(cfg, L), info, microbatches) for L in cost_depths(cfg)}


def cost_points(cfg: ModelConfig, info: dict, microbatches: int = 1) -> dict:
    """``count_step`` at the two cost depths (cached: the count does not
    depend on the mesh)."""
    key = (info["seq_len"], info["global_batch"], info["kind"])
    return _cost_points(cfg, key, microbatches)


def _group(spec, axes: tuple[str, ...], sizes: dict) -> tuple[int, int]:
    """(product of the sizes of ``axes`` that shard a leaf of ``spec``,
    product of the sizes of its other sharding axes)."""
    inside = outside = 1
    for entry in spec:
        for a in axis_names(entry):
            if a in axes:
                inside *= sizes.get(a, 1)
            else:
                outside *= sizes.get(a, 1)
    return inside, outside


def collective_traffic(model: Model, mesh_cfg: MeshConfig, kind: str) -> dict[str, float]:
    """Per-device bytes of the collectives the specs imply, by kind (ring
    volumes: an all-gather or reduce-scatter over g devices moves (g - 1) /
    g of the whole, an all-reduce twice that). The data-parallel axes are
    those the batch's activations split over (``sharding_rules``' 'batch'
    entry: the data axes, or every axis in the 'dp' layout)."""
    sizes = axis_sizes(mesh_cfg)
    data = axis_names(sharding_rules(model.cfg, mesh_cfg)["batch"])
    dp = math.prod(sizes.get(a, 1) for a in data)
    gathers = 2 if kind == "train" else 1
    out = {"all-gather": 0.0, "reduce-scatter": 0.0, "all-reduce": 0.0}
    infos = info_leaves(model.param_infos())
    for info, spec in zip(infos, leaves_of_specs(param_specs(model, mesh_cfg))):
        g, other = _group(spec, data, sizes)
        n = math.prod(info.shape) / other  # elements before the data axes' split
        out["all-gather"] += gathers * n * info.dtype.itemsize * (g - 1) / g
        if kind == "train":
            grad = n * 4  # float32 gradients
            out["reduce-scatter"] += grad * (g - 1) / g
            rest = dp // g
            out["all-reduce"] += 2 * (grad / g) * (rest - 1) / rest
    return out


def _widths(cfg: ModelConfig) -> tuple[int, int]:
    """(layers the activations keep, the formula's per-token width w)."""
    F = cfg.d_ff
    if cfg.family == "moe" or (cfg.family == "hybrid" and cfg.moe_experts):
        F = max(F, cfg.moe_topk * cfg.moe_dff)
    if cfg.family == "hybrid":
        F = max(F, 2 * cfg.mamba_expand * cfg.d_model)
    w = 4 * cfg.d_model + (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.d_head + 3 * F
    n = cfg.n_layers // 8 if cfg.family == "hybrid" else cfg.n_layers + cfg.enc_layers
    return n, w


def memory(model: Model, info: dict, mesh_cfg: MeshConfig) -> dict[str, float]:
    """The per-device memory breakdown (see the module docstring)."""
    cfg = model.cfg
    sizes = axis_sizes(mesh_cfg)
    B, S, kind = info["global_batch"], info["seq_len"], info["kind"]
    infos = model.param_infos()
    p_specs = param_specs(model, mesh_cfg)
    inputs = model.input_specs(info)
    out = {"params": bytes_per_device(infos, p_specs, sizes),
           "batch": bytes_per_device(inputs, batch_specs(model, mesh_cfg, inputs), sizes)}
    b = B // mesh_cfg.dp if B % mesh_cfg.dp == 0 else B
    c = cfg.compute_dtype.itemsize
    vp = infos["embed"].shape[0]
    n_layers, w = _widths(cfg)
    if kind == "train":
        init_opt, _ = make_optimizer(cfg.optimizer, OptConfig())
        pm = meta_params(infos)
        out["grads"] = sum(math.prod(i.shape) * 4 / shard_factor(s, sizes)
                           for i, s in zip(info_leaves(infos), leaves_of_specs(p_specs)))
        out["opt_state"] = bytes_per_device(init_opt(pm), opt_state_specs(init_opt, pm, p_specs),
                                            sizes)
        t = b * S
        logits = 2 * (t / 8) * vp * 4
        kept = n_layers * t * (cfg.d_model if cfg.remat == "layer" else w) * c
        out["activations"] = kept + 2 * t * w * c + logits
        out["update"] = out["params"] + out["opt_state"]
    else:
        out["compute_copies"] = sum(
            math.prod(i.shape) * c / shard_factor(s, sizes)
            for i, s in zip(info_leaves(infos), leaves_of_specs(p_specs))
            if len(i.shape) >= 2 and i.dtype != cfg.compute_dtype)
        out["cache"] = bytes_per_device(model.cache_infos(B, S), cache_specs(model, mesh_cfg, B, S),
                                        sizes)
        t = b * (S if kind == "prefill" else 1)
        out["activations"] = t * w * c + b * vp * 4
    return out


def state_bytes(mem: dict) -> float:
    return sum(v for k, v in mem.items() if k not in ("activations", "update"))


def peak_bytes(mem: dict) -> float:
    return state_bytes(mem) + max(mem["activations"], mem.get("update", 0.0))


def run_cell(cfg: ModelConfig, shape: str | dict, mesh_cfg: MeshConfig, *, arch: str | None = None,
             shape_name: str | None = None, mesh_label: str = "", microbatches: int = 1,
             variant: str | None = None, verbose: bool = True) -> CellArtifact:
    """The dry run of ``cfg`` (resolved, any cut) at ``shape`` (a key of
    SHAPES or a dict of its keys) on ``mesh_cfg``."""
    t0 = time.time()
    info = SHAPES[shape] if isinstance(shape, str) else dict(shape)
    if shape_name is None:
        shape_name = (shape if isinstance(shape, str) else
                      f"{info['kind']}_{info['global_batch']}x{info['seq_len']}")
    arch = arch or cfg.name
    mesh_label = mesh_label or f"{mesh_cfg.n_devices}dev"
    model = build_model(cfg)
    mem = memory(model, info, mesh_cfg)
    peak = peak_bytes(mem)
    pts = cost_points(cfg, info, microbatches)
    l1, l2 = cost_depths(cfg)
    n_dev = mesh_cfg.n_devices
    full = cfg.n_layers

    def extra(key: str) -> float:
        return extrapolate(pts[l1][key], pts[l2][key], l1, l2, full)

    coll = collective_traffic(model, mesh_cfg, info["kind"])
    art = CellArtifact(
        cell=f"{arch}__{shape_name}__{mesh_label}" + (f"__{variant}" if variant else ""),
        arch=arch, shape=shape_name, kind=info["kind"], mesh=mesh_label, chips=n_dev,
        flops=extra("flops") / n_dev, bytes_accessed=extra("bytes") / n_dev,
        collective_bytes=sum(coll.values()), collective_breakdown=coll,
        peak_memory_per_device=float(peak), memory_breakdown=mem,
        model_flops=model_flops(cfg, info), compile_seconds=time.time() - t0,
        extras={"cost_points": {str(k): v for k, v in pts.items()},
                "fits_hbm": bool(peak <= HBM_BYTES),
                "state_bytes": state_bytes(mem),
                "n_params": count_params(model.param_infos()),
                "tensor_parallel_activations": TP_NOT_COUNTED,
                "count": f"meta tensors, mode={route(cfg)!r}"})
    if verbose:
        t = art.terms()
        print(f"[{art.cell}] mem/dev={peak / 2**30:.2f}GiB fits={art.extras['fits_hbm']} "
              f"compute={t['compute_s'] * 1e3:.2f}ms memory={t['memory_s'] * 1e3:.2f}ms "
              f"collective={t['collective_s'] * 1e3:.2f}ms bottleneck={art.bottleneck()} "
              f"useful={art.useful_flops_ratio():.3f} ({art.compile_seconds:.1f}s)", flush=True)
    return art


def run_named(arch: str, shape: str, mesh_kind: str, variant: str | None = None,
              verbose: bool = True) -> CellArtifact:
    """The CLI's cell: a published arch at an assigned shape on a
    production mesh, with JAX's names."""
    cfg = get_config(arch)
    microbatches = 1
    if variant:
        kw = dict(VARIANTS[variant])
        microbatches = kw.pop("microbatches", 1)
        cfg = dataclasses.replace(cfg, **kw)
    return run_cell(cfg, shape, MeshConfig(multi_pod=(mesh_kind == "multi")), arch=arch,
                    shape_name=shape,
                    mesh_label=mesh_kind, microbatches=microbatches, variant=variant,
                    verbose=verbose)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=sorted(SHAPES), default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--variant", choices=sorted(VARIANTS), default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--out", default=str(ARTIFACT_ROOT))
    args = ap.parse_args(argv)

    out = pathlib.Path(args.out)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    todo = []
    if args.all:
        for arch, shape, skip in cells(include_skipped=True):
            for mk in meshes:
                todo.append((arch, shape, mk, skip))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all)")
        for mk in meshes:
            todo.append((args.arch, args.shape, mk, None))

    t0 = time.time()
    failures = []
    for arch, shape, mk, skip in todo:
        cell = f"{arch}__{shape}__{mk}" + (f"__{args.variant}" if args.variant else "")
        path = out / f"{cell}.json"
        if skip:
            out.mkdir(parents=True, exist_ok=True)
            path.write_text(json.dumps({"cell": cell, "skip": skip}, indent=1))
            print(f"[{cell}] {skip}")
            continue
        if args.skip_existing and path.exists() and "skip" not in json.loads(path.read_text()):
            print(f"[{cell}] cached")
            continue
        try:
            run_named(arch, shape, mk, variant=args.variant).save(out)
        except Exception as e:  # noqa: BLE001 -- a failing cell is a bug to surface
            failures.append((cell, repr(e)))
            print(f"[{cell}] FAILED: {e!r}")
    if failures:
        print(f"\n{len(failures)} FAILED cells:")
        for c, e in failures:
            print(" ", c, e[:200])
        raise SystemExit(1)
    print(f"\nALL CELLS COUNTED in {time.time() - t0:.1f} s.")


if __name__ == "__main__":
    main()
