"""The port's dry run (``repro_torch.launch.dryrun``) on meta tensors.

Parameter counts equal JAX's for all ten archs; a step counted at depths
1 and 2 extrapolates to the direct count at depth 3; a train cell's counted
FLOPs are at least its MODEL_FLOPS; the count allocates nothing off the
meta device; the LM kernels on meta tensors stand in as one operator each
with their own FLOP formulas and count no launch; the CLI writes one JSON
per cell and a skip record for long_500k of the full-attention archs."""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs.registry import ARCHS
from repro.configs.registry import get_config as jget
from repro.models.api import build_model as jbuild
from repro.models.params import count_params as jcount
from repro_torch.configs import MeshConfig, get_config
from repro_torch.kernels import flash_attention as kf
from repro_torch.kernels import mamba_scan as km
from repro_torch.kernels import meta
from repro_torch.kernels import rwkv6_scan as ks
from repro_torch.launch import dryrun
from repro_torch.launch.roofline import CellArtifact, extrapolate, model_flops
from repro_torch.models import build_model
from repro_torch.models.params import count_params

ROOT = pathlib.Path(__file__).resolve().parents[1]
ONE = MeshConfig(data=1, model=1)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_counts_equal_jax(arch):
    n = count_params(build_model(get_config(arch)).param_infos())
    assert n == jcount(jbuild(jget(arch)).param_infos())
    mem = dryrun.memory(build_model(get_config(arch)), {"seq_len": 512, "global_batch": 2,
                                                        "kind": "train"}, ONE)
    bytes_ = {torch.float32: 4, torch.bfloat16: 2}[get_config(arch).param_dtype]
    assert mem["params"] == pytest.approx(n * bytes_, rel=0.02)  # norms stay float32


#: (arch, shape): each family and step kind at a small size
LINEAR_CELLS = [
    ("tinyllama-1.1b", dict(seq_len=128, global_batch=2, kind="train")),
    ("rwkv6-7b", dict(seq_len=64, global_batch=2, kind="prefill")),
    ("whisper-medium", dict(seq_len=256, global_batch=2, kind="decode")),
    ("moonshot-v1-16b-a3b", dict(seq_len=64, global_batch=2, kind="train")),
    ("internvl2-2b", dict(seq_len=512, global_batch=1, kind="prefill")),
]


@pytest.mark.parametrize("arch,info", LINEAR_CELLS, ids=[a for a, _ in LINEAR_CELLS])
def test_depth_extrapolation_equals_direct_count(arch, info):
    cfg = get_config(arch)
    pts = {L: dryrun.count_step(dryrun.cost_config(cfg, L), info) for L in (1, 2, 3)}
    for key in ("flops", "bytes"):
        want = pts[3][key]
        assert want > 0
        assert extrapolate(pts[1][key], pts[2][key], 1, 2, 3) == pytest.approx(want, rel=1e-9)
    assert all(p["host_max"] <= 1 << 20 for p in pts.values())  # nothing off meta


def test_train_cell_counts_at_least_model_flops():
    cfg = get_config("tinyllama-1.1b")
    info = dict(seq_len=256, global_batch=2, kind="train")
    kf.reset_launches()
    art = dryrun.run_cell(cfg, info, ONE, mesh_label="1x1", verbose=False)
    assert not kf.LAUNCHES
    assert art.flops * art.chips >= art.model_flops == model_flops(cfg, info)
    assert art.cell == "tinyllama-1.1b__train_2x256__1x1" and art.chips == 1
    assert art.extras["n_params"] == count_params(build_model(cfg).param_infos())
    assert art.extras["tensor_parallel_activations"] == dryrun.TP_NOT_COUNTED
    mem = art.memory_breakdown
    assert set(mem) == {"params", "batch", "grads", "opt_state", "activations", "update"}
    assert mem["opt_state"] == pytest.approx(2 * mem["grads"], rel=1e-6)  # AdamW m and v
    assert art.peak_memory_per_device == dryrun.peak_bytes(mem) >= dryrun.state_bytes(mem)
    assert art.collective_bytes == 0.0  # one device: nothing to gather or reduce


def test_collectives_follow_the_specs():
    """tinyllama's replicated weights on the single-pod mesh: no FSDP
    gather; the gradients all-reduce over 16 data ranks, each device's
    share its model shard."""
    model = build_model(get_config("tinyllama-1.1b"))
    mesh = MeshConfig()
    c = dryrun.collective_traffic(model, mesh, "train")
    assert c["all-gather"] == 0.0 and c["reduce-scatter"] == 0.0
    from repro_torch.distributed.sharding import bytes_per_device, param_specs
    from repro_torch.tree import map_with_path
    f32 = map_with_path(lambda _, i: dataclasses.replace(i, dtype=torch.float32),
                        model.param_infos())
    grads = bytes_per_device(f32, param_specs(model, mesh), {"data": 1, "model": 16})
    assert c["all-reduce"] == pytest.approx(2 * grads * 15 / 16, rel=1e-12)
    fsdp = build_model(dataclasses.replace(get_config("tinyllama-1.1b"), fsdp=True))
    c = dryrun.collective_traffic(fsdp, mesh, "train")
    assert c["all-gather"] > 0 and c["reduce-scatter"] > 0
    assert dryrun.collective_traffic(fsdp, mesh, "prefill")["all-gather"] == pytest.approx(
        c["all-gather"] / 2)
    assert dryrun.collective_traffic(model, mesh, "decode") == {
        "all-gather": 0.0, "reduce-scatter": 0.0, "all-reduce": 0.0}


def test_kernels_on_meta_are_one_operator_each():
    B, S, H, Hkv, dh = 2, 8, 4, 2, 16
    q = torch.empty(B, S, H, dh, dtype=torch.bfloat16, device="meta")
    k = torch.empty(B, S, Hkv, dh, dtype=torch.bfloat16, device="meta")
    for mod in (kf, ks, km):
        mod.reset_launches()
    counter = dryrun.ByteCounter()
    with FlopCounterMode(display=False) as fc, counter:
        out = kf.flash_attention(q, k, k, causal=True)
    assert out.is_meta and out.shape == q.shape
    assert counter.ops == 1 and counter.bytes == 2 * q.numel() * 2 + 2 * k.numel() * 2
    assert fc.get_total_flops() == 4 * B * H * dh * (S * (S + 1) // 2)
    assert meta.attention_pairs(S, S, False, 0, 0) == S * S
    assert meta.attention_pairs(4, 12, True, 8, 3) == 12  # each query its last 3 rows
    r = torch.empty(B, S, H, dh, dtype=torch.bfloat16, device="meta")
    u = torch.empty(H, dh, device="meta")
    s0 = torch.empty(B, H, dh, dh, device="meta")
    with FlopCounterMode(display=False) as fc:
        y, sT = ks.rwkv6_scan(r, r, r, r.float(), u, s0)
    assert fc.get_total_flops() == 4 * B * S * H * dh * dh and y.dtype == torch.float32
    E, N = 8, 4
    delta = torch.empty(B, S, E, device="meta")
    bm = torch.empty(B, S, N, device="meta")
    A = torch.empty(E, N, device="meta")
    h0 = torch.empty(B, E, N, device="meta")
    with FlopCounterMode(display=False) as fc:
        y, hT = km.mamba_selective_scan(delta, delta, bm, bm, A, h0)
    assert fc.get_total_flops() == 6 * B * S * E * N and y.shape == (B, S, E)
    assert not (kf.LAUNCHES or ks.LAUNCHES or km.LAUNCHES)
    with pytest.raises(RuntimeError, match="meta tensors only"):
        cpu = [torch.zeros(x.shape, dtype=x.dtype) for x in (q, k, k)]
        meta.flash_attention(*cpu, True, 0, 0)


def test_route_follows_the_kernel_head_dims():
    assert dryrun.route(get_config("tinyllama-1.1b")) == "cuda"
    assert dryrun.route(get_config("kimi-k2-1t-a32b")) == "torch"  # dh 112


def _cli(*args, timeout=600):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("PYTHONSTARTUP", None)
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", *args], env=env,
                          capture_output=True, text=True, timeout=timeout, cwd=ROOT)


def test_cli_writes_one_json_per_cell(tmp_path):
    out = _cli("--arch", "tinyllama-1.1b", "--shape", "decode_32k", "--mesh", "both",
               "--out", str(tmp_path))
    assert out.returncode == 0, out.stdout + out.stderr
    files = sorted(p.name for p in tmp_path.iterdir())
    assert files == ["tinyllama-1.1b__decode_32k__multi.json",
                     "tinyllama-1.1b__decode_32k__single.json"]
    arts = {f: CellArtifact.load(tmp_path / f) for f in files}
    single, multi = arts[files[1]], arts[files[0]]
    assert (single.chips, multi.chips) == (256, 512)
    assert single.flops == pytest.approx(2 * multi.flops)  # the same count over twice the cards
    assert single.extras["fits_hbm"] and single.kind == "decode"
    assert "ALL CELLS COUNTED" in out.stdout
    again = _cli("--arch", "tinyllama-1.1b", "--shape", "decode_32k", "--mesh", "single",
                 "--skip-existing", "--out", str(tmp_path))
    assert again.returncode == 0 and "cached" in again.stdout


def test_cli_all_writes_skip_records(tmp_path, monkeypatch):
    """``--all``: every cell of the table gets a file; long_500k of the
    full-attention archs a skip record (the cells' counts stubbed here;
    the whole table takes minutes)."""
    ran = []

    def stub(arch, shape, mesh_kind, variant=None, verbose=True):
        ran.append((arch, shape, mesh_kind))
        return dataclasses.replace(_STUB, cell=f"{arch}__{shape}__{mesh_kind}", arch=arch,
                                   shape=shape, mesh=mesh_kind)

    monkeypatch.setattr(dryrun, "run_named", stub)
    dryrun.main(["--all", "--mesh", "both", "--out", str(tmp_path)])
    files = sorted(tmp_path.iterdir())
    assert len(files) == 80 and len(ran) == 64
    skips = [json.loads(p.read_text()) for p in files if "skip" in json.loads(p.read_text())]
    assert len(skips) == 16
    assert all(s["skip"] == "SKIP(full-attention)" and "__long_500k__" in s["cell"] for s in skips)
    subq = {a for a, c in ARCHS.items() if c.is_subquadratic}
    assert {(a, m) for a, s, m in ran if s == "long_500k"} == {
        (a, m) for a in subq for m in ("single", "multi")}


_STUB = CellArtifact(cell="", arch="", shape="", kind="train", mesh="", chips=256, flops=1.0,
                     bytes_accessed=1.0, collective_bytes=0.0, collective_breakdown={},
                     peak_memory_per_device=1.0, memory_breakdown={}, model_flops=1.0,
                     compile_seconds=0.0, extras={})
